"""Loaders of the port (``veles_tpu/loader``): the minibatch server."""
