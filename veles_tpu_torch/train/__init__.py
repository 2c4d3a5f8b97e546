"""Training of the port (``veles_tpu/train``)."""
