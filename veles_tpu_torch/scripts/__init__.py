"""Command-line tools of the port (``veles_tpu/scripts/``)."""
