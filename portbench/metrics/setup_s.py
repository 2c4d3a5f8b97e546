"""``setup_s`` (s, host clock): from the start of ``run.py`` to the
first timed step -- ``import torch`` and the port, the kernels'
libraries built (a checkout's first run) or found, and the driver's
set-up: for training, the data and weights made on the card, the
trainer built and the recorded starts of its first epochs, which warm
every shape the cell uses."""


def read(run):
    return run.setup_s
