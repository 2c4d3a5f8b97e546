"""Loaders of the port (``veles_tpu/loader``): the minibatch server.

The queue-fed loaders and the WebHDFS loader are exported here, as the
JAX package's ``loader/__init__.py`` exports them (the socket feed lives
in ``veles_tpu_torch.zmq_loader``)."""

from veles_tpu_torch.loader.hdfs import HDFSLoader  # noqa: F401
from veles_tpu_torch.loader.interactive import (InteractiveLoader,  # noqa
                                                QueueFedLoader)
from veles_tpu_torch.loader.restful import RestfulLoader  # noqa: F401
