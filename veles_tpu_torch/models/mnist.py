"""MNIST, BASELINE config 1 (``veles_tpu/models/mnist.py``).

:data:`MNIST_LAYERS` is ``MnistWorkflow``'s default topology, 784 ->
100 (LeCun tanh) -> 10 softmax, and :data:`MNIST_TRAINING` its training
defaults (the keyword arguments of ``models.build.build_training``; its
minibatch is 60, its decision's patience ``train()``'s default of 100
epochs). :class:`MnistLoader` is the
JAX package's loader over a provider -- ``datasets.golden_digits`` or
:func:`mnist_idx_provider` over the IDX files -- flat (n, 784) by
default, linearly normalized to [-1, 1] per feature on the training
samples.
"""

import gzip
import os
import struct

import numpy

from veles_tpu_torch.loader.fullbatch import ProviderLoader

#: per-sample input: flat 784 features (``MnistLoader(flatten=True)``)
MNIST_SAMPLE_SHAPE = (784,)

MNIST_LAYERS = [
    {"type": "all2all_tanh", "output_sample_shape": 100},
    {"type": "softmax", "output_sample_shape": 10},
]

#: ``MnistWorkflow``'s defaults: softmax loss, SGD with these
MNIST_TRAINING = {"learning_rate": 0.1, "weights_decay": 0.0,
                  "momentum": 0.0, "lr_decay": 1.0}


def read_idx(path):
    """An (optionally gzipped, by the ``.gz`` suffix) IDX file as a uint8
    array of its dimensions: a big-endian magic whose low byte is the
    rank, the rank's big-endian uint32 sizes, then the bytes."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = numpy.frombuffer(f.read(), dtype=numpy.uint8)
    return data.reshape(dims)


class MnistLoader(ProviderLoader):
    """Full batch over a provider returning (train_data, train_labels,
    valid_data, valid_labels): flat (n, 784) by default, (n, 28, 28, 1)
    NHWC with ``flatten=False``; ``linear`` normalization by default."""

    def __init__(self, provider=None, flatten=True,
                 normalization_type="linear", **kwargs):
        super(MnistLoader, self).__init__(
            provider=provider, flatten=flatten,
            normalization_type=normalization_type, **kwargs)


def mnist_idx_provider(directory):
    """A provider reading the four MNIST IDX files from ``directory``
    (plain or ``.gz``; t10k is the validation set)."""
    def provide():
        def grab(stem):
            for name in (stem, stem + ".gz"):
                path = os.path.join(directory, name)
                if os.path.exists(path):
                    return read_idx(path)
            raise FileNotFoundError(os.path.join(directory, stem))
        return (grab("train-images-idx3-ubyte"),
                grab("train-labels-idx1-ubyte"),
                grab("t10k-images-idx3-ubyte"),
                grab("t10k-labels-idx1-ubyte"))
    return provide
