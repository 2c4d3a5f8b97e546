"""CIFAR-10 convnet, BASELINE config 2 (``veles_tpu/models/cifar.py``).

:data:`CIFAR_LAYERS` is the Caffe cifar10-quick-style stack of the JAX
package (max and average pooling, a linear 576 -> 64 fully-connected
layer before the softmax) and :data:`CIFAR_TRAINING` ``CifarWorkflow``'s
training defaults (its minibatch is 100).
:class:`CifarLoader` reads the CIFAR-10 python pickles from a directory
(batches 1-5 train, ``test_batch`` validation), or a provider's arrays
(``datasets.golden_objects``), or else draws its synthetic data; its
samples are mean-dispersion normalized on the training samples by
default, as the reference's loader path is.
"""

import os
import pickle

import numpy
import torch

from veles_tpu_torch.loader.fullbatch import FullBatchLoader

#: per-sample NHWC input
CIFAR_SAMPLE_SHAPE = (32, 32, 3)

CIFAR_LAYERS = [
    {"type": "conv_str", "n_kernels": 32, "kx": 5, "ky": 5, "padding": 2},
    {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
    {"type": "conv_str", "n_kernels": 32, "kx": 5, "ky": 5, "padding": 2},
    {"type": "avg_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
    {"type": "conv_str", "n_kernels": 64, "kx": 5, "ky": 5, "padding": 2},
    {"type": "avg_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
    {"type": "all2all", "output_sample_shape": 64},
    {"type": "softmax", "output_sample_shape": 10},
]

#: ``CifarWorkflow``'s defaults: softmax loss, SGD with these
CIFAR_TRAINING = {"learning_rate": 0.01, "momentum": 0.9,
                  "weights_decay": 4e-3}


def read_cifar_batch(path):
    """One CIFAR-10 python pickle: (NHWC float32 data, int32 labels)."""
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    data = d[b"data"].reshape(-1, 3, 32, 32).transpose(
        0, 2, 3, 1).astype(numpy.float32)
    return data, numpy.asarray(d[b"labels"], numpy.int32)


class CifarLoader(FullBatchLoader):
    """CIFAR-10 from ``directory``'s pickles, a ``provider``'s arrays, or
    ``synthetic_samples`` training samples (600 when 0) drawn from
    ``seed``; classes ``[0, valid, train]``; ``mean_disp`` by default."""

    def __init__(self, directory=None, synthetic_samples=0, provider=None,
                 seed=2, normalization_type="mean_disp", **kwargs):
        super(CifarLoader, self).__init__(
            normalization_type=normalization_type, **kwargs)
        self.directory = directory
        self.synthetic_samples = synthetic_samples
        self.provider = provider
        self.seed = seed

    def _load_pickles(self):
        train = [read_cifar_batch(os.path.join(
            self.directory, "data_batch_%d" % i)) for i in range(1, 6)]
        valid = read_cifar_batch(os.path.join(self.directory, "test_batch"))
        return (numpy.concatenate([t[0] for t in train]),
                numpy.concatenate([t[1] for t in train]), valid[0], valid[1])

    def _synthesize(self):
        rng = numpy.random.RandomState(self.seed)
        n = self.synthetic_samples or 600
        nv = max(n // 5, 1)
        protos = rng.rand(10, 32, 32, 3).astype(numpy.float32)

        def make(count):
            labels = rng.randint(0, 10, count).astype(numpy.int32)
            data = protos[labels] + rng.normal(
                0, 0.25, (count, 32, 32, 3)).astype(numpy.float32)
            return data, labels

        tx, ty = make(n)
        vx, vy = make(nv)
        return tx, ty, vx, vy

    def load_dataset(self):
        if self.provider is not None:
            tx, ty, vx, vy = self.provider()
        elif self.directory and os.path.isdir(self.directory):
            tx, ty, vx, vy = self._load_pickles()
        else:
            tx, ty, vx, vy = self._synthesize()
        self.original_data = torch.from_numpy(numpy.ascontiguousarray(
            numpy.concatenate([vx, tx]), numpy.float32))
        self.original_labels = torch.from_numpy(numpy.ascontiguousarray(
            numpy.concatenate([vy, ty]), numpy.int32))
        self.class_lengths = [0, len(vx), len(tx)]
