"""AlexNet-227, the flagship model (``veles_tpu/models/alexnet.py``).

The layer lists are copied from the JAX package. ``space_to_depth`` on
conv1 is kept in the descriptor: the port runs the strided conv it
restates (``nn/conv.py``). :data:`ALEXNET_TRAINING` holds
``AlexNetWorkflow``'s training defaults and :class:`SyntheticImageLoader`
its synthetic ImageNet-shaped data, byte for byte.
:class:`AlexNetWorkflow` is the JAX package's workflow class: a
``StandardWorkflow`` over those layers and defaults, run by
``python -m veles_tpu_torch``.
"""

import numpy
import torch

from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.standard_workflow import StandardWorkflow

#: per-sample NHWC input of AlexNet-227
ALEXNET_SAMPLE_SHAPE = (227, 227, 3)

ALEXNET_LAYERS = [
    {"type": "conv_str", "n_kernels": 96, "kx": 11, "ky": 11,
     "sliding": (4, 4), "padding": 2, "space_to_depth": True},
    {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75},
    {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
    {"type": "conv_str", "n_kernels": 256, "kx": 5, "ky": 5,
     "padding": 2},
    {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75},
    {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
    {"type": "conv_str", "n_kernels": 384, "kx": 3, "ky": 3,
     "padding": 1},
    {"type": "conv_str", "n_kernels": 384, "kx": 3, "ky": 3,
     "padding": 1},
    {"type": "conv_str", "n_kernels": 256, "kx": 3, "ky": 3,
     "padding": 1},
    {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
    {"type": "all2all_str", "output_sample_shape": 4096},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "all2all_str", "output_sample_shape": 4096},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 1000},
]


#: ``AlexNetWorkflow``'s defaults: softmax loss, SGD with these
#: (the keyword arguments of ``models.build.build_training``)
ALEXNET_TRAINING = {"learning_rate": 0.01, "momentum": 0.9,
                    "weights_decay": 5e-4}


def small_alexnet_layers(n_classes=1000):
    """A proportionally shrunk AlexNet for tests/small chips."""
    return [
        {"type": "conv_str", "n_kernels": 16, "kx": 5, "ky": 5,
         "sliding": (2, 2)},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "conv_str", "n_kernels": 32, "kx": 3, "ky": 3},
        {"type": "max_pooling", "kx": 2, "ky": 2},
        {"type": "all2all_str", "output_sample_shape": 128},
        {"type": "dropout", "dropout_ratio": 0.5},
        {"type": "softmax", "output_sample_shape": n_classes},
    ]


class SyntheticImageLoader(FullBatchLoader):
    """ImageNet-shaped synthetic data, the JAX package's
    ``SyntheticImageLoader``: ``numpy.random.RandomState(seed)``, samples
    drawn in chunks of 512 as ``rand() * 2 - 1`` in float32, then labels
    ``randint(0, n_classes)``; classes ``[0, n_valid, n_train]``.

    ``dtype="bfloat16"`` stores the samples as bf16, rounded to nearest
    even from the float32 draws (``Tensor.to``), the rounding
    ``ml_dtypes`` gives the JAX package, so both hold the same bytes."""

    def __init__(self, n_train=512, n_valid=128, side=227, channels=3,
                 n_classes=1000, seed=1, dtype="float32", **kwargs):
        super(SyntheticImageLoader, self).__init__(**kwargs)
        if dtype not in ("float32", "bfloat16"):
            raise ValueError("dtype must be float32 or bfloat16, got %r"
                             % (dtype,))
        self._gen = (n_train, n_valid, side, channels, n_classes, seed,
                     dtype)

    def load_dataset(self):
        (n_train, n_valid, side, channels, n_classes, seed,
         dtype) = self._gen
        rng = numpy.random.RandomState(seed)
        total = n_train + n_valid
        data = torch.empty((total, side, side, channels),
                           dtype=getattr(torch, dtype))
        for start in range(0, total, 512):
            stop = min(start + 512, total)
            chunk = rng.rand(stop - start, side, side, channels).astype(
                numpy.float32) * 2 - 1
            data[start:stop] = torch.from_numpy(chunk).to(data.dtype)
        labels = rng.randint(0, n_classes, total).astype(numpy.int32)
        self.original_data = data
        self.original_labels = torch.from_numpy(labels)
        self.class_lengths = [0, n_valid, n_train]


class AlexNetWorkflow(StandardWorkflow):
    """AlexNet over any full-batch image loader: ``loader_factory(wf)``
    (default a :class:`SyntheticImageLoader` of its defaults), softmax
    loss and :data:`ALEXNET_TRAINING` unless given."""

    hide_from_registry = True

    def __init__(self, workflow=None, loader_factory=None, layers=None,
                 **kwargs):
        kwargs.setdefault("loss", "softmax")
        for key, value in ALEXNET_TRAINING.items():
            kwargs.setdefault(key, value)
        super(AlexNetWorkflow, self).__init__(
            workflow,
            loader=loader_factory or (
                lambda wf: SyntheticImageLoader(workflow=wf)),
            layers=layers if layers is not None else ALEXNET_LAYERS,
            **kwargs)
