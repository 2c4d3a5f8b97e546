"""MNIST, BASELINE config 1 (``veles_tpu/models/mnist.py``).

:data:`MNIST_LAYERS` is ``MnistWorkflow``'s default topology, 784 ->
100 (LeCun tanh) -> 10 softmax, and :data:`MNIST_TRAINING` its training
defaults (the keyword arguments of ``models.build.build_training``; its
minibatch is 60, its decision's patience ``train()``'s default of 100
epochs). :class:`MnistLoader` is the
JAX package's loader over a provider -- ``datasets.golden_digits`` or
:func:`mnist_idx_provider` over the IDX files -- flat (n, 784) by
default, linearly normalized to [-1, 1] per feature on the training
samples. :class:`MnistWorkflow` is the JAX package's workflow class,
with its own graph (not a ``StandardWorkflow``): tanh layers of the
given widths and a softmax head over an :class:`MnistLoader`.
"""

import gzip
import os
import struct

import numpy

from veles_tpu_torch.loader.fullbatch import ProviderLoader
from veles_tpu_torch.nn.decision import DecisionGD
from veles_tpu_torch.nn.units import (All2AllSoftmax, All2AllTanh,
                                      EvaluatorSoftmax, GDSoftmax, GDTanh)
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.standard_workflow import TrainableWorkflow

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


class MnistWorkflow(TrainableWorkflow):
    """784 -> layers... -> 10 softmax classifier, wired as the JAX
    package's ``MnistWorkflow``."""

    hide_from_registry = True

    def __init__(self, workflow=None, provider=None, layers=(100,),
                 minibatch_size=60, learning_rate=0.1, weights_decay=0.0,
                 momentum=0.0, lr_decay=1.0, max_epochs=None,
                 fail_iterations=100, **kwargs):
        super(MnistWorkflow, self).__init__(workflow, **kwargs)

        self.repeater = Repeater(self)
        self.repeater.link_from(self.start_point)

        self.loader = MnistLoader(workflow=self, provider=provider,
                                  minibatch_size=minibatch_size,
                                  name="MnistLoader")
        self.loader.link_from(self.repeater)

        self.forwards = []
        src_attr = "minibatch_data"
        for width in layers:
            fwd = All2AllTanh(self, output_sample_shape=(width,),
                              name="fc%d" % len(self.forwards))
            src = self.forwards[-1] if self.forwards else self.loader
            fwd.link_from(src)
            fwd.link_attrs(src, ("input", src_attr))
            self.forwards.append(fwd)
            src_attr = "output"
        head = All2AllSoftmax(self, output_sample_shape=(10,),
                              name="softmax")
        prev = self.forwards[-1] if self.forwards else self.loader
        head.link_from(prev)
        head.link_attrs(prev, ("input", src_attr))
        self.forwards.append(head)

        self.evaluator = EvaluatorSoftmax(self, name="evaluator")
        self.evaluator.link_from(head)
        self.evaluator.link_attrs(head, "output")
        self.evaluator.link_attrs(self.loader,
                                  ("labels", "minibatch_labels"))
        self.evaluator.link_attrs(self.loader,
                                  ("batch_size", "minibatch_size"))

        self.decision = DecisionGD(self, max_epochs=max_epochs,
                                   fail_iterations=fail_iterations,
                                   name="decision")
        self.decision.link_from(self.evaluator)
        self.decision.link_attrs(self.loader, "minibatch_class",
                                 "last_minibatch", "epoch_ended",
                                 "epoch_number", "class_lengths",
                                 "minibatch_size")
        self.decision.link_attrs(self.evaluator,
                                 ("minibatch_n_err", "n_err"))

        self.gds = []
        err_src, err_attr = self.evaluator, "err_output"
        for fwd in reversed(self.forwards):
            gd_cls = GDSoftmax if fwd is head else GDTanh
            gd = gd_cls(self, forward=fwd, learning_rate=learning_rate,
                        weights_decay=weights_decay, momentum=momentum,
                        solver_hp={"lr_decay": lr_decay}
                        if lr_decay != 1.0 else {},
                        need_err_input=fwd is not self.forwards[0],
                        name="gd_" + fwd.name)
            gd.link_from(self.gds[-1] if self.gds else self.decision)
            gd.link_attrs(err_src, ("err_output", err_attr))
            gd.gate_skip = self.decision.gd_skip
            self.gds.append(gd)
            err_src, err_attr = gd, "err_input"

        self.repeater.link_from(self.gds[-1])
        self.repeater.gate_block = self.decision.complete
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete
