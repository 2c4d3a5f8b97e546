"""Base class of the port's forward layers.

The port of ``veles_tpu/nn/base.py`` ``ForwardBase``: an ``nn.Module``
that knows its per-sample input and output shapes, holds ``weights``
and ``bias`` where it has them, and maps the JAX package's parameter
layout onto its own. Activations move between layers as NHWC tensors
(channels last), the JAX package's layout, so a flattened activation
has the same feature order in both.

Parameters require gradients when the layer is built for training
(``trainable=True``) and not when it is built for serving.
:func:`bias_add_nhwc` adds a bias over the last axis with a backward
that sums the bias gradient through the column-sum kernel (K6).
"""

import numpy
import torch
from torch import nn

from veles_tpu_torch.nn.precision import get_policy


class BiasAddNHWC(torch.autograd.Function):
    """``y + bias`` over the last (channel) axis; the bias gradient is
    the column sum of the upstream gradient viewed as (rows, C)."""

    @staticmethod
    def forward(ctx, y, bias, plain=False):
        ctx.constants = (y.dtype, plain)
        return y + bias

    @staticmethod
    def backward(ctx, g):
        # imported here: ops imports nn.activation, which subclasses
        # ForwardBase
        from veles_tpu_torch.ops.reduce import column_sum, column_sum_plain
        dtype, plain = ctx.constants
        # reshape to (rows, C) only over NHWC-contiguous memory: any
        # other layout is made contiguous first, never reduced on the
        # wrong axis
        rows = g.contiguous().reshape(-1, g.shape[-1])
        db = (column_sum_plain if plain else column_sum)(rows)
        return g.to(dtype), db, None


def bias_add_nhwc(y, bias, plain=False):
    """``y + bias`` with ``bias`` (C,) over y's last axis; ``plain``
    sums the bias gradient with the plain version of K6."""
    if bias is None:
        return y
    return BiasAddNHWC.apply(y, bias, plain)


class ForwardBase(nn.Module):
    """A forward layer: ``input_shape`` is the per-sample shape."""

    def __init__(self, input_shape, policy="float32"):
        super(ForwardBase, self).__init__()
        self.input_shape = tuple(int(d) for d in input_shape)
        self.policy = get_policy(policy)

    @property
    def has_weights(self):
        return False

    def output_shape(self):
        """Per-sample output shape."""
        return self.input_shape

    def plain_forward(self, x):
        """The forward with every kernel replaced by its plain PyTorch
        version; layers without kernels run their own forward."""
        return self(x)


class WeightedBase(ForwardBase):
    """A layer with ``weights`` and an optional ``bias``, and the
    parameters named in :attr:`EXTRA_PARAMS` (the mixture of experts'
    ``up`` and ``down``), each in the JAX package's layout."""

    #: names of the parameters beside ``weights`` and ``bias``
    EXTRA_PARAMS = ()

    def __init__(self, input_shape, policy="float32", include_bias=True,
                 device=None, trainable=False):
        super(WeightedBase, self).__init__(input_shape, policy)
        self.include_bias = bool(include_bias)
        self.weights = nn.Parameter(
            torch.empty(self.weights_shape(), device=device),
            requires_grad=trainable)
        self.bias = nn.Parameter(
            torch.empty(self.bias_shape(), device=device),
            requires_grad=trainable) if self.include_bias else None

    @property
    def has_weights(self):
        return True

    def jax_weights_shape(self):
        """The weights' shape in the JAX package's layout."""
        raise NotImplementedError

    def weights_shape(self):
        """The weights' shape in this module's layout."""
        return self.jax_weights_shape()

    def bias_shape(self):
        """The bias's shape: the weights' last axis."""
        return (self.jax_weights_shape()[-1],)

    def init_jax_params(self, rng):
        """Weights drawn as the JAX package's uniform filler draws them
        (``nn/base.py`` ``fill_weights``): U(-s, s) with s =
        1/sqrt(fan_in), fan_in the product of all but the last axis of
        the JAX layout; the bias from the same range. Returns the
        ``{"weights", "bias"}`` numpy dict in the JAX layout."""
        shape = self.jax_weights_shape()
        fan_in = int(numpy.prod(shape[:-1])) if len(shape) > 1 \
            else shape[0]
        s = 1.0 / numpy.sqrt(max(fan_in, 1))
        params = {"weights": rng.uniform(-s, s, shape).astype(
            numpy.float32)}
        if self.include_bias:
            params["bias"] = rng.uniform(-s, s, self.bias_shape()).astype(
                numpy.float32)
        return params
