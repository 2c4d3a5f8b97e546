"""Fully-connected layers (``veles_tpu/nn/all2all.py``).

``y = act(flatten(x) @ W + b)`` with W stored ``(in, out)`` as in the
JAX package. The input is flattened from NHWC, so fc6's 9216 input
features come in (h, w, c) order, the order the JAX weights expect.
All2All and its activation variants run
:class:`veles_tpu_torch.ops.gemm.LinearActFunction`: forward through the
hand-written GEMM + bias + activation kernel (K1) on the card, backward
with the bias gradient through the column-sum kernel (K6). The softmax
head keeps its logits product on ``torch.matmul`` in float32, as the
JAX package keeps it on a plain ``jnp.dot`` outside Pallas; its bias
goes through :func:`veles_tpu_torch.nn.base.bias_add_nhwc` (K6 in the
backward, rows = batch). :meth:`All2AllSoftmax.logits` is the training
output, the counterpart of ``apply_for_grad``.
"""

import numpy
import torch

from veles_tpu_torch.nn.base import WeightedBase, bias_add_nhwc
from veles_tpu_torch.ops.gemm import LinearActFunction


class All2All(WeightedBase):
    """y = activation(flatten(x) @ W + b)."""

    ACTIVATION = "linear"

    def __init__(self, input_shape, output_sample_shape, activation=None,
                 policy="float32", include_bias=True, device=None,
                 trainable=False):
        if isinstance(output_sample_shape, int):
            output_sample_shape = (output_sample_shape,)
        self.output_sample_shape = tuple(output_sample_shape)
        self.activation_name = activation or self.ACTIVATION
        super(All2All, self).__init__(input_shape, policy, include_bias,
                                      device, trainable)

    def jax_weights_shape(self):
        return (int(numpy.prod(self.input_shape)),
                int(numpy.prod(self.output_sample_shape)))

    def output_shape(self):
        return self.output_sample_shape

    def _apply(self, x, plain):
        batch = x.shape[0]
        xc, wc = self.policy.cast_in(x.reshape(batch, -1), self.weights)
        y = LinearActFunction.apply(xc, wc, self.bias, self.activation_name,
                                    self.policy.keep_dtype, plain)
        return y.reshape((batch,) + self.output_sample_shape)

    def forward(self, x):
        return self._apply(x, plain=False)

    def plain_forward(self, x):
        return self._apply(x, plain=True)


class All2AllTanh(All2All):
    ACTIVATION = "tanh"


class All2AllRELU(All2All):
    ACTIVATION = "relu"


class All2AllStrictRELU(All2All):
    ACTIVATION = "strict_relu"


class All2AllSigmoid(All2All):
    ACTIVATION = "sigmoid"


class All2AllSoftmax(All2All):
    """Softmax head: float32 logits whatever the policy, then the
    max-subtracted softmax."""

    def _logits(self, x, plain):
        batch = x.shape[0]
        xc, wc = self.policy.cast_in(x.reshape(batch, -1), self.weights)
        # bf16 operands widened to float32: exact products, f32 sums
        return bias_add_nhwc(torch.matmul(xc.float(), wc.float()),
                             self.bias, plain)

    def logits(self, x, plain=False):
        """float32 logits, whatever the policy: the output the loss
        differentiates (``apply_for_grad`` in the JAX package)."""
        return self._logits(x, plain).reshape(
            (x.shape[0],) + self.output_sample_shape)

    def softmax(self, logits):
        """The max-subtracted softmax of ``logits`` (batch, ...) over
        the flattened sample, in the output's shape."""
        flat = logits.reshape(logits.shape[0], -1)
        z = flat - flat.max(dim=1, keepdim=True).values
        e = torch.exp(z)
        return (e / e.sum(dim=1, keepdim=True)).reshape(
            (logits.shape[0],) + self.output_sample_shape)

    def forward(self, x):
        return self.softmax(self._logits(x, plain=False))

    def plain_forward(self, x):
        return self(x)
