"""Multi-head self-attention (``veles_tpu/nn/attention.py``).

``MultiHeadAttentionForward`` takes (batch, seq, dim) inputs, per-sample
shape (seq, dim), and returns the same shape. ``weights`` is (4, dim,
dim), the Q, K, V and output projections applied as ``x @ w[i]``, and
``bias`` is (4, dim): the JAX package's layout, unchanged. The filler
takes ``fan_in`` over every axis of the weights but the last, 4 * dim,
and draws the bias from the same range.

Each projection is ``x @ w[i] + b[i]`` over the (batch * seq, dim) rows,
the function of the fully-connected layers, so it runs
:class:`veles_tpu_torch.ops.gemm.LinearActFunction` with the linear
epilogue: forward through the GEMM + bias kernel (K1) on the card, its
bias gradient through the column-sum kernel (K6). Between them
:func:`veles_tpu_torch.parallel.sequence.local_attention` splits the
heads (head_dim = dim / heads).

Precision: the JAX layer never casts its operands to the policy's
compute dtype. Its einsums take the float32 master weights with
``preferred_element_type=float32``, so under every policy the block
computes in float32, and only its output takes the input's dtype. The
port keeps that: the input is widened to float32, the weights are
never cast. The products run under the trainer's and the served
batch's ``Policy.backends()``, which hold TF32 off.

The residual output ``x + attention(x)`` is the default; ``causal``
masks later positions. ``use_ring`` (the sequence-sharded plans) comes
with the port's parallel tier.
"""

import torch

from veles_tpu_torch.nn.base import WeightedBase
from veles_tpu_torch.ops.gemm import LinearActFunction
from veles_tpu_torch.parallel.sequence import local_attention


class MultiHeadAttentionForward(WeightedBase):
    """Self-attention over (batch, seq, dim) inputs, residual output."""

    def __init__(self, input_shape, heads=4, causal=True, residual=True,
                 policy="float32", include_bias=True, device=None,
                 trainable=False):
        if len(input_shape) != 2:
            raise ValueError("attention takes (seq, dim) samples, got %s"
                             % (tuple(input_shape),))
        self.heads = int(heads)
        if input_shape[-1] % self.heads:
            raise ValueError("dim %d not divisible by %d heads"
                             % (input_shape[-1], self.heads))
        self.causal = bool(causal)
        self.residual = bool(residual)
        super(MultiHeadAttentionForward, self).__init__(
            input_shape, policy, include_bias, device, trainable)

    def jax_weights_shape(self):
        dim = self.input_shape[-1]
        return (4, dim, dim)

    def bias_shape(self):
        return (4, self.input_shape[-1])

    def use_ring(self, *args, **kwargs):
        raise NotImplementedError(
            "ring and Ulysses attention need a sequence mesh: they come "
            "with the port's parallel tier (queue A item 7)")

    def _apply(self, x, plain):
        batch, seq, dim = x.shape
        heads = self.heads
        xf = x.float()

        def proj(i, t):
            bias = None if self.bias is None else self.bias[i]
            y = LinearActFunction.apply(t.reshape(batch * seq, dim),
                                        self.weights[i], bias, "linear",
                                        torch.float32, plain)
            return y.reshape(batch, seq, dim)

        def split(t):  # (B, S, D) -> (B, H, S, hd)
            return t.reshape(batch, seq, heads, dim // heads).transpose(1, 2)

        q, k, v = (split(proj(i, xf)) for i in range(3))
        ctx = local_attention(q, k, v, causal=self.causal)
        out = proj(3, ctx.transpose(1, 2).reshape(batch, seq, dim))
        if self.residual:
            out = out + xf
        return out.to(x.dtype)

    def forward(self, x):
        return self._apply(x, plain=False)

    def plain_forward(self, x):
        return self._apply(x, plain=True)
