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
masks later positions.

``use_ring(grid, axis, schedule)`` attaches a sequence axis of a
:class:`~veles_tpu_torch.parallel.mesh.RankGrid`, with the JAX unit's
checks: the unit still takes the activations whole, as the rest of the
model sees them, and runs the projections (K1, K6) on all of them;
between them each rank cuts its block of the sequence from q, k and v
(:class:`~veles_tpu_torch.parallel.collectives.ScatterToAxis`), runs
:func:`~veles_tpu_torch.parallel.sequence.ring_attention` or
:func:`~veles_tpu_torch.parallel.sequence.ulysses_attention` on it and
gathers the blocks whole again
(:class:`~veles_tpu_torch.parallel.collectives.GatherFromAxis`), so its
outputs and gradients are the same on every rank. The grid is a
process's runtime state: an unpickled unit has none (reattach it after
a resume), as the JAX unit's mesh. The port's units run their forward
on the rank's own device, so they need no re-placement hook (the JAX
unit's ``_placement_mesh``).
"""

import torch

from veles_tpu_torch.nn.base import WeightedBase
from veles_tpu_torch.ops.gemm import LinearActFunction
from veles_tpu_torch.parallel.collectives import (GatherFromAxis,
                                                  ScatterToAxis)
from veles_tpu_torch.parallel.sequence import (local_attention,
                                               ring_attention,
                                               ulysses_attention)


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
        self._seq_grid = None
        self._seq_axis = "seq"
        self._seq_schedule = "ring"

    def __getstate__(self):
        state = super(MultiHeadAttentionForward, self).__getstate__()
        state.update(_seq_grid=None, _seq_axis="seq", _seq_schedule="ring")
        return state

    def jax_weights_shape(self):
        dim = self.input_shape[-1]
        return (4, dim, dim)

    def bias_shape(self):
        return (4, self.input_shape[-1])

    def use_ring(self, grid, axis="seq", schedule="ring"):
        """Attach the ``axis`` of ``grid``: the sharded plan
        ``schedule`` -- ``ring`` (K/V hops with the streaming softmax)
        or ``ulysses`` (two all_to_alls; the heads must divide the
        axis). Returns the unit."""
        if schedule not in ("ring", "ulysses"):
            raise ValueError("unknown sp schedule %r" % (schedule,))
        size = grid.shape[axis]
        if schedule == "ulysses" and self.heads % size:
            raise ValueError(
                "ulysses needs heads (%d) divisible by the %r axis (%d)"
                % (self.heads, axis, size))
        self._seq_grid = grid
        self._seq_axis = axis
        self._seq_schedule = schedule
        return self

    def _attend(self, q, k, v):
        """The attention of (B, H, S, hd) q, k, v: local, or this rank's
        sequence block by the attached schedule, gathered whole."""
        # snapshots from before the parallel tier have no grid attribute
        grid = getattr(self, "_seq_grid", None)
        if grid is None:
            return local_attention(q, k, v, causal=self.causal)
        seq = grid.axis(self._seq_axis)
        blocks = [ScatterToAxis.apply(t, seq, 2) for t in (q, k, v)]
        sharded = ulysses_attention if self._seq_schedule == "ulysses" \
            else ring_attention
        ctx = sharded(*blocks, grid, self._seq_axis, causal=self.causal)
        return GatherFromAxis.apply(ctx, seq, 2)

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
        ctx = self._attend(q, k, v)
        out = proj(3, ctx.transpose(1, 2).reshape(batch, seq, dim))
        if self.residual:
            out = out + xf
        return out.to(x.dtype)

    def forward(self, x):
        return self._apply(x, plain=False)

    def plain_forward(self, x):
        return self._apply(x, plain=True)
