"""The Switch-style mixture-of-experts FFN (``veles_tpu/nn/moe.py``).

``MoEForward`` takes (batch, seq, dim) or (batch, dim) inputs and
returns their shape. ``weights`` is the router (dim, E), without a bias;
``up`` (E, dim, hidden) and ``down`` (E, hidden, dim) are the experts'
products, ``hidden`` 4 * dim unless given. Seeded, the router comes
from the filler, then ``up`` from U(-1/sqrt(dim), 1/sqrt(dim)) and
``down`` from U(-1/sqrt(hidden), 1/sqrt(hidden)), in that order.

The dense path routes each SAMPLE's tokens with their own capacity, as
the JAX layer's ``vmap`` of ``moe_ffn_reference`` does, so a sample's
answer does not depend on what it shares a batch with (the serving
path relies on it); here the samples are the leading axis of one
batched computation (:func:`veles_tpu_torch.parallel.ep.moe_ffn_dense`).
A (batch, dim) input has one token a sample, so nothing is dropped
there. The residual ``x + moe(x)`` is the default.

:meth:`MoEForward.aux_loss` is ``aux_loss_weight`` times the Switch
load-balance loss of the batch's router probabilities, the per-sample
``valid`` mask repeated over each sample's tokens; the trainer adds it
to the training loss when the weight is not 0 (default 0.0).
``use_experts`` (the expert-parallel schedule) comes with the port's
parallel tier.
"""

import numpy
import torch
from torch import nn

from veles_tpu_torch.nn.base import WeightedBase
from veles_tpu_torch.parallel.ep import (load_balance_loss, moe_ffn_dense,
                                         router_probs)


class MoEForward(WeightedBase):
    """Top-1 MoE FFN with per-sample capacity."""

    EXTRA_PARAMS = ("up", "down")

    def __init__(self, input_shape, n_experts=8, hidden=None,
                 capacity_factor=1.25, residual=True, aux_loss_weight=0.0,
                 policy="float32", include_bias=False, device=None,
                 trainable=False):
        self.n_experts = int(n_experts)
        dim = int(input_shape[-1])
        self.hidden = 4 * dim if hidden is None else int(hidden)
        self.capacity_factor = float(capacity_factor)
        self.residual = bool(residual)
        self.aux_loss_weight = float(aux_loss_weight)
        super(MoEForward, self).__init__(input_shape, policy, include_bias,
                                         device, trainable)
        self.up = nn.Parameter(
            torch.empty((self.n_experts, dim, self.hidden), device=device),
            requires_grad=trainable)
        self.down = nn.Parameter(
            torch.empty((self.n_experts, self.hidden, dim), device=device),
            requires_grad=trainable)

    def jax_weights_shape(self):
        return (self.input_shape[-1], self.n_experts)

    def init_jax_params(self, rng):
        params = super(MoEForward, self).init_jax_params(rng)
        for name, fan_in in (("up", self.input_shape[-1]),
                             ("down", self.hidden)):
            s = 1.0 / numpy.sqrt(fan_in)
            params[name] = rng.uniform(-s, s, getattr(self, name).shape
                                       ).astype(numpy.float32)
        return params

    def use_experts(self, *args, **kwargs):
        raise NotImplementedError(
            "the expert-parallel schedule needs an expert mesh: it comes "
            "with the port's parallel tier (queue A item 7)")

    def forward(self, x):
        per_sample = x.reshape(x.shape[0], -1, x.shape[-1])
        y = moe_ffn_dense(per_sample, self.weights, self.up, self.down,
                          self.capacity_factor).reshape(x.shape)
        if self.residual:
            y = y + x
        return y.to(x.dtype)

    def aux_loss(self, x, valid=None):
        """``aux_loss_weight`` times the load-balance loss of this batch's
        router probabilities; ``valid`` (batch,) keeps padded samples'
        tokens out of it."""
        tokens = x.reshape(-1, x.shape[-1])
        probs = router_probs(tokens, self.weights)
        weights = None
        if valid is not None:
            weights = valid.to(probs.dtype).repeat_interleave(
                tokens.shape[0] // x.shape[0])
        return self.aux_loss_weight * load_balance_loss(probs, weights)
