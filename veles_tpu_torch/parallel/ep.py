"""The mixture-of-experts FFN on one device (``veles_tpu/parallel/ep.py``).

Switch-style top-1 routing with a fixed capacity per expert: a token
goes to the expert of its largest router probability (the first of
tied maxima, as ``jnp.argmax`` and ``torch.argmax`` both pick), its
place among that expert's tokens is counted in token order, and a
token whose place is at or past the capacity ``max(1, ceil(tokens *
capacity_factor / n_experts))`` is dropped: its output is zero.

:func:`moe_ffn_dense` is the math of the JAX package's
``moe_ffn_reference`` over a leading axis of token groups, each group
routed with its own capacity: the products over ALL experts
(``td,edh->teh``, the activation, ``teh,ehd->ted``, each accumulated in
float32 and cast to x's dtype), then each token's chosen expert's row
times its router probability and its keep flag. The JAX package leaves
these einsums to XLA, so they stay ``torch.einsum`` here.
:func:`moe_ffn_reference` is the JAX function itself, groups being its
shards; :func:`load_balance_loss` the Switch auxiliary loss.

The expert-parallel ``moe_ffn`` (``all_to_all`` over an expert mesh)
comes with the port's parallel tier.
"""

import torch
import torch.nn.functional as F


def capacity_of(tokens, n_experts, capacity_factor):
    """Slots per expert for ``tokens`` routed tokens, as the JAX
    package computes them (a float ceiling division, at least 1)."""
    return max(1, int(-(-tokens * capacity_factor // n_experts)))


def route(probs, capacity):
    """(expert, gate, keep) of router probabilities (..., tokens, E):
    each token's top-1 expert, its probability, and whether its place
    among the tokens routed to that expert before it is below
    ``capacity``."""
    expert = probs.argmax(dim=-1)
    gate = probs.gather(-1, expert[..., None])[..., 0]
    onehot = F.one_hot(expert, probs.shape[-1])
    pos = ((onehot.cumsum(dim=-2) - 1) * onehot).sum(dim=-1)
    return expert, gate, pos < capacity


def router_probs(x, router_w):
    """The float32 router softmax of tokens ``x`` (..., d)."""
    return torch.softmax(torch.matmul(x.float(), router_w.float()), dim=-1)


def moe_ffn_dense(x, router_w, w_up, w_down, capacity_factor=1.25,
                  activation=torch.relu):
    """Top-1 MoE FFN of ``x`` (groups, tokens, d), each group with its
    own capacity; ``router_w`` (d, E), ``w_up`` (E, d, hidden),
    ``w_down`` (E, hidden, d). Returns (groups, tokens, d) in x's
    dtype."""
    groups, tokens, d = x.shape
    capacity = capacity_of(tokens, router_w.shape[1], capacity_factor)
    expert, gate, keep = route(router_probs(x, router_w), capacity)
    h = activation(torch.einsum("gtd,edh->gteh", x.float(),
                                w_up.float()).to(x.dtype))
    y = torch.einsum("gteh,ehd->gted", h.float(),
                     w_down.float()).to(x.dtype)
    picked = y.gather(2, expert[..., None, None].expand(
        groups, tokens, 1, d))[:, :, 0]
    return picked * (gate * keep).to(x.dtype)[..., None]


def moe_ffn_reference(x, router_w, w_up, w_down, n_experts,
                      capacity_factor=1.25, activation=torch.relu,
                      n_shards=None):
    """The JAX package's dense reference: ``x`` (tokens, d) cut into
    ``n_shards`` (default ``n_experts``) equal shards, each routed with
    its own capacity."""
    if router_w.shape[1] != n_experts:
        raise ValueError("router has %d experts, not %d"
                         % (router_w.shape[1], n_experts))
    n_shards = n_experts if n_shards is None else n_shards
    total, d = x.shape
    if total % n_shards:
        raise ValueError("%d tokens not divisible by %d shards" %
                         (total, n_shards))
    return moe_ffn_dense(x.reshape(n_shards, total // n_shards, d),
                         router_w, w_up, w_down, capacity_factor,
                         activation).reshape(total, d)


def load_balance_loss(probs, weights=None):
    """``E * sum_e f_e * P_e`` over router probabilities (tokens, E):
    f_e the (weighted) share of tokens whose top-1 choice is e, P_e the
    (weighted) mean probability of e. ``weights`` (tokens,) masks or
    weighs tokens, normalized by their sum (at least 1)."""
    n_experts = probs.shape[-1]
    assignment = F.one_hot(probs.argmax(dim=-1), n_experts).to(probs.dtype)
    if weights is None:
        f = assignment.mean(dim=0)
        p = probs.mean(dim=0)
    else:
        w = weights.to(probs.dtype)
        w = w / w.sum().clamp(min=1.0)
        f = (assignment * w[:, None]).sum(dim=0)
        p = (probs * w[:, None]).sum(dim=0)
    return n_experts * (f * p).sum()
