"""Attention on one device (``veles_tpu/parallel/sequence.py``).

:func:`local_attention` is the port of the JAX package's single-device
oracle: scores ``q @ k^T`` accumulated in float32 and scaled by
``scale`` (default ``1/sqrt(head_dim)``), positions after the query's
set to ``-inf`` when ``causal``, a float32 softmax over the keys, the
float32 product with ``v``, and a cast to ``q``'s dtype. The JAX
package computes it with XLA einsums, not a Pallas kernel, so it stays
``torch.matmul`` and ``torch.softmax`` here. It is not
``F.scaled_dot_product_attention``: that call's fused backends take no
float32 and would not keep the float32 scores and softmax under bf16
operands.

The sharded schedules of that module (``ring_attention``,
``ulysses_attention``) need a sequence mesh and come with the port's
parallel tier.
"""

import torch


def local_attention(q, k, v, causal=False, scale=None):
    """Attention of ``q``, ``k``, ``v`` (batch, heads, seq, head_dim)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        n_q, n_k = scores.shape[-2:]
        q_pos = torch.arange(n_q, device=scores.device)[:, None]
        k_pos = torch.arange(n_k, device=scores.device)[None, :]
        scores = scores.masked_fill(q_pos < k_pos, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    return torch.matmul(w, v.float()).to(q.dtype)
