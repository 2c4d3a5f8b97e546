"""Attention, on one device and over a sequence axis
(``veles_tpu/parallel/sequence.py``).

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

:func:`ring_attention` and :func:`ulysses_attention` are the sharded
schedules over the ``seq`` axis of a
:class:`~veles_tpu_torch.parallel.mesh.RankGrid`, one process a rank:
each takes this rank's block of the sequence (dimension 2 of (batch,
heads, seq, head_dim)) of q, k and v and returns its block of the
output, as the JAX functions' ``shard_map`` bodies do.

* The ring keeps its query block and rotates the K/V blocks one step a
  hop (:func:`~veles_tpu_torch.parallel.collectives.ring_shift`,
  ``dist.batch_isend_irecv``) while the streaming-softmax recurrence
  (running max ``m``, denominator ``l``, weighted sum) accumulates in
  float32, with the blocks' causal offsets and the ``1e-30`` floor on
  ``l``. Its backward (:class:`RingAttention`) is the reverse ring, the
  transpose of the forward's ``ppermute`` hops: the K/V blocks rotate
  the other way, each carrying its dK/dV accumulator, until every block
  is back with its owner holding every rank's contribution; the
  probabilities are recomputed from the forward's ``m`` and ``l``.
* Ulysses swaps the sequence split for a head split with one all_to_all
  per tensor (:class:`~veles_tpu_torch.parallel.collectives.AllToAll`,
  whose backward is the inverse all_to_all), runs :func:`local_attention`
  on its heads over the whole sequence, and swaps back. The heads must
  divide the axis.

The products are ``torch.matmul``, as the JAX package's are einsums.
"""

import torch

from veles_tpu_torch.parallel.collectives import AllToAll, ring_shift


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


def _scores(q, k, q_off, k_off, scale, causal):
    """float32 ``q @ k^T * scale`` of one block pair, later positions
    ``-inf`` when causal (offsets: the blocks' first positions)."""
    scores = torch.matmul(q, k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = q_off + torch.arange(scores.shape[-2],
                                     device=scores.device)[:, None]
        k_pos = k_off + torch.arange(scores.shape[-1],
                                     device=scores.device)[None, :]
        scores = scores.masked_fill(q_pos < k_pos, float("-inf"))
    return scores


def _block_attention(q, k, v, q_off, k_off, scale, causal, m, l, acc):
    """One streaming-softmax update of (m, l, acc) with a K/V block (the
    JAX package's ``_block_attention``)."""
    scores = _scores(q, k, q_off, k_off, scale, causal)
    new_m = torch.maximum(m, scores.amax(dim=-1))
    safe_m = torch.where(torch.isneginf(new_m), 0.0, new_m)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(torch.isneginf(scores), 0.0, p)
    correction = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
    l = l * correction + p.sum(dim=-1)
    acc = acc * correction[..., None] + torch.matmul(p, v.float())
    return new_m, l, acc


class RingAttention(torch.autograd.Function):
    """The ring's forward and its reverse-ring backward over this rank's
    (batch, heads, seq block, head_dim) blocks."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, scale):
        n, me = axis.size, axis.index
        block = q.shape[2]
        qf = q.float()
        m = torch.full(q.shape[:3], float("-inf"), device=q.device)
        l = torch.zeros(q.shape[:3], device=q.device)
        acc = torch.zeros(q.shape[:3] + (q.shape[3],), device=q.device)
        k_cur, v_cur = k, v
        for hop in range(n):
            src = (me - hop) % n
            m, l, acc = _block_attention(qf, k_cur, v_cur, me * block,
                                         src * block, scale, causal, m, l,
                                         acc)
            if hop < n - 1:
                k_cur, v_cur = ring_shift([k_cur, v_cur], axis, 1)
        l = torch.clamp(l, min=1e-30)
        out = acc / l[..., None]
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (axis, causal, scale)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        axis, causal, scale = ctx.args
        n, me = axis.size, axis.index
        block = q.shape[2]
        qf, do = q.float(), g.float()
        delta = (do * out).sum(dim=-1, keepdim=True)
        safe_m = torch.where(torch.isneginf(m), 0.0, m)[..., None]
        dq = torch.zeros_like(qf)
        # hop n - 1 first: the block of the rank after this one
        k_cur, v_cur = ring_shift([k, v], axis, -1)
        dk = torch.zeros(k.shape, device=k.device)
        dv = torch.zeros(v.shape, device=v.device)
        for hop in reversed(range(n)):
            src = (me - hop) % n
            scores = _scores(qf, k_cur, me * block, src * block, scale,
                             causal)
            p = torch.where(torch.isneginf(scores), 0.0,
                            torch.exp(scores - safe_m)) / l[..., None]
            dv = dv + torch.matmul(p.transpose(-1, -2), do)
            ds = p * (torch.matmul(do, v_cur.float().transpose(-1, -2)) -
                      delta)
            dq = dq + torch.matmul(ds, k_cur.float()) * scale
            dk = dk + torch.matmul(ds.transpose(-1, -2), qf) * scale
            if hop:
                k_cur, v_cur, dk, dv = ring_shift([k_cur, v_cur, dk, dv],
                                                  axis, -1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q, k, v, grid, axis="seq", causal=False, scale=None):
    """Attention of this rank's sequence blocks of ``q``, ``k``, ``v``
    (batch, heads, seq / N, head_dim) over the ``axis`` of ``grid``:
    this rank's block of the output."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return RingAttention.apply(q, k, v, grid.axis(axis), causal, scale)


def ulysses_attention(q, k, v, grid, axis="seq", causal=False, scale=None):
    """Attention of this rank's sequence blocks by the all-to-all
    schedule: heads split over the axis, the sequence gathered, then
    back. Needs the heads to divide the axis."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    seq = grid.axis(axis)
    if q.shape[1] % seq.size:
        raise ValueError(
            "ulysses needs heads (%d) divisible by the %r axis (%d) — "
            "use ring_attention for head counts below the mesh" %
            (q.shape[1], axis, seq.size))

    def to_heads(t):  # (B, H, S/n, D) -> (B, H/n, S, D)
        return AllToAll.apply(t, seq, 1, 2)

    out = local_attention(to_heads(q), to_heads(k), to_heads(v),
                          causal=causal, scale=scale)
    return AllToAll.apply(out, seq, 2, 1)
