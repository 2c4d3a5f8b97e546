"""The collectives of the SPMD tier, written out.

Where the JAX package's partitioner (or a ``shard_map``) derives a
collective, the port calls it here, over one axis of a
:class:`~veles_tpu_torch.parallel.mesh.RankGrid`: :func:`all_reduce`
(the sum, ``psum``), :func:`all_gather` (concatenated along a
dimension), :func:`all_to_all` (``lax.all_to_all``'s tiled split and
concatenation) and :func:`ring_shift` (``ppermute`` by one step of the
ring, through ``dist.batch_isend_irecv``). Over an axis of one rank each
is the identity and no process group is touched.

gloo runs on CPU tensors; with CUDA tensors (ranks that share a card)
it takes some collectives and refuses others. Those in
:data:`GLOO_CUDA_STAGED` are staged through the host: the tensor is
copied to the CPU, the collective runs there and the result is copied
back; compute never leaves the card. Each staged collective is logged
once and counted in :data:`staged`, which the callers print.

The collectives that carry a gradient are autograd Functions whose
backward is the forward's transpose under one convention, Megatron's:
a value every rank of the axis holds whole has the same cotangent on
every rank (the ranks compute the same loss). So

* :class:`ReduceFromAxis` (``psum``): forward the all_reduce, backward
  the identity;
* :class:`CopyToAxis`: forward the identity, backward the all_reduce --
  a whole value entering work that each rank does on its own part (a
  column layer), whose input cotangents are partial;
* :class:`GatherFromAxis`: forward the all_gather, backward this rank's
  slice of the cotangent (the reduce_scatter of the N equal cotangents
  would be N times it);
* :class:`ScatterToAxis`: forward this rank's slice, backward the
  all_gather;
* :class:`AllToAll`: forward the all_to_all, backward the inverse
  all_to_all.
"""

import collections
import logging

import torch
import torch.distributed as dist

_log = logging.getLogger("collectives")

#: the collectives gloo is not handed CUDA tensors for: staged through
#: the host. gloo's point-to-point send and recv fail on a device
#: pointer ("writev ... Bad address", torch 2.11 on an H100; its
#: all_reduce, broadcast, all_gather, all_to_all_single and
#: reduce_scatter take CUDA tensors: ``scripts/probe_gloo_cuda.py``)
GLOO_CUDA_STAGED = frozenset(("ring_shift",))

#: staged calls by collective, and calls and bytes sent by collective
staged = collections.Counter()
calls = collections.Counter()
sent_bytes = collections.Counter()


def _nbytes(t):
    return t.numel() * t.element_size()


def _stage(axis, op, t):
    """True when ``op`` on ``t`` over ``axis`` goes through the host."""
    if axis.backend != "gloo" or not t.is_cuda or op not in GLOO_CUDA_STAGED:
        return False
    if not staged[op]:
        _log.info("gloo takes no CUDA tensor for %s: staged through the "
                  "host", op)
    staged[op] += 1
    return True


def reset_counts():
    for counter in (staged, calls, sent_bytes):
        counter.clear()


def all_reduce(t, axis):
    """Sum ``t`` over ``axis`` in place; returns it."""
    if axis.size == 1:
        return t
    calls["all_reduce"] += 1
    sent_bytes["all_reduce"] += _nbytes(t)
    if _stage(axis, "all_reduce", t):
        host = t.cpu()
        dist.all_reduce(host, group=axis.group)
        return t.copy_(host)
    dist.all_reduce(t, group=axis.group)
    return t


def all_gather(t, axis, dim=0):
    """Every rank's ``t`` concatenated along ``dim`` in axis order."""
    if axis.size == 1:
        return t
    calls["all_gather"] += 1
    sent_bytes["all_gather"] += _nbytes(t)
    src = t.contiguous()
    if _stage(axis, "all_gather", src):
        host = src.cpu()
        parts = [torch.empty_like(host) for _ in range(axis.size)]
        dist.all_gather(parts, host, group=axis.group)
        return torch.cat(parts, dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim)


def all_to_all(t, axis, split_dim, concat_dim):
    """``lax.all_to_all(t, axis, split_dim, concat_dim, tiled=True)``:
    ``t`` cut in ``size`` equal parts along ``split_dim``, part j sent to
    the rank at index j, and the parts received concatenated along
    ``concat_dim`` in the senders' order."""
    n = axis.size
    if n == 1:
        return t
    if t.shape[split_dim] % n:
        raise ValueError("dimension %d of %s does not divide over the %r "
                         "axis (%d)" % (split_dim, tuple(t.shape), axis.name,
                                        n))
    calls["all_to_all"] += 1
    sent_bytes["all_to_all"] += _nbytes(t)
    send = torch.stack(t.chunk(n, split_dim))
    if _stage(axis, "all_to_all", send):
        host = send.cpu()
        recv = torch.empty_like(host)
        dist.all_to_all_single(recv, host, group=axis.group)
        recv = recv.to(t.device)
    else:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=axis.group)
    return torch.cat(recv.unbind(0), concat_dim)


def ring_shift(tensors, axis, shift=1):
    """``ppermute`` of each tensor by ``shift`` along the ring of
    ``axis``: the rank at index i sends to i + shift and receives from
    i - shift. Returns the received tensors."""
    n = axis.size
    if n == 1 or shift % n == 0:
        return list(tensors)
    calls["ring_shift"] += 1
    sent_bytes["ring_shift"] += sum(_nbytes(t) for t in tensors)
    dst = axis.ranks[(axis.index + shift) % n]
    src = axis.ranks[(axis.index - shift) % n]
    host = _stage(axis, "ring_shift", tensors[0])
    sends = [t.contiguous().cpu() if host else t.contiguous()
             for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, dst, axis.group))
        ops.append(dist.P2POp(dist.irecv, r, src, axis.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if host:
        return [r.to(t.device) for r, t in zip(recvs, tensors)]
    return recvs


def local_part(t, axis, dim):
    """This rank's part of ``t`` cut in ``size`` equal parts along
    ``dim``."""
    if axis.size == 1:
        return t
    part = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * part, part)


class ReduceFromAxis(torch.autograd.Function):
    """``psum``: forward the all_reduce, backward the identity."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class CopyToAxis(torch.autograd.Function):
    """Forward the identity, backward the all_reduce of the partial
    cotangents (``reduce=False``, a control: this rank's own)."""

    @staticmethod
    def forward(ctx, x, axis, reduce=True):
        ctx.axis, ctx.reduce = axis, reduce
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if not ctx.reduce:
            return g, None, None
        return all_reduce(g.clone(), ctx.axis), None, None


class GatherFromAxis(torch.autograd.Function):
    """Forward the all_gather along ``dim``, backward this rank's slice
    of the cotangent."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return local_part(g, ctx.axis, ctx.dim).contiguous(), None, None


class ScatterToAxis(torch.autograd.Function):
    """Forward this rank's part along ``dim``, backward the all_gather
    (``gather=False``, a control: this rank's part in zeros)."""

    @staticmethod
    def forward(ctx, x, axis, dim, gather=True):
        ctx.args = (axis, dim, gather, x.shape)
        return local_part(x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        axis, dim, gather, shape = ctx.args
        if gather:
            return all_gather(g, axis, dim), None, None, None
        whole = g.new_zeros(shape)
        local_part(whole, axis, dim).copy_(g)
        return whole, None, None, None


class AllToAll(torch.autograd.Function):
    """Forward :func:`all_to_all`, backward the inverse all_to_all."""

    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return all_to_all(g, axis, concat_dim, split_dim), None, None, None
