"""Moves between tensor layouts, measured (``veles_tpu/parallel/
reshard.py``).

The one seam every layout move of the SPMD tier goes through, so each
shows up in ``veles_reshard_ms{src,dst}`` (and a ``reshard`` span)
instead of hiding in the code that called it:

* host -> ranks: each rank copies only its own block of the host value
  (:meth:`~veles_tpu_torch.parallel.mesh.Sharding.local_slice`) to its
  device -- the per-run parameter placement, the row-sharded dataset,
  streamed shards (:func:`veles_tpu_torch.loader.prefetch.
  sharded_placer`);
* split -> replicated: the all_gather along each split dimension
  (train -> serve: model-axis shards gathered whole before snapshots and
  the model store read them);
* replicated -> split: this rank's slice, no communication;
* host -> one device (:func:`host_placer`, the offloaded model state's
  uploads) and any layout -> host (:func:`gather_to_host`).

Labels are layouts, not grids, as in the JAX package: ``replicated``,
``P(batch)``, ``P(_,model)``, ``host`` (on no device yet) and
``committed`` (one device, no named placement): bounded however many
grid shapes a run moves between.
"""

import time

import numpy
import torch

from veles_tpu_torch.parallel import collectives
from veles_tpu_torch.parallel.mesh import Sharding
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.telemetry.registry import get_registry


def reshard_histogram():
    return get_registry().histogram(
        "veles_reshard_ms",
        "Array redistribution time between device layouts",
        labels=("src", "dst"))


def layout_label(layout):
    """The bounded label of a :class:`Sharding`, ``None`` (a host value)
    or a device tensor (``committed``)."""
    if isinstance(layout, Sharding):
        parts = ["_" if s is None else s for s in layout.spec]
        while parts and parts[-1] == "_":
            parts.pop()
        return "P(%s)" % ",".join(parts) if parts else "replicated"
    if isinstance(layout, torch.Tensor) and layout.device.type != "cpu":
        return "committed"
    return "host"


def _observe(src, dst, t0):
    elapsed = time.perf_counter() - t0
    reshard_histogram().labels(src=src, dst=dst).observe(elapsed * 1e3)
    tracing.add_complete("reshard", t0, elapsed, src=src, dst=dst)


def reshard(value, sharding, src=None, *, block=False, pad=False):
    """``value`` moved to ``sharding``: a host value (numpy or a CPU
    tensor, ``src`` None) lands as this rank's block on the grid's
    device; a device tensor in layout ``src`` (a :class:`Sharding` of
    the same grid) moves there (:func:`_move`). ``block`` waits for the device (the honest
    time of a one-off move); otherwise the time is the dispatch's.
    ``pad``: a host value's split dimensions need not divide (the short
    blocks are padded with zero rows)."""
    grid = sharding.grid
    host = src is None
    if not host and src == sharding:
        return value
    src_label = "host" if host else layout_label(src)
    t0 = time.perf_counter()
    if host:
        out = sharding.local_slice(torch.as_tensor(numpy.asarray(value))
                                   if not isinstance(value, torch.Tensor)
                                   else value, pad=pad)
        out = out.to(grid.device, non_blocking=out.is_pinned(),
                     copy=True).contiguous()
    else:
        out = _move(value, src, sharding)
    if block and out.is_cuda:
        torch.cuda.synchronize(out.device)
    _observe(src_label, layout_label(sharding), t0)
    return out


def _move(value, src, dst):
    """``value`` from layout ``src`` to ``dst`` of one grid: gathered
    along the dimensions ``src`` splits and ``dst`` does not, then
    sliced along those ``dst`` splits and ``src`` does not."""
    grid = dst.grid
    dims = max(len(src.spec), len(dst.spec))
    have = list(src.spec) + [None] * (dims - len(src.spec))
    want = list(dst.spec) + [None] * (dims - len(dst.spec))
    for d in range(dims):
        if have[d] is not None and have[d] != want[d]:
            value = collectives.all_gather(value, grid.axis(have[d]), d)
    for d in range(dims):
        if want[d] is not None and have[d] != want[d]:
            value = collectives.local_part(value, grid.axis(want[d]),
                                           d).contiguous()
    return value


def reshard_tree(tree, shardings, srcs=None, *, block=False):
    """:func:`reshard` of every tensor of a list of dicts; ``shardings``
    (and ``srcs``) one :class:`Sharding` for all, or a matching list of
    dicts."""
    def pick(spec, i, k):
        if spec is None or isinstance(spec, Sharding):
            return spec
        return spec[i][k]
    return [{k: reshard(v, pick(shardings, i, k), pick(srcs, i, k),
                        block=block) for k, v in layer.items()}
            for i, layer in enumerate(tree)]


def host_placer(ring):
    """``place(host_tree, after=())`` through the staging ``ring``,
    measured as ``veles_reshard_ms{src="host", dst="committed"}``: the
    uploads of the offloaded model state (``train/offload.py``)."""

    def place(host_tree, after=()):
        t0 = time.perf_counter()
        out = ring.place(host_tree, after=after)
        _observe("host", "committed", t0)
        return out
    return place


def gather_to_host(value, src=None):
    """Any layout -> the whole value as a CPU tensor (the all_gather
    along ``src``'s split dimensions, then device -> host), measured
    under ``dst="host"``."""
    t0 = time.perf_counter()
    label = layout_label(value if src is None else src)
    if src is not None:
        value = _move(value, src, Sharding(src.grid, ()))
    out = value.detach().cpu()
    _observe(label, "host", t0)
    return out
