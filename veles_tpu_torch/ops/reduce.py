"""Matrix reductions (``veles_tpu/ops/reduce.py``).

:func:`matrix_reduce` reduces a matrix along an axis with a named op
(``sum``, ``max``, ``min``, ``mean``, ``argmax``, ``l2``) in float32;
the JAX package leaves these to XLA, the port to torch's reductions.

:func:`column_sum` computes the bias gradients of the training step. It
is the port of ``pallas_column_reduce``
(``veles_tpu/ops/reduce.py``): x (R, C), float32 or bfloat16, summed
over its rows into a float32 (C,) vector. On a CUDA tensor it launches
``csrc/column_reduce.cu`` in the form :func:`column_plan` picks by
shape (one launch, no float atomics, so a repeat gives the same bits;
see the source's header for the bound and the design), through the
CPython binding ``csrc/column_reduce_binding.cpp``, which allocates the
output and launches in one call; on a CPU tensor it runs
:func:`column_sum_plain`. A CUDA tensor the kernel does not take
raises.
"""

import collections
import functools
import threading

import torch

from veles_tpu_torch.ops import build

_DTYPES = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()

#: the kernel's forms
COLUMN_FORMS = ("single", "chunked")
#: threads of a block
COLUMN_THREADS = 256
#: rows up to which one block per column tile sums every row
SINGLE_MAX_ROWS = 1024
#: the single form's column tile, in vectors: narrow, so the fc and head
#: rows spread over many blocks
SINGLE_TILE = 8
#: the chunked form's widest column tile (one warp of vectors), and the
#: blocks it aims for: two per SM, each streaming with 8 loads in flight
#: per thread, so the last block of a tile has few partials to add
CHUNK_TILE = 32
CHUNK_BLOCKS = 2 * build.SMS
#: rows a row slot takes at least in a chunk
MIN_SLOT_ROWS = 8

ColumnPlan = collections.namedtuple(
    "ColumnPlan", "form vec tile tiles chunks chunk_rows workspace_bytes")

_OPS = {
    "sum": lambda x, axis: torch.sum(x, axis),
    "max": lambda x, axis: torch.amax(x, axis),
    "min": lambda x, axis: torch.amin(x, axis),
    "mean": lambda x, axis: torch.mean(x, axis),
    "argmax": lambda x, axis: torch.argmax(x, axis),
    "l2": lambda x, axis: torch.sqrt(torch.sum(torch.square(x), axis)),
}


def matrix_reduce(x, op="sum", axis=0):
    """Reduce a matrix along ``axis`` with ``op`` (float32 accumulation;
    ``argmax`` gives int64 indices of ``x`` as it is)."""
    try:
        fn = _OPS[op]
    except KeyError:
        raise ValueError("unknown reduction %r (have %s)" % (op, sorted(_OPS)))
    return fn(x if op == "argmax" else x.float(), axis)


def _check(x):
    if x.dim() != 2:
        raise ValueError("column_sum needs x (R, C), got %s"
                         % (tuple(x.shape),))
    if x.dtype not in _DTYPES:
        raise TypeError("column_sum takes float32 or bfloat16, got %s"
                        % x.dtype)


def column_sum_plain(x):
    """The plain PyTorch version: a float32 sum over the rows."""
    _check(x)
    return x.float().sum(0)


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def column_plan(rows, cols, dtype, aligned=True):
    """How ``csrc/column_reduce.cu`` sums an (rows, cols) x of ``dtype``
    (``aligned``: x starts on 16 bytes): a :class:`ColumnPlan` of

    * ``form``: ``single`` for ``rows <= SINGLE_MAX_ROWS`` (a block per
      column tile sums every row and writes out), else ``chunked`` (a
      block per column tile and row chunk writes a float32 partial row;
      the last block of a tile adds the partials in order);
    * ``vec``: columns a thread loads at once, 16 bytes where ``cols``
      and the pointer allow it, else 1;
    * ``tile``: vectors of a column tile, ``tiles`` of them;
    * ``chunks`` and ``chunk_rows``: the row ranges (1 and ``rows`` in
      the single form);
    * ``workspace_bytes``: the chunked form's ``chunks * cols`` float32
      partials; 0 in the single form. Its tickets, one a column tile,
      live in a buffer kept per card and stream.

    Depends on the shape alone, so every call at a shape sums in one
    order."""
    if dtype not in _DTYPES:
        raise TypeError("column_plan takes float32 or bfloat16, got %s"
                        % dtype)
    if rows <= 0 or cols <= 0:
        raise ValueError("column_plan needs rows, cols > 0, got %s"
                         % ((rows, cols),))
    wide = 16 // (4 if dtype == torch.float32 else 2)
    vec = wide if aligned and cols % wide == 0 else 1
    vectors = cols // vec
    if rows <= SINGLE_MAX_ROWS:
        tile = min(vectors, SINGLE_TILE)
        return ColumnPlan("single", vec, tile, _cdiv(vectors, tile), 1,
                          rows, 0)
    tile = min(vectors, CHUNK_TILE)
    tiles = _cdiv(vectors, tile)
    slots = COLUMN_THREADS // tile
    chunks = max(2, min(_cdiv(CHUNK_BLOCKS, tiles),
                        rows // (slots * MIN_SLOT_ROWS)))
    chunk_rows = _cdiv(rows, chunks)
    chunks = _cdiv(rows, chunk_rows)
    return ColumnPlan("chunked", vec, tile, tiles, chunks, chunk_rows,
                      4 * chunks * cols)


def column_sum(x):
    """float32 (C,) column sums of a row-major (R, C) ``x``. Counts each
    kernel launch in ``column_sum.launches``, in
    ``column_sum.launches_by_form`` under ``(R, C, dtype)`` and in
    ``column_sum.launches_by_variant`` under the plan's form."""
    _check(x)
    if not x.is_contiguous():
        raise ValueError("column_sum needs a row-major contiguous x (got "
                         "strides %s for shape %s)" % (x.stride(),
                                                       tuple(x.shape)))
    device = x.device
    if device.type == "cpu":
        return column_sum_plain(x)
    if device.type != "cuda":
        raise ValueError("column_sum runs on cuda or cpu, not %s" % device)
    rows, cols = x.shape
    if rows == 0 or cols == 0:
        return torch.zeros(cols, dtype=torch.float32, device=device)
    plan = column_plan(rows, cols, x.dtype, x.data_ptr() % 16 == 0)
    tickets = None
    if plan.form == "chunked":
        tickets = _tickets(device, plan.tiles).data_ptr()
    # the binding allocates out (and the partials) and launches: one C
    # call, no ctypes conversions and no torch.empty from Python
    out = build.launch(
        build.binding("column_reduce", "veles_column_reduce").column_sum,
        device, x, tickets, int(x.dtype == torch.bfloat16), plan.vec,
        plan.tile, plan.chunks, plan.chunk_rows)
    with _count_lock:
        column_sum.launches += 1
        column_sum.launches_by_form[(rows, cols, x.dtype)] += 1
        column_sum.launches_by_variant[plan.form] += 1
    return out


column_sum.launches = 0
column_sum.launches_by_form = collections.Counter()
column_sum.launches_by_variant = collections.Counter()

#: {(card, raw stream): int32 tickets of the chunked form}, zeroed once:
#: each call's last blocks set their tickets back to 0, calls on one
#: stream run in order, and calls on two streams never share tickets
_ticket_buffers = {}


def _tickets(device, tiles):
    key = build.stream(device)
    tickets = _ticket_buffers.get(key)
    if tickets is None or tickets.numel() < tiles:
        tickets = _ticket_buffers[key] = torch.zeros(
            max(tiles, 64), dtype=torch.int32, device=device)
    return tickets
