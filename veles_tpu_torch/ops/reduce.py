"""Matrix reductions (``veles_tpu/ops/reduce.py``).

:func:`matrix_reduce` reduces a matrix along an axis with a named op
(``sum``, ``max``, ``min``, ``mean``, ``argmax``, ``l2``) in float32;
the JAX package leaves these to XLA, the port to torch's reductions.

:func:`column_sum` computes the bias gradients of the training step. It
is the port of ``pallas_column_reduce``
(``veles_tpu/ops/reduce.py``): x (R, C), float32 or bfloat16, summed
over its rows into a float32 (C,) vector. On a CUDA tensor it launches
``csrc/column_reduce.cu`` (two passes, no float atomics, so a repeat
gives the same bits; see its header for the bound); on a CPU tensor it
runs :func:`column_sum_plain`. A CUDA tensor the kernel does not take
raises.
"""

import collections
import ctypes
import threading

import torch

from veles_tpu_torch.ops import build

_DTYPES = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()

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


def column_sum(x):
    """float32 (C,) column sums of a row-major (R, C) ``x``. Counts each
    kernel call in ``column_sum.launches``, and in
    ``column_sum.launches_by_form`` under ``(R, C, dtype)``."""
    _check(x)
    if not x.is_contiguous():
        raise ValueError("column_sum needs a row-major contiguous x (got "
                         "strides %s for shape %s)" % (x.stride(),
                                                       tuple(x.shape)))
    if x.device.type == "cpu":
        return column_sum_plain(x)
    if x.device.type != "cuda":
        raise ValueError("column_sum runs on cuda or cpu, not %s" % x.device)
    rows, cols = x.shape
    if rows == 0 or cols == 0:
        return torch.zeros(cols, dtype=torch.float32, device=x.device)
    lib = _library()
    out = torch.empty(cols, dtype=torch.float32, device=x.device)
    partial = torch.empty(lib.veles_column_reduce_chunks(rows, cols) * cols,
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.veles_column_reduce(
            x.data_ptr(), partial.data_ptr(), out.data_ptr(), rows, cols,
            int(x.dtype == torch.bfloat16), stream)
        with _count_lock:
            column_sum.launches += 1
            column_sum.launches_by_form[(rows, cols, x.dtype)] += 1
    build.check(status, "column_reduce")
    return out


column_sum.launches = 0
column_sum.launches_by_form = collections.Counter()


def _library():
    lib = build.library("column_reduce")
    fn = lib.veles_column_reduce
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        chunks = lib.veles_column_reduce_chunks
        chunks.argtypes = [ctypes.c_longlong, ctypes.c_int]
        chunks.restype = ctypes.c_int
    return lib
