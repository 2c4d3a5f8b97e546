"""Cross-channel LRN over channels-last rows, forward and backward.

:func:`lrn_forward` is the port of ``lrn_fused`` / ``_call_fwd``
(``veles_tpu/ops/lrn.py``):

    y = x * d^-beta,  d = k + alpha * W(x^2)

with W the n-wide channel window (n odd), zero beyond the first and
last channel. :func:`lrn_backward` is the port of ``_call_bwd``:

    dx = g * d^-beta - 2 * alpha * beta * x * W(g * x * d^(-beta-1))

with d recomputed from x. :class:`LRNFunction` ties them together as
``lrn_fused``'s ``custom_vjp`` does: its only residual is x. On a CUDA
tensor each wrapper launches its hand-written kernel
(``csrc/lrn_fwd.cu``, ``csrc/lrn_bwd.cu`` in the form
:func:`lrn_bwd_plan` picks; see their headers for the bounds and the
designs); on a CPU tensor it runs its plain PyTorch version. A CUDA
tensor a kernel does not take raises.

The input must be channels-last and contiguous (NHWC, or any rank with
channels last): the kernel walks (rows, C). PyTorch convolutions yield
NCHW unless the caller keeps ``channels_last`` memory, so the port's
conv module hands NHWC-contiguous tensors on (``nn/conv.py``).
"""

import collections
import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from veles_tpu_torch.ops import build

_DTYPES = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()
#: shared memory a launch may take without opting in to more
_SMEM_LIMIT = 48 * 1024
#: warps of a block in both kernels; each warp of lrn_fwd.cu and of
#: lrn_bwd.cu's general form stages 1 and 2 C-float rows in shared memory
_WARPS = 8
#: channels the shared-memory kernels take
FWD_MAX_CHANNELS = _SMEM_LIMIT // (_WARPS * 4)
GENERAL_MAX_CHANNELS = _SMEM_LIMIT // (_WARPS * 2 * 4)
#: lrn_bwd.cu's forms and the vector form's widest window half (n = 9)
BWD_FORMS = ("vector", "general")
VECTOR_MAX_HALF = 4
#: the vector form's grid cap: 16 blocks of 8 warps an SM (the grid
#: walks row groups grid-stride)
BLOCKS_PER_SM = 16
#: the general form's grid cap (its rows are walked grid-stride)
_MAX_BLOCKS = 1 << 30

LRNPlan = collections.namedtuple(
    "LRNPlan", "form cpt lanes rows_per_warp blocks")


def _check(x, n):
    if n % 2 == 0:
        raise ValueError("the LRN requires an odd window (n=%d)" % n)
    if x.dim() < 2:
        raise ValueError("the LRN needs (..., C), got %s"
                         % (tuple(x.shape),))
    if x.dtype not in _DTYPES:
        raise TypeError("the LRN takes float32 or bfloat16, got %s"
                        % x.dtype)


def _check_layout(x, name):
    if not x.is_contiguous():
        raise ValueError(
            "%s needs channels-last contiguous input (got strides %s for "
            "shape %s): keep convolutions in channels_last memory or "
            "permute to NHWC first" % (name, x.stride(), tuple(x.shape)))


def _window(v, n):
    """W(v): the n-wide channel window sum as n shifted slices of the
    zero-padded last axis."""
    channels = v.shape[-1]
    padded = F.pad(v, (n // 2, n // 2))
    return sum(padded[..., i:i + channels] for i in range(n))


def lrn_forward_plain(x_nhwc, k=2.0, alpha=1e-4, beta=0.75, n=5):
    """The plain PyTorch version: window sum as n shifted slices of the
    zero-padded squares, float32 math, cast back to the input dtype."""
    _check(x_nhwc, n)
    xf = x_nhwc.float()
    return (xf * torch.pow(k + alpha * _window(xf * xf, n), -beta)).to(
        x_nhwc.dtype)


def lrn_forward(x_nhwc, k=2.0, alpha=1e-4, beta=0.75, n=5):
    """LRN over the last axis of a channels-last contiguous tensor.
    Counts each kernel launch in ``lrn_forward.launches``, and in
    ``lrn_forward.launches_by_form`` under ``(shape, dtype)``."""
    _check(x_nhwc, n)
    _check_layout(x_nhwc, "lrn_forward")
    if x_nhwc.device.type == "cpu":
        return lrn_forward_plain(x_nhwc, k, alpha, beta, n)
    if x_nhwc.device.type != "cuda":
        raise ValueError("lrn_forward runs on cuda or cpu, not %s"
                         % x_nhwc.device)
    channels = x_nhwc.shape[-1]
    rows = x_nhwc.numel() // channels if channels else 0
    y = torch.empty_like(x_nhwc)
    if rows == 0 or channels == 0:
        return y
    if channels > FWD_MAX_CHANNELS:
        raise ValueError("lrn_forward's kernel takes at most %d channels, "
                         "got %d" % (FWD_MAX_CHANNELS, channels))
    status = build.launch(
        build.function("lrn_fwd", "veles_lrn_fwd", _FWD_ARGTYPES),
        x_nhwc.device, x_nhwc.data_ptr(), y.data_ptr(), rows, channels,
        float(k), float(alpha), float(beta), n,
        int(abs(beta - 0.75) < 1e-12), int(x_nhwc.dtype == torch.bfloat16))
    build.check(status, "lrn_fwd")
    with _count_lock:
        lrn_forward.launches += 1
        lrn_forward.launches_by_form[
            (tuple(x_nhwc.shape), x_nhwc.dtype)] += 1
    return y


lrn_forward.launches = 0
lrn_forward.launches_by_form = collections.Counter()


_FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                 ctypes.c_int, ctypes.c_float, ctypes.c_float,
                 ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                 ctypes.c_void_p]


def lrn_backward_plain(x_nhwc, g, k=2.0, alpha=1e-4, beta=0.75, n=5):
    """The plain PyTorch version of the backward: the explicit formula
    with d recomputed from x, float32 math, cast back to x's dtype."""
    _check(x_nhwc, n)
    xf, gf = x_nhwc.float(), g.float()
    d = k + alpha * _window(xf * xf, n)
    q = torch.pow(d, -beta)
    u = _window(gf * xf * (q / d), n)
    return (gf * q - (2.0 * alpha * beta) * xf * u).to(x_nhwc.dtype)


@functools.lru_cache(maxsize=256)
def lrn_bwd_plan(rows, channels, n, dtype, aligned=True):
    """How ``csrc/lrn_bwd.cu`` takes (rows, channels) of ``dtype`` with
    window n (``aligned``: x, g and dx start on 16 bytes): an
    :class:`LRNPlan` of

    * ``form``: ``vector`` where channels are a multiple of the 16-byte
      vector (4 float32, 8 bf16), the pointers aligned, a row fits 32
      lanes of ``cpt`` channels and n <= 9; else ``general`` (the
      shared-memory kernel, at most :data:`GENERAL_MAX_CHANNELS`
      channels; more raise);
    * ``cpt``: channels a lane holds (one vector, or two when a row of
      one-vector lanes would be wider than a warp), ``lanes`` lanes a
      row, ``rows_per_warp`` rows a warp (0 in the general form);
    * ``blocks``: the grid, 8 warps a block, each warp walking row groups
      grid-stride."""
    if dtype not in _DTYPES:
        raise TypeError("lrn_bwd_plan takes float32 or bfloat16, got %s"
                        % dtype)
    if n % 2 == 0:
        raise ValueError("the LRN requires an odd window (n=%d)" % n)
    vec = 16 // (4 if dtype == torch.float32 else 2)
    for cpt in (vec, 2 * vec):
        lanes = -(-channels // cpt)
        if lanes <= 32:
            break
    if aligned and channels % vec == 0 and lanes <= 32 and \
            n // 2 <= VECTOR_MAX_HALF:
        per_warp = 32 // lanes
        groups = -(-rows // per_warp)
        blocks = min(-(-groups // _WARPS), build.SMS * BLOCKS_PER_SM)
        return LRNPlan("vector", cpt, lanes, per_warp, max(blocks, 1))
    if channels > GENERAL_MAX_CHANNELS:
        raise ValueError("lrn_backward's kernel takes at most %d channels, "
                         "got %d" % (GENERAL_MAX_CHANNELS, channels))
    return LRNPlan("general", 1, 0, 0,
                   max(1, min(-(-rows // _WARPS), _MAX_BLOCKS)))


def lrn_backward(x_nhwc, g, k=2.0, alpha=1e-4, beta=0.75, n=5):
    """dx of the LRN over the last axis for upstream gradient ``g``;
    x and g channels-last contiguous, of one shape and dtype. Counts
    each kernel launch in ``lrn_backward.launches``, in
    ``lrn_backward.launches_by_form`` under ``(shape, dtype)`` and in
    ``lrn_backward.launches_by_variant`` under the plan's form."""
    _check(x_nhwc, n)
    if g.shape != x_nhwc.shape or g.dtype != x_nhwc.dtype or \
            g.device != x_nhwc.device:
        raise ValueError("lrn_backward needs g like x: got %s %s on %s for "
                         "%s %s on %s" % (tuple(g.shape), g.dtype, g.device,
                                          tuple(x_nhwc.shape), x_nhwc.dtype,
                                          x_nhwc.device))
    _check_layout(x_nhwc, "lrn_backward")
    _check_layout(g, "lrn_backward")
    device = x_nhwc.device
    if device.type == "cpu":
        return lrn_backward_plain(x_nhwc, g, k, alpha, beta, n)
    if device.type != "cuda":
        raise ValueError("lrn_backward runs on cuda or cpu, not %s" % device)
    channels = x_nhwc.shape[-1]
    rows = x_nhwc.numel() // channels if channels else 0
    dx = torch.empty_like(x_nhwc)
    if rows == 0 or channels == 0:
        return dx
    ptrs = (x_nhwc.data_ptr(), g.data_ptr(), dx.data_ptr())
    plan = lrn_bwd_plan(rows, channels, n, x_nhwc.dtype,
                        not any(p % 16 for p in ptrs))
    status = build.launch(
        build.function("lrn_bwd", "veles_lrn_bwd", _BWD_ARGTYPES), device,
        *ptrs, rows, channels, float(k), float(alpha), float(beta), n,
        int(abs(beta - 0.75) < 1e-12), int(x_nhwc.dtype == torch.bfloat16),
        BWD_FORMS.index(plan.form), plan.cpt, plan.lanes,
        plan.rows_per_warp, plan.blocks)
    build.check(status, "lrn_bwd")
    with _count_lock:
        lrn_backward.launches += 1
        lrn_backward.launches_by_form[
            (tuple(x_nhwc.shape), x_nhwc.dtype)] += 1
        lrn_backward.launches_by_variant[plan.form] += 1
    return dx


lrn_backward.launches = 0
lrn_backward.launches_by_form = collections.Counter()
lrn_backward.launches_by_variant = collections.Counter()

_BWD_ARGTYPES = [ctypes.c_void_p] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p]


class LRNFunction(torch.autograd.Function):
    """The differentiable LRN: forward :func:`lrn_forward` (K3), backward
    :func:`lrn_backward` (K4), saving only x, as ``lrn_fused``'s
    ``custom_vjp`` does. ``plain=True`` runs both plain versions."""

    @staticmethod
    def forward(ctx, x_nhwc, k, alpha, beta, n, plain=False):
        ctx.save_for_backward(x_nhwc)
        ctx.constants = (k, alpha, beta, n, plain)
        forward = lrn_forward_plain if plain else lrn_forward
        return forward(x_nhwc, k, alpha, beta, n)

    @staticmethod
    def backward(ctx, g):
        x_nhwc, = ctx.saved_tensors
        k, alpha, beta, n, plain = ctx.constants
        backward = lrn_backward_plain if plain else lrn_backward
        return (backward(x_nhwc, g.contiguous(), k, alpha, beta, n),
                None, None, None, None, None)
