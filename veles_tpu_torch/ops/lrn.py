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
(``csrc/lrn_fwd.cu``, ``csrc/lrn_bwd.cu``, in the form
:func:`lrn_fwd_plan` or :func:`lrn_bwd_plan` picks; see their headers
for the bounds and the designs), the forward through its CPython
binding (``csrc/lrn_fwd_binding.cpp``), which allocates y and launches
in one C call; on a CPU tensor it runs its plain PyTorch version. A
CUDA tensor a kernel does not take raises.

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
#: warps of a block in both kernels; each warp of the general forms of
#: lrn_fwd.cu and lrn_bwd.cu stages 1 and 2 C-float rows in shared memory
_WARPS = 8
#: channels the shared-memory (general) forms take
FWD_MAX_CHANNELS = _SMEM_LIMIT // (_WARPS * 4)
GENERAL_MAX_CHANNELS = _SMEM_LIMIT // (_WARPS * 2 * 4)
#: both kernels' forms (the C functions' form argument is the index) and
#: the vector forms' widest window half (n = 9)
FORMS = ("vector", "general")
VECTOR_MAX_HALF = 4
#: the vector forms' grid cap: 16 blocks of 8 warps an SM (the grid
#: walks row groups grid-stride)
BLOCKS_PER_SM = 16
#: channels a lane of lrn_fwd.cu's vector form may hold, the instances
#: the kernel has: whole 16-byte vectors
FWD_CPTS = {torch.float32: (4, 8, 12, 16, 24), torch.bfloat16: (8, 16, 24)}
#: the bytes a forward lane holds where a row allows: two vectors
FWD_LANE_BYTES = 32
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


def _vec(dtype):
    """Values of ``dtype`` in a 16-byte vector."""
    return 16 // (4 if dtype == torch.float32 else 2)


def _check_plan(dtype, n, name):
    if dtype not in _DTYPES:
        raise TypeError("%s takes float32 or bfloat16, got %s"
                        % (name, dtype))
    if n % 2 == 0:
        raise ValueError("the LRN requires an odd window (n=%d)" % n)


def vector_plan(rows, channels, n, dtype, aligned, cpt, blocks_per_sm):
    """The vector form's :class:`LRNPlan` at ``cpt`` channels a lane and
    a grid of at most ``blocks_per_sm`` blocks an SM, or None where the
    form does not take the shape: channels not a multiple of the 16-byte
    vector, a pointer off 16 bytes (``aligned`` false), a row wider than
    32 lanes of ``cpt`` or n > 9. The geometry of both kernels."""
    lanes = -(-channels // cpt)
    if not aligned or channels % _vec(dtype) or lanes > 32 or \
            n // 2 > VECTOR_MAX_HALF:
        return None
    per_warp = 32 // lanes
    groups = -(-rows // per_warp)
    blocks = min(-(-groups // _WARPS), build.SMS * blocks_per_sm)
    return LRNPlan("vector", cpt, lanes, per_warp, max(blocks, 1))


def _general_plan(rows, channels, limit, name):
    if channels > limit:
        raise ValueError("%s's kernel takes at most %d channels, got %d"
                         % (name, limit, channels))
    return LRNPlan("general", 1, 0, 0,
                   max(1, min(-(-rows // _WARPS), _MAX_BLOCKS)))


def _fwd_cpt(channels, dtype):
    """The forward's channels a lane: of :data:`FWD_CPTS` whose row fits
    32 lanes, the one holding at most :data:`FWD_LANE_BYTES` (else the
    fewest bytes), then whose rows fill the most of the warp's lane
    slots, then the most channels."""
    size = 16 // _vec(dtype)

    def key(cpt):
        lanes = -(-channels // cpt)
        fill = channels * (32 // lanes) / (32.0 * cpt) if lanes <= 32 \
            else 0.0
        return (lanes <= 32, -max(cpt * size, FWD_LANE_BYTES), fill, cpt)
    return max(FWD_CPTS[dtype], key=key)


@functools.lru_cache(maxsize=256)
def lrn_fwd_plan(rows, channels, n, dtype, aligned=True):
    """How ``csrc/lrn_fwd.cu`` takes (rows, channels) of ``dtype`` with
    window n (``aligned``: x and y start on 16 bytes): an
    :class:`LRNPlan` of

    * ``form``: ``vector`` where :func:`vector_plan` takes the shape at
      some cpt of :data:`FWD_CPTS`; else ``general`` (the shared-memory
      kernel, at most :data:`FWD_MAX_CHANNELS` channels; more raise);
    * ``cpt``: channels a lane (:func:`_fwd_cpt`: two 16-byte vectors
      where a row allows, C = 96: 8 float32 on 12 lanes, 2 rows a warp,
      16 bf16 on 6 lanes, 5 rows; C = 256: 8 float32 on 32 lanes, 16
      bf16 on 16), ``lanes`` lanes a row, ``rows_per_warp`` rows a warp
      (0 in the general form);
    * ``blocks``: the grid, 8 warps a block, at most
      :data:`BLOCKS_PER_SM` an SM, each warp walking row groups
      grid-stride."""
    _check_plan(dtype, n, "lrn_fwd_plan")
    plan = vector_plan(rows, channels, n, dtype, aligned,
                       _fwd_cpt(channels, dtype), BLOCKS_PER_SM)
    return plan or _general_plan(rows, channels, FWD_MAX_CHANNELS,
                                 "lrn_forward")


def lrn_forward(x_nhwc, k=2.0, alpha=1e-4, beta=0.75, n=5):
    """LRN over the last axis of a channels-last contiguous tensor.
    Counts each kernel launch in ``lrn_forward.launches``, in
    ``lrn_forward.launches_by_form`` under ``(shape, dtype)`` and in
    ``lrn_forward.launches_by_variant`` under the plan's form."""
    _check(x_nhwc, n)
    _check_layout(x_nhwc, "lrn_forward")
    # each tensor attribute is read once: a small serving batch's call
    # is host time
    device = x_nhwc.device
    kind = device.type
    if kind == "cpu":
        return lrn_forward_plain(x_nhwc, k, alpha, beta, n)
    if kind != "cuda":
        raise ValueError("lrn_forward runs on cuda or cpu, not %s" % device)
    shape, dtype = x_nhwc.shape, x_nhwc.dtype
    channels = shape[-1]
    rows = x_nhwc.numel() // channels if channels else 0
    if rows == 0 or channels == 0:
        return torch.empty_like(x_nhwc)
    # the binding allocates y (on 512 bytes, the caching allocator's
    # alignment: only x's pointer can be off 16) and launches: one C call
    plan = lrn_fwd_plan(rows, channels, n, dtype,
                        x_nhwc.data_ptr() % 16 == 0)
    y = build.launch(
        build.binding("lrn_fwd", "veles_lrn_fwd").forward, device, x_nhwc,
        k, alpha, beta, n, abs(beta - 0.75) < 1e-12, FORMS.index(plan.form),
        plan.cpt, plan.lanes, plan.rows_per_warp, plan.blocks)
    with _count_lock:
        lrn_forward.launches += 1
        lrn_forward.launches_by_form[(tuple(shape), dtype)] += 1
        lrn_forward.launches_by_variant[plan.form] += 1
    return y


lrn_forward.launches = 0
lrn_forward.launches_by_form = collections.Counter()
lrn_forward.launches_by_variant = collections.Counter()


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

    * ``form``: ``vector`` where :func:`vector_plan` takes the shape;
      else ``general`` (the shared-memory kernel, at most
      :data:`GENERAL_MAX_CHANNELS` channels; more raise);
    * ``cpt``: channels a lane holds (one vector, or two when a row of
      one-vector lanes would be wider than a warp), ``lanes`` lanes a
      row, ``rows_per_warp`` rows a warp (0 in the general form);
    * ``blocks``: the grid, 8 warps a block, at most
      :data:`BLOCKS_PER_SM` an SM, each warp walking row groups
      grid-stride."""
    _check_plan(dtype, n, "lrn_bwd_plan")
    vec = _vec(dtype)
    cpt = vec if channels <= 32 * vec else 2 * vec
    plan = vector_plan(rows, channels, n, dtype, aligned, cpt,
                       BLOCKS_PER_SM)
    return plan or _general_plan(rows, channels, GENERAL_MAX_CHANNELS,
                                 "lrn_backward")


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
        FORMS.index(plan.form), plan.cpt, plan.lanes,
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
