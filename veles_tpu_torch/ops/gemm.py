"""GEMM with a selectable accumulation discipline, and the fused linear
layer of fc6 and fc7 (``veles_tpu/ops/gemm.py``).

:func:`gemm` is the cuBLAS-like ``alpha * op(a) @ op(b) + beta * c`` of
the JAX package, at three precision levels:

* 0 -- :func:`_planned_dot`, one float32 ``torch.matmul`` (XLA's dot in
  JAX; the port has no autotuner);
* 1 -- :func:`kahan_matmul`: K summed in blocks joined by Kahan
  compensation. On a CUDA tensor it launches the hand-written kernel
  ``csrc/kahan_gemm.cu`` through :func:`kahan_gemm` (the port of
  ``pallas_kahan_gemm``); on a CPU tensor it runs
  :func:`kahan_matmul_plain`, the port of ``_kahan_matmul_loop``;
* 2 -- :func:`pairwise_matmul`: K split into partials reduced pairwise.

Every float32 product here is full float32 whatever
``torch.backends.cuda.matmul.allow_tf32`` says: :func:`full_float32`
turns TF32 (and bf16 reduced-precision reductions) off around each
library product and restores the switches after.

:func:`linear_act` is the port of ``pallas_gemm(..., bias=...)`` /
``fused_linear`` (``veles_tpu/ops/gemm.py``). ``w`` is stored
``(in, out)`` as in the JAX package. On a CUDA tensor it launches the
hand-written kernel ``csrc/gemm_bias_act.cu`` (see its header for the
bound and the design); on a CPU tensor it runs
:func:`linear_act_plain`, the same function in plain PyTorch. There is
no other route: a CUDA tensor that the kernel does not take raises.

:class:`LinearActFunction` is the differentiable layer, the port of
``fused_linear``'s ``custom_vjp``: forward :func:`linear_act`, residuals
(x, w, y), and a backward that takes the activation's derivative from
the output y (:data:`ACTIVATION_GRADS`), sums the bias gradient with
:func:`veles_tpu_torch.ops.reduce.column_sum` (K6) and leaves the two
products to ``torch.matmul``, as the JAX package leaves them to XLA's
dot.

The five epilogues keep the JAX package's exact constants: LeCun tanh
``1.7159 * tanh(0.6666 x)``, sigmoid, softplus "relu" linear above 15,
strict relu, linear. The product accumulates in float32 from float32
or bfloat16 operands; the bias is float32.
"""

import collections
import contextlib
import ctypes
import threading

import torch
import torch.nn.functional as F

from veles_tpu_torch.nn.activation import ACTIVATIONS
from veles_tpu_torch.ops import build
from veles_tpu_torch.ops.reduce import column_sum, column_sum_plain

#: the kernel's epilogue codes
EPILOGUES = ("linear", "tanh", "sigmoid", "relu", "strict_relu")
_DTYPES = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()
#: the Kahan block depth of ``_kahan_matmul_loop`` and ``_BK``
KAHAN_BK = 512


def epilogue_fn(name):
    """The fusable epilogue activation by name."""
    if name not in EPILOGUES:
        raise ValueError("no fused epilogue for activation %r (have %s)"
                         % (name, sorted(EPILOGUES)))
    return ACTIVATIONS[name]


def fusable_activation(name):
    return name in EPILOGUES


class _FullFloat32(object):
    """The process-wide matmul switches held off while any caller is
    inside :func:`full_float32`, and restored when the last one leaves
    (so concurrent callers cannot restore TF32 under each other)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = None

    @contextlib.contextmanager
    def __call__(self):
        matmul = torch.backends.cuda.matmul
        with self._lock:
            if self._depth == 0:
                self._saved = (matmul.allow_tf32,
                               matmul.allow_bf16_reduced_precision_reduction)
                matmul.allow_tf32 = False
                matmul.allow_bf16_reduced_precision_reduction = False
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    (matmul.allow_tf32,
                     matmul.allow_bf16_reduced_precision_reduction) = \
                        self._saved


#: ``with full_float32():`` -- library products inside run in full
#: float32 and accumulate bf16 in float32
full_float32 = _FullFloat32()


# -- public gemm -------------------------------------------------------------

def gemm(a, b, transpose_a=False, transpose_b=False, alpha=1.0, beta=0.0,
         c=None, precision_level=0, out_dtype=None):
    """cuBLAS-like gemm: ``alpha * op(a) @ op(b) + beta * c``.

    As in the JAX package: the operands are transposed first, the
    product is float32 at every level, ``beta * c`` is added only when
    ``c`` is given and ``beta != 0``, and the result is cast to
    ``out_dtype`` (default: the operands' promoted dtype) last."""
    if transpose_a:
        a = a.t()
    if transpose_b:
        b = b.t()
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    if precision_level <= 0:
        out = _planned_dot(a, b)
    elif precision_level == 1:
        out = kahan_matmul(a, b)
    else:
        out = pairwise_matmul(a, b)
    out = alpha * out
    if c is not None and beta != 0.0:
        out = out + beta * c
    return out.to(out_dtype)


def _planned_dot(a, b):
    """Level 0: one float32 ``torch.matmul`` (bf16 operands widened
    first: their products are exact, so this is JAX's
    ``preferred_element_type=float32`` dot, rounded once)."""
    with full_float32():
        return torch.matmul(a.float(), b.float())


def pairwise_matmul(a, b, parts=None):
    """PRECISION_LEVEL 2: split-K partial products reduced pairwise.

    ``parts`` defaults to the smallest power of two whose square is at
    least K (at most K), halved until it divides K. The tree is JAX's:
    with an odd count the last two partials are added first, then
    adjacent pairs."""
    k = a.shape[-1]
    if parts is None:
        parts = 1
        while parts * parts < k:
            parts *= 2
        parts = min(parts, k)
    while k % parts:
        parts //= 2
    kc = k // parts
    ap = a.float().reshape(a.shape[0], parts, kc)
    bp = b.float().reshape(parts, kc, b.shape[1])
    with full_float32():
        partials = torch.einsum("mpk,pkn->pmn", ap, bp)
    while partials.shape[0] > 1:
        if partials.shape[0] % 2:
            partials = torch.cat([partials[:-2],
                                  (partials[-2] + partials[-1])[None]])
        else:
            partials = partials[0::2] + partials[1::2]
    return partials[0]


def kahan_matmul(a, b, chunk=None):
    """PRECISION_LEVEL 1: K summed in ``chunk``-deep blocks (default
    ``min(512, K)``) joined by Kahan compensation, float32 out.

    A CUDA tensor goes to :func:`kahan_gemm` (the kernel), a CPU tensor
    to :func:`kahan_matmul_plain`. Operands of two dtypes, or of a dtype
    other than float32 and bfloat16, are widened to float32, and each is
    made row-major contiguous (a transposed, strided or broadcast view is
    copied once, O(MK) against the O(MNK) product)."""
    k = a.shape[1]
    chunk = max(1, min(KAHAN_BK, k)) if chunk is None else chunk
    if a.device.type == "cpu":
        return kahan_matmul_plain(a, b, chunk)
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        a, b = a.float(), b.float()
    return kahan_gemm(a.contiguous(), b.contiguous(), bk=chunk)


def kahan_matmul_plain(a, b, chunk=None):
    """The plain PyTorch version: ``_kahan_matmul_loop``. K zero-padded
    to whole ``chunk``s (default ``min(512, K)``), each block's float32
    product joined by ``y = term - comp; t = acc + y; comp = (t - acc) -
    y; acc = t``."""
    m, k = a.shape
    n = b.shape[1]
    if chunk is None:
        chunk = max(1, min(KAHAN_BK, k))
    a32, b32 = a.float(), b.float()
    if k % chunk:
        pad = chunk - k % chunk
        a32 = F.pad(a32, (0, pad))
        b32 = F.pad(b32, (0, 0, 0, pad))
        k += pad
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    comp = torch.zeros_like(acc)
    with full_float32():
        for start in range(0, k, chunk):
            term = torch.matmul(a32[:, start:start + chunk],
                                b32[start:start + chunk])
            y = term - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
    return acc


def kahan_gemm(a, b, bk=KAHAN_BK, out_dtype=torch.float32):
    """``a @ b`` with the K products summed in ``bk``-deep blocks joined
    by Kahan compensation: the counterpart of ``pallas_kahan_gemm``.

    a (M, K) and b (K, N) are row-major contiguous and share dtype
    float32 or bfloat16. Any M, N, K: the last block is ``K mod bk``
    deep. The kernel writes float32; a bfloat16 ``out_dtype`` is a cast
    after it. On a CUDA tensor it launches ``csrc/kahan_gemm.cu`` or
    raises; on a CPU tensor it runs :func:`kahan_matmul_plain`. Counts
    each launch in ``kahan_gemm.launches``, and in
    ``kahan_gemm.launches_by_form`` under ``(M, K, N, dtype, block
    depth)``."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError("kahan_gemm needs a (M, K) and b (K, N), got %s "
                         "and %s" % (tuple(a.shape), tuple(b.shape)))
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError("a and b must share dtype float32 or bfloat16, got "
                        "%s and %s" % (a.dtype, b.dtype))
    if out_dtype not in _DTYPES:
        raise TypeError("out_dtype must be float32 or bfloat16")
    if a.device != b.device:
        raise ValueError("a on %s but b on %s" % (a.device, b.device))
    if int(bk) < 1:
        raise ValueError("kahan_gemm needs bk >= 1, got %r" % (bk,))
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("kahan_gemm needs row-major contiguous a and b, got "
                         "strides %s and %s" % (a.stride(), b.stride()))
    m, k = a.shape
    n = b.shape[1]
    bk = max(1, min(int(bk), k))
    if a.device.type == "cpu":
        return kahan_matmul_plain(a, b, bk).to(out_dtype)
    if a.device.type != "cuda":
        raise ValueError("kahan_gemm runs on cuda or cpu, not %s" % a.device)
    if m > 65535 * 64 or max(m, n, k) >= 2 ** 31:
        raise ValueError("kahan_gemm takes M <= %d and M, N, K < 2^31, got "
                         "%s" % (65535 * 64, (m, k, n)))
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out.to(out_dtype)
    lib = _kahan_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = lib.veles_kahan_gemm(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, bk,
            int(a.dtype == torch.bfloat16), stream)
        with _count_lock:
            kahan_gemm.launches += 1
            kahan_gemm.launches_by_form[(m, k, n, a.dtype, bk)] += 1
    build.check(status, "kahan_gemm")
    return out.to(out_dtype)


kahan_gemm.launches = 0
kahan_gemm.launches_by_form = collections.Counter()


def _kahan_library():
    lib = build.library("kahan_gemm")
    fn = lib.veles_kahan_gemm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 +
                       [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


# -- the fused linear layer --------------------------------------------------

#: each epilogue's derivative as a function of its OUTPUT y
#: (``_EPILOGUE_GRADS``, ``veles_tpu/ops/gemm.py``), so the backward
#: keeps only (x, w, y) and never the pre-activation
ACTIVATION_GRADS = {
    "linear": lambda y: torch.ones_like(y),
    "tanh": lambda y: 1.7159 * 0.6666 * (1.0 - torch.square(y / 1.7159)),
    "sigmoid": lambda y: y * (1.0 - y),
    # y = log1p(e^x) => dy/dx = sigmoid(x) = 1 - e^-y
    "relu": lambda y: 1.0 - torch.exp(-y),
    "strict_relu": lambda y: (y > 0.0).to(y.dtype),
}


def linear_act_plain(x, w, bias=None, activation="linear",
                     out_dtype=None):
    """The plain PyTorch version: float32 product of the (possibly
    bf16) operands, + bias, activation, cast to ``out_dtype``."""
    _check(x, w, bias, activation)
    y = torch.matmul(x.float(), w.float())
    if bias is not None:
        y = y + bias
    return ACTIVATIONS[activation](y).to(out_dtype or x.dtype)


def _check(x, w, bias, activation):
    epilogue_fn(activation)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError("linear_act needs x (M, K) and w (K, N), got %s "
                         "and %s" % (tuple(x.shape), tuple(w.shape)))
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError("x and w must share dtype float32 or bfloat16, "
                        "got %s and %s" % (x.dtype, w.dtype))
    if x.device != w.device:
        raise ValueError("x on %s but w on %s" % (x.device, w.device))
    if bias is not None and (bias.dtype != torch.float32 or
                             tuple(bias.shape) != (w.shape[1],) or
                             bias.device != x.device or
                             not bias.is_contiguous()):
        raise ValueError("bias must be contiguous float32 (%d,) on %s" %
                         (w.shape[1], x.device))


def linear_act(x, w, bias=None, activation="linear", out_dtype=None):
    """``act(x @ w + bias)`` with x (M, K), w (K, N), bias (N,) or None.

    Any M, N, K: the kernel masks ragged edges itself. ``out_dtype``
    defaults to ``x.dtype``. Counts each kernel launch in
    ``linear_act.launches``, and in ``linear_act.launches_by_form`` under
    ``(M, K, N, x.dtype, has_bias)``."""
    _check(x, w, bias, activation)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise TypeError("out_dtype must be float32 or bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("linear_act needs row-major contiguous x and w")
    if x.device.type == "cpu":
        return linear_act_plain(x, w, bias, activation, out_dtype)
    if x.device.type != "cuda":
        raise ValueError("linear_act runs on cuda or cpu, not %s"
                         % x.device)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.veles_gemm_bias_act(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), m, n, k, int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), EPILOGUES.index(activation),
            stream)
        with _count_lock:
            linear_act.launches += 1
            linear_act.launches_by_form[
                (m, k, n, x.dtype, bias is not None)] += 1
    build.check(status, "gemm_bias_act")
    return out


linear_act.launches = 0
linear_act.launches_by_form = collections.Counter()


def _library():
    lib = build.library("gemm_bias_act")
    fn = lib.veles_gemm_bias_act
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


class LinearActFunction(torch.autograd.Function):
    """Differentiable ``act(x @ w + bias)``: forward :func:`linear_act`
    (K1), backward as ``_fused_linear_bwd``:

    * ``dpre = g * act'(y)`` in float32;
    * ``db = column_sum(dpre)`` (K6);
    * ``dx = dpre_c @ w^T`` and ``dw = x^T @ dpre_c`` on ``torch.matmul``,
      with ``dpre_c`` cast to the compute dtype (w's).

    ``plain=True`` runs the plain versions of both kernels."""

    @staticmethod
    def forward(ctx, x, w, bias, activation, out_dtype, plain=False):
        forward = linear_act_plain if plain else linear_act
        y = forward(x, w, bias, activation, out_dtype)
        ctx.save_for_backward(x, w, y)
        ctx.constants = (activation, bias is not None, plain)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        activation, has_bias, plain = ctx.constants
        dpre = g.float() * ACTIVATION_GRADS[activation](y.float())
        db = None
        if has_bias:
            db = (column_sum_plain if plain else column_sum)(
                dpre.contiguous())
        dpre_c = dpre.to(w.dtype)
        dx = torch.matmul(dpre_c, w.t()).to(x.dtype)
        dw = torch.matmul(x.t(), dpre_c).to(w.dtype)
        return dx, dw, db, None, None, None
