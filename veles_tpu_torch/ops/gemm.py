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
hand-written kernel ``csrc/gemm_bias_act.cu`` in the variant
:func:`gemm_plan` picks by shape (see the source's header for each
variant's bound and design); on a CPU tensor it runs
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
import ctypes
import functools
import heapq
import threading

import torch
import torch.nn.functional as F

from veles_tpu_torch.nn.activation import ACTIVATIONS
from veles_tpu_torch.nn.precision import full_float32
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


#: K5's forms (``csrc/kahan_gemm.cu``), by their C codes: the masked SIMT
#: kernel, and the tensor cores by ``wgmma`` (3xTF32 for float32
#: operands, bf16 products for bf16)
KAHAN_FORMS = ("general", "mma")
#: the mma form's output tile, and the K values one wgmma takes by dtype
#: (the depth a Kahan block must be a multiple of, unless it is all of K)
KAHAN_TILE = 128
KAHAN_STEP = {torch.float32: 8, torch.bfloat16: 16}
#: the mma form's model of the H100's time (:func:`_kahan_us`): one block
#: an SM at a time (225 KB of shared memory each), handed out in launch
#: order to the SM that frees first; a block takes :data:`KAHAN_BLOCK_US`
#: plus :data:`KAHAN_ROW_US` (by dtype) for each K row of its 128 x 128
#: tile, fitted to the card's split sweep; the second pass moves the
#: (acc, comp) planes at :data:`PARTIAL_BYTES_PER_US`. Beyond
#: :data:`KAHAN_MAX_WAVES` waves of tiles K is not split.
KAHAN_ROW_US = {torch.float32: 0.071, torch.bfloat16: 0.019}
KAHAN_BLOCK_US = 3.5
KAHAN_MAX_WAVES = 4

#: what :func:`kahan_plan` returns. ``tile`` is (rows, columns) of one
#: block's output; split s covers Kahan blocks ``[s * blocks_per_split,
#: (s + 1) * blocks_per_split)``, K rows ``k_ranges[s]``;
#: ``workspace_bytes`` holds the splits' float32 (acc, comp) planes (0
#: with one split)
KahanPlan = collections.namedtuple(
    "KahanPlan", "form tile splits blocks_per_split k_ranges "
                 "workspace_bytes")


def _kahan_us(m, n, k, bk, dtype, per_split):
    """The mma form's modelled time (us) with ``per_split`` Kahan blocks
    a split."""
    tiles = _cdiv(m, KAHAN_TILE) * _cdiv(n, KAHAN_TILE)
    span = per_split * bk
    splits = _cdiv(k, span)
    free = [0.0] * min(SMS, tiles * splits)
    for s in range(splits):  # blockIdx.z is the slowest launch index
        us = KAHAN_BLOCK_US + (min(k, (s + 1) * span) - s * span) * \
            KAHAN_ROW_US[dtype]
        for _ in range(tiles):
            heapq.heapreplace(free, free[0] + us)
    us = max(free)
    if splits > 1:  # 2 planes a split written and read, the output written
        us += (4 * splits + 1) * 4 * m * n / PARTIAL_BYTES_PER_US
    return us


@functools.lru_cache(maxsize=1024)
def kahan_plan(m, n, k, bk, dtype, aligned=True, splits=None):
    """The form of ``csrc/kahan_gemm.cu`` that computes a (m, k) @ b (k,
    n) of ``dtype`` in ``bk``-deep Kahan blocks (``bk`` is cut to K), with
    its tile, K splits and workspace. ``aligned``: a and b start on 16
    bytes. ``splits``, for tuning sweeps: at most that many splits instead
    of the model's choice (the general form keeps one).

    * ``mma`` where a and b are aligned, N and K are multiples of the
      16-byte chunk (4 float32, 8 bf16) and each block but the last ends
      on a whole wgmma step (:data:`KAHAN_STEP`): 128 x 128 tiles, K split
      over whole Kahan blocks where :func:`_kahan_us` finds it faster
      (fewer splits on a tie; none beyond :data:`KAHAN_MAX_WAVES` waves
      of tiles);
    * ``general`` for everything else (bk below the wgmma depth,
      unaligned rows or pointers, K = 0), in one split.
    """
    if dtype not in _DTYPES:
        raise TypeError("kahan_plan takes float32 or bfloat16, not %s"
                        % (dtype,))
    bk = max(1, min(int(bk), k))
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    blocks = _cdiv(k, bk)
    if (aligned and k > 0 and n % vec == 0 and k % vec == 0 and
            (bk % KAHAN_STEP[dtype] == 0 or bk == k)):
        form, tile = "mma", (KAHAN_TILE, KAHAN_TILE)
        if splits:
            per_split = _cdiv(blocks, min(int(splits), blocks))
        elif (_cdiv(m, KAHAN_TILE) * _cdiv(n, KAHAN_TILE) >
              KAHAN_MAX_WAVES * SMS):
            per_split = blocks
        else:
            per_split = min(
                sorted({_cdiv(blocks, s) for s in range(1, blocks + 1)},
                       reverse=True),
                key=lambda p: _kahan_us(m, n, k, bk, dtype, p))
    else:
        form, tile, per_split = "general", (64, 64), max(1, blocks)
    count = max(1, _cdiv(blocks, per_split))
    span = per_split * bk
    k_ranges = tuple((s * span, min(k, (s + 1) * span))
                     for s in range(count))
    return KahanPlan(form, tile, count, per_split, k_ranges,
                     8 * count * m * n if count > 1 else 0)


def kahan_gemm(a, b, bk=KAHAN_BK, out_dtype=torch.float32, splits=None):
    """``a @ b`` with the K products summed in ``bk``-deep blocks joined
    by Kahan compensation: the counterpart of ``pallas_kahan_gemm``.

    a (M, K) and b (K, N) are row-major contiguous and share dtype
    float32 or bfloat16. Any M, N, K: the last block is ``K mod bk``
    deep. The kernel writes float32; a bfloat16 ``out_dtype`` is a cast
    after it. On a CUDA tensor it launches ``csrc/kahan_gemm.cu`` in the
    form :func:`kahan_plan` picks (``splits`` overrides its split count,
    for tuning sweeps), or raises; on a CPU tensor it runs
    :func:`kahan_matmul_plain`. Counts each launch in
    ``kahan_gemm.launches``, in ``kahan_gemm.launches_by_form`` under
    ``(M, K, N, dtype, block depth)`` and in
    ``kahan_gemm.launches_by_variant`` under the plan's form."""
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
    plan = kahan_plan(m, n, k, bk, a.dtype, _aligned(a, b), splits)
    ws = None
    if plan.workspace_bytes:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                         device=a.device)
    status = build.launch(
        build.function("kahan_gemm", "veles_kahan_gemm", _KAHAN_ARGTYPES),
        a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n, k, bk,
        int(a.dtype == torch.bfloat16), KAHAN_FORMS.index(plan.form),
        plan.splits, plan.blocks_per_split)
    build.check(status, "kahan_gemm")
    with _count_lock:
        kahan_gemm.launches += 1
        kahan_gemm.launches_by_form[(m, k, n, a.dtype, bk)] += 1
        kahan_gemm.launches_by_variant[plan.form] += 1
    return out if out_dtype == torch.float32 else out.to(out_dtype)


kahan_gemm.launches = 0
kahan_gemm.launches_by_form = collections.Counter()
kahan_gemm.launches_by_variant = collections.Counter()
#: ``veles_kahan_gemm``'s C arguments: a, b, out, ws, m, n, k, bk,
#: in_bf16, form, splits, blocks a split, stream
_KAHAN_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
    ctypes.c_void_p]


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


#: the kernel's variants (``csrc/gemm_bias_act.cu``), by their C codes:
#: the three designed forms and the masked kernel for unaligned shapes
FORMS = ("general", "stream", "tiles", "tensor_core")
SMS = build.SMS
#: the stream form: rows per bucket at most (float32, bf16), blocks it
#: aims at (about 4 per SM), the K depth its splits are cut in, and the
#: shared memory that one split's x slab may take
STREAM_MAX_M = {torch.float32: 32, torch.bfloat16: 16}
STREAM_BLOCKS = 4 * SMS
STREAM_SMEM = 96 * 1024
#: the tiles form: 64 rows (m <= 64, or a K of at most
#: :data:`TILE_THIN_K`) or 128 by 128 columns. Its splits minimise a
#: model of the H100's time (``_tile_us``): each SM works through its
#: share of the blocks one after another, a K row of a tile taking
#: :data:`TILE_ROW_US` (fitted to the card's runs: ~65% of the float32
#: peak at 128 rows), a 64-row block alone on its SM
#: :data:`TILE_ALONE` times longer; the second pass moves the partials
#: at :data:`PARTIAL_BYTES_PER_US`. No split shallower than
#: :data:`TILE_MIN_SPLIT_K`, at most :data:`TILE_MAX_SPLITS`.
TILE_BN = 128
TILE_THIN_K = 256
TILE_ROW_US = {64: 0.056, 128: 0.099}
TILE_ALONE = 1.15
PARTIAL_BYTES_PER_US = 3e6
TILE_MIN_SPLIT_K = 128
TILE_MAX_SPLITS = 16
#: the tensor-core form: 128 x 128 tiles, 64-deep TMA stages, one block
#: per SM, at least 4 stages per split
TC_TILE = 128
TC_BK = 64
#: every split but the last covers a multiple of this many K rows
SPLIT_K_STEP = 64

#: what :func:`gemm_plan` returns. ``tile`` is (rows, columns) of one
#: block's output (the stream form: the row bucket by the columns a block
#: streams); split s covers K rows ``k_ranges[s]``; ``workspace_bytes``
#: is the float32 split partials' buffer (0 with one split)
GemmPlan = collections.namedtuple(
    "GemmPlan", "form tile splits kchunk k_ranges workspace_bytes")


def _cdiv(a, b):
    return -(-a // b)


def _split_k(k, want):
    """(splits, kchunk): K cut into at most ``want`` ranges of a multiple
    of :data:`SPLIT_K_STEP` rows each, the last one ragged."""
    kchunk = _cdiv(_cdiv(k, max(1, want)), SPLIT_K_STEP) * SPLIT_K_STEP
    return _cdiv(k, kchunk), kchunk


def _tile_us(m, n, k, rows, splits, kchunk):
    """The tiles form's modelled time (us) with K in ``splits``."""
    blocks = _cdiv(m, rows) * _cdiv(n, TILE_BN) * splits
    row_us = TILE_ROW_US[rows] * (
        TILE_ALONE if rows == 64 and blocks <= SMS else 1.0)
    us = _cdiv(blocks, SMS) * min(kchunk, k) * row_us
    if splits > 1:  # partials written, read back, the output written
        us += (2 * splits + 1) * 4 * m * n / PARTIAL_BYTES_PER_US
    return us


def _tile_split_k(m, n, k, rows):
    """(splits, kchunk) of least :func:`_tile_us`, fewer splits on a
    tie."""
    cuts = {_split_k(k, want) for want in range(
        1, max(1, min(TILE_MAX_SPLITS, k // TILE_MIN_SPLIT_K)) + 1)}
    return min(sorted(cuts),
               key=lambda cut: _tile_us(m, n, k, rows, *cut))


@functools.lru_cache(maxsize=1024)
def gemm_plan(m, n, k, dtype, aligned=True, splits=None):
    """The variant of ``csrc/gemm_bias_act.cu`` that computes
    ``act(x @ w + bias)`` for x (m, k) and w (k, n) of ``dtype``, with its
    tile, K splits and workspace. ``aligned``: the base pointers of x, w
    and the bias are 16 bytes aligned. ``splits``, for tuning sweeps: cut
    K into at most that many ranges instead of the form's own choice
    (the general variant keeps one).

    * ``stream`` for m up to 32 (float32) or 16 (bf16), rows of w 16-byte
      aligned (n a multiple of 4 or 8): K split so that the column blocks
      times the splits make about :data:`STREAM_BLOCKS`, each split's x
      slab within :data:`STREAM_SMEM`;
    * ``tiles`` for larger float32 m, n and k multiples of 4: 64 rows up
      to m = 64 or K = :data:`TILE_THIN_K`, else 128, by 128 columns; K
      split where :func:`_tile_split_k` finds it faster;
    * ``tensor_core`` for larger bf16 m, n and k multiples of 8 (TMA's
      16-byte strides): 128 x 128 tiles, K split when the tiles are fewer
      than the SMs;
    * ``general`` for everything else, in one split.
    """
    if dtype not in _DTYPES:
        raise TypeError("gemm_plan takes float32 or bfloat16, not %s"
                        % (dtype,))
    bf16 = dtype == torch.bfloat16
    vec = 8 if bf16 else 4  # elements in 16 bytes
    wanted, splits, kchunk = splits, 1, k
    if m <= STREAM_MAX_M[dtype]:
        form = "stream" if aligned and n % vec == 0 and k > 0 else "general"
        if form == "stream":
            rows = 1
            while rows < m:
                rows *= 2
            tile = (rows, 32 * vec)
            splits, kchunk = _split_k(
                k, wanted or round(STREAM_BLOCKS / _cdiv(n, tile[1])))
            cap = STREAM_SMEM // (4 * rows) // SPLIT_K_STEP * SPLIT_K_STEP
            if kchunk > cap:
                kchunk = cap
                splits = _cdiv(k, kchunk)
    elif bf16:
        form = ("tensor_core" if aligned and n % 8 == 0 and k % 8 == 0
                and k > 0 else "general")
        if form == "tensor_core":
            tile = (TC_TILE, TC_TILE)
            tiles = _cdiv(m, TC_TILE) * _cdiv(n, TC_TILE)
            splits, kchunk = _split_k(
                k, wanted or min(SMS // tiles, _cdiv(k, TC_BK) // 4))
    else:
        form = ("tiles" if aligned and n % 4 == 0 and k % 4 == 0 and k > 0
                else "general")
        if form == "tiles":
            tile = (64 if m <= 64 or k <= TILE_THIN_K else 128, TILE_BN)
            splits, kchunk = (_split_k(k, wanted) if wanted else
                              _tile_split_k(m, n, k, tile[0]))
    if form == "general":
        tile = (16 if m <= 16 else 64, 32)
    k_ranges = tuple((s * kchunk, min(k, (s + 1) * kchunk))
                     for s in range(splits))
    return GemmPlan(form, tile, splits, kchunk, k_ranges,
                    4 * splits * m * n if splits > 1 else 0)


def _aligned(*tensors):
    """Every tensor given (None skipped) starts on 16 bytes."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def linear_act(x, w, bias=None, activation="linear", out_dtype=None,
               splits=None):
    """``act(x @ w + bias)`` with x (M, K), w (K, N), bias (N,) or None.

    Any M, N, K: :func:`gemm_plan` picks the kernel's variant by shape,
    dtype and alignment, and one C call launches it and, with K split,
    the pass that sums the splits (``splits`` overrides the count, for
    tuning sweeps). ``out_dtype`` defaults to ``x.dtype``.
    Counts each call in ``linear_act.launches``, in
    ``linear_act.launches_by_form`` under ``(M, K, N, x.dtype,
    has_bias)`` and in ``linear_act.launches_by_variant`` under the
    plan's form."""
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
    if m > 65535 * 64 or max(m, n, k) >= 2 ** 31:
        raise ValueError("linear_act takes M <= %d and M, N, K < 2^31, got "
                         "%s" % (65535 * 64, (m, k, n)))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    plan = gemm_plan(m, n, k, x.dtype, _aligned(x, w, bias), splits)
    ws = None
    if plan.workspace_bytes:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                         device=x.device)
    status = build.launch(
        build.function("gemm_bias_act", "veles_gemm_bias_act",
                       _GEMM_ARGTYPES),
        x.device, x.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), m, n, k,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        EPILOGUES.index(activation), FORMS.index(plan.form), plan.tile[0],
        plan.splits, plan.kchunk)
    build.check(status, "gemm_bias_act")
    with _count_lock:
        linear_act.launches += 1
        linear_act.launches_by_form[
            (m, k, n, x.dtype, bias is not None)] += 1
        linear_act.launches_by_variant[plan.form] += 1
    return out


linear_act.launches = 0
linear_act.launches_by_form = collections.Counter()
linear_act.launches_by_variant = collections.Counter()


_GEMM_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
    ctypes.c_void_p]


class LinearActFunction(torch.autograd.Function):
    """Differentiable ``act(x @ w + bias)``: forward :func:`linear_act`
    (K1), backward as ``_fused_linear_bwd``:

    * ``dpre = g * act'(y)`` in float32;
    * ``db = column_sum(dpre)`` (K6);
    * ``dx = dpre_c @ w^T`` and ``dw = x^T @ dpre_c`` on ``torch.matmul``,
      with ``dpre_c`` cast to the compute dtype (w's). The two products
      accumulate in float32 and round once under the switches of
      ``Policy.backends()``, which the trainer holds around each step.

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
