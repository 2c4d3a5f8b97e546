"""The port's fused linear layer (``veles_tpu_torch.ops.gemm``) against
the JAX package's ``pallas_gemm`` and its XLA chain.

On the CPU the port's ``linear_act`` runs its plain PyTorch version;
the JAX side runs the Pallas kernel in interpret mode (tileable shapes)
or its XLA fallback (ragged M). The same numpy inputs, from a seed, go
through both.

Tolerance: both sides accumulate the K products in float32, in
different orders. With K = 64 and unit-scale inputs the sums are O(1)
and reordering moves them by a few float32 ulps, so atol = rtol = 1e-5
(~100 ulp at 1.0) holds with margin and still catches any wrong
epilogue constant (the smallest, 0.6666 vs 2/3, moves results ~1e-4).
The backward (``LinearActFunction`` against ``jax.vjp`` of
``fused_linear``) sums over M = 16 or N = 32 products of the same
scale: the same 1e-5. With bf16 operands both sides round dpre and the
products' results to bf16 at the same points, but a float32 sum that
lands on the other side of a rounding tie moves one value by a bf16 ulp
(2^-8 relative): atol = rtol = 1e-2 there.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.nn.activation import get_activation  # noqa: E402
from veles_tpu.ops.gemm import (_DS, _kahan_matmul_loop,  # noqa: E402
                                fused_linear, pallas_gemm)
from veles_tpu_torch.nn.activation import ACTIVATIONS  # noqa: E402
from veles_tpu_torch.ops.gemm import (EPILOGUES, KAHAN_STEP,  # noqa: E402
                                      KAHAN_TILE, SMS, SPLIT_K_STEP,
                                      STREAM_SMEM, TILE_THIN_K,
                                      LinearActFunction, gemm_plan,
                                      kahan_plan, linear_act,
                                      linear_act_plain)
from veles_tpu_torch.ops.gemm_bench import SHAPES, hostile_input  # noqa

TOL = dict(atol=1e-5, rtol=1e-5)
#: AlexNet's fc layers, K by name (N = 4096), and the row counts the
#: serving buckets and the training batch give them
FC_K = {"fc6": 9216, "fc7": 4096}
MAIN_PATH_M = (1, 2, 4, 8, 16, 32, 64, 128)


def _inputs(m, k, n, seed=3):
    rng = numpy.random.RandomState(seed)
    a = rng.randn(m, k).astype(numpy.float32)
    b = (rng.randn(k, n) / numpy.sqrt(k)).astype(numpy.float32)
    bias = rng.randn(n).astype(numpy.float32)
    return a, b, bias


def _port(a, b, bias, activation):
    return linear_act(torch.from_numpy(a), torch.from_numpy(b),
                      None if bias is None else torch.from_numpy(bias),
                      activation).numpy()


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("activation", EPILOGUES)
def test_matches_pallas_gemm_interpret(activation, with_bias):
    a, b, bias = _inputs(16, 64, 32)
    if not with_bias:
        bias = None
    want = pallas_gemm(jnp.asarray(a), jnp.asarray(b), bm=8, bn=16, bk=32,
                       bias=None if bias is None else jnp.asarray(bias),
                       activation=activation, interpret=True)
    numpy.testing.assert_allclose(_port(a, b, bias, activation),
                                  numpy.asarray(want), **TOL)


@pytest.mark.parametrize("activation", EPILOGUES)
def test_ragged_m_matches_xla_chain(activation):
    """M = 5 does not tile: the TPU kernel falls back to the XLA chain,
    which is what All2All runs untuned. The port takes any M."""
    a, b, bias = _inputs(5, 64, 32, seed=4)
    chain = get_activation(activation)(
        jnp.dot(jnp.asarray(a), jnp.asarray(b),
                preferred_element_type=jnp.float32) + jnp.asarray(bias))
    fallback = pallas_gemm(jnp.asarray(a), jnp.asarray(b), bm=4, bn=16,
                           bk=32, bias=jnp.asarray(bias),
                           activation=activation, interpret=True)
    got = _port(a, b, bias, activation)
    numpy.testing.assert_allclose(got, numpy.asarray(chain), **TOL)
    numpy.testing.assert_allclose(got, numpy.asarray(fallback), **TOL)


def test_bfloat16_operands_accumulate_in_float32():
    """bf16 operands, f32 output: both sides multiply the same bf16
    values exactly and sum in float32."""
    a, b, bias = _inputs(8, 64, 16, seed=5)
    a16 = jnp.asarray(a, jnp.bfloat16)
    b16 = jnp.asarray(b, jnp.bfloat16)
    want = pallas_gemm(a16, b16, bm=8, bn=16, bk=32, out_dtype=jnp.float32,
                       bias=jnp.asarray(bias), activation="strict_relu",
                       interpret=True)
    ta = torch.from_numpy(numpy.array(a16.astype(jnp.float32))).to(
        torch.bfloat16)
    tb = torch.from_numpy(numpy.array(b16.astype(jnp.float32))).to(
        torch.bfloat16)
    got = linear_act(ta, tb, torch.from_numpy(bias), "strict_relu",
                     torch.float32)
    assert got.dtype == torch.float32
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    a, b, bias = _inputs(4, 32, 8)
    before = linear_act.launches
    before_forms = dict(linear_act.launches_by_form)
    ta, tb, tbias = map(torch.from_numpy, (a, b, bias))
    assert torch.equal(linear_act(ta, tb, tbias, "tanh"),
                       linear_act_plain(ta, tb, tbias, "tanh"))
    assert linear_act.launches == before
    assert dict(linear_act.launches_by_form) == before_forms


@pytest.mark.parametrize("bad", ["shape", "dtype", "activation", "bias",
                                 "layout"])
def test_rejects_what_the_kernel_does_not_take(bad):
    a, b, bias = _inputs(4, 32, 8)
    ta, tb, tbias = map(torch.from_numpy, (a, b, bias))
    act = "linear"
    if bad == "shape":
        tb = tb[:16]
    elif bad == "dtype":
        tb = tb.double()
    elif bad == "activation":
        act = "sincos"
    elif bad == "bias":
        tbias = tbias[:4]
    else:
        tb = tb.t().contiguous().t()
    with pytest.raises((ValueError, TypeError)):
        linear_act(ta, tb, tbias, act)



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", EPILOGUES)
def test_backward_matches_fused_linear_vjp(activation, dtype):
    """dx, dw and db of ``LinearActFunction`` against ``jax.vjp`` of
    ``fused_linear`` (Pallas forward in interpret mode, residuals
    (x, w, y), derivatives from the output)."""
    a, b, bias = _inputs(16, 64, 32, seed=6)
    g = numpy.random.RandomState(7).randn(16, 32).astype(numpy.float32)
    jdt = getattr(jnp, dtype)
    cfg = (8, 16, 32, _DS, True)
    y, vjp = jax.vjp(
        lambda x, w, bb: fused_linear(x, w, bb, activation, jdt, cfg),
        jnp.asarray(a, jdt), jnp.asarray(b, jdt), jnp.asarray(bias))
    want = [numpy.asarray(v.astype(jnp.float32))
            for v in vjp(jnp.asarray(g, jdt))]
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(a).to(tdt).requires_grad_()
    w = torch.from_numpy(b).to(tdt).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    out = LinearActFunction.apply(x, w, tb, activation, tdt)
    tol = TOL if dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    numpy.testing.assert_allclose(out.detach().float().numpy(),
                                  numpy.asarray(y.astype(jnp.float32)), **tol)
    out.backward(torch.from_numpy(g).to(tdt))
    assert x.grad.dtype == tdt and w.grad.dtype == tdt
    assert tb.grad.dtype == torch.float32
    for got, ref in zip((x.grad, w.grad, tb.grad), want):
        numpy.testing.assert_allclose(got.float().numpy(), ref, **tol)


def _check_plan(plan, m, n, k):
    """The K ranges cover K once, in order, none empty, each but the
    last ``kchunk`` deep; the workspace holds one float32 (m, n) plane
    per split when K is split."""
    assert plan.splits == len(plan.k_ranges) >= 1
    assert plan.k_ranges[0][0] == 0 and plan.k_ranges[-1][1] == k
    for (_, end), (start, _) in zip(plan.k_ranges, plan.k_ranges[1:]):
        assert end == start
    assert all(end > start for start, end in plan.k_ranges)
    assert all(end - start == plan.kchunk
               for start, end in plan.k_ranges[:-1])
    assert plan.workspace_bytes == (4 * plan.splits * m * n
                                    if plan.splits > 1 else 0)


def _grid_blocks(plan, m, n):
    rows = 1 if plan.form == "stream" else -(-m // plan.tile[0])
    return rows * -(-n // plan.tile[1]) * plan.splits


@pytest.mark.parametrize("m", MAIN_PATH_M)
@pytest.mark.parametrize("layer", sorted(FC_K))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_plan_main_path_lands_on_a_designed_form(dtype, layer, m):
    """fc6/fc7 at every serving bucket and the training batch: weight
    streaming up to 32 rows (float32) or 16 (bf16), then float32 tiles
    or bf16 tensor cores; K split so the grid covers the 132 SMs."""
    dt = getattr(torch, dtype)
    k, n = FC_K[layer], 4096
    plan = gemm_plan(m, n, k, dt)
    _check_plan(plan, m, n, k)
    if m <= (32 if dtype == "float32" else 16):
        assert plan.form == "stream"
        rows = plan.tile[0]
        assert rows >= m and rows & (rows - 1) == 0 and rows < 2 * m + 1
        assert plan.tile[1] == 32 * (4 if dtype == "float32" else 8)
        assert rows * plan.kchunk * 4 <= STREAM_SMEM
    else:
        assert plan.form == ("tiles" if dtype == "float32"
                             else "tensor_core")
    assert plan.kchunk % SPLIT_K_STEP == 0
    assert plan.splits > 1
    assert _grid_blocks(plan, m, n) >= 0.9 * SMS


@pytest.mark.parametrize("dims", [dims for _, dims in SHAPES],
                         ids=[name.split(" (")[0] for name, _ in SHAPES])
def test_gemm_plan_disciplines_shapes_take_float32_tiles(dims):
    """K2's five shapes: register-blocked tiles, 64 rows deep for the
    weight gradient's K of 128; K split where the tiles alone leave SMs
    idle (the two thin fc products) or end in a ragged wave (1500^3:
    144 tiles on 132 SMs)."""
    m, k, n = dims
    plan = gemm_plan(m, n, k, torch.float32)
    _check_plan(plan, m, n, k)
    assert plan.form == "tiles"
    assert plan.tile == (64 if k <= TILE_THIN_K else 128, 128)
    assert (plan.splits > 1) == (m in (128, 1500))
    assert _grid_blocks(plan, m, n) >= 0.9 * SMS


@pytest.mark.parametrize("case", [
    (64, 70, 300, "float32", True),    # rows of w 280 B: not 16-byte
    (5, 70, 300, "bfloat16", True),    # 140 B
    (1, 4096, 9216, "float32", False),  # a base pointer off 16 bytes
    (128, 4096, 9216, "float32", False),
    (128, 4096, 9216, "bfloat16", False),
    (128, 132, 200, "bfloat16", True),  # 264 B rows: TMA wants 16 B
    (128, 4096, 302, "float32", True),  # rows of x 1208 B
    (3, 4098, 64, "float32", True),
    (20, 4096, 0, "float32", True),  # K = 0: act(bias)
    (20, 4096, 0, "bfloat16", True)])
def test_gemm_plan_unaligned_shapes_take_the_general_variant(case):
    m, n, k, dtype, aligned = case
    plan = gemm_plan(m, n, k, getattr(torch, dtype), aligned)
    assert plan.form == "general" and plan.splits == 1
    assert plan.k_ranges == ((0, k),) and plan.workspace_bytes == 0


@pytest.mark.parametrize("want", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("case", [(1, 4096, 9216, "float32"),
                                  (32, 4096, 9216, "float32"),
                                  (1500, 1500, 1500, "float32"),
                                  (128, 4096, 9216, "bfloat16"),
                                  (64, 70, 300, "float32")])
def test_gemm_plan_split_override(case, want):
    """``splits`` (the sweeps' override) keeps the form and cuts K into at
    most that many ranges; the stream form still keeps its x slab within
    shared memory, the general variant in one split."""
    m, n, k, dtype = case
    dt = getattr(torch, dtype)
    plan = gemm_plan(m, n, k, dt, splits=want)
    _check_plan(plan, m, n, k)
    assert plan.form == gemm_plan(m, n, k, dt).form
    if plan.form == "general":
        assert plan.splits == 1
    elif plan.form == "stream":
        assert plan.tile[0] * plan.kchunk * 4 <= STREAM_SMEM
        cap = STREAM_SMEM // (4 * plan.tile[0])
        assert plan.splits <= max(want, -(-k // cap))
    else:
        assert plan.splits <= want


def test_gemm_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        gemm_plan(4, 8, 16, torch.float64)


def _split_k_plain(x, w, bias, activation, out_dtype, plan):
    """The plan's arithmetic in plain PyTorch: each split's float32
    product over its K range, the splits summed in split order, then the
    bias once and the epilogue on the full sum."""
    total = None
    for start, end in plan.k_ranges:
        part = torch.matmul(x[:, start:end].float(), w[start:end].float())
        total = part if total is None else total + part
    if bias is not None:
        total = total + bias
    return ACTIVATIONS[activation](total).to(out_dtype)


#: (m, n, k, dtype, Pallas bk, form): small shapes whose plan splits K,
#: one for each designed form, and one whose last split is ragged
SPLIT_CASES = {"stream_f32": (3, 16, 1024, "float32", 256, "stream"),
               "stream_bf16": (5, 16, 512, "bfloat16", 256, "stream"),
               "tiles": (40, 8, 2048, "float32", 512, "tiles"),
               "tiles_ragged": (40, 8, 1000, "float32", 250, "tiles"),
               "tensor_core": (24, 16, 1024, "bfloat16", 256,
                               "tensor_core")}


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_k_sum_matches_pallas_gemm_interpret(case, with_bias):
    """The splits of :func:`gemm_plan` summed in order, the bias added
    once after them and the epilogue on the whole sum, as the kernel's
    second pass does, against ``pallas_gemm`` (interpret mode), which
    sums all of K in one accumulator. Two controls must read far off:
    the bias added in every split, and the epilogue applied to every
    split's partial sum."""
    m, n, k, dtype, bk, form = SPLIT_CASES[case]
    a, b, bias = _inputs(m, k, n, seed=9)
    if not with_bias:
        bias = None
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    a16, b16 = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    plan = gemm_plan(m, n, k, tdt)
    assert plan.form == form and plan.splits > 1
    want = numpy.asarray(pallas_gemm(
        a16, b16, bm=m, bn=n, bk=bk, out_dtype=jnp.float32,
        bias=None if bias is None else jnp.asarray(bias),
        activation="tanh", interpret=True))
    x = torch.from_numpy(numpy.array(a16.astype(jnp.float32))).to(tdt)
    w = torch.from_numpy(numpy.array(b16.astype(jnp.float32))).to(tdt)
    tbias = None if bias is None else torch.from_numpy(bias)
    got = _split_k_plain(x, w, tbias, "tanh", torch.float32, plan)
    numpy.testing.assert_allclose(got.numpy(), want, **TOL)
    tanh = ACTIVATIONS["tanh"]
    per_split_act = sum(tanh(torch.matmul(x[:, s:e].float(), w[s:e].float())
                             + (0 if tbias is None else tbias / plan.splits))
                        for s, e in plan.k_ranges)
    controls = [per_split_act]
    if tbias is not None:
        controls.append(_split_k_plain(x, w, tbias * plan.splits, "tanh",
                                       torch.float32, plan))
    for wrong in controls:
        assert numpy.abs(wrong.numpy() - want).max() > 1e-2


@pytest.mark.parametrize("activation", EPILOGUES)
def test_split_k_epilogues_match_pallas_gemm_interpret(activation):
    """Every epilogue after a split-K sum (the stream form's plan)."""
    m, n, k, _, bk, _ = SPLIT_CASES["stream_f32"]
    a, b, bias = _inputs(m, k, n, seed=10)
    want = pallas_gemm(jnp.asarray(a), jnp.asarray(b), bm=m, bn=n, bk=bk,
                       bias=jnp.asarray(bias), activation=activation,
                       interpret=True)
    plan = gemm_plan(m, n, k, torch.float32)
    got = _split_k_plain(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(bias), activation, torch.float32,
                         plan)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), **TOL)


def test_backward_without_bias_and_through_plain_versions():
    a, b, _ = _inputs(4, 32, 8, seed=8)
    grads = []
    for plain in (False, True):
        x = torch.from_numpy(a).requires_grad_()
        w = torch.from_numpy(b).requires_grad_()
        LinearActFunction.apply(x, w, None, "tanh", torch.float32,
                                plain).sum().backward()
        grads.append((x.grad, w.grad))
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


# -- K5: kahan_plan and the mma form's arithmetic ----------------------------

#: the card tests' K5 shapes (m, k, n) and where their plans land
KAHAN_CARD_MMA = ((67, 1000, 132), (200, 1500, 260), (129, 4104, 136),
                  (1, 64, 4))
KAHAN_CARD_GENERAL = ((5, 1000, 70), (67, 300, 129), (1, 64, 1), (130, 1, 65))


def _check_kahan_plan(plan, m, n, k, bk):
    """The K ranges cover K once, in order, none empty, each starting on
    a Kahan block (no block straddles two splits) and each but the last
    ``blocks_per_split`` blocks deep; the workspace holds an (acc, comp)
    pair of float32 (m, n) planes per split when K is split."""
    bk = max(1, min(bk, k))
    assert plan.splits == len(plan.k_ranges) >= 1
    assert plan.k_ranges[0][0] == 0 and plan.k_ranges[-1][1] == k
    for (_, end), (start, _) in zip(plan.k_ranges, plan.k_ranges[1:]):
        assert end == start
    assert all(start % bk == 0 for start, _ in plan.k_ranges)
    assert all(end > start for start, end in plan.k_ranges) or k == 0
    assert all(end - start == plan.blocks_per_split * bk
               for start, end in plan.k_ranges[:-1])
    assert plan.workspace_bytes == (8 * plan.splits * m * n
                                    if plan.splits > 1 else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [dims for _, dims in SHAPES],
                         ids=[name.split(" (")[0] for name, _ in SHAPES])
def test_kahan_plan_bench_shapes_take_the_mma_form(dims, dtype):
    """The disciplines bench's five shapes at its block depth min(512, K)
    run on the tensor cores, but 1500-wide bf16 rows (3000 bytes) are not
    16-byte aligned; K splits over whole blocks where the tiles alone
    leave SMs idle (the thin fc products) or end in a ragged wave
    (1500^3: 144 tiles on 132 SMs), never at 4096^3 or the weight
    gradient."""
    m, k, n = dims
    dt = getattr(torch, dtype)
    bk = min(512, k)
    plan = kahan_plan(m, n, k, bk, dt)
    _check_kahan_plan(plan, m, n, k, bk)
    if dtype == "bfloat16" and n == 1500:
        assert plan.form == "general" and plan.splits == 1
        return
    assert plan.form == "mma" and plan.tile == (KAHAN_TILE, KAHAN_TILE)
    assert plan.splits == {128: 4, 1500: 2}.get(m, 1)
    tiles = -(-m // KAHAN_TILE) * -(-n // KAHAN_TILE)
    if plan.splits > 1:
        assert tiles * plan.splits >= 0.9 * SMS or m == 1500


@pytest.mark.parametrize("dims", KAHAN_CARD_MMA + KAHAN_CARD_GENERAL)
@pytest.mark.parametrize("bk", [1, 7, 8, 24, 64, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kahan_plan_card_shapes(dims, bk, dtype):
    """The card tests' shapes: bk below the wgmma step (8 float32, 16 bf16)
    unless it is all of K, N or K off the 16-byte chunk, go to the
    general form in one split; the rest to the mma form."""
    m, k, n = dims
    dt = getattr(torch, dtype)
    plan = kahan_plan(m, n, k, bk, dt)
    _check_kahan_plan(plan, m, n, k, bk)
    vec = 8 if dtype == "bfloat16" else 4
    whole = min(bk, k)
    mma = (n % vec == 0 and k % vec == 0 and
           (whole % KAHAN_STEP[dt] == 0 or whole == k))
    assert plan.form == ("mma" if mma else "general")
    if dims in KAHAN_CARD_GENERAL:
        assert plan.form == "general"
    if plan.form == "general":
        assert plan.splits == 1 and plan.tile == (64, 64)


@pytest.mark.parametrize("case", [(128, 4096, 9216, 512, "float32", False),
                                  (128, 4096, 9216, 512, "bfloat16", False),
                                  (64, 64, 0, 512, "float32", True),
                                  (64, 64, 1000, 4, "float32", True),
                                  (64, 64, 1000, 8, "bfloat16", True)])
def test_kahan_plan_unaligned_or_shallow_takes_general(case):
    """A base pointer off 16 bytes, K = 0 (zeros out), and blocks shallower
    than one wgmma step."""
    m, n, k, bk, dtype, aligned = case
    plan = kahan_plan(m, n, k, bk, getattr(torch, dtype), aligned)
    assert plan.form == "general" and plan.splits == 1
    assert plan.k_ranges == ((0, k),) and plan.workspace_bytes == 0


@pytest.mark.parametrize("want", [1, 2, 3, 4, 7, 18, 100])
@pytest.mark.parametrize("case", [(128, 4096, 9216), (1500, 1500, 1500),
                                  (67, 132, 1000)])
def test_kahan_plan_split_override(case, want):
    """``splits`` keeps the form and cuts the Kahan blocks into at most
    that many splits of whole blocks."""
    m, n, k = case
    plan = kahan_plan(m, n, k, 64, torch.float32, splits=want)
    _check_kahan_plan(plan, m, n, k, 64)
    assert plan.form == "mma"
    assert plan.splits <= want
    blocks = -(-k // 64)
    assert plan.splits == -(-blocks // -(-blocks // min(want, blocks)))


def _tf32_rna(x):
    """float32 rounded to TF32 (10 mantissa bits), ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds: half of TF32's last place added to
    the magnitude bits, then the 13 low bits cleared."""
    bits = numpy.ascontiguousarray(x, numpy.float32).view(numpy.uint32)
    return ((bits + numpy.uint32(0x1000)) &
            numpy.uint32(0xFFFFE000)).view(numpy.float32)


def test_tf32_rna_by_bits_matches_rounding_in_float64():
    """The bit recipe against rounding written out in float64: the
    magnitude scaled to 11 significant bits, floor(s + 1/2) (ties away
    from zero), scaled back; exact ties both ways and random values."""
    rng = numpy.random.RandomState(12)
    x = numpy.concatenate([
        rng.randn(4096).astype(numpy.float32) * numpy.float32(10.0) **
        rng.randint(-20, 20, 4096).astype(numpy.float32),
        numpy.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11,
                     1 + 2.0 ** -11 - 2.0 ** -23, 0.0, -0.0, 1.0, 3.0],
                    numpy.float32)])
    mant, exp = numpy.frexp(x.astype(numpy.float64))
    want = numpy.sign(mant) * numpy.floor(numpy.abs(mant) * 2.0 ** 11 +
                                          0.5) * 2.0 ** (exp - 11)
    got = _tf32_rna(x)
    numpy.testing.assert_array_equal(got.astype(numpy.float64), want)
    assert got[-8] == numpy.float32(1 + 2.0 ** -10)
    assert got[-7] == numpy.float32(-(1 + 2.0 ** -10))
    assert got[-6] == numpy.float32(1 + 2.0 ** -9)
    assert got[-5] == numpy.float32(1.0)


def _split_tf32(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _emulate_kahan_mma(a, b, bk, plan, passes=3):
    """The mma form's arithmetic on the CPU (float32 torch ops): each
    operand split into TF32 hi and lo; each 16-deep stage's product
    lo_a hi_b + hi_a lo_b + hi_a hi_b (``passes=1``: hi_a hi_b alone, the
    1xTF32 control) summed in float32 into the block's term; each Kahan
    block joined by the compensated add; each split of ``plan`` summed
    from zero and the splits' (acc, comp) pairs joined in split order:
    comp += comp_s, then acc_s joins by the compensated add."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    ah, al, bh, bl = map(torch.from_numpy, (ah, al, bh, bl))
    m, n = a.shape[0], b.shape[1]
    pairs = []
    for start, end in plan.k_ranges:
        acc = torch.zeros(m, n)
        comp = torch.zeros(m, n)
        for c0 in range(start, end, bk):
            cend = min(c0 + bk, end)
            term = torch.zeros(m, n)
            for s0 in range(c0, cend, 16):
                ks = slice(s0, min(s0 + 16, cend))
                part = ah[:, ks] @ bh[ks]
                if passes == 3:
                    part = (al[:, ks] @ bh[ks] + ah[:, ks] @ bl[ks]) + part
                term = term + part
            y = term - comp
            t = acc + y
            comp = (t - acc) - y
            acc = t
        pairs.append((acc, comp))
    acc, comp = pairs[0]
    for acc_s, comp_s in pairs[1:]:
        comp = comp + comp_s
        y = acc_s - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc.numpy()


#: (m, k, n, bk, splits): ragged last blocks, one block, and split
#: counts that leave a short last split
EMULATION_CASES = ((24, 1000, 40, 64, 3), (24, 1000, 40, 512, None),
                   (17, 600, 12, 600, None), (32, 2048, 16, 128, 5),
                   (8, 1500, 8, 512, 2))
#: float32-sized errors: against the JAX loop as in ``test_torch_ops.py``
#: (reordered float32 sums of O(1) outputs, plus 3xTF32's operand split
#: at ~2^-22 of each product), and against float64 as ``chip_smoke.py``'s
#: check (c): max |err| at most 2e-6 of |a| @ |b|. TF32 alone reads
#: ~1e-4 of |a| @ |b| and fails both.
EMULATION_TOL = dict(atol=1e-5, rtol=1e-5)
EMULATION_SHARE = 2e-6


@pytest.mark.parametrize("case", EMULATION_CASES)
def test_3xtf32_kahan_emulation_matches_the_jax_loop(case):
    m, k, n, bk, splits = case
    a, b, _ = _inputs(m, k, n, seed=13)
    plan = kahan_plan(m, n, k, bk, torch.float32, splits=splits)
    assert plan.form == "mma"
    want = numpy.asarray(_kahan_matmul_loop(jnp.asarray(a), jnp.asarray(b),
                                            bk))
    got = _emulate_kahan_mma(a, b, bk, plan)
    numpy.testing.assert_allclose(got, want, **EMULATION_TOL)
    ref = a.astype(numpy.float64) @ b.astype(numpy.float64)
    scale = numpy.abs(a).astype(numpy.float64) @ numpy.abs(b)
    assert numpy.max(numpy.abs(got - ref) / scale) <= EMULATION_SHARE
    control = _emulate_kahan_mma(a, b, bk, plan, passes=1)
    assert numpy.max(numpy.abs(control - ref) / scale) > EMULATION_SHARE
    with pytest.raises(AssertionError):
        numpy.testing.assert_allclose(control, want, **EMULATION_TOL)


@pytest.mark.parametrize("falling", [False, True])
def test_3xtf32_kahan_emulation_on_hostile_input(falling):
    """``tests/test_ops.py``'s hostile input at 256 rows, magnitudes
    rising or falling along K, 64-deep blocks on the plan's splits: no
    worse than 1.05x the JAX loop's max |error| against float64 (check
    (a)'s limit), and with magnitudes falling at least 2x better than one
    K-deep block (check (b)). The 1xTF32 control errs far beyond the
    limit."""
    a, b, exact = hostile_input(falling=falling)
    k = a.shape[1]
    jax_err = numpy.abs(numpy.asarray(_kahan_matmul_loop(
        jnp.asarray(a), jnp.asarray(b), 64)) - exact).max()
    errs = {}
    for bk, passes in ((64, 3), (k, 3), (64, 1)):
        plan = kahan_plan(a.shape[0], b.shape[1], k, bk, torch.float32)
        errs[bk, passes] = numpy.abs(
            _emulate_kahan_mma(a, b, bk, plan, passes) - exact).max()
    assert errs[64, 3] <= 1.05 * jax_err, (errs, jax_err)
    assert errs[64, 1] > 1.05 * jax_err
    if falling:
        assert 2.0 * errs[64, 3] <= errs[k, 3], errs
