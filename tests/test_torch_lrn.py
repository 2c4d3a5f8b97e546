"""The port's LRN (``veles_tpu_torch.ops.lrn``), forward and backward,
against the JAX package's fused Pallas LRN (interpret mode) and its
default XLA slices form, at the shapes of ``tests/test_lrn_fused.py``.

Tolerance: the window sum of five squares and the power differ in
order and formula (banded matmul and the rsqrt chain on the JAX kernel,
shifted slices and ``pow`` here), a few float32 ulps on outputs of
order 1: atol = 1e-6, the bound ``tests/test_lrn_fused.py`` holds the
Pallas kernel to. The backward adds a second window sum and a product
of three factors, a few more ulps on dx of order 1: atol = rtol = 2e-6.
bf16 inputs are held to bf16 resolution.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.nn.normalization import _lrn_slices  # noqa: E402
from veles_tpu.ops.lrn import _call_bwd, _call_fwd, lrn_fused  # noqa: E402
from veles_tpu_torch.ops import build  # noqa: E402
from veles_tpu_torch.ops.lrn import (BLOCKS_PER_SM,  # noqa: E402
                                     FWD_MAX_CHANNELS, GENERAL_MAX_CHANNELS,
                                     LRNFunction, lrn_backward,
                                     lrn_backward_plain, lrn_bwd_plan,
                                     lrn_forward, lrn_forward_plain,
                                     lrn_fwd_plan)

BWD_TOL = dict(atol=2e-6, rtol=2e-6)
#: AlexNet's constants, and a case where the cross term is large
CONSTANTS = {"alexnet": (2.0, 1e-4, 0.75, 5), "cross_term": (1.0, 0.5,
                                                             0.75, 5)}

SHAPES = [(4, 7, 7, 96), (2, 5, 5, 256), (3, 9, 9, 64), (2, 3, 3, 32)]


def _x(shape, seed=7, scale=1.0):
    return (numpy.random.RandomState(seed).randn(*shape) * scale).astype(
        numpy.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_lrn_interpret(shape):
    x = _x(shape)
    want = lrn_fused(jnp.asarray(x), 2.0, 1e-4, 0.75, 5, True)
    got = lrn_forward(torch.from_numpy(x), 2.0, 1e-4, 0.75, 5)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_xla_slices(shape):
    x = _x(shape, seed=8, scale=3.0)
    want = _lrn_slices(jnp.asarray(x))
    got = lrn_forward(torch.from_numpy(x))
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                  atol=1e-6)


def test_generic_beta_and_window():
    """beta != 3/4 takes the exp/log form; n = 3 a narrower window."""
    x = _x((2, 4, 4, 48), seed=9, scale=2.0)
    kw = dict(k=1.0, alpha=2e-4, beta=0.5, n=3)
    got = lrn_forward(torch.from_numpy(x), **kw).numpy()
    numpy.testing.assert_allclose(
        got, numpy.asarray(lrn_fused(jnp.asarray(x), 1.0, 2e-4, 0.5, 3,
                                     True)), atol=1e-6)
    numpy.testing.assert_allclose(
        got, numpy.asarray(_lrn_slices(jnp.asarray(x), **kw)), atol=1e-6)


def test_bfloat16_in_float32_math():
    xf = _x((2, 6, 6, 96), seed=10)
    x16 = torch.from_numpy(xf).to(torch.bfloat16)
    got = lrn_forward(x16)
    assert got.dtype == torch.bfloat16
    want = lrn_fused(jnp.asarray(xf, jnp.bfloat16), 2.0, 1e-4, 0.75, 5,
                     True)
    numpy.testing.assert_allclose(
        got.float().numpy(), numpy.asarray(want.astype(jnp.float32)),
        atol=2e-2, rtol=2e-2)


def test_even_window_and_strided_input_rejected():
    x = torch.from_numpy(_x((2, 3, 3, 16)))
    with pytest.raises(ValueError, match="odd"):
        lrn_forward(x, n=4)
    with pytest.raises(ValueError, match="channels-last"):
        # NHWC shape over NCHW memory: what a conv without
        # channels_last memory would hand on
        lrn_forward(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1))


def test_cpu_tensors_take_the_plain_version_without_counting():
    x = torch.from_numpy(_x((2, 3, 3, 32)))
    before = lrn_forward.launches
    before_forms = dict(lrn_forward.launches_by_form)
    before_variants = dict(lrn_forward.launches_by_variant)
    assert torch.equal(lrn_forward(x), lrn_forward_plain(x))
    assert lrn_forward.launches == before
    assert dict(lrn_forward.launches_by_form) == before_forms
    assert dict(lrn_forward.launches_by_variant) == before_variants



def _xg(shape, seed, scale):
    rng = numpy.random.RandomState(seed)
    return ((rng.randn(*shape) * scale).astype(numpy.float32),
            rng.randn(*shape).astype(numpy.float32))


@pytest.mark.parametrize("constants", sorted(CONSTANTS))
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_pallas_bwd_interpret_and_xla_vjp(shape,
                                                           constants):
    k, alpha, beta, n = CONSTANTS[constants]
    x, g = _xg(shape, seed=11, scale=3.0 if constants == "alexnet"
               else 1.0)
    rows = int(numpy.prod(shape[:-1]))
    want = numpy.asarray(_call_bwd(jnp.asarray(x), jnp.asarray(g), k,
                                   alpha, beta, n, True, block_rows=rows))
    _, vjp = jax.vjp(lambda v: _lrn_slices(v, k, alpha, beta, n),
                     jnp.asarray(x))
    want_xla = numpy.asarray(vjp(jnp.asarray(g))[0])
    got = lrn_backward(torch.from_numpy(x), torch.from_numpy(g), k, alpha,
                       beta, n).numpy()
    numpy.testing.assert_allclose(got, want, **BWD_TOL)
    numpy.testing.assert_allclose(got, want_xla, **BWD_TOL)
    if constants == "cross_term":
        # the 2*alpha*beta*x*W(...) term must be visible: a dx that
        # dropped it would fail by at least 10% of |dx|
        half = n // 2
        padded = numpy.pad(x * x, [(0, 0)] * (x.ndim - 1) + [(half, half)])
        window = sum(padded[..., i:i + shape[-1]] for i in range(n))
        without = g * (k + alpha * window) ** -beta
        assert numpy.abs(got - without).max() >= \
            0.1 * numpy.abs(got).max()


def test_backward_bfloat16_in_float32_math():
    x, g = _xg((2, 6, 6, 96), seed=12, scale=3.0)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    g16 = torch.from_numpy(g).to(torch.bfloat16)
    got = lrn_backward(x16, g16)
    assert got.dtype == torch.bfloat16
    want = _call_bwd(jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(g, jnp.bfloat16), 2.0, 1e-4, 0.75, 5, True,
                     block_rows=72)
    numpy.testing.assert_allclose(
        got.float().numpy(), numpy.asarray(want.astype(jnp.float32)),
        atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("constants", sorted(CONSTANTS))
def test_lrn_function_gradient_matches_autograd_of_the_forward(constants):
    """LRNFunction saves x alone and recomputes d; its gradient is the
    autograd gradient of the plain forward."""
    k, alpha, beta, n = CONSTANTS[constants]
    x, g = _xg((3, 4, 4, 40), seed=13, scale=1.0)
    xa = torch.from_numpy(x).requires_grad_()
    LRNFunction.apply(xa, k, alpha, beta, n).backward(torch.from_numpy(g))
    xb = torch.from_numpy(x).requires_grad_()
    lrn_forward_plain(xb, k, alpha, beta, n).backward(torch.from_numpy(g))
    numpy.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(),
                                  **BWD_TOL)
    xc = torch.from_numpy(x).requires_grad_()
    LRNFunction.apply(xc, k, alpha, beta, n, True).backward(
        torch.from_numpy(g))
    assert torch.equal(xc.grad, xa.grad)


def test_backward_checks_and_cpu_path_does_not_count():
    x, g = _xg((2, 3, 3, 32), seed=14, scale=1.0)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    before = lrn_backward.launches
    assert torch.equal(lrn_backward(xt, gt), lrn_backward_plain(xt, gt))
    assert lrn_backward.launches == before
    with pytest.raises(ValueError, match="like x"):
        lrn_backward(xt, gt[:1])
    with pytest.raises(ValueError, match="channels-last"):
        lrn_backward(xt, gt.permute(0, 3, 1, 2).contiguous().permute(
            0, 2, 3, 1))


#: chip_smoke.py's tolerance of the kernel against its plain version
LRN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
F32 = numpy.float32


def _window_f32(v, half, lane_channels=None):
    """The vector form's window sum in float32: v[c - half] + ... +
    v[c + half], low channel first, 0 beyond the row. With
    ``lane_channels`` a window stops at its lane's edge: the halo that
    the shuffles bring is missing (the control)."""
    channels = v.shape[-1]
    total = None
    for j in range(-half, half + 1):
        term = numpy.zeros_like(v)
        lo, hi = max(0, -j), min(channels, channels - j)
        term[:, lo:hi] = v[:, lo + j:hi + j]
        if lane_channels:
            lane = numpy.arange(channels) // lane_channels
            src = numpy.clip(numpy.arange(channels) + j, 0, channels - 1)
            term[:, lane != lane[src]] = 0.0
        total = term if total is None else (total + term).astype(F32)
    return total


def _emulate_vector_form(x, g, k, alpha, beta, n, lane_channels=None):
    """The vector form's float32 arithmetic, in its order: one d =
    fma(alpha, W(x^2), k); q = d^-beta and 1/d once (for 3/4 from s =
    rsqrt(d): q = s^2 rsqrt(s), 1/d = s^2, each step rounded; otherwise
    exp/log and a rounded reciprocal); t = (g x) (q (1/d)); u = W(t);
    dx = fma(-((2 alpha beta) x), u, g q). A fused multiply-add is the
    float64 result rounded once. x and g float32 (R, C) arrays."""
    f64 = numpy.float64
    k, alpha, beta = F32(k), F32(alpha), F32(beta)
    half = n // 2
    window = _window_f32(x * x, half, lane_channels)
    d = (f64(k) + f64(alpha) * window.astype(f64)).astype(F32)
    if beta == F32(0.75):
        s = (1.0 / numpy.sqrt(d.astype(f64))).astype(F32)
        inv = (s * s).astype(F32)
        q = (inv * (1.0 / numpy.sqrt(s.astype(f64))).astype(F32)).astype(
            F32)
    else:
        q = numpy.exp(-float(beta) * numpy.log(d.astype(f64))).astype(F32)
        inv = (F32(1) / d).astype(F32)
    t = ((g * x).astype(F32) * (q * inv).astype(F32)).astype(F32)
    u = _window_f32(t, half, lane_channels)
    scale = (F32(2) * alpha * beta).astype(F32)
    sx = (scale * x).astype(F32)
    return ((g * q).astype(F32).astype(f64) -
            sx.astype(f64) * u.astype(f64)).astype(F32)


def _exact(x, g, k, alpha, beta, n):
    x, g = x.astype(numpy.float64), g.astype(numpy.float64)
    half = n // 2
    pad = [(0, 0), (half, half)]
    channels = x.shape[-1]

    def window(v):
        p = numpy.pad(v, pad)
        return sum(p[:, i:i + channels] for i in range(n))

    d = k + alpha * window(x * x)
    q = d ** -beta
    return g * q - 2 * alpha * beta * x * window(g * x * q / d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [96, 256])
@pytest.mark.parametrize("constants", sorted(CONSTANTS))
def test_vector_form_arithmetic_matches_pallas_bwd_and_float64(
        constants, channels, dtype):
    """The new K4 arithmetic (one d, q times 1/d taken once, window sums
    unrolled low channel first), emulated in float32, against the JAX
    kernel ``_call_bwd`` in interpret mode and against float64, within
    chip_smoke.py's LRN_TOL; bf16 inputs are rounded first on all sides
    and the emulation's output rounded to bf16 as the kernel stores it.
    A control that loses the window halo across the kernel's lanes (4
    channels a lane) must fail the float64 check."""
    k, alpha, beta, n = CONSTANTS[constants]
    x, g = _xg((2, 5, 5, channels), seed=31, scale=3.0 if
               constants == "alexnet" else 1.0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    rows = 50
    x2 = numpy.asarray(xj.astype(jnp.float32)).reshape(rows, channels)
    g2 = numpy.asarray(gj.astype(jnp.float32)).reshape(rows, channels)
    got = _emulate_vector_form(x2, g2, k, alpha, beta, n)
    exact = _exact(x2, g2, k, alpha, beta, n)
    pallas = numpy.asarray(_call_bwd(xj, gj, k, alpha, beta, n, True,
                                     block_rows=rows).astype(jnp.float32))
    if dtype == "bfloat16":
        got = numpy.asarray(jnp.asarray(got, jnp.bfloat16).astype(
            jnp.float32))
    atol, rtol = LRN_TOL[dtype]
    numpy.testing.assert_allclose(got, pallas.reshape(rows, channels),
                                  atol=atol, rtol=rtol)
    numpy.testing.assert_allclose(got, exact, atol=atol, rtol=rtol)
    if dtype == "float32" and constants == "cross_term":
        lost = _emulate_vector_form(x2, g2, k, alpha, beta, n, 4)
        with pytest.raises(AssertionError):
            numpy.testing.assert_allclose(lost, exact, atol=atol,
                                          rtol=rtol)


@pytest.mark.parametrize("case", [
    # (rows, C, n, dtype, form, cpt, lanes, rows a warp)
    (401408, 96, 5, "float32", "vector", 4, 24, 1),
    (93312, 256, 5, "float32", "vector", 8, 32, 1),
    (401408, 96, 5, "bfloat16", "vector", 8, 12, 2),
    (93312, 256, 5, "bfloat16", "vector", 8, 32, 1),
    (105, 512, 9, "bfloat16", "vector", 16, 32, 1),
    (105, 96, 1, "float32", "vector", 4, 24, 1),
    (105, 96, 11, "float32", "general", 1, 0, 0),
    (105, 255, 5, "float32", "general", 1, 0, 0),
    (105, 260, 5, "float32", "general", 1, 0, 0),
    (105, 3, 5, "bfloat16", "general", 1, 0, 0),
    (105, GENERAL_MAX_CHANNELS, 5, "float32", "general", 1, 0, 0),
])
def test_lrn_bwd_plan(case):
    rows, channels, n, dtype, form, cpt, lanes, per_warp = case
    plan = lrn_bwd_plan(rows, channels, n, getattr(torch, dtype))
    assert (plan.form, plan.cpt, plan.lanes, plan.rows_per_warp) == (
        form, cpt, lanes, per_warp)
    assert plan.blocks >= 1
    if form == "vector":
        assert channels <= plan.cpt * plan.lanes <= 32 * plan.cpt
        assert plan.lanes * plan.rows_per_warp <= 32


def test_lrn_bwd_plan_unaligned_and_refusals():
    assert lrn_bwd_plan(105, 96, 5, torch.float32, False).form == "general"
    with pytest.raises(ValueError, match="at most"):
        lrn_bwd_plan(105, GENERAL_MAX_CHANNELS + 1, 5, torch.float32)
    with pytest.raises(ValueError, match="odd"):
        lrn_bwd_plan(105, 96, 4, torch.float32)
    with pytest.raises(TypeError):
        lrn_bwd_plan(105, 96, 5, torch.float64)


def _emulate_vector_fwd(x, k, alpha, beta, n, lane_channels=None):
    """The forward vector form's float32 arithmetic, in its order: d =
    fma(alpha, W(x^2), k), the window summed low channel first; for
    beta = 3/4 s = rsqrt(d), q = (s s) rsqrt(s), each step rounded,
    otherwise exp/log rounded once; y = x q. A fused multiply-add is
    the float64 result rounded once. x a float32 (R, C) array; with
    ``lane_channels`` the windows stop at the lanes' edges (the
    control)."""
    f64 = numpy.float64
    k, alpha, beta = F32(k), F32(alpha), F32(beta)
    window = _window_f32((x * x).astype(F32), n // 2, lane_channels)
    d = (f64(k) + f64(alpha) * window.astype(f64)).astype(F32)
    if beta == F32(0.75):
        s = (1.0 / numpy.sqrt(d.astype(f64))).astype(F32)
        s2 = (s * s).astype(F32)
        q = (s2 * (1.0 / numpy.sqrt(s.astype(f64))).astype(F32)).astype(F32)
    else:
        q = numpy.exp(-float(beta) * numpy.log(d.astype(f64))).astype(F32)
    return (x * q).astype(F32)


def _exact_fwd(x, k, alpha, beta, n):
    x = x.astype(numpy.float64)
    half, channels = n // 2, x.shape[-1]
    p = numpy.pad(x * x, [(0, 0), (half, half)])
    return x * (k + alpha * sum(p[:, i:i + channels] for i in range(n))) \
        ** -beta


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [96, 256])
@pytest.mark.parametrize("constants", sorted(CONSTANTS) + ["exp_log"])
def test_vector_form_arithmetic_matches_pallas_fwd_and_float64(
        constants, channels, dtype):
    """K3's vector-form arithmetic (one fma for d, the rsqrt chain, the
    window unrolled low channel first), emulated in float32, against the JAX
    kernel ``_call_fwd`` in interpret mode and against float64, within
    chip_smoke.py's LRN_TOL; bf16 inputs are rounded first on all sides
    and the emulation's output rounded to bf16 as the kernel stores it.
    A control that loses the window halo across the lanes, at the
    channels a lane that ``lrn_fwd_plan`` gives the shape, must fail the
    float64 check."""
    k, alpha, beta, n = CONSTANTS.get(constants, (2.0, 1e-3, 0.6, 3))
    x = _x((2, 5, 5, channels), seed=41, scale=3.0 if
           constants == "alexnet" else 1.0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(x, jdt)
    rows = 50
    x2 = numpy.asarray(xj.astype(jnp.float32)).reshape(rows, channels)
    got = _emulate_vector_fwd(x2, k, alpha, beta, n)
    exact = _exact_fwd(x2, k, alpha, beta, n)
    pallas = numpy.asarray(_call_fwd(xj, k, alpha, beta, n, True,
                                     block_rows=rows).astype(jnp.float32))
    if dtype == "bfloat16":
        got = numpy.asarray(jnp.asarray(got, jnp.bfloat16).astype(
            jnp.float32))
    atol, rtol = LRN_TOL[dtype]
    numpy.testing.assert_allclose(got, pallas.reshape(rows, channels),
                                  atol=atol, rtol=rtol)
    numpy.testing.assert_allclose(got, exact, atol=atol, rtol=rtol)
    if dtype == "float32" and constants != "exp_log":
        plan = lrn_fwd_plan(rows, channels, n, torch.float32)
        assert plan.form == "vector"
        lost = _emulate_vector_fwd(x2, k, alpha, beta, n, plan.cpt)
        with pytest.raises(AssertionError):
            numpy.testing.assert_allclose(lost, exact, atol=atol,
                                          rtol=rtol)


@pytest.mark.parametrize("case", [
    # (rows, C, n, dtype, aligned, form, cpt, lanes, rows a warp)
    (401408, 96, 5, "float32", True, "vector", 8, 12, 2),
    (93312, 256, 5, "float32", True, "vector", 8, 32, 1),
    (401408, 96, 5, "bfloat16", True, "vector", 16, 6, 5),
    (93312, 256, 5, "bfloat16", True, "vector", 16, 16, 2),
    (3136, 96, 5, "float32", True, "vector", 8, 12, 2),     # bucket 1
    (729, 256, 5, "float32", True, "vector", 8, 32, 1),     # bucket 1
    (105, 104, 9, "float32", True, "vector", 8, 13, 2),
    (105, 352, 5, "float32", True, "vector", 12, 30, 1),
    (105, 768, 5, "float32", True, "vector", 24, 32, 1),
    (105, 8, 5, "bfloat16", True, "vector", 8, 1, 32),
    (105, 512, 1, "bfloat16", True, "vector", 16, 32, 1),
    (3136, 96, 5, "float32", False, "general", 1, 0, 0),    # off 16 bytes
    (105, 98, 5, "float32", True, "general", 1, 0, 0),
    (105, 100, 5, "bfloat16", True, "general", 1, 0, 0),
    (105, 96, 11, "float32", True, "general", 1, 0, 0),
    (105, 776, 5, "float32", True, "general", 1, 0, 0),     # 33 lanes
    (105, FWD_MAX_CHANNELS, 5, "bfloat16", True, "general", 1, 0, 0),
    (105, FWD_MAX_CHANNELS + 1, 5, "float32", True, ValueError, "at most"),
    (105, 96, 4, "float32", True, ValueError, "odd"),
    (105, 96, 5, "float64", True, TypeError, "float32 or bfloat16"),
])
def test_lrn_fwd_plan(case):
    """The forward's form and geometry at the training shapes, the
    serving buckets' and odd ones, and the refusals: the vector form
    gives a lane two 16-byte vectors where a row allows (C = 96: 8
    float32 channels on 12 lanes, 2 rows a warp; 16 bf16 on 6 lanes, 5
    rows), more only for rows wider than 32 such lanes, and caps its
    grid at BLOCKS_PER_SM blocks an SM."""
    rows, channels, n, dtype, aligned, form = case[:6]
    if isinstance(form, type):
        with pytest.raises(form, match=case[6]):
            lrn_fwd_plan(rows, channels, n, getattr(torch, dtype), aligned)
        return
    plan = lrn_fwd_plan(rows, channels, n, getattr(torch, dtype), aligned)
    assert (plan.form, plan.cpt, plan.lanes, plan.rows_per_warp) == (
        form,) + case[6:]
    if form == "vector":
        assert channels <= plan.cpt * plan.lanes <= 32 * plan.cpt
        assert plan.lanes * plan.rows_per_warp <= 32
        groups = -(-rows // plan.rows_per_warp)
        assert plan.blocks == min(-(-groups // 8),
                                  build.SMS * BLOCKS_PER_SM)
    else:
        assert plan.blocks == -(-rows // 8)
