"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same inputs. Every test here needs a CUDA card
and skips without one.

This file imports neither JAX nor the JAX package, so on a machine
without JAX it runs with the repository's conftest left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: float32 outputs differ by the order of float32 sums (and
the LRN's rsqrt chain vs ``pow``), a few ulps on O(1) values, so
atol = rtol = 1e-4 for the GEMM (K up to 300) and 1e-5 for the LRN,
forward and backward; bf16 outputs by one bf16 ulp (2^-8 relative), so
1e-2. A column sum is held to 1e-6 of its column's sum of magnitudes
(reordering R float32 additions moves a sum by far less). The Philox
fill is held to its plain version bit for bit. A training step's
gradients through the kernels are held to 1e-4 of each layer's
gradient norm against the same step through the plain versions. The
Kahan GEMM is held to its plain loop at atol = rtol = 1e-4 (float32
sums of K <= 1000 products of values below 1, in other orders), and
``gemm()``'s float32 products to 2e-6 of ``|a| @ |b|`` against float64:
float32 sums read a few 1e-7 at most there, TF32 products ~1e-5.
The workflow tests run the CLI on the card: an epoch fused, eagerly
(``--eager``: the same launches and history as the fused run), and an
eager run exported to a package holding the card's parameters bit for
bit, a dense package served on the card as on the CPU.
"""

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu_torch.loader.base import TRAIN  # noqa: E402
from veles_tpu_torch.models.alexnet import (  # noqa: E402
    SyntheticImageLoader, small_alexnet_layers)
from veles_tpu_torch.models.build import (build_model,  # noqa: E402
                                          build_training, layer_hypers,
                                          plain_forward)
from veles_tpu_torch.ops.gemm import (EPILOGUES,  # noqa: E402
                                      LinearActFunction, gemm, gemm_plan,
                                      kahan_gemm, kahan_matmul,
                                      kahan_matmul_plain, kahan_plan,
                                      linear_act, linear_act_plain)
from veles_tpu_torch.ops.gemm_bench import hostile_input  # noqa: E402
from veles_tpu_torch.nn.precision import get_policy  # noqa: E402
from veles_tpu_torch.ops import build  # noqa: E402
from veles_tpu_torch.ops.lrn import (GENERAL_MAX_CHANNELS,  # noqa: E402
                                     lrn_backward, lrn_backward_plain,
                                     lrn_bwd_plan, lrn_forward,
                                     lrn_forward_plain, lrn_fwd_plan)
from veles_tpu_torch.ops.random import (dropout_offset,  # noqa: E402
                                        uniform_fill, uniform_fill_plain)
from veles_tpu_torch.ops.reduce import (column_plan,  # noqa: E402
                                        column_sum, column_sum_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0):
    return (numpy.random.RandomState(seed).uniform(-1, 1, shape) *
            scale).astype(numpy.float32)


@pytest.mark.parametrize("m", [1, 5, 17, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_kernel_matches_plain(card, m, dtype):
    """Ragged M, N = 70 and K = 300: rows of w and x not 16-byte
    aligned, so the general variant takes them and masks every edge."""
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_rand((m, 300), 1)).to(card, dt)
    w = torch.from_numpy(_rand((300, 70), 2, 0.1)).to(card, dt)
    bias = torch.from_numpy(_rand((70,), 3)).to(card)
    tol = (1e-4, 1e-4) if dtype == "float32" else (1e-2, 1e-2)
    for activation in EPILOGUES:
        for b in (bias, None):
            for out_dtype in (torch.float32, dt):
                form = (m, 300, 70, dt, b is not None)
                before = linear_act.launches
                before_form = linear_act.launches_by_form[form]
                before_general = linear_act.launches_by_variant["general"]
                got = linear_act(x, w, b, activation, out_dtype)
                torch.cuda.synchronize()
                assert linear_act.launches == before + 1
                assert linear_act.launches_by_form[form] == before_form + 1
                assert linear_act.launches_by_variant["general"] == \
                    before_general + 1
                assert got.dtype == out_dtype
                want = linear_act_plain(x, w, b, activation, out_dtype)
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol[0], rtol=tol[1])


def _designed_form(m, dtype):
    if m <= (32 if dtype == "float32" else 16):
        return "stream"
    return "tiles" if dtype == "float32" else "tensor_core"


@pytest.mark.parametrize("kn", [(2056, 136), (200, 264)])
@pytest.mark.parametrize("m", [1, 7, 16, 33, 64, 65, 128, 129])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_designed_forms_match_plain_and_repeat(card, dtype, m, kn):
    """Aligned shapes land on the form :func:`gemm_plan` designs for them
    (weight streaming, float32 tiles, bf16 tensor cores), with ragged
    row and column tiles; K = 2056 splits K (a last split of 8 to 136
    rows), K = 200 runs the tiles in one. Every epilogue, with and
    without a bias, to either output dtype, within the plain version's
    tolerance, and two calls bitwise equal (the splits are summed in a
    fixed order)."""
    k, n = kn
    dt = getattr(torch, dtype)
    form = _designed_form(m, dtype)
    plan = gemm_plan(m, n, k, dt)
    assert plan.form == form
    assert plan.splits > 1 or k == 200
    x = torch.from_numpy(_rand((m, k), 30)).to(card, dt)
    w = torch.from_numpy(_rand((k, n), 31, 0.1)).to(card, dt)
    bias = torch.from_numpy(_rand((n,), 32)).to(card)
    for activation in EPILOGUES:
        for b in (bias, None):
            for out_dtype in (torch.float32, dt):
                before = linear_act.launches_by_variant[form]
                got = linear_act(x, w, b, activation, out_dtype)
                again = linear_act(x, w, b, activation, out_dtype)
                torch.cuda.synchronize()
                assert linear_act.launches_by_variant[form] == before + 2
                assert got.dtype == out_dtype and got.shape == (m, n)
                assert torch.equal(got, again)
                want = linear_act_plain(x, w, b, activation, out_dtype)
                tol = 1e-4 if out_dtype == torch.float32 else 1e-2
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol, rtol=tol)


@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_empty_k_is_the_epilogue_of_the_bias(card, dtype, m):
    dt = getattr(torch, dtype)
    x = torch.empty((m, 0), device=card, dtype=dt)
    w = torch.empty((0, 264), device=card, dtype=dt)
    bias = torch.from_numpy(_rand((264,), 36)).to(card)
    before = linear_act.launches_by_variant["general"]
    got = linear_act(x, w, bias, "sigmoid", torch.float32)
    torch.cuda.synchronize()
    assert linear_act.launches_by_variant["general"] == before + 1
    torch.testing.assert_close(got, torch.sigmoid(bias).expand(m, 264),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("which", ["x", "w", "bias"])
def test_gemm_misaligned_pointer_takes_the_general_variant(card, which):
    """A base pointer 4 bytes off 16 (a view into a larger buffer) cannot
    feed 16-byte copies: the general variant takes the call."""
    m, k, n = 64, 256, 128
    t = {"x": (m, k), "w": (k, n), "bias": (n,)}
    seeds = {"x": 33, "w": 34, "bias": 35}
    ops = {}
    for name, shape in t.items():
        v = torch.from_numpy(_rand(shape, seeds[name])).to(card)
        if name == which:
            buf = torch.empty(v.numel() + 1, device=card)
            ops[name] = buf[1:].view(shape)
            ops[name].copy_(v)
        else:
            ops[name] = v
    assert ops[which].data_ptr() % 16 == 4
    before = linear_act.launches_by_variant["general"]
    got = linear_act(ops["x"], ops["w"], ops["bias"], "tanh")
    torch.cuda.synchronize()
    assert linear_act.launches_by_variant["general"] == before + 1
    want = linear_act_plain(ops["x"], ops["w"], ops["bias"], "tanh")
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(4, 7, 7, 96), (2, 5, 5, 256),
                                   (3, 9, 9, 64), (2, 3, 3, 33),
                                   (2, 56, 56, 96)])
@pytest.mark.parametrize("beta", [0.75, 0.5])
def test_lrn_kernel_matches_plain(card, shape, beta):
    x = torch.from_numpy(_rand(shape, 4, 20.0)).to(card)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        xd = x.to(dtype)
        form = (tuple(shape), dtype)
        before = lrn_forward.launches
        before_form = lrn_forward.launches_by_form[form]
        got = lrn_forward(xd, 2.0, 1e-4, beta, 5)
        torch.cuda.synchronize()
        assert lrn_forward.launches == before + 1
        assert lrn_forward.launches_by_form[form] == before_form + 1
        want = lrn_forward_plain(xd, 2.0, 1e-4, beta, 5)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_lrn_kernel_refuses_nchw_memory(card):
    x = torch.zeros(2, 8, 5, 5, device=card).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="channels-last"):
        lrn_forward(x)


def test_model_forward_through_kernels_matches_plain(card):
    layers = [dict(d) for d in small_alexnet_layers(10)]
    layers.insert(1, {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75})
    model = build_model(layers, (32, 32, 3), seed=5, device=card)
    x = torch.from_numpy(_rand((4, 32, 32, 3), 6)).to(card)
    with torch.inference_mode():
        k1, k3 = linear_act.launches, lrn_forward.launches
        got = model(x)
        assert linear_act.launches == k1 + 1
        assert lrn_forward.launches == k3 + 1
        want = plain_forward(model, x)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


#: K3's shapes: the training batch and serving bucket 1 after conv1 and
#: conv2 (the vector form), rows of 104, 512 and 768 channels (4, 16 and
#: 24 float32 a lane), and the general form's: 33 channels (not a whole
#: vector) and 776 (33 lanes of 24)
LRN_FWD_SHAPES = [(128, 56, 56, 96), (128, 27, 27, 256), (1, 56, 56, 96),
                  (1, 27, 27, 256), (3, 5, 7, 104), (3, 5, 7, 512),
                  (3, 5, 7, 768), (3, 5, 7, 33), (3, 5, 7, 776)]


@pytest.mark.parametrize("shape", LRN_FWD_SHAPES)
@pytest.mark.parametrize("n,beta", [(5, 0.75), (5, 0.6), (1, 0.75),
                                    (9, 0.75), (11, 0.75), (3, 0.6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lrn_forward_forms_match_plain(card, shape, n, beta, dtype):
    """Both forms of K3 against the plain version, on the form
    lrn_fwd_plan picks: the vector form wherever C is a whole number of
    vectors on at most 32 lanes and n <= 9, the general one elsewhere."""
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_rand(shape, 18, 20.0)).to(card, dt)
    rows = x.numel() // shape[-1]
    plan = lrn_fwd_plan(rows, shape[-1], n, dt)
    assert plan.form == ("vector" if n <= 9 and shape[-1] not in (33, 776)
                         else "general")
    before = lrn_forward.launches_by_variant[plan.form]
    got = lrn_forward(x, 2.0, 1e-4, beta, n)
    torch.cuda.synchronize()
    assert lrn_forward.launches_by_variant[plan.form] == before + 1
    assert got.dtype == dt
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), lrn_forward_plain(
        x, 2.0, 1e-4, beta, n).float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lrn_forward_off_16_bytes_takes_the_general_form(card, dtype):
    shape = (4, 6, 6, 96)
    x = torch.from_numpy(_rand(shape, 19, 20.0)).to(card, getattr(torch,
                                                                  dtype))
    buf = torch.empty(x.numel() + 1, device=card, dtype=x.dtype)
    shifted = buf[1:].view(shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    before = lrn_forward.launches_by_variant["general"]
    got = lrn_forward(shifted)
    torch.cuda.synchronize()
    assert lrn_forward.launches_by_variant["general"] == before + 1
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), lrn_forward_plain(x).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(64, 56, 56, 96), (64, 27, 27, 256)])
def test_lrn_forward_on_a_side_stream(card, shape):
    """K3, launched through its CPython binding (never a ctypes call), on
    a side stream gives the default stream's bits once that stream is
    done."""
    x = torch.from_numpy(_rand(shape, 20, 20.0)).to(card)
    on_default = lrn_forward(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = lrn_forward(x)
    side.synchronize()
    assert torch.equal(on_side, on_default)
    assert "lrn_fwd" in build._bindings
    assert "veles_lrn_fwd" not in build._functions


#: AlexNet's constants, a case whose cross term is a large part of dx,
#: and the exp/log power with a narrower window
LRN_CONSTANTS = [(2.0, 1e-4, 0.75, 5, 20.0), (1.0, 0.5, 0.75, 5, 1.0),
                 (2.0, 1e-3, 0.5, 3, 5.0)]


@pytest.mark.parametrize("shape", [(4, 7, 7, 96), (2, 5, 5, 256),
                                   (2, 3, 3, 33), (2, 56, 56, 96)])
@pytest.mark.parametrize("constants", LRN_CONSTANTS)
def test_lrn_backward_kernel_matches_plain(card, shape, constants):
    k, alpha, beta, n, scale = constants
    x = torch.from_numpy(_rand(shape, 7, scale)).to(card)
    g = torch.from_numpy(_rand(shape, 8)).to(card)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        xd, gd = x.to(dtype), g.to(dtype)
        form = (tuple(shape), dtype)
        before = lrn_backward.launches
        before_form = lrn_backward.launches_by_form[form]
        got = lrn_backward(xd, gd, k, alpha, beta, n)
        torch.cuda.synchronize()
        assert lrn_backward.launches == before + 1
        assert lrn_backward.launches_by_form[form] == before_form + 1
        assert got.dtype == dtype
        want = lrn_backward_plain(xd, gd, k, alpha, beta, n)
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def _assert_column_sums(x, got):
    want = column_sum_plain(x)
    limit = 1e-6 * x.float().abs().sum(0) + 1e-30
    assert got.dtype == torch.float32 and got.shape == (x.shape[1],)
    assert bool(((got - want).abs() <= limit).all()), float(
        ((got - want).abs() / limit).max())


@pytest.mark.parametrize("shape", [(1, 5), (7, 1000), (128, 4096),
                                   (21632, 384), (100003, 96),
                                   (1024, 37), (1025, 3), (100003, 37),
                                   (5000, 4100), (401408, 96), (93312, 256),
                                   (21632, 256), (128, 1000), (3000, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_column_sum_kernel_matches_plain_and_repeats_bitwise(card, shape,
                                                             dtype):
    """Both forms of column_plan (single up to 1024 rows, chunked above),
    16-byte and scalar loads (C not a multiple of the vector), ragged
    column tiles and row chunks."""
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_rand(shape, 9)).to(card, dt)
    form = (shape[0], shape[1], dt)
    plan = column_plan(shape[0], shape[1], dt)
    before_form = column_sum.launches_by_form[form]
    before_variant = column_sum.launches_by_variant[plan.form]
    got = column_sum(x)
    again = column_sum(x)
    torch.cuda.synchronize()
    assert column_sum.launches_by_form[form] == before_form + 2
    assert column_sum.launches_by_variant[plan.form] == before_variant + 2
    assert torch.equal(got, again)
    _assert_column_sums(x, got)


@pytest.mark.parametrize("shape", [(128, 4096), (21632, 384)])
def test_column_sum_on_a_side_stream_and_off_16_bytes(card, shape):
    """A call on a side stream (its tickets zeroed on that stream), and x
    4 bytes off 16 (a view into a larger buffer), which takes scalar
    loads: both the plain version's sums, and the side stream's the
    default stream's bits."""
    x = torch.from_numpy(_rand(shape, 10)).to(card)
    on_default = column_sum(x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = [column_sum(x) for _ in range(3)]
    side.synchronize()
    for got in on_side:
        assert torch.equal(got, on_default)
    buf = torch.empty(x.numel() + 1, device=card)
    shifted = buf[1:].view(shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == 4
    assert column_plan(*shape, torch.float32, False).vec == 1
    got = column_sum(shifted)
    again = column_sum(shifted)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _assert_column_sums(x, got)


@pytest.mark.parametrize("channels", [1, 3, 96, 255, 256,
                                      GENERAL_MAX_CHANNELS])
@pytest.mark.parametrize("n", [1, 5, 9])
@pytest.mark.parametrize("beta", [0.75, 0.6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lrn_backward_forms_match_plain(card, channels, n, beta, dtype):
    """Every channel count the shared-memory kernel takes, up to its
    widest, on the
    form lrn_bwd_plan picks (the vector form at C = 96 and 256; the
    general one where C is not a multiple of the vector or a row is
    wider than a warp), 105 rows (odd: a bf16 warp holds two rows of
    96), the rsqrt chain and exp/log powers."""
    shape = (3, 5, 7, channels)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_rand(shape, 14, 20.0)).to(card, dt)
    g = torch.from_numpy(_rand(shape, 15)).to(card, dt)
    plan = lrn_bwd_plan(105, channels, n, dt)
    assert plan.form == ("vector" if channels in (96, 256) else "general")
    before = lrn_backward.launches_by_variant[plan.form]
    got = lrn_backward(x, g, 2.0, 1e-3, beta, n)
    torch.cuda.synchronize()
    assert lrn_backward.launches_by_variant[plan.form] == before + 1
    want = lrn_backward_plain(x, g, 2.0, 1e-3, beta, n)
    tol = 1e-5 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)


def test_lrn_backward_refuses_more_channels_than_the_general_form(card):
    x = torch.zeros(2, 3, GENERAL_MAX_CHANNELS + 1, device=card)
    with pytest.raises(ValueError, match="at most"):
        lrn_backward(x, x)


def test_lrn_backward_off_16_bytes_takes_the_general_form(card):
    shape = (4, 6, 6, 96)
    x = torch.from_numpy(_rand(shape, 16, 20.0)).to(card)
    g = torch.from_numpy(_rand(shape, 17)).to(card)
    buf = torch.empty(g.numel() + 1, device=card)
    shifted = buf[1:].view(shape)
    shifted.copy_(g)
    before = lrn_backward.launches_by_variant["general"]
    got = lrn_backward(x, shifted)
    torch.cuda.synchronize()
    assert lrn_backward.launches_by_variant["general"] == before + 1
    torch.testing.assert_close(got, lrn_backward_plain(x, g), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(128, 4096), (3, 5), (1, 7), (1000, 37)])
@pytest.mark.parametrize("stream", [(0, 0), (2 ** 64 - 1, 2 ** 64 - 1),
                                    (12345, dropout_offset(3, 11))])
def test_uniform_fill_kernel_matches_plain_bit_for_bit(card, shape,
                                                       stream):
    seed, offset = stream
    for vmin, vmax in ((0.0, 1.0), (-1.0, 1.0)):
        before = uniform_fill.launches_by_form[shape]
        got = uniform_fill(shape, seed, offset, vmin, vmax, device=card)
        torch.cuda.synchronize()
        assert uniform_fill.launches_by_form[shape] == before + 1
        want = uniform_fill_plain(shape, seed, offset, vmin, vmax,
                                  device=card)
        assert got.dtype == torch.float32 and got.shape == shape
        assert torch.equal(got, want)


def test_uniform_fill_launches_on_the_current_stream_and_card(card):
    """The launch path hands the kernel the raw handle of the current
    stream: a fill on a side stream, with the card named by index, is
    the plain version's bits once that stream is done, and is counted."""
    shape, seed, offset = (128, 4096), 99, dropout_offset(7, 2)
    side = torch.cuda.Stream()
    before = uniform_fill.launches
    with torch.cuda.stream(side):
        got = uniform_fill(shape, seed, offset, device="cuda:%d" %
                           torch.cuda.current_device())
    side.synchronize()
    assert uniform_fill.launches == before + 1
    assert torch.equal(got, uniform_fill_plain(shape, seed, offset,
                                               device=card))


@pytest.mark.parametrize("named", [False, True])
def test_uniform_fill_goes_through_its_binding(card, named):
    """K7's wrapper allocates and launches through its CPython binding
    (never a ctypes call): on a side stream, on the card named by index
    or not, the plain version's bits."""
    shape, seed, offset = (128, 4096), 2 ** 63 + 5, dropout_offset(9, 4)
    device = "cuda:%d" % torch.cuda.current_device() if named else "cuda"
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = uniform_fill(shape, seed, offset, -0.1, 0.3, device=device)
    side.synchronize()
    assert "uniform_fill" in build._bindings
    assert "veles_uniform_fill" not in build._functions
    assert got.device.index == torch.cuda.current_device()
    assert torch.equal(got, uniform_fill_plain(shape, seed, offset, -0.1,
                                               0.3, device=card))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_act_function_backward_matches_plain(card, dtype):
    dt = getattr(torch, dtype)
    grads = []
    for plain in (False, True):
        x = torch.from_numpy(_rand((128, 300), 10)).to(card, dt)
        w = torch.from_numpy(_rand((300, 70), 11, 0.1)).to(card, dt)
        b = torch.from_numpy(_rand((70,), 12)).to(card)
        for t in (x, w, b):
            t.requires_grad_()
        y = LinearActFunction.apply(x, w, b, "tanh", dt, plain)
        y.backward(torch.from_numpy(_rand((128, 70), 13)).to(card, dt))
        grads.append((x.grad, w.grad, b.grad))
    tol = 1e-4 if dtype == "float32" else 1e-2
    for got, want in zip(*grads):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


def test_training_step_through_kernels_matches_plain(card):
    """One step's gradients of a small AlexNet-like net with an LRN and
    dropout, through K1, K3, K4, K6 and K7 against the plain versions
    (the same Philox bits), cuDNN deterministic; the launches of the
    step are counted."""
    layers = [dict(d) for d in small_alexnet_layers(10)]
    layers.insert(1, {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75})
    loader = SyntheticImageLoader(n_train=64, n_valid=0, side=32,
                                  n_classes=10, minibatch_size=32)
    trainer = build_training(layers, (32, 32, 3), loader, seed=5,
                             device=card, learning_rate=0.01, momentum=0.9)
    idx = torch.from_numpy(trainer._segment_indices(TRAIN)[0]).to(card)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for plain in (False, True):
            trainer.plain = plain
            counts = (lrn_backward.launches, column_sum.launches,
                      uniform_fill.launches)
            trainer.gradients(idx, 0, 77)
            runs.append([{k: p.grad.clone() for k, p in layer.items()}
                         for layer in trainer.params])
            launched = (lrn_backward.launches - counts[0],
                        column_sum.launches - counts[1],
                        uniform_fill.launches - counts[2])
            assert launched == ((0, 0, 0) if plain else (1, 4, 1))
    finally:
        torch.backends.cudnn.deterministic = saved
        trainer.plain = False
    for got, want in zip(*runs):
        for k in want:
            share = float((got[k] - want[k]).norm() / want[k].norm())
            assert share < 1e-4, (k, share)


@pytest.mark.parametrize("kind", ["dp", "gspmd"])
def test_spmd_trainer_without_a_grid_keeps_its_data_on_the_card(card, kind):
    """A data-parallel or GSPMD trainer built without a grid, on a model
    on the card: its grid, its resident dataset and its gathered rows
    are on the card, and a training step there gives a finite loss."""
    from veles_tpu_torch.parallel.dp import DataParallelTrainer
    from veles_tpu_torch.parallel.gspmd import GSPMDTrainer
    layers = small_alexnet_layers(10)
    loader = SyntheticImageLoader(n_train=64, n_valid=0, side=32,
                                  n_classes=10, minibatch_size=32)
    model = build_model(layers, (32, 32, 3), seed=5, device=card,
                        trainable=True)
    cls = DataParallelTrainer if kind == "dp" else GSPMDTrainer
    trainer = cls(model, loader.initialize(), layer_hypers(layers))
    assert trainer.device.type == "cuda"
    assert trainer.grid.device == trainer.device
    assert trainer._data_args[0].device == trainer.device
    idx = trainer._segment_indices(TRAIN)[:1]
    x, _, _ = trainer._gather(torch.from_numpy(idx[0]).to(card))
    assert x.device == trainer.device
    losses, _ = trainer.train_rows(idx, 0, 7)
    assert torch.isfinite(torch.as_tensor(losses)).all()


@pytest.mark.parametrize("shape", [(5, 1000, 70), (67, 300, 129),
                                   (1, 64, 1), (130, 1, 65)])
@pytest.mark.parametrize("bk", [64, 512])
@pytest.mark.parametrize("layout", ["nn", "tn", "nt", "tt"])
def test_kahan_gemm_kernel_matches_plain(card, shape, bk, layout):
    """Ragged M, N and K (K = 1000 leaves a short last block at both
    depths), float32 and bf16 operands, float32 and bf16 outputs, and
    each operand row-major or a transposed view (layout t), which
    ``kahan_matmul`` copies once before it launches the kernel."""
    m, k, n = shape
    a32 = torch.from_numpy(_rand((m, k), 20)).to(card)
    b32 = torch.from_numpy(_rand((k, n), 21)).to(card)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = a32.to(dtype), b32.to(dtype)
        if layout[0] == "t":
            a = a.t().contiguous().t()
        if layout[1] == "t":
            b = b.t().contiguous().t()
        want = kahan_matmul_plain(a, b, bk)
        for out_dtype, tol in ((torch.float32, 1e-4),
                               (torch.bfloat16, 1e-2)):
            before = kahan_gemm.launches
            if layout == "nn":
                got = kahan_gemm(a, b, bk, out_dtype)
            else:
                got = kahan_matmul(a, b, chunk=bk).to(out_dtype)
            torch.cuda.synchronize()
            assert kahan_gemm.launches == before + 1
            assert got.dtype == out_dtype and got.shape == (m, n)
            torch.testing.assert_close(
                got.float(), want.to(out_dtype).float(), atol=tol, rtol=tol)


#: shapes whose N and K are whole 16-byte chunks in both dtypes, with
#: ragged row and column tiles and ragged last Kahan blocks
KAHAN_MMA_SHAPES = [(67, 1000, 136), (200, 1504, 264), (129, 4104, 136),
                    (1, 64, 8)]


@pytest.mark.parametrize("shape", KAHAN_MMA_SHAPES)
@pytest.mark.parametrize("bk", [1, 7, 64, 512])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kahan_gemm_forms_match_plain_and_repeat(card, dtype, bk, shape):
    """Every form and split count :func:`kahan_plan` gives these shapes
    (its own, and 1, 2, 3 and 8 splits forced): block depths below the
    wgmma step (1, 7) on the general form, 64 and 512 on the tensor cores;
    each launch counted under its form, two calls bitwise equal, and the
    plain loop's result within 1e-4 (float32 sums of K <= 4104 products
    of values below 1, in other orders)."""
    m, k, n = shape
    dt = getattr(torch, dtype)
    a = torch.from_numpy(_rand((m, k), 26)).to(card, dt)
    b = torch.from_numpy(_rand((k, n), 27)).to(card, dt)
    want = kahan_matmul_plain(a, b, bk)
    assert kahan_plan(m, n, k, bk, dt).form == (
        "general" if bk < 8 and bk < k else "mma")
    seen = set()
    for splits in (None, 1, 2, 3, 8):
        plan = kahan_plan(m, n, k, bk, dt, True, splits)
        if plan.splits in seen:
            continue
        seen.add(plan.splits)
        before = kahan_gemm.launches_by_variant[plan.form]
        got = kahan_gemm(a, b, bk, splits=splits)
        again = kahan_gemm(a, b, bk, splits=splits)
        torch.cuda.synchronize()
        assert kahan_gemm.launches_by_variant[plan.form] == before + 2
        assert got.dtype == torch.float32 and got.shape == (m, n)
        assert torch.equal(got, again), (splits, plan)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_kahan_gemm_split_sweep_matches_plain(card):
    """16 Kahan blocks of 128 cut into every split count from 1 to 16:
    each within the plain loop's tolerance and bitwise repeatable."""
    m, k, n = 64, 2048, 256
    a = torch.from_numpy(_rand((m, k), 28)).to(card)
    b = torch.from_numpy(_rand((k, n), 29)).to(card)
    want = kahan_matmul_plain(a, b, 128)
    counts = set()
    for splits in range(1, 17):
        plan = kahan_plan(m, n, k, 128, torch.float32, True, splits)
        assert plan.form == "mma"
        counts.add(plan.splits)
        got = kahan_gemm(a, b, 128, splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(got, kahan_gemm(a, b, 128, splits=splits))
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert counts == {1, 2, 3, 4, 6, 8, 16}


@pytest.mark.parametrize("which", ["a", "b"])
def test_kahan_gemm_misaligned_pointer_takes_the_general_form(card, which):
    m, k, n = 64, 256, 128
    ops = {"a": torch.from_numpy(_rand((m, k), 37)).to(card),
           "b": torch.from_numpy(_rand((k, n), 38)).to(card)}
    v = ops[which]
    buf = torch.empty(v.numel() + 1, device=card)
    ops[which] = buf[1:].view(v.shape)
    ops[which].copy_(v)
    before = kahan_gemm.launches_by_variant["general"]
    got = kahan_gemm(ops["a"], ops["b"], 64)
    torch.cuda.synchronize()
    assert kahan_gemm.launches_by_variant["general"] == before + 1
    torch.testing.assert_close(got, kahan_matmul_plain(ops["a"], ops["b"],
                                                       64),
                               atol=1e-4, rtol=1e-4)


def test_kahan_gemm_empty_k_writes_zeros(card):
    before = kahan_gemm.launches_by_variant["general"]
    got = kahan_gemm(torch.empty(8, 0, device=card),
                     torch.empty(0, 16, device=card))
    torch.cuda.synchronize()
    assert kahan_gemm.launches_by_variant["general"] == before + 1
    assert torch.equal(got, torch.zeros(8, 16, device=card))


@pytest.mark.parametrize("falling", [False, True])
def test_kahan_gemm_kernel_on_hostile_input(card, falling):
    """K = 4096 over 8 decades with alternating signs, 256 rows: 64-deep
    Kahan blocks stay within 8 float32 ulps of the largest output
    (~4.9e8) with the magnitudes rising or falling along K, and with
    them falling they err at least 2x less than one K-deep block. With
    them rising both read ~3 ulps, so their ratio is rounding noise and
    is not held."""
    a, b, exact = hostile_input(falling=falling)
    exact = torch.from_numpy(exact)
    ta, tb = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    err = {bk: float((kahan_gemm(ta, tb, bk).double().cpu() - exact).abs()
                     .max()) for bk in (64, a.shape[1])}
    assert err[64] <= 8 * 2.0 ** -23 * float(exact.abs().max()), err
    if falling:
        assert 2.0 * err[64] <= err[a.shape[1]], err


def test_kahan_gemm_raises_on_what_the_kernel_does_not_take(card):
    a = torch.ones(8, 16, device=card)
    b = torch.ones(16, 4, device=card)
    with pytest.raises(TypeError):
        kahan_gemm(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        kahan_gemm(torch.ones(8, 32, device=card)[:, ::2], b)
    with pytest.raises(ValueError, match="contiguous"):
        kahan_gemm(a.t().contiguous().t(), b)
    # kahan_matmul makes such an operand contiguous once and launches
    before = kahan_gemm.launches
    got = kahan_matmul(torch.ones(8, 32, device=card)[:, ::2], b, chunk=4)
    torch.cuda.synchronize()
    assert kahan_gemm.launches == before + 1
    assert torch.equal(got, torch.full((8, 4), 16.0, device=card))


@pytest.mark.parametrize("view", ["row", "column"])
def test_kahan_matmul_on_broadcast_views(card, view):
    """Broadcast operands (a stride of 0) through ``kahan_matmul`` and
    ``gemm(precision_level=1)`` equal the plain loop on their contiguous
    copies; ``kahan_gemm`` refuses them."""
    m, k, n = 70, 600, 33
    v = torch.from_numpy(_rand((k,), 24)).to(card)
    w = torch.from_numpy(_rand((k,), 25)).to(card)
    if view == "row":  # strides (0, 1): every row the same
        a, b = v[None].expand(m, k), w[:, None].expand(k, n)
    else:  # strides (1, 0): every column the same
        a, b = v[:m, None].expand(m, k), w[None, :n].expand(k, n)
    want = kahan_matmul_plain(a.contiguous(), b.contiguous(), 64)
    torch.testing.assert_close(kahan_matmul(a, b, chunk=64), want,
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(
        gemm(a, b, precision_level=1),
        kahan_matmul_plain(a.contiguous(), b.contiguous()),
        atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        kahan_gemm(a, b.contiguous())


@pytest.mark.parametrize("level", [0, 1, 2])
def test_gemm_is_full_float32_with_tf32_on(card, level):
    """allow_tf32 on for the process: gemm() at every level still
    computes float32 products, and the control (a plain matmul under
    the same switch) is as coarse as TF32."""
    a = torch.from_numpy(_rand((256, 4096), 22, 0.5)).to(card)
    b = torch.from_numpy(_rand((4096, 256), 23, 0.5)).to(card)
    ref = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        got = gemm(a, b, precision_level=level)
        control = torch.matmul(a, b)
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = saved
    share = float(((got.double() - ref).abs() / scale).max())
    control_share = float(((control.double() - ref).abs() / scale).max())
    assert share <= 2e-6 < control_share, (share, control_share)


def _bf16_ulp(v):
    """One bf16 ulp at each value of ``v`` (float64): 2^(e - 8) for
    |v| = m 2^e, m in [0.5, 1)."""
    _, e = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), e - 8)


@pytest.mark.parametrize("k", [9216, 4096])
def test_bf16_backward_products_round_once_under_the_policy(card, k):
    """fc6 (K 9216) and fc7 (K 4096) at batch 128 under the bf16 policy,
    with bf16 reduced-precision reductions switched on by the caller:
    inside ``Policy.backends()`` LinearActFunction's dx and dw are within
    one bf16 ulp of the product of the same bf16 operands rounded once
    (float64 here), and the caller's switch is back after. Beside the ulp
    the limit allows a float32 sum's own order error, 4 sqrt(depth)
    2^-24 of |a| @ |b|: it matters only where the terms cancel to far
    below their size. A sum reduced in bf16 errs by ~2^-9 of its
    partial sums, some 100 times more."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_bf16_reduced_precision_reduction
    m, n = 128, 4096
    x = torch.from_numpy(_rand((m, k), 40)).to(card, torch.bfloat16)
    w = torch.from_numpy(_rand((k, n), 41, k ** -0.5)).to(card,
                                                           torch.bfloat16)
    b = torch.from_numpy(_rand((n,), 42, 0.1)).to(card)
    g = torch.from_numpy(_rand((m, n), 43)).to(card, torch.bfloat16)
    for t in (x, w, b):
        t.requires_grad_()
    matmul.allow_bf16_reduced_precision_reduction = True
    try:
        with get_policy("bfloat16").backends():
            assert not matmul.allow_bf16_reduced_precision_reduction
            y = LinearActFunction.apply(x, w, b, "strict_relu",
                                        torch.bfloat16)
            y.backward(g)
            torch.cuda.synchronize()
        assert matmul.allow_bf16_reduced_precision_reduction
    finally:
        matmul.allow_bf16_reduced_precision_reduction = saved
    dpre = (g.float() * (y.detach().float() > 0).float()).to(
        torch.bfloat16).double()
    xd, wd = x.detach().double(), w.detach().double()
    refs = {"dx": (dpre @ wd.t(), dpre.abs() @ wd.abs().t(), n),
            "dw": (xd.t() @ dpre, xd.abs().t() @ dpre.abs(), m)}
    for name, got in (("dx", x.grad), ("dw", w.grad)):
        ref, scale, depth = refs[name]
        assert got.dtype == torch.bfloat16
        err = (got.double() - ref.to(torch.bfloat16).double()).abs()
        limit = _bf16_ulp(ref) + 4 * depth ** 0.5 * 2.0 ** -24 * scale
        assert bool((err <= limit).all()), (
            name, float((err / limit).max()))


#: K1 at the shapes the BASELINE paths give it: (M, K, N, epilogue)
BASELINE_GEMMS = [(500, 784, 100, "tanh"), (250, 512, 100, "relu"),
                  (250, 576, 64, "linear"), (500, 100, 784, "linear")]


@pytest.mark.parametrize("shape", BASELINE_GEMMS,
                         ids=["%dx%dx%d-%s" % s for s in BASELINE_GEMMS])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_baseline_shapes_match_plain(card, dtype, shape):
    """The MNIST, CIFAR and autoencoder layers' products with their
    bias and epilogue, on the form :func:`gemm_plan` picks (float32
    tiles; bf16 tensor cores where N and K are multiples of 8, the
    general kernel at N or K = 100), within the plain version's
    tolerance (K up to 784: float32 1e-4, bf16 one ulp)."""
    m, k, n, activation = shape
    dt = getattr(torch, dtype)
    x = torch.from_numpy(_rand((m, k), 50)).to(card, dt)
    w = torch.from_numpy(_rand((k, n), 51, k ** -0.5)).to(card, dt)
    bias = torch.from_numpy(_rand((n,), 52, 0.1)).to(card)
    plan = gemm_plan(m, n, k, dt)
    if dtype == "float32":
        assert plan.form == "tiles"
    else:
        assert plan.form == ("tensor_core" if n % 8 == 0 and k % 8 == 0
                             else "general")
    before = linear_act.launches_by_variant[plan.form]
    got = linear_act(x, w, bias, activation, torch.float32)
    torch.cuda.synchronize()
    assert linear_act.launches_by_variant[plan.form] == before + 1
    want = linear_act_plain(x, w, bias, activation, torch.float32)
    tol = 1e-4 if dtype == "float32" else 1e-2
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def _layer_on(device, layer):
    from veles_tpu_torch.nn.conv import Deconv
    from veles_tpu_torch.nn.pooling import AvgPooling, MaxAbsPooling
    if layer == "deconv":
        module = Deconv((7, 6, 5), n_kernels=4, kx=3, ky=3,
                        sliding=(2, 2), padding="SAME", include_bias=True,
                        device=device, trainable=True)
        params = module.init_jax_params(numpy.random.RandomState(60))
        from veles_tpu_torch.convert import params_from_jax
        params_from_jax([module], [params])
        return module
    cls = AvgPooling if layer == "avg_pooling" else MaxAbsPooling
    return cls((7, 6, 5), kx=3, ky=3, sliding=(2, 2))


@pytest.mark.parametrize("layer", ["deconv", "avg_pooling",
                                   "maxabs_pooling"])
def test_baseline_layers_on_the_card_match_the_cpu(card, layer):
    """``Deconv`` (cuDNN's transposed convolution, its bias gradient
    through K6), ``AvgPooling`` and ``MaxAbsPooling`` on the card against
    the same modules on the CPU: output and input gradient within 1e-5
    (float32 sums of a few dozen terms in another order; the max-abs
    selections exactly)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for device in (card, torch.device("cpu")):
            module = _layer_on(device, layer)
            x = torch.from_numpy(_rand((3, 7, 6, 5), 61)).to(device)
            x.requires_grad_()
            y = module(x)
            y.backward(torch.from_numpy(_rand(tuple(y.shape), 62)).to(
                device))
            grads = [x.grad] + [p.grad for p in module.parameters()]
            runs.append([y.detach()] + grads)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    tol = 0 if layer == "maxabs_pooling" else 1e-5
    for got, want in zip(*runs):
        torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=tol)


#: K1 on the sequence paths: the attention projections, (batch * seq,
#: dim) rows by (dim, dim) with the bias and the linear epilogue,
#: float32 under every policy (the layer never casts): the trained
#: batches of ``bench_all.py``'s attention (64 x 256) and moe (64 x 128)
#: configurations and served buckets of one and 16 samples
SEQUENCE_GEMMS = [(64 * 256, 256, 256), (64 * 128, 256, 256),
                  (256, 256, 256), (16 * 256, 256, 256), (128, 256, 256)]
#: K6 on the sequence paths: the projections' bias gradients and the
#: head's
SEQUENCE_REDUCES = [(64 * 256, 256), (64 * 128, 256), (64, 8)]


@pytest.mark.parametrize("shape", SEQUENCE_GEMMS,
                         ids=["%dx%dx%d" % s for s in SEQUENCE_GEMMS])
def test_gemm_sequence_shapes_match_plain(card, shape):
    """The projections' products on the ``tiles`` form, within the
    float32 tolerance of the plain version, two calls bitwise equal."""
    m, k, n = shape
    x = torch.from_numpy(_rand((m, k), 70)).to(card)
    w = torch.from_numpy(_rand((k, n), 71, k ** -0.5)).to(card)
    bias = torch.from_numpy(_rand((n,), 72, 0.1)).to(card)
    assert gemm_plan(m, n, k, torch.float32).form == "tiles"
    before = linear_act.launches_by_form[(m, k, n, torch.float32, True)]
    got = linear_act(x, w, bias, "linear")
    again = linear_act(x, w, bias, "linear")
    torch.cuda.synchronize()
    assert linear_act.launches_by_form[
        (m, k, n, torch.float32, True)] == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, linear_act_plain(x, w, bias, "linear"),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", SEQUENCE_REDUCES)
def test_column_sum_sequence_shapes_match_plain(card, shape):
    x = torch.from_numpy(_rand(shape, 73)).to(card)
    got = column_sum(x)
    torch.cuda.synchronize()
    assert torch.equal(got, column_sum(x))
    _assert_column_sums(x, got)


@pytest.mark.parametrize("kind", ["attention", "moe"])
def test_sequence_layers_on_the_card_match_the_cpu(card, kind):
    """An attention layer (4 heads, causal) and a MoE layer (4 experts)
    over (3, 64, 64) inputs on the card, through K1 and K6, against the
    same modules on the CPU with their plain versions: output, input
    gradient and every parameter gradient within 1e-4 of its norm
    (float32 sums of up to 256 terms in other orders), the MoE's routing
    exactly (its router probabilities are float32 softmaxes of the same
    products: the check fails loudly on a near tie)."""
    layers = [{"type": "attention", "heads": 4, "causal": True}
              if kind == "attention" else
              {"type": "moe", "n_experts": 4, "capacity_factor": 1.0}]
    policy = get_policy("float32")
    runs = []
    for device in (card, torch.device("cpu")):
        model = build_model(layers, (64, 64), seed=74, device=device,
                            trainable=True)
        x = torch.from_numpy(_rand((3, 64, 64), 75)).to(device)
        x.requires_grad_()
        with policy.backends():
            y = model(x)
            y.backward(torch.from_numpy(_rand((3, 64, 64), 76)).to(device))
        runs.append([y.detach(), x.grad] +
                    [p.grad for p in model.parameters()])
    for got, want in zip(*runs):
        got = got.cpu()
        assert float((got - want).norm()) <= 1e-4 * float(want.norm())


SMALL_ALEXNET_FILE = '''
from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,
                                            SyntheticImageLoader,
                                            small_alexnet_layers)
from veles_tpu_torch.snapshotter import SnapshotterToFile


def run(load, main):
    wf, restored = load(
        AlexNetWorkflow,
        loader_factory=lambda wf: SyntheticImageLoader(
            workflow=wf, n_train=256, n_valid=64, side=64, n_classes=10,
            minibatch_size=64),
        layers=small_alexnet_layers(10), max_epochs=1)
    if not restored:
        snap = SnapshotterToFile(wf, directory=SNAPS, time_interval=0,
                                 compression="", name="snapshotter")
        snap.link_from(wf.decision)
        snap.gate_skip = ~wf.loader.epoch_ended
    main()
'''


def _workflow_weights(wf):
    from veles_tpu_torch.convert import layer_params, to_jax_layout
    return [to_jax_layout(layer_params(f.module)) for f in wf.forwards]


def test_cli_epoch_of_small_alexnet_on_the_card(card, tmp_path):
    """One epoch of the small AlexNet through ``python -m
    veles_tpu_torch`` on the card: finite metrics, the kernels launched,
    a snapshot written."""
    from veles_tpu_torch.__main__ import Main
    path = tmp_path / "small_alexnet.py"
    path.write_text("SNAPS = %r\n" % str(tmp_path / "snaps") +
                    SMALL_ALEXNET_FILE)
    linear_act.launches = uniform_fill.launches = 0
    main = Main()
    assert main.run([str(path), "-s", "7"]) == 0
    wf = main.workflow
    assert wf.forwards[0].weights.device.type == "cuda"
    (hist,) = wf.decision.epoch_history
    assert numpy.isfinite(hist["train"]["normalized"])
    assert numpy.isfinite(wf.evaluator.loss)
    assert linear_act.launches > 0 and uniform_fill.launches > 0
    assert (tmp_path / "snaps" / "wf.0.pickle").exists()


@pytest.mark.parametrize("direction", ["card_to_cpu", "cpu_to_card"])
def test_snapshot_crosses_between_card_and_cpu(card, tmp_path, direction):
    """A snapshot written on one side loads on the other with equal
    parameters and solver state."""
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.convert import solver_state_to_jax
    from veles_tpu_torch.snapshotter import load_workflow
    path = tmp_path / "small_alexnet.py"
    path.write_text("SNAPS = %r\n" % str(tmp_path / "snaps") +
                    SMALL_ALEXNET_FILE)
    write, read = (("auto", "cpu") if direction == "card_to_cpu"
                   else ("cpu", "cuda"))
    main = Main()
    assert main.run([str(path), "-s", "7", "-a", write]) == 0
    wf = load_workflow(str(tmp_path / "snaps" / "wf.0.pickle"))
    wf.initialize(device=read)
    assert wf.forwards[0].weights.device.type == read
    for got, want in zip(_workflow_weights(wf),
                         _workflow_weights(main.workflow)):
        for k in want:
            numpy.testing.assert_array_equal(got[k], want[k])
    for gd, ref in zip(wf.gds, main.workflow.gds):
        if gd.opt_state:
            got = solver_state_to_jax([gd.opt_state])[0]["velocity"]
            want = solver_state_to_jax([ref.opt_state])[0]["velocity"]
            for k in want:
                numpy.testing.assert_array_equal(got[k], want[k])


def test_cli_eager_epoch_of_small_alexnet_on_the_card(card, tmp_path):
    """One epoch of the small AlexNet through ``python -m veles_tpu_torch
    --eager`` on the card: every kernel launched as often as by the
    fused CLI run of the same file, the same history, and parameters
    within 1e-2 of their change (cuDNN's backward may add in another
    order outside deterministic mode)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.ops.lrn import lrn_backward, lrn_forward
    from veles_tpu_torch.ops.reduce import column_sum
    path = tmp_path / "small_alexnet.py"
    path.write_text("SNAPS = %r\n" % str(tmp_path / "snaps") +
                    SMALL_ALEXNET_FILE)
    wrappers = (linear_act, lrn_forward, lrn_backward, column_sum,
                uniform_fill)
    runs = {}
    for mode, flags in (("init", ["--dry-run", "init"]), ("fused", []),
                        ("eager", ["--eager"])):
        prng._generators.clear()
        for fn in wrappers:
            fn.launches = 0
        main = Main()
        assert main.run([str(path), "-s", "7"] + flags) == 0
        runs[mode] = (main.workflow, [fn.launches for fn in wrappers])
    eager, fused = runs["eager"][0], runs["fused"][0]
    launched = dict(zip(("linear_act", "lrn_forward", "lrn_backward",
                         "column_sum", "uniform_fill"), runs["eager"][1]))
    assert runs["eager"][1] == runs["fused"][1]
    assert launched["linear_act"] and launched["column_sum"] and \
        launched["uniform_fill"]  # the small AlexNet has no LRN
    assert eager.decision.epoch_history[0]["train"]["samples"] == 256
    assert numpy.isfinite(eager.evaluator.loss)
    for got, want, start in zip(_workflow_weights(eager),
                                _workflow_weights(fused),
                                _workflow_weights(runs["init"][0])):
        for k in want:
            change = numpy.abs(want[k] - start[k]).max()
            assert numpy.abs(got[k] - want[k]).max() <= 1e-2 * change


def test_package_export_on_the_card(card, tmp_path):
    """A package written from the card's tensors holds them bit for bit
    in the JAX layout, and a dense package served on the card (K1)
    answers as it does on the CPU."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.convert import layer_params, to_jax_layout
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.fullbatch import ProviderLoader
    from veles_tpu_torch.serving.model_store import (ModelLoadError,
                                                     ModelStore,
                                                     _read_package)
    from veles_tpu_torch.standard_workflow import StandardWorkflow
    path = tmp_path / "small_alexnet.py"
    path.write_text("SNAPS = %r\n" % str(tmp_path / "snaps") +
                    SMALL_ALEXNET_FILE)
    main = Main()
    assert main.run([str(path), "-s", "7", "--eager"]) == 0
    package = main.workflow.package_export(str(tmp_path / "alexnet.tar"))
    contents, members = _read_package(package)
    for unit, entry in zip(main.workflow.forwards,
                           contents["workflow"]["units"]):
        for key, value in to_jax_layout(layer_params(unit.module)).items():
            assert members[entry["data"][key]].tobytes() == value.tobytes()
    with pytest.raises(ModelLoadError, match="Conv"):
        ModelStore().load(package)

    def provider():
        rng = numpy.random.RandomState(0)
        x = rng.rand(300, 64).astype(numpy.float32)
        y = rng.randint(0, 10, 300).astype(numpy.int32)
        return x[:240], y[:240], x[240:], y[240:]

    prng._generators.clear()
    prng.get().seed(5)
    wf = StandardWorkflow(
        DummyLauncher(), loader=lambda w: ProviderLoader(
            workflow=w, provider=provider, minibatch_size=60),
        layers=[{"type": "all2all_tanh", "output_sample_shape": 100},
                {"type": "softmax", "output_sample_shape": 10}],
        max_epochs=1)
    wf.initialize(device="cuda")
    wf.run()
    dense = wf.package_export(str(tmp_path / "dense"))
    linear_act.launches = 0
    batch = numpy.random.RandomState(1).rand(64, 64).astype(numpy.float32)
    got = ModelStore().load(dense)(batch)
    assert linear_act.launches >= 1
    want = ModelStore().load(dense, device="cpu")(batch)
    numpy.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


# -- out-of-core training: the staging rings and the residencies ------------


def test_staging_ring_orders_refills_and_bounds_residency(card):
    """A 2-slot ring over 6 placements: each read (after a sleep that
    holds the compute stream) sees its own shard's values though the
    worker refills behind it, and at most two shards' buffers exist."""
    from veles_tpu_torch.loader import prefetch
    ring = prefetch.StagingRing(2, card)
    host = [torch.full((1 << 20,), float(i)).pin_memory() for i in range(6)]
    pipe = prefetch.PrefetchPipeline(lambda i: ring.place((host[i],)), 6,
                                     depth=1, workers=1, name="ring")
    pipe.start()
    sums = []
    for i in range(6):
        staged = pipe.get()[0]
        (x,) = staged.wait()
        torch.cuda._sleep(20000000)
        sums.append(x.sum())
        ring.release(staged)
        assert ring.resident_bytes() <= 2 * (1 << 22)
    pipe.close()
    assert [float(s) for s in sums] == [float(i << 20) for i in range(6)]
    ring.clear()
    with pytest.raises(RuntimeError, match="pinned"):
        prefetch.StagingRing(2, card).place((torch.zeros(4),))


def _small_trainer(card, **residency):
    from veles_tpu_torch import prng
    from veles_tpu_torch.models.alexnet import (ALEXNET_TRAINING,
                                                SyntheticImageLoader,
                                                small_alexnet_layers)
    prng.get().seed(3)
    prng.get("loader").seed(4)
    loader = SyntheticImageLoader(n_train=70, n_valid=24, side=32,
                                  n_classes=10, minibatch_size=16)
    return build_training(small_alexnet_layers(10), (32, 32, 3), loader,
                          seed=1, device=card, **dict(ALEXNET_TRAINING,
                                                      **residency))


@pytest.mark.parametrize("residency", [
    {"stream": True}, {"stream": True, "prefetch_depth": 0},
    {"offload": True}, {"offload": True, "offload_depth": 0}],
    ids=["streamed", "streamed_inline", "offloaded", "offloaded_inline"])
def test_out_of_core_equals_resident_on_the_card(card, monkeypatch,
                                                 residency):
    """Two epochs streamed (one minibatch a shard) or offloaded (one
    group a weighted layer) on the card, in deterministic mode, against
    the resident in-core run: every loss, confusion count, parameter and
    velocity equal."""
    monkeypatch.setenv("VELES_SHARD_MB", "0.2")
    monkeypatch.setenv("VELES_OFFLOAD_GROUP_MB", "0.0001")
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        runs = []
        for kw in ({}, residency):
            trainer = _small_trainer(card, **kw)
            history = [trainer.run_epoch(e) for e in range(2)]
            trainer.shutdown()
            runs.append((trainer, history))
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
    (want, want_history), (got, history) = runs
    assert got.streaming or got.offloaded
    for x, y in zip(history, want_history):
        for klass in ("validation", "train"):
            numpy.testing.assert_array_equal(x[klass]["losses"],
                                             y[klass]["losses"])
        numpy.testing.assert_array_equal(x["validation"]["confusion"],
                                         y["validation"]["confusion"])
    for pa, pb in zip(got.params, want.params):
        for k in pa:
            assert torch.equal(pa[k].cpu(), pb[k].cpu()), k
    for sa, sb in zip(got.states, want.states):
        for k in (sa or {}).get("velocity", {}):
            assert torch.equal(sa["velocity"][k].cpu(),
                               sb["velocity"][k].cpu())


# -- telemetry and the result cache on the card -------------------------------

def test_memory_gauges_read_the_allocator(card):
    """``sample_memory``'s live bytes of the card equal
    ``torch.cuda.memory_allocated`` at the moment of the sample, its peak
    ``max_memory_allocated``, and its limit the card's total memory."""
    from veles_tpu_torch.telemetry import profiler
    from veles_tpu_torch.telemetry.registry import MetricsRegistry
    held = torch.empty(64 << 20, dtype=torch.uint8, device=card)
    reg = MetricsRegistry()
    sample = profiler.sample_memory(reg)
    index = card.index if card.index is not None else 0
    entry = sample["devices"]["cuda:%d" % index]
    assert entry["live_bytes"] == torch.cuda.memory_allocated(index)
    assert entry["peak_bytes"] == torch.cuda.max_memory_allocated(index)
    assert entry["limit_bytes"] == torch.cuda.get_device_properties(
        index).total_memory
    gauge = reg.get("veles_hbm_live_bytes").labels(device="cuda:%d" % index)
    assert gauge.value == entry["live_bytes"] >= held.numel()


def test_cache_hit_launches_no_kernel(card):
    """A served request answered from the result cache returns the first
    reply's row bit for bit and launches neither K1 nor K3."""
    from veles_tpu_torch.serving.engine import DynamicBatcher
    from veles_tpu_torch.serving.cache import ResultCache
    from veles_tpu_torch.serving.model_store import ServeableModel
    from veles_tpu_torch.serving.replica import ReplicaPool
    model = ServeableModel.from_layers(small_alexnet_layers(10),
                                       (32, 32, 3), seed=3, device=card)
    pool = ReplicaPool(model, n_replicas=1, max_batch_size=4)
    engine = DynamicBatcher(pool, batch_timeout_ms=1,
                            cache=ResultCache(max_bytes=1 << 20))
    try:
        x = _rand((3, 32, 32, 3), 7)
        first = [engine.submit(row).result(timeout=60) for row in x]
        launched = (linear_act.launches, lrn_forward.launches)
        again = [engine.submit(row).result(timeout=60) for row in x]
        assert (linear_act.launches, lrn_forward.launches) == launched
        assert launched[0] > 0 and launched[1] > 0
        for a, b in zip(first, again):
            assert a is b or numpy.array_equal(a, b)
        assert engine.cache.stats()["hits"] == 3
    finally:
        engine.stop()
        pool.stop()


def test_sharded_generation_round_trips_the_cards_state(card, tmp_path):
    """The small AlexNet trained an epoch on the card by the SPMD trainer
    (``1x1``; K1, K3, K4, K6, K7), its parameters and SGD state cut as a
    sharded generation, restored on the card and on the CPU: every leaf
    equal to the bit, the restored state on the device it was asked
    for."""
    from veles_tpu_torch import prng, snapshotter
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.alexnet import AlexNetWorkflow
    from veles_tpu_torch.parallel.elastic import (ElasticContext,
                                                  save_elastic_checkpoint)
    from veles_tpu_torch.parallel.gspmd import GSPMDTrainer
    from veles_tpu_torch.train.runner import trainer_for
    prng.get().seed(3)
    prng.get("loader").seed(4)
    wf = AlexNetWorkflow(
        DummyLauncher(), layers=small_alexnet_layers(10), max_epochs=1,
        momentum=0.9, loader_factory=lambda w: SyntheticImageLoader(
            workflow=w, n_train=64, n_valid=16, side=32, n_classes=10,
            minibatch_size=16))
    wf.initialize(device=card)
    trainer = trainer_for(wf, GSPMDTrainer)
    trainer.train(max_epochs=1)
    assert trainer.params[0]["weights"].device.type == card.type
    ctx = ElasticContext(0, 1, 0, snapshot_dir=str(tmp_path))
    save_elastic_checkpoint(trainer, ctx, trainer.params, trainer.states,
                            wf, compression="")
    want = trainer.pull_params()
    trainer.shutdown()

    def flat(params, states):
        out = {}
        for i, (layer, state) in enumerate(zip(params, states)):
            for k, v in layer.items():
                out["%d.%s" % (i, k)] = v
            for k, v in (state.get("velocity") or {}).items():
                out["%d.velocity.%s" % (i, k)] = v
            if "step" in state:
                out["%d.step" % i] = state["step"]
        return out

    expected = flat(*want)
    for device in (card, torch.device("cpu")):
        restored, path = snapshotter.restore_latest(str(tmp_path))
        assert path.endswith("wf_g0.1.shards")
        restored.workflow = DummyLauncher()
        restored.initialize(device=device)
        again = trainer_for(restored, GSPMDTrainer)
        got = flat(*again.pull_params())
        again.shutdown()
        assert sorted(got) == sorted(expected)
        for key, value in expected.items():
            assert got[key].device.type == device.type, key
            assert torch.equal(got[key].cpu(), value.cpu()), key


#: the warm worker's card memory after its second job may exceed that
#: after its first by at most this (a job's workflow, trainer and
#: tensors are released, the allocator's idle blocks emptied)
WARM_MEMORY_SLACK = 16 << 20


def test_warm_worker_releases_the_card_and_builds_once(card, tmp_path):
    """Two jobs of the small AlexNet in one warm evaluator process
    (``parallel/warm_pool.py``) on the card: the second's allocated
    bytes after it no more than the first's (plus a slack), the kernel
    libraries built before it untouched by it (no rebuild), K1, K6 and
    K7 launched by each job."""
    import os
    import sys
    from veles_tpu_torch.parallel.warm_pool import WarmPool
    path = tmp_path / "small_alexnet.py"
    path.write_text("SNAPS = %r\n" % str(tmp_path / "snaps") +
                    SMALL_ALEXNET_FILE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))] +
        sys.path))

    def libraries():
        if not os.path.isdir(build.BUILD_DIR):
            return {}
        return {n: os.stat(os.path.join(build.BUILD_DIR, n)).st_mtime_ns
                for n in os.listdir(build.BUILD_DIR) if n.endswith(".so")}

    replies, built = [], []
    with WarmPool(workers=1, env=env) as pool:
        for seed in (7, 8):
            result = str(tmp_path / ("r%d.json" % seed))
            reply = pool.run([str(path), "-s", str(seed), "--result-file",
                              result, "-v", "warning"], result_file=result)
            assert reply["ok"], reply
            replies.append(reply)
            built.append(libraries())
    assert replies[0]["pid"] == replies[1]["pid"]
    assert built[1] == built[0] and built[0]
    first, second = (r["cuda_allocated"] for r in replies)
    assert second <= first + WARM_MEMORY_SLACK, (first, second)
    before = {}
    for reply in replies:
        counts = reply["kernel_counts"]
        for name in ("gemm_bias_act", "column_reduce", "uniform_fill"):
            assert counts[name]["launches"] > before.get(name, 0), name
        before = {k: v["launches"] for k, v in counts.items()}


def test_autotune_search_at_fc7_m16_matches_the_plain_version(
        card, tmp_path, monkeypatch):
    """A ``search`` of K1's split counts at the served fc7 (16 rows,
    4096 -> 4096, strict relu): the winner is persisted, ``linear_act``
    then launches at its split count, and its output is the plain
    version's (1e-4)."""
    from veles_tpu_torch.ops import autotune
    monkeypatch.setenv("VELES_AUTOTUNE_CACHE", str(tmp_path / "tune.json"))
    monkeypatch.setenv("VELES_AUTOTUNE", "search")
    monkeypatch.setenv("VELES_AUTOTUNE_BUDGET_S", "5")
    autotune.reset()
    try:
        impl, cfg = autotune.linear_plan(16, 4096, 4096, torch.float32,
                                         "strict_relu", torch.float32, True,
                                         "cuda")
        assert impl == "kernel" and autotune.summary()["entries"]
        want_splits = gemm_plan(16, 4096, 4096, torch.float32, True,
                                cfg["splits"]).splits
        rng = numpy.random.RandomState(5)
        x = torch.from_numpy(rng.rand(16, 4096).astype("f") - 0.5).cuda()
        w = torch.from_numpy(rng.rand(4096, 4096).astype("f") - 0.5).cuda()
        b = torch.from_numpy(rng.rand(4096).astype("f") - 0.5).cuda()
        before = dict(linear_act.launches_by_splits)
        got = linear_act(x, w, b, "strict_relu")
        grown = {key: n - before.get(key, 0) for key, n in
                 linear_act.launches_by_splits.items()
                 if n != before.get(key, 0)}
        assert grown == {(16, 4096, 4096, torch.float32, "stream",
                          want_splits): 1}
        torch.testing.assert_close(
            got, linear_act_plain(x, w, b, "strict_relu"), atol=1e-4,
            rtol=1e-4)
    finally:
        autotune.reset()


def test_confusion_segment_on_the_card_equals_the_argmax_matrix(card):
    """The train-class confusion sweep through K1 and K3 on the card
    equals the matrix numpy builds from the argmax of the same forward's
    logits (the scatter-add held), and a confusion plotter's snapshot
    holds host arrays only."""
    import pickle
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.plotting_units import MatrixPlotter
    trainer = _small_trainer(card)
    idx = trainer._segment_indices(TRAIN)
    conf = trainer.confusion_segment(None, idx)
    assert conf.device.type == "cuda" and conf.dtype == torch.int32
    logits, truth = [], []
    with torch.no_grad():
        for row in idx:
            x, labels, valid = trainer._gather(
                torch.from_numpy(row).to(card))
            out = trainer._forward(x, False).reshape(len(row), -1)
            logits.append(out[valid].cpu().numpy())
            truth.append(labels[valid].cpu().numpy())
    logits, truth = numpy.concatenate(logits), numpy.concatenate(truth)
    want = numpy.zeros(conf.shape, numpy.int32)
    numpy.add.at(want, (truth, logits.argmax(axis=1)), 1)
    assert int(conf.sum()) == trainer.loader.class_lengths[TRAIN]
    assert int((conf.cpu().numpy() != want).sum()) == 0
    plotter = MatrixPlotter(DummyWorkflow(), name="confusion")
    plotter.input = conf
    plotter.fill()
    plotter.stripped_pickle = True
    clone = pickle.loads(pickle.dumps(plotter))
    assert isinstance(clone.matrix, numpy.ndarray)
    numpy.testing.assert_array_equal(clone.matrix, want)
    assert not [k for k, v in vars(clone).items()
                if isinstance(v, torch.Tensor) and v.device.type == "cuda"]
