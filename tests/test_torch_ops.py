"""The port's ``ops`` layer (``veles_tpu_torch.ops``) against the JAX
package's ``veles_tpu.ops`` on the same numpy inputs, on the CPU.

The port's CUDA wrappers run their plain PyTorch versions here. The
JAX side runs ``pallas_kahan_gemm`` in interpret mode and everything
else through XLA on the CPU, with the autotuner off so that no cached
plan steers it.

Tolerances, stated per test:
* float32 products: both sides sum the same float32 products in
  different orders (XLA's dot vs torch's matmul). With operands of unit
  scale over K <= 1000 the sums are O(1), and reordering moves them by a
  few float32 ulps: atol = rtol = 1e-5 (~100 ulp at 1.0). The Kahan
  compensation is written out on both sides in the same order, so only
  the block products differ.
* a bfloat16 result: one bf16 ulp (2^-8 relative), 1e-2.
* reductions, gather, normalisation, join: float32 sums of at most 33
  values, 1e-6 relative; the rest is exact.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.ops.gemm import (_kahan_matmul_loop,  # noqa: E402
                                epilogue_fn as jax_epilogue_fn,
                                pairwise_matmul as jax_pairwise_matmul,
                                pallas_kahan_gemm)
from veles_tpu.ops import (gather_minibatch as jax_gather,  # noqa: E402
                           gemm as jax_gemm, join_arrays as jax_join,
                           matrix_reduce as jax_reduce,
                           mean_disp_normalize as jax_normalize)
from veles_tpu.ops.benchmark import \
    gemm_benchmark as jax_gemm_benchmark  # noqa: E402
from veles_tpu.ops.normalize import \
    compute_mean_disp as jax_mean_disp  # noqa: E402
from veles_tpu_torch.ops import (gather_minibatch, gemm,  # noqa: E402
                                 join_arrays, matrix_reduce,
                                 mean_disp_normalize)
from veles_tpu_torch.ops.benchmark import gemm_benchmark  # noqa: E402
from veles_tpu_torch.ops.gemm import (epilogue_fn,  # noqa: E402
                                      fusable_activation, full_float32,
                                      kahan_gemm, kahan_matmul,
                                      kahan_matmul_plain, pairwise_matmul)
from veles_tpu_torch.ops.gemm_bench import (ERRORS,  # noqa: E402
                                            format_table, gemm_bench,
                                            hostile_input, small_shapes)
from veles_tpu_torch.ops.normalize import compute_mean_disp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("VELES_AUTOTUNE", "off")


def _operands(m, k, n, seed):
    rng = numpy.random.RandomState(seed)
    a = rng.randn(m, k).astype(numpy.float32)
    b = (rng.randn(k, n) / numpy.sqrt(k)).astype(numpy.float32)
    return a, b


def _bf16(x):
    """x rounded to bf16, as float32 numpy (the values both sides see)."""
    return numpy.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [None, 64, 256, 1000])
def test_kahan_plain_matches_the_jax_loop(chunk, dtype):
    """K = 1000: the default 512 and 64, 256 leave a ragged last block
    (zero-padded on both sides); chunk = K is one block."""
    a, b = _operands(24, 1000, 40, seed=1)
    if dtype == "bfloat16":
        a, b = _bf16(a), _bf16(b)
    want = _kahan_matmul_loop(
        jnp.asarray(a, dtype), jnp.asarray(b, dtype), chunk)
    tdt = getattr(torch, dtype)
    got = kahan_matmul_plain(torch.from_numpy(a).to(tdt),
                             torch.from_numpy(b).to(tdt), chunk)
    assert got.dtype == torch.float32 and got.shape == (24, 40)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), **TOL)


@pytest.mark.parametrize("bk", [512, 128])
def test_kahan_plain_matches_pallas_kahan_gemm_interpret(bk):
    """256 x 512 @ 512 x 256 through the Pallas kernel in interpret mode:
    one 512-deep block, or four 128-deep ones compensated in VMEM."""
    a, b = _operands(256, 512, 256, seed=5)
    want = pallas_kahan_gemm(
        jnp.asarray(a), jnp.asarray(b), bm=128, bn=128, bk=bk,
        interpret=True)
    got = kahan_gemm(torch.from_numpy(a), torch.from_numpy(b), bk=bk)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), **TOL)


@pytest.mark.parametrize("rows", [4, 256])
@pytest.mark.parametrize("falling", [False, True])
def test_kahan_on_hostile_input_is_no_worse_than_jax_or_naive(falling, rows):
    """``tests/test_ops.py``'s hostile input (K = 4096 over 8 decades,
    alternating signs), magnitudes rising or falling along K: 64-deep
    compensated blocks against the JAX loop (error within 1% of its) and
    against one naive 4096-deep block."""
    a, b, exact = hostile_input(rows=rows, falling=falling)
    jax_err = numpy.abs(numpy.asarray(_kahan_matmul_loop(
        jnp.asarray(a), jnp.asarray(b), 64)) - exact).max()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    port_err = numpy.abs(kahan_matmul(ta, tb, chunk=64).numpy() -
                         exact).max()
    naive_err = numpy.abs(kahan_matmul(ta, tb, chunk=4096).numpy() -
                          exact).max()
    assert port_err <= jax_err * 1.01
    assert port_err <= naive_err


GEMM_CASES = {
    "plain": {},
    "transpose_a": dict(transpose_a=True),
    "transpose_b": dict(transpose_b=True),
    "both": dict(transpose_a=True, transpose_b=True),
    "alpha_beta_c": dict(alpha=2.0, beta=0.5, c=True),
    "alpha_beta0_c": dict(alpha=-1.5, beta=0.0, c=True),
    "out_bf16": dict(out_dtype="bfloat16", alpha=0.5),
    "bf16_operands": dict(operands="bfloat16", beta=1.0, c=True),
}


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(GEMM_CASES))
def test_gemm_matches_jax(level, case):
    """M = 24, K = 700 (two Kahan blocks, the last ragged; 32 pairwise
    partials), N = 40."""
    kw = dict(GEMM_CASES[case])
    a, b = _operands(24, 700, 40, seed=7)
    c = numpy.random.RandomState(8).randn(24, 40).astype(numpy.float32)
    operands = kw.pop("operands", "float32")
    if operands == "bfloat16":
        a, b, c = _bf16(a), _bf16(b), _bf16(c)
    if kw.get("transpose_a"):
        a = numpy.ascontiguousarray(a.T)
    if kw.get("transpose_b"):
        b = numpy.ascontiguousarray(b.T)
    out_dtype = kw.pop("out_dtype", None)
    use_c = kw.pop("c", False)
    want = jax_gemm(jnp.asarray(a, operands), jnp.asarray(b, operands),
                    c=jnp.asarray(c, operands) if use_c else None,
                    precision_level=level,
                    out_dtype=getattr(jnp, out_dtype) if out_dtype else None,
                    **kw)
    tdt = getattr(torch, operands)
    got = gemm(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt),
               c=torch.from_numpy(c).to(tdt) if use_c else None,
               precision_level=level,
               out_dtype=getattr(torch, out_dtype) if out_dtype else None,
               **kw)
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    tol = TOL if got.dtype == torch.float32 else BF16_TOL
    numpy.testing.assert_allclose(got.float().numpy(),
                                  numpy.asarray(want.astype(jnp.float32)),
                                  **tol)


@pytest.mark.parametrize("k", [12, 100])
@pytest.mark.parametrize("parts", [None, 2, 3, 6])
def test_pairwise_matmul_matches_jax(parts, k):
    """parts None gives 4 (K = 12, 100); 3 is an odd count and 6 folds to
    3 after one round (K = 12); at K = 100 3 and 6 halve to 1 and 2."""
    a, b = _operands(8, k, 9, seed=k)
    want = jax_pairwise_matmul(jnp.asarray(a), jnp.asarray(b),
                                           parts)
    got = pairwise_matmul(torch.from_numpy(a), torch.from_numpy(b), parts)
    numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want), **TOL)


def test_epilogue_table_matches_jax():
    x = torch.linspace(-20, 20, 101)
    for name in ("linear", "tanh", "sigmoid", "relu", "strict_relu"):
        assert fusable_activation(name)
        numpy.testing.assert_allclose(
            epilogue_fn(name)(x).numpy(),
            numpy.asarray(jax_epilogue_fn(name)(
                jnp.asarray(x.numpy()))), rtol=1e-6, atol=1e-6)
    assert not fusable_activation("sincos")
    with pytest.raises(ValueError):
        epilogue_fn("sincos")


def test_full_float32_restores_the_switches_and_nests():
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    try:
        matmul.allow_tf32 = True
        with full_float32():
            assert not matmul.allow_tf32
            with full_float32():
                assert not matmul.allow_tf32
            assert not matmul.allow_tf32
        assert matmul.allow_tf32
    finally:
        matmul.allow_tf32 = saved


def test_kahan_gemm_on_cpu_runs_the_plain_version_without_counting():
    a, b = _operands(6, 300, 5, seed=9)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = kahan_gemm.launches
    got = kahan_gemm(ta, tb, bk=64, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, kahan_matmul_plain(ta, tb, 64).to(
        torch.bfloat16))
    assert kahan_gemm.launches == before
    # a transposed view is refused here as on the card; kahan_matmul
    # takes it and gives the same values
    with pytest.raises(ValueError, match="contiguous"):
        kahan_gemm(ta.t().contiguous().t(), tb, bk=64)
    assert torch.equal(kahan_matmul(ta.t().contiguous().t(), tb, chunk=64),
                       kahan_matmul_plain(ta, tb, 64))


@pytest.mark.parametrize("bad", ["shape", "mixed", "dtype", "bk",
                                 "out_dtype", "strided", "broadcast"])
def test_kahan_gemm_rejects_what_the_kernel_does_not_take(bad):
    a, b = _operands(4, 32, 8, seed=10)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    kw = {}
    if bad == "shape":
        tb = tb[:16]
    elif bad == "mixed":
        tb = tb.to(torch.bfloat16)
    elif bad == "dtype":
        ta, tb = ta.double(), tb.double()
    elif bad == "bk":
        kw["bk"] = 0
    elif bad == "strided":
        ta = torch.from_numpy(_operands(4, 64, 8, seed=10)[0])[:, ::2]
    elif bad == "broadcast":
        ta = ta[:1].expand(4, 32)
    else:
        kw["out_dtype"] = torch.float16
    with pytest.raises((ValueError, TypeError)):
        kahan_gemm(ta, tb, **kw)


@pytest.mark.parametrize("op", ["sum", "max", "min", "mean", "argmax",
                                "l2"])
@pytest.mark.parametrize("axis", [0, 1])
def test_matrix_reduce_matches_jax(op, axis):
    x = numpy.random.RandomState(11).randn(33, 17).astype(numpy.float32)
    want = numpy.asarray(jax_reduce(jnp.asarray(x), op, axis))
    got = matrix_reduce(torch.from_numpy(x), op, axis).numpy()
    if op == "argmax":
        numpy.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == numpy.float32
        numpy.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_matrix_reduce_rejects_an_unknown_op():
    with pytest.raises(ValueError):
        matrix_reduce(torch.zeros(2, 2), "median")


@pytest.mark.parametrize("with_labels", [True, False])
def test_gather_minibatch_matches_jax(with_labels):
    rng = numpy.random.RandomState(12)
    data = rng.randn(10, 3, 4).astype(numpy.float32)
    labels = numpy.arange(10, dtype=numpy.int32) + 5
    idx = numpy.array([4, -1, 2, 9, -1], dtype=numpy.int32)
    want = jax_gather(jnp.asarray(data), jnp.asarray(idx),
                      jnp.asarray(labels) if with_labels else None,
                      pad_label=-7)
    got = gather_minibatch(torch.from_numpy(data), torch.from_numpy(idx),
                           torch.from_numpy(labels) if with_labels else None,
                           pad_label=-7)
    numpy.testing.assert_array_equal(got[0].numpy(), numpy.asarray(want[0]))
    assert not got[0][1].any()
    if with_labels:
        numpy.testing.assert_array_equal(got[1].numpy(),
                                         numpy.asarray(want[1]))
        assert int(got[1][1]) == -7
    else:
        assert got[1] is None and want[1] is None


def test_mean_disp_matches_jax_with_a_constant_column():
    x = numpy.random.RandomState(13).rand(30, 6).astype(numpy.float32)
    x[:, 2] = 3.0
    want_mean, want_rdisp = map(numpy.asarray, jax_mean_disp(jnp.asarray(x)))
    mean, rdisp = compute_mean_disp(torch.from_numpy(x))
    numpy.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-6)
    numpy.testing.assert_allclose(rdisp.numpy(), want_rdisp, rtol=1e-6)
    assert float(rdisp[2]) == 1.0
    want = numpy.asarray(jax_normalize(jnp.asarray(x), jnp.asarray(want_mean),
                                       jnp.asarray(want_rdisp)))
    got = mean_disp_normalize(torch.from_numpy(x), mean, rdisp)
    numpy.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_join_arrays_matches_jax():
    rng = numpy.random.RandomState(14)
    a = rng.randn(4, 2, 3).astype(numpy.float32)
    b = rng.randn(4, 5).astype(numpy.float32)
    want = numpy.asarray(jax_join(jnp.asarray(a), jnp.asarray(b)))
    got = join_arrays(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(got.shape) == (4, 11)
    numpy.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        join_arrays()


def test_gemm_benchmark_returns_the_jax_keys():
    want = jax_gemm_benchmark(size=64, repeats=2)
    got = gemm_benchmark(size=64, repeats=2, device="cpu")
    assert set(got) == set(want)
    assert got["dtype"] == want["dtype"] == "bfloat16"
    assert got["size"] == 64 and got["seconds"] > 0
    assert got["computing_power"] == pytest.approx(2000.0 / got["seconds"])
    f32 = gemm_benchmark(size=32, repeats=1, dtype=torch.float32,
                         device="cpu")
    assert f32["dtype"] == "float32"


def test_gemm_bench_on_the_cpu():
    """The disciplines bench at its small shapes: every column timed,
    level 1 as accurate as the plain loop (both are the plain loop
    here), every level within float32 of float64."""
    shapes = small_shapes()
    rows = gemm_bench("cpu", shapes, trials=1, per_trial=1)
    assert [r["shape"] for r in rows] == [s for _, s in shapes]
    assert shapes[0][1] == (94, 94, 94)
    for row in rows:
        assert all(v > 0 for v in row["ms"].values())
        assert set(row["err"]) == set(ERRORS)
        assert row["err"]["level1"] <= 1.05 * row["err"]["kahan_loop"]
        assert max(row["share"].values()) < 1e-6
    table = format_table(rows, "the CPU")
    assert table.count("\n| ") == len(rows) + 1


def test_ops_import_and_gemm_load_neither_jax_nor_the_jax_package():
    """A fresh interpreter imports the port's ops and runs gemm() at
    every level, the bench's Kahan kernel wrapper and the rest of the
    layer on the CPU, loading neither jax nor any veles_tpu module and
    building no kernel."""
    code = (
        "import sys, torch\n"
        "import veles_tpu_torch.ops as ops\n"
        "from veles_tpu_torch.ops.gemm import kahan_gemm\n"
        "from veles_tpu_torch.ops import build\n"
        "a, b = torch.randn(6, 20), torch.randn(20, 3)\n"
        "for level in (0, 1, 2):\n"
        "    assert ops.gemm(a, b, precision_level=level).shape == (6, 3)\n"
        "kahan_gemm(a, b, bk=8)\n"
        "ops.matrix_reduce(a, 'l2', 1)\n"
        "ops.gather_minibatch(a, torch.tensor([1, -1]))\n"
        "ops.mean_disp_normalize(a, a.mean(0), a.std(0))\n"
        "ops.join_arrays(a, b.t())\n"
        "assert not build._libraries\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'veles_tpu' or "
        "k.startswith('veles_tpu.'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
