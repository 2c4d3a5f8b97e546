"""The port's column sum (``veles_tpu_torch.ops.reduce``) against the
JAX package's ``pallas_column_reduce`` in interpret mode (row counts
divisible by its 128-row blocks; otherwise it falls back to
``jnp.sum``) and against ``jnp.sum`` at ragged row counts.

Tolerance: both sides sum float32 values in different orders (block
by block on the TPU kernel, torch's cascade here). Reordering a sum of
R values moves it by at most ~R ulps of the sum of magnitudes, so each
column is held to 1e-6 * sum_r |x[r, c]| (at R <= 512 that is ~8 float32
ulps of the magnitude sum per 64 rows). bf16 inputs are widened exactly
to float32 on both sides, so the same bound holds.
"""

import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.ops.reduce import pallas_column_reduce  # noqa: E402
from veles_tpu_torch.ops.reduce import (column_sum,  # noqa: E402
                                        column_sum_plain)


def _x(rows, cols, seed):
    return numpy.random.RandomState(seed).randn(rows, cols).astype(
        numpy.float32)


def _assert_close(got, want, x):
    limit = 1e-6 * numpy.abs(x.astype(numpy.float64)).sum(axis=0) + 1e-30
    err = numpy.abs(got.astype(numpy.float64) - want)
    assert (err <= limit).all(), (err / limit).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(128, 96), (512, 40), (384, 256)])
def test_matches_pallas_column_reduce_interpret(shape, dtype):
    x = _x(*shape, seed=shape[0] + shape[1])
    xj = jnp.asarray(x, dtype)
    want = numpy.asarray(pallas_column_reduce(xj, block_rows=128,
                                              interpret=True))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = column_sum(xt)
    assert got.dtype == torch.float32 and got.shape == (shape[1],)
    _assert_close(got.numpy(), want, xt.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(100, 33), (7, 1000), (1, 5)])
def test_ragged_rows_match_jnp_sum(shape, dtype):
    x = _x(*shape, seed=3)
    xj = jnp.asarray(x, dtype)
    want = numpy.asarray(jnp.sum(xj.astype(jnp.float32), axis=0))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    _assert_close(column_sum(xt).numpy(), want, xt.float().numpy())


def test_cpu_tensors_take_the_plain_version_without_counting():
    x = torch.from_numpy(_x(16, 8, 4))
    before = column_sum.launches
    before_forms = dict(column_sum.launches_by_form)
    assert torch.equal(column_sum(x), column_sum_plain(x))
    assert column_sum.launches == before
    assert dict(column_sum.launches_by_form) == before_forms


@pytest.mark.parametrize("bad", ["rank", "dtype", "layout"])
def test_rejects_what_the_kernel_does_not_take(bad):
    x = torch.from_numpy(_x(16, 8, 5))
    if bad == "rank":
        x = x.reshape(2, 8, 8)
    elif bad == "dtype":
        x = x.double()
    else:
        x = x.t()
    with pytest.raises((ValueError, TypeError)):
        column_sum(x)
