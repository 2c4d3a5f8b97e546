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
from veles_tpu_torch.ops.build import SMS  # noqa: E402
from veles_tpu_torch.ops.reduce import (CHUNK_BLOCKS,  # noqa: E402
                                        COLUMN_THREADS, SINGLE_MAX_ROWS,
                                        column_plan, column_sum,
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


#: every bias gradient of AlexNet's training step at batch 128, (R, C)
MAIN_PATH = {"conv1": (401408, 96), "conv2": (93312, 256),
             "conv3/conv4": (21632, 384), "conv5": (21632, 256),
             "fc6/fc7": (128, 4096), "head": (128, 1000)}


def _check_plan(plan, rows, cols):
    """What every plan must hold: the row chunks cover R once, the tiles
    cover C, and the workspace holds a float32 partial row per chunk."""
    vectors = cols // plan.vec
    assert cols % plan.vec == 0
    assert plan.tiles == -(-vectors // plan.tile)
    assert plan.tile <= COLUMN_THREADS
    assert (plan.chunks - 1) * plan.chunk_rows < rows <= \
        plan.chunks * plan.chunk_rows
    if plan.form == "single":
        assert plan.chunks == 1 and plan.workspace_bytes == 0
    else:
        assert plan.chunks >= 2
        assert plan.workspace_bytes == 4 * plan.chunks * cols


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer", sorted(MAIN_PATH))
def test_column_plan_main_path_shapes(layer, dtype):
    """The fc and head rows take the single form (one launch, no
    workspace, narrow tiles so 2 MB spread over many blocks); the conv
    rows the chunked form at 16-byte loads, about two blocks per SM."""
    rows, cols = MAIN_PATH[layer]
    dt = getattr(torch, dtype)
    plan = column_plan(rows, cols, dt)
    _check_plan(plan, rows, cols)
    assert plan.vec == (4 if dtype == "float32" else 8)
    if rows <= SINGLE_MAX_ROWS:
        assert plan.form == "single" and plan.tile == 8
        assert plan.tiles >= 16
    else:
        assert plan.form == "chunked"
        assert plan.tile == min(cols // plan.vec, 32)
        assert SMS <= plan.tiles * plan.chunks <= CHUNK_BLOCKS + plan.tiles


@pytest.mark.parametrize("case", [
    ("R = 1", 1, 5, "single", 1),
    ("R = 1, wide", 1, 4096, "single", 4),
    ("the last single row", SINGLE_MAX_ROWS, 96, "single", 4),
    ("the first chunked row", SINGLE_MAX_ROWS + 1, 96, "chunked", 4),
    ("R not a multiple of the chunk", 100003, 96, "chunked", 4),
    ("C not a multiple of 4", 100003, 37, "chunked", 1),
    ("C not a multiple of 32 vectors", 5000, 4100, "chunked", 4),
    ("C = 1", 3000, 1, "chunked", 1),
    ("C = 3, two chunks", 1025, 3, "chunked", 1),
])
def test_column_plan_ragged_shapes(case):
    _, rows, cols, form, vec = case
    plan = column_plan(rows, cols, torch.float32)
    _check_plan(plan, rows, cols)
    assert (plan.form, plan.vec) == (form, vec)


def test_column_plan_unaligned_pointer_and_refusals():
    assert column_plan(21632, 384, torch.float32, False).vec == 1
    assert column_plan(21632, 384, torch.bfloat16, False).vec == 1
    assert column_plan(128, 1004, torch.bfloat16).vec == 1  # 1004 % 8
    with pytest.raises(TypeError):
        column_plan(128, 96, torch.float64)
    with pytest.raises(ValueError):
        column_plan(0, 96, torch.float32)


def _emulate(x, plan):
    """The kernel's float32 sum in its order, numpy, all columns at once
    (every column tile walks the same rows): per chunk, each of the 256 /
    tile row slots takes every slots-th row in batches of 8, row j of a
    batch into accumulator j % 4, joined (a0 + a1) + (a2 + a3); the slots
    join in order; the chunks' partial rows are then summed the same way
    (the chunked form's last block)."""
    slots = COLUMN_THREADS // plan.tile

    def slot_sums(rows):
        total = numpy.zeros(rows.shape[1], numpy.float32)
        for slot in range(slots):
            acc = numpy.zeros((4, rows.shape[1]), numpy.float32)
            mine = rows[slot::slots]
            for j in range(len(mine)):
                acc[j % 8 % 4] += mine[j]
            part = (acc[0] + acc[1]) + (acc[2] + acc[3])
            total = part if slot == 0 else total + part
        return total

    x = x.astype(numpy.float32)
    partials = numpy.stack([
        slot_sums(x[c * plan.chunk_rows:(c + 1) * plan.chunk_rows])
        for c in range(plan.chunks)])
    return partials[0] if plan.chunks == 1 else slot_sums(partials)


@pytest.mark.parametrize("shape", [(128, 1000), (1000, 96), (5000, 96),
                                   (3001, 37), (1025, 3)])
def test_plan_order_emulation_matches_the_sum(shape):
    """The plan's row slots and chunks take every row once: the
    emulated kernel sum is the float64 sum within 1e-6 of the column's
    sum of magnitudes, as the kernel is held on the card; a sum that
    dropped the last row of each chunk fails it."""
    x = _x(*shape, seed=21)
    plan = column_plan(*shape, torch.float32)
    want = x.astype(numpy.float64).sum(axis=0)
    _assert_close(_emulate(x, plan), want, x)
    if plan.chunks > 1:
        dropped = x.copy()
        dropped[plan.chunk_rows - 1::plan.chunk_rows] = 0.0
        with pytest.raises(AssertionError):
            _assert_close(_emulate(dropped, plan), want, x)
