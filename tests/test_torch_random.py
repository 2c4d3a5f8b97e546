"""The port's Philox uniform fill (``veles_tpu_torch.ops.random``, the
counterpart of the TPU kernel in ``pallas_uniform``) and its random
streams (``veles_tpu_torch.prng``), on the CPU.

``pallas_uniform`` draws the TPU's hardware PRNG, which neither runs
here nor can be reproduced, and the JAX suite has no CPU test of it. So
the fill is held to its own terms: Random123's published Philox4x32-10
known answers (exact), the TPU kernel's bits-to-float map evaluated by
``jnp`` on the same bits (exact), its range and 2^-24 grid, determinism
by (seed, offset), and a Kolmogorov-Smirnov test of uniformity on 2^17
draws (at the fixed seed the statistic is a fixed number; the limit is
the 1% critical value).
"""

import ctypes
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.ops import build  # noqa: E402
from veles_tpu_torch.ops.random import (bits_to_uniform,  # noqa: E402
                                        dropout_offset, philox4x32,
                                        uniform_fill, uniform_fill_plain)

M = 0xFFFFFFFF

KNOWN_ANSWERS = {
    "zeros": ((0, 0, 0, 0), (0, 0),
              (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    "ones": ((M, M, M, M), (M, M),
             (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    "pi": ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
           (0xA4093822, 0x299F31D0),
           (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
}


@pytest.mark.parametrize("case", sorted(KNOWN_ANSWERS))
def test_philox4x32_10_known_answers(case):
    counter, key, want = KNOWN_ANSWERS[case]
    got = tuple(int(w) for w in philox4x32(counter, key))
    assert got == want, ["%08x" % w for w in got]


@pytest.mark.parametrize("vmin,vmax", [(0.0, 1.0), (-1.0, 1.0),
                                       (0.5, 2.0)])
def test_bits_to_float_map_matches_the_tpu_kernels(vmin, vmax):
    """``random.py``'s kernel body: u24 = bits >> 8 as int32, times
    1/2^24, then vmin + (vmax - vmin) * u, on the same bits."""
    words = philox4x32((torch.arange(4096, dtype=torch.int64), 0, 7, 0),
                       (11, 13))
    bits = torch.cat(words).numpy().astype(numpy.uint32)
    bits[:4] = [0, 0xFF, 0x100, M]           # the grid's ends
    u24 = (jnp.asarray(bits) >> 8).astype(jnp.int32)
    want = vmin + (vmax - vmin) * (u24.astype(jnp.float32) *
                                   (1.0 / (1 << 24)))
    got = bits_to_uniform(torch.from_numpy(bits.astype(numpy.int64)),
                          vmin, vmax)
    numpy.testing.assert_array_equal(got.numpy(), numpy.asarray(want))


def test_range_grid_and_determinism():
    u = uniform_fill((128, 4096), seed=2 ** 40 + 5, offset=3,
                     device="cpu")
    assert u.dtype == torch.float32 and u.shape == (128, 4096)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    scaled = u.double() * 2 ** 24
    assert torch.equal(scaled, scaled.round())
    assert torch.equal(u, uniform_fill_plain((128, 4096), 2 ** 40 + 5, 3))
    for seed, offset in ((2 ** 40 + 5, 4), (2 ** 40 + 6, 3)):
        other = uniform_fill((128, 4096), seed, offset, device="cpu")
        assert float((other == u).float().mean()) < 1e-3


def test_ragged_sizes_take_a_prefix_of_the_stream():
    """Element e is word e % 4 of counter e / 4 whatever the shape, so
    a (3, 5) fill is the first 15 values of any longer one."""
    long = uniform_fill((1, 64), 9, 1, device="cpu").reshape(-1)
    short = uniform_fill((3, 5), 9, 1, device="cpu").reshape(-1)
    assert torch.equal(short, long[:15])


def test_uniformity_kolmogorov_smirnov():
    from scipy import stats
    u = uniform_fill((64, 2048), seed=12345, offset=dropout_offset(0, 11),
                     device="cpu").reshape(-1).double().numpy()
    statistic = stats.kstest(u, "uniform").statistic
    assert statistic < 1.63 / numpy.sqrt(u.size), statistic


def test_dropout_offset_packs_batch_and_layer():
    assert dropout_offset(0, 0) == 0
    assert dropout_offset(3, 11) == (3 << 32) | 11
    assert dropout_offset(1, 0) != dropout_offset(0, 1)


def test_wrapper_checks_and_cpu_path_does_not_count(monkeypatch):
    before = uniform_fill.launches
    uniform_fill((4, 8), 1, device="cpu")
    assert uniform_fill.launches == before
    with pytest.raises(ValueError, match="2-D"):
        uniform_fill((4, 8, 2), 1, device="cpu")
    with pytest.raises(ValueError, match="64-bit"):
        uniform_fill((4, 8), -1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        uniform_fill((4, 8), 1)


def test_host_streams_match_the_jax_package():
    """Seeding, fills and the loader's shuffles give the JAX package's
    numbers, bit for bit; the Philox seed chain leaves the numpy stream
    untouched and survives a save/restore."""
    ours = prng.RandomGenerator("t").seed(b"some bytes")
    theirs = jax_prng.RandomGenerator("t").seed(b"some bytes")
    assert ours.seed_value == theirs.seed_value
    a, b = numpy.zeros((5, 7), numpy.float32), numpy.zeros((5, 7),
                                                           numpy.float32)
    ours.fill(a, -0.5, 0.5)
    theirs.fill(b, -0.5, 0.5)
    numpy.testing.assert_array_equal(a, b)
    saved = ours.save_state()
    seeds = [ours.philox_seed() for _ in range(3)]
    assert len(set(seeds)) == 3 and all(0 <= s < 2 ** 64 for s in seeds)
    x, y = numpy.arange(50), numpy.arange(50)
    ours.shuffle(x)
    theirs.shuffle(y)
    numpy.testing.assert_array_equal(x, y)
    ours.restore_state(saved)
    assert [ours.philox_seed() for _ in range(3)] == seeds
    assert prng.get("fresh-name").seed_value == \
        jax_prng.RandomGenerator("x").seed(b"fresh-name").seed_value


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("shape", [(128, 4096), (3, 5), (0, 7)])
def test_cpu_fill_builds_and_counts_nothing(shape):
    """In a fresh interpreter a CPU fill runs the plain version: it
    builds no library and no binding, counts no launch, and loads
    neither jax nor any veles_tpu module."""
    code = (
        "import sys\n"
        "from veles_tpu_torch.ops import build\n"
        "from veles_tpu_torch.ops.random import uniform_fill\n"
        "u = uniform_fill(%r, 7, 3, -1.0, 1.0, device='cpu')\n"
        "assert tuple(u.shape) == %r\n"
        "assert not (build._libraries or build._bindings or "
        "build._functions)\n"
        "assert uniform_fill.launches == 0\n"
        "assert not uniform_fill.launches_by_form\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'veles_tpu')]\n"
        "print('LOADED', bad)\n" % (shape, shape))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


@pytest.mark.parametrize("value", [0.1, 1.0 / 3.0, -0.7, 2.0 ** 24 + 1,
                                   1e-40, 0.5, -1, 3])
def test_vmin_vmax_round_to_float32_as_ctypes_does(value):
    """The binding casts vmin and vmax from double to float, as a ctypes
    c_float argument did; the plain version rounds them with numpy's
    float32: the three agree, so the kernel and the plain version map
    the same bits to the same values."""
    assert ctypes.c_float(value).value == float(numpy.float32(value))


@pytest.mark.parametrize("constant,value", [("kSms", build.SMS),
                                            ("kThreads", 256)])
def test_the_fill_sizes_its_wave_from_the_card(constant, value):
    """uniform_fill.cu caps its grid at one wave of its 256-thread
    blocks on the card the sources are built for: its SM count is
    ops/build.py's SMS."""
    with open(os.path.join(build.CSRC, "uniform_fill.cu")) as f:
        source = f.read()
    found = re.search(r"constexpr int %s = (\d+);" % constant, source)
    assert found and int(found.group(1)) == value
