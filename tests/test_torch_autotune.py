"""The port's kernel autotuner (``veles_tpu_torch/ops/autotune.py``) on
the CPU: the cases of ``tests/test_autotune.py`` that do not need the
Pallas kernels, and the port's candidate grids.

* Modes: ``cache`` by default, ``VELES_AUTOTUNE`` over
  ``root.common.engine.autotune``, an unknown mode read as ``cache``;
  ``off`` never reads the cache; ``cache`` and ``search`` on the CPU
  never measure.
* The search, reached here by replacing ``tunable`` (the card check)
  and ``_measure`` (CUDA events) with a fake clock that times each
  candidate by its split count: the winner persisted, a fresh cache
  read giving the same plan with no search, two rounds over the grid
  (the first candidate not slower for going first), a search never
  consulting itself, one search a key under eight threads, a corrupt or stale file read as empty (and healed by
  the next write), a failed search not persisted, a failed baseline not
  named as the baseline, the 2% win margin, ``warm()``, ``summary()``'s
  counters; the call sites' memo dropped by a write and by ``reset()``.
* The grids: K1's split counts are ``gemm_plan``'s (each candidate's
  plan covers K and differs from the default's and every other's), and
  the plan of each candidate, summed split by split in plain PyTorch,
  matches ``pallas_gemm`` in interpret mode (1e-5, the tolerance of
  ``tests/test_torch_gemm.py``); K5's split counts are ``kahan_plan``'s
  and each candidate's arithmetic (the mma form's 3xTF32 emulation)
  matches ``_kahan_matmul_loop`` (1e-5) and stays within 2e-6 of
  ``|a| @ |b|`` against float64.
"""

import json
import os
import threading

import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from test_torch_gemm import (TOL, _check_kahan_plan,  # noqa: E402
                             _check_plan, _emulate_kahan_mma, _inputs,
                             _split_k_plain)
from veles_tpu.ops.gemm import _kahan_matmul_loop, pallas_gemm  # noqa
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.ops import autotune  # noqa: E402
from veles_tpu_torch.ops.gemm import gemm_plan, kahan_plan  # noqa: E402


@pytest.fixture
def tuner(tmp_path, monkeypatch):
    """An isolated cache file; the search reachable on the CPU through
    a fake clock (each candidate's seconds: 1 ms over its split count,
    the plan's own choice 1 ms)."""
    cache_file = str(tmp_path / "tune.json")
    monkeypatch.setenv("VELES_AUTOTUNE_CACHE", cache_file)
    monkeypatch.setenv("VELES_AUTOTUNE_BUDGET_S", "60")
    monkeypatch.setattr(autotune, "tunable", lambda device: True)
    measured = []

    def fake_measure(fn, iters=None):
        measured.append(fn)
        return fn()

    monkeypatch.setattr(autotune, "_measure", fake_measure)
    autotune.reset()
    yield cache_file, measured
    autotune.reset()


def _fake_linear(monkeypatch, times=None):
    """Replace ``linear_act`` in the grid's runner with a clock: a
    candidate's call returns its seconds (``times[splits]`` or 1e-3 /
    splits; the plan's own, ``splits=0``, 1e-3)."""
    import sys
    gemm_mod = sys.modules["veles_tpu_torch.ops.gemm"]

    def fake(x, w, b, activation, out_dtype, splits=None):
        assert splits is not None, "a search launch consulted the tuner"
        if times is not None:
            return times[splits or None]
        return 1e-3 / splits if splits else 1e-3

    monkeypatch.setattr(gemm_mod, "linear_act", fake)
    monkeypatch.setattr(gemm_mod, "kahan_gemm",
                        lambda a, b, bk=None, splits=None: fake(
                            a, b, None, None, None, splits))


def _entries(path):
    if not os.path.exists(path):
        return {}
    return json.load(open(path))["entries"]


SHAPE = dict(m=16, n=4096, k=4096, dtype=torch.float32,
             activation="strict_relu", out_dtype=torch.float32)


def _linear(device="cpu", **kwargs):
    args = dict(SHAPE, **kwargs)
    return autotune.linear_plan(args["m"], args["n"], args["k"],
                                args["dtype"], args["activation"],
                                args["out_dtype"], True, device)


# -- modes -------------------------------------------------------------------

class TestModes(object):
    def test_default_is_cache(self, monkeypatch):
        monkeypatch.delenv("VELES_AUTOTUNE", raising=False)
        assert root.common.engine.get("autotune") == "cache"
        assert autotune.mode() == "cache"

    def test_env_knob_wins_over_config(self, monkeypatch):
        before = root.common.engine.get("autotune")
        root.common.engine["autotune"] = "search"
        try:
            monkeypatch.setenv("VELES_AUTOTUNE", "off")
            assert autotune.mode() == "off"
            monkeypatch.delenv("VELES_AUTOTUNE")
            assert autotune.mode() == "search"
        finally:
            root.common.engine["autotune"] = before

    def test_invalid_mode_falls_back_to_cache(self, monkeypatch):
        monkeypatch.setenv("VELES_AUTOTUNE", "bogus")
        assert autotune.mode() == "cache"

    def test_off_returns_default_without_touching_cache(self, monkeypatch,
                                                         tuner):
        monkeypatch.setenv("VELES_AUTOTUNE", "off")
        monkeypatch.setattr(autotune, "get_cache", lambda *a: pytest.fail(
            "off mode must not consult the cache"))
        assert _linear() == ("default", None)
        assert autotune.gemm_plan(128, 128, 128, torch.float32,
                                  level=1) == ("default", None)
        assert autotune.warm() == 0

    def test_cache_mode_never_measures(self, monkeypatch, tuner):
        monkeypatch.setenv("VELES_AUTOTUNE", "cache")
        monkeypatch.setattr(autotune, "_search", lambda *a: pytest.fail(
            "cache mode must never measure"))
        assert _linear(device="cuda") == ("default", None)

    def test_search_mode_on_the_cpu_never_measures(self, monkeypatch,
                                                    tmp_path):
        """Without the card (the real ``tunable``) a search answers the
        default at once and writes nothing."""
        path = str(tmp_path / "cpu.json")
        monkeypatch.setenv("VELES_AUTOTUNE_CACHE", path)
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        autotune.reset()
        try:
            assert not autotune.tunable("cpu")
            monkeypatch.setattr(autotune, "_search", lambda *a: pytest.fail(
                "the CPU must not measure"))
            assert _linear() == ("default", None)
            assert autotune.gemm_plan(256, 64, 1024, torch.float32,
                                      level=1, device="cpu") == \
                ("default", None)
            assert not os.path.exists(path)
        finally:
            autotune.reset()

    def test_level0_lrn_and_reduce_answer_the_default(self, monkeypatch,
                                                      tuner):
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        monkeypatch.setattr(autotune, "_search", lambda *a: pytest.fail(
            "no configuration to search"))
        assert autotune.gemm_plan(128, 128, 128, torch.float32, level=0,
                                  device="cuda") == ("default", None)
        assert autotune.lrn_plan(128 * 55 * 55, 96, "float32") == \
            ("default", None)
        assert autotune.reduce_plan(128, 4096, "float32") == \
            ("default", None)


# -- the search and the cache ------------------------------------------------

class TestSearch(object):
    def test_search_persists_and_a_fresh_read_skips_measuring(
            self, monkeypatch, tuner):
        cache_file, measured = tuner
        _fake_linear(monkeypatch)
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        impl, cfg = _linear()
        cands = autotune.linear_candidates(16, 4096, 4096, torch.float32)
        assert len(measured) == autotune.SEARCH_PASSES * len(cands)
        # the fake clock: more splits is faster
        assert (impl, cfg) == ("kernel", {"splits": max(
            c["splits"] for _, c in cands[1:])})
        entries = _entries(cache_file)
        [key] = entries
        assert key == autotune._key(
            "linear", m=16, n=4096, k=4096, dtype="float32",
            act="strict_relu", out="float32", bias=1)
        entry = entries[key]
        assert entry["impl"] == "kernel" and entry["config"] == cfg
        assert entry["baseline_impl"] == "kernel"
        assert entry["baseline_ms"] == 1.0
        assert entry["candidates"] == len(cands)
        autotune.reset()
        monkeypatch.setenv("VELES_AUTOTUNE", "cache")
        monkeypatch.setattr(autotune, "_search", lambda *a: pytest.fail(
            "a warm cache must not measure"))
        assert _linear() == (impl, cfg)
        assert autotune.AutotuneCache(cache_file).get(key)["config"] == cfg

    def test_a_search_never_consults_itself(self, monkeypatch, tuner):
        """Every candidate launches with an explicit count (0: the
        plan's own), since a launch with None consults the tuner; and a
        consult from inside a search answers the default at once instead
        of waiting on the search's own lock (which here raises after 5 s
        instead of hanging)."""
        import sys
        gemm_mod = sys.modules["veles_tpu_torch.ops.gemm"]

        class GuardedLock(object):
            def __init__(self):
                self.lock = threading.Lock()

            def __enter__(self):
                assert self.lock.acquire(timeout=5), "the lock taken twice"

            def __exit__(self, *exc):
                self.lock.release()

        monkeypatch.setattr(autotune, "_search_lock", GuardedLock())
        seen, nested = [], []

        def fake(x, w, b, activation, out_dtype, splits=None):
            seen.append(splits)
            nested.append(_linear(device="cuda"))
            return 1e-3 if not splits else 1e-3 / splits

        monkeypatch.setattr(gemm_mod, "linear_act", fake)
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        impl, cfg = _linear()
        assert seen[0] == 0 and None not in seen
        assert set(map(repr, nested)) == {repr(("default", None))}
        assert impl == "kernel" and cfg["splits"] == max(seen)

    def test_one_search_a_key_under_threads(self, monkeypatch, tuner):
        _fake_linear(monkeypatch)
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        calls = []
        real = autotune._search

        def counting(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(autotune, "_search", counting)
        answers = []
        threads = [threading.Thread(target=lambda: answers.append(
            _linear())) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(calls) == 1
        assert len(answers) == 8 and len(set(map(repr, answers))) == 1

    def test_the_win_margin_keeps_the_default(self, monkeypatch, tuner):
        """A candidate 1% faster than the plan's own choice does not
        win (2% margin); one 5% faster does."""
        cache_file, _ = tuner
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        cands = autotune.linear_candidates(16, 4096, 4096, torch.float32)
        times = {c["splits"]: 1e-3 for _, c in cands}
        times[cands[1][1]["splits"]] = 0.99e-3
        _fake_linear(monkeypatch, times)
        assert _linear() == ("kernel", {"splits": None})
        autotune.reset()
        os.unlink(cache_file)
        times[cands[1][1]["splits"]] = 0.95e-3
        assert _linear() == ("kernel", cands[1][1])

    def test_the_first_candidate_is_not_slower_for_going_first(
            self, monkeypatch, tuner):
        """Two rounds over the grid, each candidate at its best: a
        baseline timed slow only on its first launch (clocks settling)
        still wins against candidates 1% slower than its settled time."""
        cache_file, _ = tuner
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        cands = autotune.linear_candidates(16, 4096, 4096, torch.float32)
        times = {c["splits"]: 1.01e-3 for _, c in cands}
        first = []

        def clock(x, w, b, activation, out_dtype, splits=None):
            if not splits and not first:
                first.append(True)
                return 2e-3
            return 1e-3 if not splits else times[splits]

        import sys
        monkeypatch.setattr(sys.modules["veles_tpu_torch.ops.gemm"],
                            "linear_act", clock)
        assert _linear() == ("kernel", {"splits": None})
        [entry] = _entries(cache_file).values()
        assert entry["baseline_ms"] == 1.0

    def test_corrupt_and_stale_files_read_as_empty(self, monkeypatch,
                                                    tuner):
        cache_file, _ = tuner
        with open(cache_file, "w") as f:
            f.write("{not json")
        monkeypatch.setenv("VELES_AUTOTUNE", "cache")
        assert _linear(device="cuda") == ("default", None)
        # a search's write heals the file
        _fake_linear(monkeypatch)
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        _linear()
        blob = json.load(open(cache_file))
        assert blob["version"] == autotune.CACHE_VERSION
        assert len(blob["entries"]) == 1
        with open(cache_file, "w") as f:
            json.dump({"version": -1, "entries": {"linear|x": {}}}, f)
        autotune.reset()
        assert len(autotune.get_cache()) == 0

    def test_failed_search_is_not_persisted(self, monkeypatch, tuner):
        cache_file, _ = tuner
        monkeypatch.setenv("VELES_AUTOTUNE", "search")

        def broken(fn, iters=None):
            raise RuntimeError("the kernel did not launch")

        monkeypatch.setattr(autotune, "_measure", broken)
        assert _linear() == ("default", None)
        assert not _entries(cache_file)
        # the call site asks again next time: a failure is not memoized
        calls = []
        monkeypatch.setattr(autotune, "linear_plan",
                            lambda *a: calls.append(1) or ("default", None))
        for _ in range(2):
            autotune.linear_splits(16, 4096, 4096, torch.float32,
                                   "strict_relu", torch.float32, True,
                                   "cuda")
        assert len(calls) == 2

    def test_failed_baseline_does_not_mislabel_survivor(self, monkeypatch,
                                                        tuner):
        cache_file, _ = tuner
        _fake_linear(monkeypatch)
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        real = autotune._measure
        seen = []

        def flaky(fn, iters=None):
            if not seen:  # the first candidate, the baseline
                seen.append(True)
                raise RuntimeError("the baseline would not launch")
            return real(fn, iters)

        monkeypatch.setattr(autotune, "_measure", flaky)
        impl, cfg = _linear()
        assert impl == "kernel" and cfg["splits"] is not None
        [entry] = _entries(cache_file).values()
        assert entry["baseline_impl"] is None
        assert "baseline_ms" not in entry

    def test_warm_counts_entries(self, monkeypatch, tuner):
        _fake_linear(monkeypatch)
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        _linear()
        autotune.reset()
        monkeypatch.setenv("VELES_AUTOTUNE", "cache")
        from veles_tpu_torch.telemetry import profiler
        before = profiler.phase_report().get("autotune_load", 0.0)
        assert autotune.warm() == 1
        assert profiler.phase_report()["autotune_load"] >= before
        monkeypatch.setenv("VELES_AUTOTUNE", "off")
        assert autotune.warm() == 0

    def test_summary_reports_counters(self, monkeypatch, tuner):
        from veles_tpu_torch.telemetry.registry import get_registry
        _fake_linear(monkeypatch)
        monkeypatch.setenv("VELES_AUTOTUNE", "search")
        before = autotune.summary()
        _linear()
        _linear()
        s = autotune.summary()
        assert s["mode"] == "search" and len(s["entries"]) == 1
        assert s["searches"] == before["searches"] + 1
        assert s["hits"] == before["hits"] + 1
        assert s["path"] == tuner[0]
        gauge = get_registry().get("veles_autotune_best_tflops")
        assert gauge.labels(op="linear", shape="16x4096x4096").value > 0

    def test_the_consult_memo_follows_the_cache(self, monkeypatch, tuner):
        """``linear_splits`` answers from its memo until the cache is
        written or ``reset()``; a hand-written entry then takes
        effect."""
        monkeypatch.setenv("VELES_AUTOTUNE", "cache")
        args = (16, 4096, 4096, torch.float32, "strict_relu",
                torch.float32, True, "cuda")
        assert autotune.linear_splits(*args) is None
        key = autotune._key("linear", m=16, n=4096, k=4096,
                            dtype="float32", act="strict_relu",
                            out="float32", bias=1)
        autotune.get_cache().put(key, {"impl": "kernel",
                                       "config": {"splits": 3}})
        assert autotune.linear_splits(*args) == 3
        monkeypatch.setenv("VELES_AUTOTUNE", "off")
        assert autotune.linear_splits(*args) == 3  # memoized
        autotune.reset()
        assert autotune.linear_splits(*args) is None


# -- the candidate grids -----------------------------------------------------

#: (m, n, k, dtype): AlexNet's served fc6/fc7, their training rows, and
#: small shapes of every designed form
GRID_SHAPES = ((1, 4096, 9216, "float32"), (16, 4096, 4096, "float32"),
               (128, 4096, 9216, "float32"), (9216, 4096, 128, "float32"),
               (128, 4096, 9216, "bfloat16"), (5, 16, 512, "bfloat16"),
               (40, 8, 2048, "float32"))


@pytest.mark.parametrize("m,n,k,dtype", GRID_SHAPES)
def test_linear_candidates_are_gemm_plans_split_counts(m, n, k, dtype):
    dtype = getattr(torch, dtype)
    cands = autotune.linear_candidates(m, n, k, dtype)
    assert cands[0] == ("kernel", {"splits": None})
    default = gemm_plan(m, n, k, dtype)
    seen = {(default.splits, default.kchunk)}
    for impl, cfg in cands[1:]:
        assert impl == "kernel" and cfg["splits"] in autotune.SPLIT_LADDER
        plan = gemm_plan(m, n, k, dtype, True, cfg["splits"])
        _check_plan(plan, m, n, k)
        assert plan.form == default.form
        assert (plan.splits, plan.kchunk) not in seen
        seen.add((plan.splits, plan.kchunk))
    # every ladder count gives one of the grid's plans
    for s in autotune.SPLIT_LADDER:
        plan = gemm_plan(m, n, k, dtype, True, s)
        assert (plan.splits, plan.kchunk) in seen


@pytest.mark.parametrize("m,n,k,dtype,bk", [
    (128, 4096, 9216, "float32", 512), (128, 9216, 4096, "float32", 512),
    (9216, 4096, 128, "float32", 128), (128, 4096, 9216, "bfloat16", 512),
    (1500, 1500, 1500, "float32", 512)])
def test_kahan_candidates_are_kahan_plans_split_counts(m, n, k, dtype, bk):
    dtype = getattr(torch, dtype)
    cands = autotune.kahan_candidates(m, n, k, bk, dtype)
    assert cands[0] == ("kernel", {"splits": None})
    default = kahan_plan(m, n, k, bk, dtype)
    seen = {(default.splits, default.blocks_per_split)}
    for impl, cfg in cands[1:]:
        plan = kahan_plan(m, n, k, bk, dtype, True, cfg["splits"])
        _check_kahan_plan(plan, m, n, k, bk)
        assert plan.form == default.form == "mma"
        assert (plan.splits, plan.blocks_per_split) not in seen
        seen.add((plan.splits, plan.blocks_per_split))
    if k <= bk:
        assert len(cands) == 1  # one Kahan block: nothing to split


@pytest.mark.parametrize("case", ["stream_f32", "tiles", "tensor_core"])
def test_every_linear_candidate_sums_as_pallas_gemm(case):
    """Each candidate's plan, its splits summed in order in plain
    PyTorch with the bias and epilogue once after, as the kernel's
    second pass does, against ``pallas_gemm`` (interpret mode)."""
    from test_torch_gemm import SPLIT_CASES
    m, n, k, dtype, bk, form = SPLIT_CASES[case]
    a, b, bias = _inputs(m, k, n, seed=9)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    a16, b16 = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    want = numpy.asarray(pallas_gemm(
        a16, b16, bm=m, bn=n, bk=bk, out_dtype=jnp.float32,
        bias=jnp.asarray(bias), activation="strict_relu", interpret=True))
    x = torch.from_numpy(numpy.array(a16.astype(jnp.float32))).to(tdt)
    w = torch.from_numpy(numpy.array(b16.astype(jnp.float32))).to(tdt)
    cands = autotune.linear_candidates(m, n, k, tdt)
    assert len(cands) > 2
    for _, cfg in cands:
        plan = gemm_plan(m, n, k, tdt, True, cfg["splits"])
        assert plan.form == form
        got = _split_k_plain(x, w, torch.from_numpy(bias), "strict_relu",
                             torch.float32, plan)
        numpy.testing.assert_allclose(got.numpy(), want, err_msg=str(cfg),
                                      **TOL)


@pytest.mark.parametrize("m,k,n,bk", [(24, 2048, 40, 128),
                                      (32, 1000, 16, 64)])
def test_every_kahan_candidate_matches_the_jax_loop(m, k, n, bk):
    """Each candidate's arithmetic (the mma form's 3xTF32 emulation of
    ``tests/test_torch_gemm.py``, its splits merged in order) against
    ``_kahan_matmul_loop`` and float64."""
    a, b, _ = _inputs(m, k, n, seed=13)
    want = numpy.asarray(_kahan_matmul_loop(jnp.asarray(a), jnp.asarray(b),
                                            bk))
    ref = a.astype(numpy.float64) @ b.astype(numpy.float64)
    scale = numpy.abs(a).astype(numpy.float64) @ numpy.abs(b)
    cands = autotune.kahan_candidates(m, n, k, bk, torch.float32)
    assert len(cands) > 2
    for _, cfg in cands:
        plan = kahan_plan(m, n, k, bk, torch.float32, True, cfg["splits"])
        got = _emulate_kahan_mma(a, b, bk, plan)
        numpy.testing.assert_allclose(got, want, err_msg=str(cfg), atol=1e-5,
                                      rtol=1e-5)
        assert numpy.max(numpy.abs(got - ref) / scale) <= 2e-6


def test_pairwise_candidates_and_parts():
    """Level 2's grid (the JAX package's): the default rule first, then
    powers of two dividing K; each ``parts`` gives the same product."""
    from veles_tpu_torch.ops.gemm import pairwise_matmul
    cands = autotune.pairwise_candidates(64)
    assert cands == [("pairwise", {"parts": p})
                     for p in (None, 2, 4, 8, 16, 32)]
    a, b, _ = _inputs(32, 64, 16, seed=4)
    ref = a.astype(numpy.float64) @ b.astype(numpy.float64)
    for _, cfg in cands:
        out = pairwise_matmul(torch.from_numpy(a), torch.from_numpy(b),
                              parts=cfg["parts"])
        numpy.testing.assert_allclose(out.numpy(), ref, rtol=1e-4,
                                      atol=1e-5)
