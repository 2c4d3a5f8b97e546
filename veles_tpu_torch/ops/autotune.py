"""The kernel autotuner with a persistent per-card cache
(``veles_tpu/ops/autotune.py``).

The plans of the port's kernels choose their configuration by a model
of the H100's time (``ops/gemm.py`` ``gemm_plan``, ``kahan_plan``). This
module measures instead: keyed by ``(op, M, N, K, dtype, ...)`` it times
a bounded grid of a kernel's own configurations -- the K split counts
its plan accepts -- against the plan's own choice, and keeps the winner
in a JSON file of the card's kind that later runs consult. It chooses
among a kernel's configurations only, never between a kernel and a
library call: every candidate runs the same hand-written kernel.

Modes (``VELES_AUTOTUNE`` over ``root.common.engine.autotune`` over the
default ``cache``):

* ``off``: every consult answers ``("default", None)``: the plans' own
  choices, and the cache is never read;
* ``cache``: consult the cache; a miss answers the default without
  measuring (nothing is ever measured at a call site);
* ``search``: a miss on a CUDA device runs a sweep of at most
  ``VELES_AUTOTUNE_BUDGET_S`` seconds a key (default 20; the baseline is
  always measured): two rounds over the grid, each candidate timed over
  ``VELES_AUTOTUNE_ITERS`` launches (default 10, back to back between
  CUDA events) and kept at its best, and persists the winner at once. A candidate wins only when it beats the baseline by
  2%; one search runs a key at a time (a lock); a search in which
  nothing could be measured is not persisted. Anywhere but on a CUDA
  device a search answers the default without measuring.

The cache, ``VELES_AUTOTUNE_CACHE`` or ``<cache root>/autotune/<card
kind>.json``: ``{"version": CACHE_VERSION, "device": ..., "entries":
{key: entry}}``, merged with the file on every write (another process
may have tuned meanwhile) and written atomically; an unreadable or
stale file reads as empty.

What each plan tunes:

* :func:`linear_plan` (K1, and K2 without a bias): the split counts of
  ``gemm_plan(..., splits=)``; consulted by ``linear_act`` (so by
  ``LinearActFunction``'s forward) when its ``splits`` is None;
* :func:`gemm_plan` level 1 (K5): the split counts of
  ``kahan_plan(..., splits=)``; consulted by ``kahan_gemm``; level 2:
  ``pairwise_matmul``'s ``parts``; level 0 stays one ``torch.matmul``
  and answers the default;
* :func:`lrn_plan` and :func:`reduce_plan` keep the JAX package's keys
  and answer the default: K3, K4 and K6 take no configuration from a
  caller yet.

The call sites consult through :func:`linear_splits`,
:func:`kahan_splits` and :func:`pairwise_parts`, which memoize the
answer per key in the process (a dict lookup on the launch path);
:func:`reset` and every write to the cache drop the memo.

Telemetry: the counters ``veles_autotune_searches_total``,
``veles_autotune_cache_hits_total`` and ``veles_autotune_misses_total``,
the gauge ``veles_autotune_best_tflops{op,shape}``, a
``span("autotune:search")`` around each sweep, and the winner's row
``autotune:<op>:<shape>`` in the cost book. :func:`warm` reads the
card's cache under the ``autotune_load`` start-up phase.
"""

import json
import logging
import os
import re
import threading
import time

import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.envknob import env_knob
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.telemetry.registry import get_registry

_log = logging.getLogger("autotune")

_MODES = ("off", "cache", "search")
#: a candidate must beat the baseline by this share to win (noise
#: between runs must not flip the choice)
_WIN_MARGIN = 0.02
#: bump to invalidate every persisted entry at once
CACHE_VERSION = 1
#: rounds a search makes over its grid, keeping each candidate's best
SEARCH_PASSES = 2
#: the K split counts a search tries (each kept if the plan it gives
#: differs from the default's and from every other's)
SPLIT_LADDER = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)

_DEFAULT = ("default", None)
_search_lock = threading.Lock()
#: ``searching``: this thread runs a search (a consult from inside one,
#: e.g. a candidate's own launch, answers the default at once)
_local = threading.local()
_caches = {}
_caches_lock = threading.Lock()
_warned_corrupt = set()
_warmed = set()
#: (call site, key fields) -> the configuration value its consult
#: answered (see :func:`_consult`)
_memo = {}


# -- mode and environment ----------------------------------------------------

def mode():
    """The tuning mode: ``VELES_AUTOTUNE`` over the config tree."""
    m = env_knob("VELES_AUTOTUNE")
    if not m:
        m = root.common.engine.get("autotune", "cache")
    return m if m in _MODES else "cache"


def tunable(device):
    """May this process measure kernels on ``device``: a CUDA card."""
    return torch.device(device).type == "cuda" and \
        torch.cuda.is_available()


def device_kind():
    """The cache file's identity: one tuning database per card model."""
    kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"
    return re.sub(r"[^a-z0-9]+", "-", str(kind).lower()).strip("-") or \
        "unknown"


def cache_path():
    explicit = env_knob("VELES_AUTOTUNE_CACHE")
    if explicit:
        return explicit
    from veles_tpu_torch.loader.dataset_cache import veles_cache_dir
    return os.path.join(veles_cache_dir("autotune"), device_kind() + ".json")


def _dtype_name(dtype):
    """``torch.float32`` -> ``"float32"`` (the JAX keys' spelling)."""
    return str(dtype).replace("torch.", "")


# -- telemetry ---------------------------------------------------------------

def _metrics():
    reg = get_registry()
    return (
        reg.counter("veles_autotune_searches_total",
                    "Autotune measurement sweeps run"),
        reg.counter("veles_autotune_cache_hits_total",
                    "Autotune plans answered from the cache"),
        reg.counter("veles_autotune_misses_total",
                    "Autotune plans that fell back to the default path"),
        reg.gauge("veles_autotune_best_tflops",
                  "Best measured rate per tuned op/shape",
                  labels=("op", "shape")),
    )


# -- the persistent cache ----------------------------------------------------

class AutotuneCache(object):
    """One JSON file of ``{key: entry}`` winners: read lazily, an
    unreadable or stale file as empty, merged with the file and
    rewritten atomically on every :meth:`put`."""

    def __init__(self, path):
        self.path = path
        self._lock = threading.Lock()
        self._entries = None

    def _read_disk(self):
        try:
            with open(self.path) as f:
                blob = json.load(f)
            if (isinstance(blob, dict) and
                    blob.get("version") == CACHE_VERSION and
                    isinstance(blob.get("entries"), dict)):
                return dict(blob["entries"])
            raise ValueError("schema mismatch")
        except FileNotFoundError:
            return {}
        except Exception as e:  # a corrupt or stale cache is empty
            if self.path not in _warned_corrupt:
                _warned_corrupt.add(self.path)
                _log.warning("ignoring unreadable autotune cache %s "
                             "(%s: %s)", self.path, type(e).__name__, e)
            return {}

    def _ensure(self):
        """The first load. The caller holds ``self._lock``."""
        if self._entries is None:
            self._entries = self._read_disk()
        return self._entries

    def get(self, key):
        with self._lock:
            return self._ensure().get(key)

    def put(self, key, entry):
        with self._lock:
            # what other processes persisted since our load joins ours;
            # the key written here is ours
            merged = self._read_disk()
            self._ensure().update(
                {k: v for k, v in merged.items() if k not in self._entries})
            self._entries[key] = entry
            self._persist()
        _memo.clear()

    def _persist(self):
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = "%s.%d.tmp" % (self.path, os.getpid())
            with open(tmp, "w") as f:
                json.dump({"version": CACHE_VERSION,
                           "device": device_kind(),
                           "entries": self._entries}, f, indent=1,
                          sort_keys=True)
            os.replace(tmp, self.path)
        except OSError as e:  # the cache saves time; it never fails a run
            _log.warning("could not write autotune cache %s: %s",
                         self.path, e)

    def __len__(self):
        with self._lock:
            return len(self._ensure())

    def items(self):
        with self._lock:
            return sorted(self._ensure().items())


def get_cache(path=None):
    path = path or cache_path()
    with _caches_lock:
        cache = _caches.get(path)
        if cache is None:
            cache = _caches[path] = AutotuneCache(path)
        return cache


def reset():
    """Drop the in-memory caches and the consult memo (after a change of
    ``VELES_AUTOTUNE`` or ``VELES_AUTOTUNE_CACHE``; files stay)."""
    with _caches_lock:
        _caches.clear()
    _warned_corrupt.clear()
    _warmed.clear()
    _memo.clear()


def warm():
    """Read the card's cache into memory ahead of the first launch
    (``AcceleratedUnit.initialize`` on a CUDA device), under the
    ``autotune_load`` phase; one read per file a process. Returns the
    entry count (0 when off)."""
    if mode() == "off":
        return 0
    from veles_tpu_torch.telemetry import profiler
    cache = get_cache()
    with profiler.phase("autotune_load"):
        n = len(cache)
    if cache.path not in _warmed:
        _warmed.add(cache.path)
        _log.info("autotune cache %s: %d tuned shapes (mode=%s)",
                  cache.path, n, mode())
    return n


# -- measurement -------------------------------------------------------------

def _measure(fn, iters=None):
    """Seconds a call of ``fn()`` (which launches on the current CUDA
    stream): one call to settle, then ``iters`` back to back between two
    CUDA events."""
    if iters is None:
        iters = env_knob("VELES_AUTOTUNE_ITERS", 10, parse=int)
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _operands(shapes, dtype, device, seed=0):
    """Uniform [-0.5, 0.5) tensors of ``shapes``, made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return [(torch.rand(shape, generator=gen, device=device) - 0.5).to(
        dtype) for shape in shapes]


# -- the plan and search core ------------------------------------------------

def _key(op, **fields):
    return op + "|" + "|".join(
        "%s=%s" % (k, fields[k]) for k in sorted(fields))


def _plan(op, fields, candidates_fn, runner_fn, device, flops=None,
          shape_label=None):
    """``(impl, config)`` of one op instance.

    ``candidates_fn()``: the ordered ``[(impl, config)]``, the plan's
    own choice first; ``runner_fn(impl, config)``: a callable that
    launches that candidate once, or None to skip it. The cache first;
    a search only in ``search`` mode on a CUDA ``device``."""
    m = mode()
    if m == "off":
        return _DEFAULT
    searches, hits, misses, best_gauge = _metrics()
    cache = get_cache()
    key = _key(op, **fields)
    entry = cache.get(key)
    if entry is not None:
        hits.inc()
        return entry["impl"], entry.get("config")
    if m != "search" or device is None or not tunable(device) or \
            getattr(_local, "searching", False):
        misses.inc()
        return _DEFAULT
    with _search_lock:
        entry = cache.get(key)  # another thread tuned it meanwhile
        if entry is None:
            _local.searching = True
            try:
                entry = _search(op, key, candidates_fn(), runner_fn, flops,
                                shape_label)
            finally:
                _local.searching = False
            if entry is None:  # nothing measured: persist nothing
                misses.inc()
                return _DEFAULT
            cache.put(key, entry)
    return entry["impl"], entry.get("config")


def _search(op, key, candidates, runner_fn, flops, shape_label):
    searches, hits, misses, best_gauge = _metrics()
    searches.inc()
    budget = env_knob("VELES_AUTOTUNE_BUDGET_S", 20.0, parse=float)
    best, failed = {}, set()
    with tracing.span("autotune:search", op=op, key=key):
        t0 = time.perf_counter()
        # SEARCH_PASSES rounds over the grid, each candidate's best: the
        # one timed first (the baseline) is not slower for going first,
        # while the card's clocks settle
        for _ in range(SEARCH_PASSES):
            for i, (impl, cfg) in enumerate(candidates):
                # the baseline is always measured, the rest within budget
                if best and time.perf_counter() - t0 > budget:
                    break
                if i in failed:
                    continue
                fn = runner_fn(impl, cfg)
                if fn is None:
                    failed.add(i)
                    continue
                try:
                    seconds = _measure(fn)
                except Exception as e:  # noqa: BLE001 -- drop the candidate
                    failed.add(i)
                    _log.warning("autotune %s: candidate %s %s failed: %s",
                                 key, impl, cfg, e)
                    continue
                best[i] = min(best.get(i, seconds), seconds)
    results = [candidates[i] + (seconds,) for i, seconds in
               sorted(best.items()) if i not in failed]
    if not results:
        return None
    # the win margin applies only against a baseline that ran; a
    # surviving candidate is never labelled the baseline
    base_id = (candidates[0][0], candidates[0][1])
    base = next((r for r in results if (r[0], r[1]) == base_id), None)
    impl, cfg, best_s = min(results, key=lambda r: r[2])
    if base is not None and (impl, cfg) != base_id and \
            best_s > base[2] * (1.0 - _WIN_MARGIN):
        impl, cfg, best_s = base
    by_config = {}
    for r_impl, r_cfg, r_s in results:
        label = "%s %s" % (r_impl, json.dumps(r_cfg, sort_keys=True))
        by_config[label] = round(r_s * 1e3, 4)
    entry = {"impl": impl, "config": cfg,
             "baseline_impl": base[0] if base else None,
             "best_ms": round(best_s * 1e3, 4),
             "candidate_ms": by_config,
             "candidates": len(results)}
    if base is not None:
        entry["baseline_ms"] = round(base[2] * 1e3, 4)
    if flops:
        if base is not None:
            entry["baseline_tflops"] = round(flops / base[2] / 1e12, 3)
        entry["best_tflops"] = round(flops / best_s / 1e12, 3)
        try:
            from veles_tpu_torch.telemetry import profiler
            book = profiler.get_cost_book()
            label = "autotune:%s:%s" % (op, shape_label or "?")
            book.note_cost(label, flops, 0.0)
            book.observe_ms(label, best_s)
        except Exception:  # noqa: BLE001 -- the row is a report only
            _log.debug("autotune: no cost-book row", exc_info=True)
        best_gauge.labels(op=op, shape=shape_label or "?").set(
            entry["best_tflops"])
    return entry


def summary():
    """Path, mode, card kind, entries and counters, for scripts."""
    reg = get_registry()

    def _val(name):
        metric = reg.get(name)
        return metric.value if metric is not None else 0.0

    cache = get_cache()
    return {"path": cache.path, "mode": mode(),
            "device": device_kind(), "entries": dict(cache.items()),
            "searches": _val("veles_autotune_searches_total"),
            "hits": _val("veles_autotune_cache_hits_total"),
            "misses": _val("veles_autotune_misses_total")}


def _explicit(value):
    """A candidate's count as the call site takes it without consulting
    the tuner: ``0`` is the plan's own choice (None would consult)."""
    return 0 if value is None else value


# -- candidate grids ---------------------------------------------------------

def _gemm_mod():
    import sys
    import veles_tpu_torch.ops.gemm  # noqa: F401 -- the sys.modules entry
    return sys.modules["veles_tpu_torch.ops.gemm"]


def linear_candidates(m, n, k, dtype):
    """K1's grid: ``("kernel", {"splits": None})`` (the plan's own
    choice) first, then ``{"splits": s}`` for each count of
    :data:`SPLIT_LADDER` whose ``gemm_plan(..., splits=s)`` cuts K
    otherwise than the default and every earlier candidate."""
    plan = _gemm_mod().gemm_plan
    default = plan(m, n, k, dtype)
    seen = {(default.splits, default.kchunk)}
    cands = [("kernel", {"splits": None})]
    for s in SPLIT_LADDER:
        got = plan(m, n, k, dtype, True, s)
        if (got.splits, got.kchunk) not in seen:
            seen.add((got.splits, got.kchunk))
            cands.append(("kernel", {"splits": s}))
    return cands


def kahan_candidates(m, n, k, bk, dtype):
    """K5's grid: the plan's own choice, then each count of
    :data:`SPLIT_LADDER` whose ``kahan_plan(..., splits=s)`` differs
    from the default and every earlier candidate."""
    plan = _gemm_mod().kahan_plan
    default = plan(m, n, k, bk, dtype)
    seen = {(default.splits, default.blocks_per_split)}
    cands = [("kernel", {"splits": None})]
    for s in SPLIT_LADDER:
        got = plan(m, n, k, bk, dtype, True, s)
        if (got.splits, got.blocks_per_split) not in seen:
            seen.add((got.splits, got.blocks_per_split))
            cands.append(("kernel", {"splits": s}))
    return cands


def pairwise_candidates(k):
    """Level 2's grid: ``parts`` of the default rule, then powers of two
    dividing K (8 candidates at most, the JAX package's)."""
    cands, p = [("pairwise", {"parts": None})], 2
    while p < k and len(cands) < 8:
        if k % p == 0:
            cands.append(("pairwise", {"parts": p}))
        p *= 2
    return cands


# -- op plans ----------------------------------------------------------------

def linear_plan(m, n, k, dtype, activation, out_dtype, bias=True,
                device=None):
    """Plan K1's ``act(x @ w + b)`` of x (m, k), w (k, n) in ``dtype``
    (K2's ``x @ w`` with ``bias=False``): ``("kernel", {"splits": s})``
    (None: the plan's own) or the default. The key is the JAX
    package's and ``bias``; searched on ``device``'s card."""
    if mode() == "off":
        return _DEFAULT
    gemm_mod = _gemm_mod()
    fields = dict(m=m, n=n, k=k, dtype=_dtype_name(dtype),
                  act=str(activation), out=_dtype_name(out_dtype),
                  bias=int(bool(bias)))
    made = {}

    def run(impl, cfg):
        if not made:
            made["x"], made["w"] = _operands([(m, k), (k, n)], dtype, device)
            made["b"], = _operands([(n,)], torch.float32, device, seed=1) \
                if bias else (None,)
        x, w, b = made["x"], made["w"], made["b"]
        splits = _explicit(cfg["splits"])
        return lambda: gemm_mod.linear_act(x, w, b, activation, out_dtype,
                                           splits=splits)
    return _plan("linear", fields, lambda: linear_candidates(
        m, n, k, dtype), run, device, 2.0 * m * n * k,
        "%dx%dx%d" % (m, n, k))


def gemm_plan(m, n, k, dtype, ta=False, tb=False, level=0, bk=None,
              device=None):
    """Plan one ``gemm()`` product by precision level: level 1 (K5)
    ``("kernel", {"splits": s})`` over ``kahan_plan``'s split counts
    (Kahan blocks ``bk`` deep, default ``min(512, K)``), level 2
    ``("pairwise", {"parts": p})``; level 0 stays one ``torch.matmul``
    and answers the default. ``ta``/``tb`` are part of the key (the JAX
    package's); the port's kernels take row-major operands."""
    if mode() == "off" or level <= 0:
        return _DEFAULT
    gemm_mod = _gemm_mod()
    fields = dict(m=m, n=n, k=k, dtype=_dtype_name(dtype),
                  ta=int(bool(ta)), tb=int(bool(tb)))
    flops = 2.0 * m * n * k
    label = "%dx%dx%d" % (m, n, k)
    made = {}

    def operands():
        if not made:
            made["ab"] = _operands([(m, k), (k, n)], dtype, device)
        return made["ab"]

    if level == 1:
        bk = max(1, min(int(bk or gemm_mod.KAHAN_BK), k))
        fields["bk"] = bk

        def run(impl, cfg):
            a, b = operands()
            splits = _explicit(cfg["splits"])
            return lambda: gemm_mod.kahan_gemm(a, b, bk=bk, splits=splits)
        return _plan("gemm_kahan", fields, lambda: kahan_candidates(
            m, n, k, bk, dtype), run, device, flops, label)

    def run(impl, cfg):
        a, b = operands()
        parts = _explicit(cfg["parts"])
        return lambda: gemm_mod.pairwise_matmul(a, b, parts=parts)
    return _plan("gemm_pairwise", fields, lambda: pairwise_candidates(k),
                 run, device, flops, label)


def lrn_plan(rows, channels, dtype, which="fwd"):
    """The JAX package's key for K3 (``which="fwd"``) and K4
    (``"bwd"``), ``lrn_<which>|c=|dtype=|rows=|which=``: the default.
    The kernels take no configuration from a caller yet."""
    return _DEFAULT


def reduce_plan(m, n, dtype):
    """The JAX package's key for K6, ``col_reduce|dtype=|m=|n=``: the
    default. ``column_sum`` takes no configuration from a caller
    yet."""
    return _DEFAULT


# -- the call sites' consults -------------------------------------------------

def _consult(site, fields, plan, name):
    """The ``name`` value of the configuration :func:`_plan` answers for
    ``fields`` at a call site, memoized per key when the answer is
    final for this process (a hit, off, or a miss in ``cache`` mode):
    a failed search is asked again next time."""
    memo_key = (site,) + fields
    try:
        return _memo[memo_key]
    except KeyError:
        pass
    impl, cfg = plan()
    value = cfg.get(name) if cfg else None
    if impl != "default" or mode() != "search":
        _memo[memo_key] = value
    return value


def linear_splits(m, n, k, dtype, activation, out_dtype, bias, device):
    """The split count ``linear_act`` launches K1 with (None: the
    plan's own); ``bias``: whether it adds one."""
    return _consult("linear", (m, n, k, dtype, activation, out_dtype,
                               bias),
                    lambda: linear_plan(m, n, k, dtype, activation,
                                        out_dtype, bias, device), "splits")


def kahan_splits(m, n, k, bk, dtype, device):
    """The split count ``kahan_gemm`` launches K5 with (None: the
    plan's own)."""
    return _consult("kahan", (m, n, k, bk, dtype),
                    lambda: gemm_plan(m, n, k, dtype, level=1, bk=bk,
                                      device=device), "splits")


def pairwise_parts(m, n, k, dtype, device):
    """The ``parts`` of a level-2 product on a CUDA device (None: the
    default rule)."""
    return _consult("pairwise", (m, n, k, dtype),
                    lambda: gemm_plan(m, n, k, dtype, level=2,
                                      device=device), "parts")
