"""Performance attribution: cost book, roofline, step MFU, phases and
memory (the port of ``veles_tpu/telemetry/profiler.py``).

* **per-op cost attribution** -- every op the system times (the train
  and eval sweeps, each serving bucket's forward, the offload
  transfers) is a row of the :class:`CostBook`: its analytic FLOPs and
  bytes, noted by the caller with :meth:`CostBook.note_cost`, beside its
  *measured* wall time from the registry, and the roofline verdict
  against the card's peaks (``veles_op_flops``, ``veles_op_bytes``,
  ``veles_op_ms``). The JAX package harvests the FLOPs and bytes from
  XLA's ``cost_analysis()`` of a compiled program; the port has no
  compiled program, and ``torch.utils.flop_counter`` cannot see the
  kernels launched through ``ctypes`` and the CPython bindings, so the
  costs come from the model's layers
  (:func:`veles_tpu_torch.models.build.model_cost`);
* **step MFU** -- the train sweep's analytic FLOPs over its measured
  wall time, as a fraction of the card's peak (``veles_step_mfu``). One
  peak per card, its dense bf16 rate: a float32 step's MFU is measured
  against the bf16 peak too;
* **startup phases** -- :func:`phase` marks the cold-start stages as
  spans and one-shot ``veles_phase_ms{phase}`` gauges;
* **memory** -- :class:`MemorySampler` folds the caching allocator's
  live and peak bytes of every card (``torch.cuda.memory_stats``, which
  reads host-side counters and never synchronizes) and the host RSS
  into gauges; :func:`dump_memory_profile` writes the allocator's
  snapshot (``torch.cuda.memory._snapshot()``, a pickle that
  ``torch.cuda._memory_viz`` renders) where the JAX package writes
  ``jax.profiler.device_memory_profile``'s pprof.

Times are host times: the instrumented sites end where the path already
waits for the card, and nothing here synchronizes or launches a kernel.
``VELES_COST_ATTRIBUTION=0`` turns the noting of analytic costs off.
"""

import atexit
import json
import logging
import os
import threading
import time

from veles_tpu_torch.envknob import env_flag, env_knob
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.telemetry.registry import get_registry

_log = logging.getLogger(__name__)

#: (peak dense TFLOP/s, HBM GB/s) per ``torch.cuda.get_device_name``
#: prefix -- NVIDIA's data sheet, bf16 peak without sparsity. The
#: roofline ridge point is their ratio. Unknown cards (and the CPU)
#: fall back to the VELES_PEAK_TFLOPS / VELES_HBM_GBPS overrides, else
#: attribution reports absolute numbers with MFU and verdict omitted.
DEVICE_SPECS = (
    ("NVIDIA H100 80GB HBM3", (989.0, 3350.0)),
)


def _env_positive(name):
    """float(env) or None -- a typo'd override must degrade to
    "unknown peak" (no MFU/verdict), never unwind a training sweep."""
    value = env_knob(name, parse=float, on_error="default")
    return value if value is not None and value > 0 else None


def _device_kind(device=None):
    """The card's name, or "" off the card."""
    try:
        import torch
        if not torch.cuda.is_available():
            return ""
        return torch.cuda.get_device_name(device)
    except (ImportError, RuntimeError, AssertionError):
        return ""


def device_spec(device=None):
    """``(peak_flops_per_s, hbm_bytes_per_s)`` for ``device`` (default:
    the current card), or ``(None, None)`` when unknown."""
    tflops = _env_positive("VELES_PEAK_TFLOPS")
    gbps = _env_positive("VELES_HBM_GBPS")
    if tflops and gbps:
        return tflops * 1e12, gbps * 1e9
    kind = _device_kind(device)
    for prefix, (tf, gb) in DEVICE_SPECS:
        if kind.startswith(prefix):
            return tf * 1e12, gb * 1e9
    return ((tflops * 1e12 if tflops else None),
            (gbps * 1e9 if gbps else None))


def attribution_enabled():
    return env_flag("VELES_COST_ATTRIBUTION", True)


class CostBook(object):
    """Per-op ledger: analytic cost (noted by the caller) joined with
    measured wall time (observed per call) and the card's roofline."""

    def __init__(self, registry=None):
        registry = registry or get_registry()
        self._lock = threading.Lock()
        self._costs = {}          # op -> {"flops", "bytes"}
        self._g_flops = registry.gauge(
            "veles_op_flops", "Analytic FLOPs per execution of a "
            "compiled op (XLA cost model)", labels=("op",))
        self._g_bytes = registry.gauge(
            "veles_op_bytes", "Analytic bytes accessed per execution "
            "of a compiled op (XLA cost model)", labels=("op",))
        self._h_ms = registry.histogram(
            "veles_op_ms", "Measured wall time per compiled-op call",
            labels=("op",))
        self._g_mfu = registry.gauge(
            "veles_step_mfu", "Model FLOPs utilization of the train "
            "step (analytic FLOPs / measured time / device peak)")
        # the JAX package's family (an estimate read from a partitioned
        # XLA program): registered under the same name and help so that
        # /metrics lists the same families; the port never sets it
        registry.gauge(
            "veles_op_collective_bytes",
            "Estimated bytes moved per execution by the "
            "compiler-inserted collectives of a partitioned op "
            "(summed HLO collective output shapes, per device)",
            labels=("op",))

    # -- recording ---------------------------------------------------------

    def note_cost(self, op, flops, bytes_accessed):
        """Record ``op``'s analytic FLOPs and bytes for one execution
        (a no-op under ``VELES_COST_ATTRIBUTION=0``)."""
        if not attribution_enabled():
            return
        with self._lock:
            self._costs[op] = {"flops": float(flops),
                               "bytes": float(bytes_accessed)}
        self._g_flops.labels(op=op).set(flops)
        self._g_bytes.labels(op=op).set(bytes_accessed)

    def observe_ms(self, op, elapsed_s):
        self._h_ms.labels(op=op).observe(elapsed_s * 1e3)

    def cost(self, op):
        with self._lock:
            return dict(self._costs.get(op) or {}) or None

    # -- derived -----------------------------------------------------------

    def record_step_mfu(self, op, elapsed_s):
        """Set ``veles_step_mfu`` from one measured execution of ``op``
        (the train sweep). Returns the MFU or None."""
        cost = self.cost(op)
        peak, _ = device_spec()
        if not cost or not cost["flops"] or not peak or elapsed_s <= 0:
            return None
        mfu = cost["flops"] / elapsed_s / peak
        self._g_mfu.set(mfu)
        return mfu

    def report(self):
        """The attribution table: one row per op with analytic cost,
        measured time (registry percentiles) and the roofline verdict.
        JSON-able -- what ``/profile.json`` renders; the JAX package's
        schema."""
        peak_flops, peak_bw = device_spec()
        ridge = (peak_flops / peak_bw
                 if peak_flops and peak_bw else None)
        with self._lock:
            costs = {op: dict(c) for op, c in self._costs.items()}
        measured = {}
        for labels, child in self._h_ms.series():
            measured[labels.get("op")] = child.summary()
        ops = []
        for op in sorted(set(costs) | set(measured)):
            cost = costs.get(op) or {}
            times = measured.get(op) or {}
            row = {"op": op,
                   "flops": cost.get("flops"),
                   "bytes": cost.get("bytes"),
                   "calls": times.get("count", 0),
                   "p50_ms": times.get("p50"),
                   "p95_ms": times.get("p95")}
            flops, byts = cost.get("flops"), cost.get("bytes")
            if flops and byts:
                row["arithmetic_intensity"] = flops / byts
                if ridge is not None:
                    row["bound"] = ("compute"
                                    if row["arithmetic_intensity"] >= ridge
                                    else "memory")
            p50 = times.get("p50")
            if flops and p50:
                row["achieved_tflops"] = flops / (p50 / 1e3) / 1e12
                if peak_flops:
                    row["utilization"] = (flops / (p50 / 1e3) /
                                          peak_flops)
            if byts and p50:
                row["achieved_gbps"] = byts / (p50 / 1e3) / 1e9
            ops.append(row)
        out = {"ops": ops,
               "device": {"peak_tflops": (peak_flops / 1e12
                                          if peak_flops else None),
                          "hbm_gbps": (peak_bw / 1e9
                                       if peak_bw else None),
                          "ridge_flops_per_byte": ridge}}
        try:
            out["step_mfu"] = self._g_mfu.value
        except ValueError:  # never set this process
            out["step_mfu"] = None
        return out


_book = None
_book_lock = threading.Lock()


def get_cost_book():
    global _book
    with _book_lock:
        if _book is None:
            _book = CostBook()
        return _book


def reset_cost_book():
    """Tests only: drop the book so a fresh registry gets fresh gauges."""
    global _book
    with _book_lock:
        _book = None


class timed_op(object):
    """Context manager timing one execution of a named op into the
    cost book (span + ``veles_op_ms``). It ends where the caller's
    block ends: put the host read that waits for the card inside it."""

    __slots__ = ("op", "_start", "_book")

    def __init__(self, op, book=None):
        self.op = op
        self._book = book or get_cost_book()

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self._start
        self._book.observe_ms(self.op, elapsed)
        tracing.add_complete("op:%s" % self.op, self._start, elapsed)
        return False


# -- startup phases ----------------------------------------------------------

PHASES = ("dataset_generate", "dataset_load", "autotune_load",
          "compile", "warmup", "replica_warmup", "pipeline_fill",
          "offload_plan", "first_step")

_phase_lock = threading.Lock()
_phase_ms = {}  # phase -> cumulative ms this process


class _Phase(object):
    __slots__ = ("name", "_start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        elapsed = time.perf_counter() - self._start
        record_phase(self.name, elapsed)
        tracing.add_complete("phase:%s" % self.name, self._start,
                             elapsed)
        return False


def phase(name):
    """Span + ``veles_phase_ms{phase}`` for one startup stage. Phases
    ACCUMULATE within a process (two datasets load = one total)."""
    return _Phase(name)


def record_phase(name, elapsed_s):
    with _phase_lock:
        _phase_ms[name] = _phase_ms.get(name, 0.0) + elapsed_s * 1e3
        total = _phase_ms[name]
    get_registry().gauge(
        "veles_phase_ms", "Cumulative startup-phase wall time",
        labels=("phase",)).labels(phase=name).set(total)


def phase_report():
    """``{phase: ms}`` in canonical order (extras appended)."""
    with _phase_lock:
        snap = dict(_phase_ms)
    out = {}
    for name in PHASES:
        if name in snap:
            out[name] = round(snap.pop(name), 3)
    for name in sorted(snap):
        out[name] = round(snap[name], 3)
    return out


def reset_phases():
    """Tests only."""
    with _phase_lock:
        _phase_ms.clear()


# -- memory ------------------------------------------------------------------


def host_rss_bytes():
    """Resident set size of this process, or None off-Linux."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def _card_memory(index):
    """(live, peak, limit) bytes of card ``index`` from the caching
    allocator's counters and the driver's total; no synchronization."""
    import torch
    stats = torch.cuda.memory_stats(index)
    live = stats.get("allocated_bytes.all.current")
    peak = stats.get("allocated_bytes.all.peak")
    _, total = torch.cuda.mem_get_info(index)
    return live, peak, total


def sample_memory(registry=None):
    """One sample of every card's allocator bytes and the host RSS into
    gauges (labels ``cuda:<i>``). Returns the JSON-able sample (what
    ``/profile.json`` embeds)."""
    registry = registry or get_registry()
    g_live = registry.gauge(
        "veles_hbm_live_bytes", "Live device memory", labels=("device",))
    g_peak = registry.gauge(
        "veles_hbm_peak_bytes", "Peak device memory", labels=("device",))
    g_limit = registry.gauge(
        "veles_hbm_limit_bytes", "Device memory capacity",
        labels=("device",))
    g_rss = registry.gauge("veles_host_rss_bytes", "Host process RSS")
    sample = {"devices": {}, "host_rss_bytes": None}
    try:
        import torch
        # is_initialized(): a process that never touched the card has
        # nothing allocated, and sampling must not create a context
        count = (torch.cuda.device_count()
                 if torch.cuda.is_available() and
                 torch.cuda.is_initialized() else 0)
    except ImportError:
        count = 0
    for index in range(count):
        live, peak, limit = _card_memory(index)
        label = "cuda:%d" % index
        entry = {}
        if live is not None:
            g_live.labels(device=label).set(live)
            entry["live_bytes"] = int(live)
        if peak is not None:
            g_peak.labels(device=label).set(peak)
            entry["peak_bytes"] = int(peak)
        if limit is not None:
            g_limit.labels(device=label).set(limit)
            entry["limit_bytes"] = int(limit)
        if entry:
            sample["devices"][label] = entry
    rss = host_rss_bytes()
    if rss is not None:
        g_rss.set(rss)
        sample["host_rss_bytes"] = rss
    return sample


class MemorySampler(object):
    """Daemon thread folding :func:`sample_memory` into the registry
    every ``interval`` seconds. It reads counters and launches nothing
    on any stream."""

    def __init__(self, interval=5.0, registry=None):
        self.interval = float(interval)
        self._registry = registry
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="memory-sampler")
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                sample_memory(self._registry)
            except Exception:  # advisory: never kill its host
                pass

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_sampler = None


def start_memory_sampler(interval=None):
    """Process-wide sampler (idempotent), joined when the interpreter
    exits: a daemon thread still inside a card query while the
    interpreter finalizes aborts the process ("terminate called without
    an active exception"). ``VELES_MEMORY_SAMPLE_S`` overrides the
    interval; 0 disables."""
    global _sampler
    if interval is None:
        env = _env_positive("VELES_MEMORY_SAMPLE_S")
        if env is None and \
                env_knob("VELES_MEMORY_SAMPLE_S") is not None:
            return None  # explicit 0 / unparsable: sampling off
        interval = env if env is not None else 5.0
    if interval <= 0:
        return None
    with _book_lock:
        if _sampler is None:
            _sampler = MemorySampler(interval=interval).start()
            atexit.register(stop_memory_sampler)
    return _sampler


def stop_memory_sampler():
    """Join the process-wide sampler (tests / orderly shutdown)."""
    global _sampler
    with _book_lock:
        sampler, _sampler = _sampler, None
    if sampler is not None:
        sampler.stop()


def record_memory_history():
    """Start the caching allocator's record of every allocation with its
    stack (what :func:`dump_memory_profile` writes). Returns True when
    recording, False off the card."""
    import torch
    if not torch.cuda.is_available():
        return False
    torch.cuda.memory._record_memory_history(max_entries=100000)
    return True


def stop_memory_history():
    """Stop :func:`record_memory_history`'s record (off the card: no-op)."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.memory._record_memory_history(enabled=None)


def dump_memory_profile(path):
    """Write the caching allocator's snapshot
    (``torch.cuda.memory._snapshot()``: segments, blocks and, after
    :func:`record_memory_history`, each allocation's stack) to ``path``
    as a pickle. Returns True on success, False off the card; a failure
    on the card raises."""
    import pickle

    import torch
    if not torch.cuda.is_available():
        return False
    snapshot = torch.cuda.memory._snapshot()
    tmp = "%s.%d.tmp" % (path, os.getpid())
    with open(tmp, "wb") as f:
        pickle.dump(snapshot, f)
    os.replace(tmp, path)
    return True


# -- --trace-out -------------------------------------------------------------


def dump_trace(path, process_name):
    """End a :func:`start_trace` session: write the trace buffer to
    ``path`` and, on the card, the caching allocator's snapshot to
    ``<path>.memprof``, then turn tracing and the allocator's record off
    (a process that runs on, as a test or a benchmark does, pays for
    neither). A failure to write either file raises: a run asked for the
    files never ends without them unnoticed."""
    try:
        n = tracing.get_buffer().dump(path, process_name=process_name)
        _log.info("wrote %d trace events to %s", n, path)
        try:
            if dump_memory_profile(path + ".memprof"):
                _log.info("wrote the device memory profile to %s.memprof",
                          path)
        except Exception:
            _log.exception("could not write the device memory profile %s",
                           path + ".memprof")
            raise
    finally:
        tracing.disable()
        stop_memory_history()


def start_trace(path):
    """``--trace-out``: enable tracing, remove a stale file (the exit
    dump merges into an existing one) and, on the card, start the
    caching allocator's record of allocations for the memory profile."""
    tracing.enable()
    try:
        os.remove(path)
    except OSError:
        pass
    try:
        record_memory_history()
    except Exception:
        _log.exception("could not start the device memory record")
        raise


# -- the /profile.json payload ----------------------------------------------


def profile_report():
    """Everything the observability surfaces render: attribution table,
    step MFU, startup phases, the latest memory sample, and the last
    flight-record path (when the recorder has written one)."""
    from veles_tpu_torch.telemetry import flight
    report = get_cost_book().report()
    report["phases_ms"] = phase_report()
    try:
        report["memory"] = sample_memory()
    except Exception:
        report["memory"] = None
    report["flight_record"] = flight.last_record_path()
    return report


def render_profile_json():
    return json.dumps(profile_report())
