"""Training flight recorder: bounded black box + failure detectors (the
port's copy of ``veles_tpu/telemetry/flight.py``).

A :class:`FlightRecorder` keeps a
bounded ring of recent training notes (step completions, loss/metric
deltas, detector observations), the tail of the process log and — when
tracing is on — the most recent spans. When something goes wrong it
writes everything as ONE atomic JSON "flight record" an operator can
load after the fact, the way a post-incident investigation wants it:

* **NaN/Inf loss** — the fused runner feeds every sweep's per-batch
  loss vector (already on the host: the sweep's own read) to
  :meth:`FlightRecorder.check_losses`; the first
  non-finite entry trips a record naming the offending epoch + batch;
* **gradient-norm divergence** — per-batch global gradient norms
  (:class:`~veles_tpu_torch.train.step.FusedTrainer` keeps them in
  ``last_grad_norms``) trip when one exceeds ``VELES_GRAD_SPIKE_FACTOR``× the
  rolling p95 of the preceding window, or goes non-finite;
* **stall watchdog** — the runner arms the watchdog around each
  sweep; if no completion lands within
  ``VELES_STALL_FACTOR``× the rolling p95 of previous sweeps (floored
  at ``VELES_STALL_MIN_S``), the watchdog writes a ``faulthandler``
  all-thread stack dump next to the flight record — the "why is it
  hung" evidence that is unrecoverable once the process is killed;
* **unhandled step exceptions** — the runner's crash path dumps the
  same record before re-raising.

Records land under ``VELES_FLIGHT_DIR`` (default ``flight_records/``)
as ``flight-<utc>-<reason>.json`` via write-to-temp + rename, so a
watching process (or the web dashboard's link) never reads a torn
file. Dumps are rate-limited per reason — a NaN that recurs every
batch must not fill the disk. The watchdog thread reads the host clock
only: it touches no CUDA stream.
"""

import collections
import faulthandler
import json
import logging
import os
import threading
import time

from veles_tpu_torch.envknob import env_knob
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.telemetry.registry import Reservoir, get_registry

#: how many trailing trace-buffer spans a record embeds
SPAN_TAIL = 200


def _env_float(name, default):
    return env_knob(name, default, parse=float, on_error="default")


class LogTail(logging.Handler):
    """Bounded ring of the most recent formatted log lines."""

    def __init__(self, capacity=200):
        super(LogTail, self).__init__()
        self.records = collections.deque(maxlen=capacity)

    def emit(self, record):
        try:
            self.records.append({
                "t": record.created,
                "level": record.levelname,
                "logger": record.name,
                "message": record.getMessage()})
        except Exception:  # a broken record must not break training
            pass

    def tail(self):
        return list(self.records)


class FlightRecorder(object):
    """The black box. One per process (:func:`get_recorder`)."""

    def __init__(self, capacity=512, log_capacity=200, out_dir=None,
                 stall_factor=None, stall_min_s=None,
                 grad_spike_factor=None, poll_s=1.0,
                 min_dump_interval_s=5.0):
        self.out_dir = out_dir or env_knob(
            "VELES_FLIGHT_DIR", "flight_records")
        self.stall_factor = (stall_factor if stall_factor is not None
                             else _env_float("VELES_STALL_FACTOR", 10.0))
        self.stall_min_s = (stall_min_s if stall_min_s is not None
                            else _env_float("VELES_STALL_MIN_S", 60.0))
        self.grad_spike_factor = (
            grad_spike_factor if grad_spike_factor is not None
            else _env_float("VELES_GRAD_SPIKE_FACTOR", 25.0))
        self._notes = collections.deque(maxlen=capacity)
        self._log_tail = LogTail(log_capacity)
        self._lock = threading.Lock()
        self._durations = Reservoir(128)    # sweep seconds
        self._grad_norms = Reservoir(512)   # recent finite norms
        self._grad_seen = 0
        self._last_dump = {}                # reason -> perf_counter
        self._last_path = None
        self._min_dump_interval_s = min_dump_interval_s
        self._dump_listeners = []
        registry = get_registry()
        self._m_records = registry.counter(
            "veles_flight_records_total",
            "Flight records written", labels=("reason",))
        self._m_trips = registry.counter(
            "veles_flight_detector_trips_total",
            "Detector trips (may be rate-limited before dumping)",
            labels=("detector",))
        # watchdog state
        self._poll_s = poll_s
        self._armed = None        # (label, perf_deadline) or None
        self._watch_stop = threading.Event()
        self._watch_thread = None
        logging.getLogger().addHandler(self._log_tail)

    # -- the ring ----------------------------------------------------------

    def note(self, kind, **data):
        data["t"] = time.time()
        data["kind"] = kind
        with self._lock:
            self._notes.append(data)

    def notes(self):
        with self._lock:
            return list(self._notes)

    # -- step bookkeeping + detectors --------------------------------------

    def observe_step(self, phase, duration_s, loss=None, epoch=None):
        """One completed sweep: feeds the stall watchdog's rolling p95
        and the ring."""
        with self._lock:
            self._durations.add(duration_s)
        self.note("step", phase=phase, epoch=epoch,
                  ms=round(duration_s * 1e3, 3),
                  loss=None if loss is None else float(loss))

    def check_losses(self, losses, epoch=None, phase="train"):
        """Trip on the first non-finite entry of a sweep's per-batch
        loss vector. Returns the flight-record path when tripped."""
        import numpy
        values = numpy.asarray(losses, numpy.float64).reshape(-1)
        finite = numpy.isfinite(values)
        if finite.all():
            return None
        batch = int(numpy.argmin(finite))
        self._m_trips.labels(detector="non_finite_loss").inc()
        return self.dump("non_finite_loss", epoch=epoch, phase=phase,
                         batch=batch, value=repr(values[batch]),
                         step="epoch %s batch %d of %s sweep"
                              % (epoch, batch, phase))

    def observe_grad_norms(self, norms, epoch=None):
        """Per-batch global gradient norms of one train sweep: trip on
        non-finite or a spike above factor× the rolling p95 of the
        PRECEDING window (so the spike does not judge itself)."""
        import numpy
        values = numpy.asarray(norms, numpy.float64).reshape(-1)
        path = None
        for batch, value in enumerate(values):
            if not numpy.isfinite(value):
                self._m_trips.labels(detector="grad_norm").inc()
                path = path or self.dump(
                    "non_finite_grad_norm", epoch=epoch, batch=batch,
                    step="epoch %s batch %d" % (epoch, batch))
                continue
            with self._lock:
                seen = self._grad_seen
                p95 = self._grad_norms.percentile(95) if seen else 0.0
            if seen >= 32 and value > self.grad_spike_factor * max(
                    p95, 1e-30):
                self._m_trips.labels(detector="grad_norm").inc()
                path = path or self.dump(
                    "grad_norm_divergence", epoch=epoch, batch=batch,
                    norm=float(value), rolling_p95=float(p95),
                    factor=self.grad_spike_factor,
                    step="epoch %s batch %d" % (epoch, batch))
            with self._lock:
                self._grad_norms.add(value)
                self._grad_seen += 1
        if len(values):
            finite = values[numpy.isfinite(values)]
            self.note("grad_norms", epoch=epoch,
                      last=float(values[-1]),
                      max=float(finite.max()) if len(finite) else None)
        return path

    # -- stall watchdog ----------------------------------------------------

    def _stall_deadline_s(self):
        with self._lock:
            values = self._durations.sorted_values()
        if len(values) < 3:   # no steady state yet (first sweep holds
            return None       # the whole compile) — do not watch
        from veles_tpu_torch.telemetry.registry import percentile
        return max(self.stall_factor * percentile(values, 95),
                   self.stall_min_s)

    def step_begin(self, label):
        """Arm the watchdog for one sweep (no-op until a rolling p95
        exists). Starts the watcher thread on first use."""
        deadline = self._stall_deadline_s()
        if deadline is None:
            return
        with self._lock:
            self._armed = (label, time.perf_counter() + deadline,
                           deadline)
            if self._watch_thread is None:
                self._watch_thread = threading.Thread(
                    target=self._watch_loop, daemon=True,
                    name="flight-watchdog")
                self._watch_thread.start()

    def step_end(self):
        with self._lock:
            self._armed = None

    def _watch_loop(self):
        while not self._watch_stop.wait(self._poll_s):
            with self._lock:
                armed = self._armed
            if armed is None:
                continue
            label, deadline, budget = armed
            if time.perf_counter() < deadline:
                continue
            with self._lock:
                # fire once per arm; step_end clears it anyway
                self._armed = None
            self._m_trips.labels(detector="stall").inc()
            self.dump("stall", step=label, budget_s=round(budget, 3),
                      stall_factor=self.stall_factor,
                      dump_stacks=True)

    # -- dump listeners ----------------------------------------------------

    def add_dump_listener(self, fn):
        """``fn(reason, path, context)`` runs after every successful
        dump — the hook a distributed slave uses to notify its master
        so ONE correlated cluster record replaces N disjoint files."""
        with self._lock:
            self._dump_listeners.append(fn)
        return fn

    def remove_dump_listener(self, fn):
        with self._lock:
            if fn in self._dump_listeners:
                self._dump_listeners.remove(fn)

    # -- dumping -----------------------------------------------------------

    def record_exception(self, exc, step=None):
        """The crash path: dump before the exception unwinds the run."""
        return self.dump("exception", step=step,
                         exception=type(exc).__name__,
                         message=str(exc))

    def dump(self, reason, dump_stacks=False, **context):
        """Write one flight record atomically; returns its path (or
        None when rate-limited / the directory is unwritable)."""
        now = time.perf_counter()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and \
                    now - last < self._min_dump_interval_s:
                return None
            self._last_dump[reason] = now
        try:
            os.makedirs(self.out_dir, exist_ok=True)
        except OSError:
            return None
        # name must be unique across PROCESSES sharing a flight dir
        # (master + slaves tripping on the same NaN batch in the same
        # second): rate-limiting is per-process state, and os.replace
        # would silently destroy the other black boxes right when an
        # incident investigation needs them — so the host, pid and a
        # per-process sequence number join the stamp
        import socket
        with self._lock:
            self._seq = getattr(self, "_seq", 0) + 1
            seq = self._seq
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        base = "flight-%s-%s-%s-%d-%d" % (
            stamp, reason, socket.gethostname(), os.getpid(), seq)
        path = os.path.join(self.out_dir, base + ".json")
        stacks_path = None
        if dump_stacks:
            # the stacks are the part that evaporates if the operator
            # kills the stuck process — write them FIRST
            stacks_path = os.path.join(self.out_dir, base + ".stacks.txt")
            try:
                with open(stacks_path, "w") as f:
                    faulthandler.dump_traceback(file=f, all_threads=True)
            except Exception:
                stacks_path = None
        from veles_tpu_torch.telemetry import profiler
        record = {
            "reason": reason,
            "time": time.time(),
            "context": context,
            "notes": self.notes(),
            "log_tail": self._log_tail.tail(),
            "spans": tracing.get_buffer().events()[-SPAN_TAIL:],
            "metrics": get_registry().snapshot(),
            "phases_ms": profiler.phase_report(),
            "stacks_file": stacks_path,
        }
        tmp = "%s.%d.tmp" % (path, os.getpid())
        try:
            with open(tmp, "w") as f:
                json.dump(record, f, default=str)
            os.replace(tmp, path)
        except OSError:
            return None
        with self._lock:
            self._last_path = path
            listeners = list(self._dump_listeners)
        self._m_records.labels(reason=reason).inc()
        logging.getLogger("flight").error(
            "flight record (%s) written to %s", reason, path)
        for fn in listeners:
            try:  # a broken notifier must not mask the record itself
                fn(reason, path, dict(context))
            except Exception:
                logging.getLogger("flight").warning(
                    "flight dump listener failed", exc_info=True)
        return path

    def last_record_path(self):
        with self._lock:
            return self._last_path

    def stop(self):
        self._watch_stop.set()
        # swap under the lock, join outside it (the watcher takes the
        # same lock to dump; joining while holding it would deadlock)
        with self._lock:
            thread, self._watch_thread = self._watch_thread, None
        if thread is not None:
            thread.join(timeout=5)
        logging.getLogger().removeHandler(self._log_tail)


_recorder = None
_recorder_lock = threading.Lock()


def get_recorder():
    """THE process flight recorder (created on first use)."""
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def last_record_path():
    with _recorder_lock:
        return _recorder.last_record_path() if _recorder else None


def reset_recorder():
    """Tests only: detach the log handler and drop the singleton."""
    global _recorder
    with _recorder_lock:
        if _recorder is not None:
            _recorder.stop()
        _recorder = None


def load_record(path):
    """Parse a flight record back (the operator/test loading path)."""
    with open(path) as f:
        record = json.load(f)
    for key in ("reason", "time", "notes", "log_tail", "metrics"):
        if key not in record:
            raise ValueError("not a flight record: missing %r" % key)
    return record
