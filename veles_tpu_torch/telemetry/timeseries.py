"""Bounded per-series metric history: the ``/history.json`` store (the
port's copy of ``veles_tpu/telemetry/timeseries.py``).

The registry (:mod:`veles_tpu_torch.telemetry.registry`) answers "what is
the value NOW"; this module gives the observability plane memory — a
:class:`SeriesStore` keeps a bounded ring of ``(t, value)`` points per
labeled series, fed from ordinary registry snapshots, and serves the
``/history.json?series=&since=`` query a dashboard's sparklines and a
canary comparison read.

Bounding is three-way, so a hostile cardinality or a month-long run
cannot grow the store without limit:

* **resolution** — points landing inside the same ``resolution_s``
  bucket overwrite (last-writer-wins), so a tight ingest loop cannot
  out-append the wall clock;
* **downsample-on-overflow** — when a series ring fills, every other
  point is dropped and the series' resolution doubles (classic RRD
  behaviour): old history gets coarser, it never gets truncated to a
  fixed recent window;
* **retention + max-series** — points older than ``retention_s`` are
  pruned on ingest, and series beyond ``max_series`` are counted into
  ``veles_history_dropped_series_total`` instead of stored.

The store NEVER interpolates: a process that stopped pushing (a
preempted gang, a dead worker) leaves a visible gap between real
points — exactly what an operator reading a preemption window wants.
To keep that property, the snapshot pump skips families that have a
dedicated gap-aware writer (``veles_sched_job_*`` — the scheduler
records those directly, RUNNING gangs only); everything else it
would ingest is a live value whose staleness IS the signal.

Knobs (the JAX package's, read through the port's ``envknob``):

* ``VELES_HISTORY_RESOLUTION_S`` — base bucket width (default 0.5 s);
* ``VELES_HISTORY_POINTS`` — ring capacity per series (default 512);
* ``VELES_HISTORY_RETENTION_S`` — max point age (default 3600 s);
* ``VELES_HISTORY_MAX_SERIES`` — store-wide series cap (default 1024);
* ``VELES_HISTORY_INTERVAL_S`` — background pump period (default 1 s).
"""

import threading
import time

from veles_tpu_torch.envknob import env_knob
from veles_tpu_torch.telemetry.registry import get_registry


def _env_float(name, default):
    return env_knob(name, default, parse=float, on_error="default")


def _env_int(name, default):
    return env_knob(name, default, parse=int, on_error="default")


class _Series(object):
    """One labeled series' ring: ``points`` is a list of ``[t, v]``
    ascending in ``t``; ``res_s`` doubles on every overflow."""

    __slots__ = ("points", "res_s")

    def __init__(self, res_s):
        self.points = []
        self.res_s = res_s

    def add(self, t, value, max_points):
        if self.points:
            last_t = self.points[-1][0]
            if t < last_t:
                return          # out-of-order point: drop, never sort
            if int(t // self.res_s) == int(last_t // self.res_s):
                self.points[-1][1] = value   # same bucket: overwrite
                return
        self.points.append([t, value])
        if len(self.points) > max_points:
            # downsample: halve the density, double the resolution —
            # keep the NEWEST point exactly (it anchors "now")
            kept = self.points[::-2]
            kept.reverse()
            self.points = kept
            self.res_s *= 2.0

    def prune(self, horizon):
        points = self.points
        i = 0
        while i < len(points) and points[i][0] < horizon:
            i += 1
        if i:
            del points[:i]


class SeriesStore(object):
    """Bounded history of scalar series, fed from registry snapshots
    (:meth:`ingest`) or single points (:meth:`record`)."""

    # veles_sched_job_*: the scheduler's publish pass records these
    # itself, RUNNING gangs only, so a preemption is a hole in the
    # series. The snapshot pump would re-ingest the stale mirror
    # gauge of a displaced job and bridge that hole — so the pump
    # never touches families that have a gap-aware writer.
    _DEFAULT_EXCLUDE = ("veles_history_", "veles_sched_job_")

    def __init__(self, resolution_s=None, max_points=None,
                 retention_s=None, max_series=None, registry=None,
                 exclude_prefixes=_DEFAULT_EXCLUDE):
        self.resolution_s = float(
            resolution_s if resolution_s is not None
            else _env_float("VELES_HISTORY_RESOLUTION_S", 0.5))
        self.max_points = int(
            max_points if max_points is not None
            else _env_int("VELES_HISTORY_POINTS", 512))
        self.retention_s = float(
            retention_s if retention_s is not None
            else _env_float("VELES_HISTORY_RETENTION_S", 3600.0))
        self.max_series = int(
            max_series if max_series is not None
            else _env_int("VELES_HISTORY_MAX_SERIES", 1024))
        self.exclude_prefixes = tuple(exclude_prefixes)
        self._lock = threading.Lock()
        self._series = {}           # (name, labels_key) -> _Series
        self._stop = threading.Event()
        self._thread = None
        reg = registry or get_registry()
        self._m_series = reg.gauge(
            "veles_history_series", "Series held by the history store")
        self._m_points = reg.counter(
            "veles_history_points_total",
            "Points accepted into the history store")
        self._m_dropped = reg.counter(
            "veles_history_dropped_series_total",
            "Series refused because the store is at max_series")

    # -- writing -----------------------------------------------------------

    @staticmethod
    def _key(name, labels):
        return (name, tuple(sorted((labels or {}).items())))

    def record(self, name, labels, value, now=None):
        """Append one point (used by tests and direct feeders)."""
        now = time.time() if now is None else now
        key = self._key(name, labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                if len(self._series) >= self.max_series:
                    self._m_dropped.inc()
                    return False
                series = self._series[key] = _Series(self.resolution_s)
                self._m_series.set(len(self._series))
            series.add(now, float(value), self.max_points)
            series.prune(now - self.retention_s)
            self._m_points.inc()
        return True

    def ingest(self, snapshot, now=None):
        """Feed every counter/gauge series of a registry snapshot
        (histograms are windows already — the registry serves those)."""
        now = time.time() if now is None else now
        for kind in ("gauges", "counters"):
            for name, family in snapshot.get(kind, {}).items():
                if name.startswith(self.exclude_prefixes):
                    continue
                for entry in family.get("series", ()):
                    if "value" not in entry:
                        continue
                    self.record(name, entry.get("labels") or {},
                                entry["value"], now=now)

    # -- reading -----------------------------------------------------------

    def query(self, series=None, since=None, now=None):
        """The ``/history.json`` body. ``series`` filters by family
        name (exact or prefix); ``since`` returns only points strictly
        newer than the cursor — a poller passes the previous reply's
        ``now`` back and receives just the delta."""
        now = time.time() if now is None else now
        since = float(since) if since is not None else None
        out = []
        with self._lock:
            items = sorted(self._series.items())
            for (name, labels_key), data in items:
                if series and not name.startswith(series):
                    continue
                points = data.points
                if since is not None:
                    points = [p for p in points if p[0] > since]
                out.append({"name": name,
                            "labels": dict(labels_key),
                            "res_s": data.res_s,
                            "points": [list(p) for p in points]})
        return {"now": now, "series": out}

    def series_count(self):
        with self._lock:
            return len(self._series)

    def drop(self, name=None):
        """Drop series (all, or one family) — tests / job GC."""
        with self._lock:
            if name is None:
                self._series.clear()
            else:
                for key in [k for k in self._series if k[0] == name]:
                    del self._series[key]
            self._m_series.set(len(self._series))

    # -- the pump ----------------------------------------------------------

    def start(self, interval_s=None, registry=None):
        """Background snapshot pump (idempotent): every ``interval_s``
        the process registry's snapshot is ingested, so any surface
        serving ``/history.json`` has history without every metric
        producer knowing the store exists."""
        interval_s = float(
            interval_s if interval_s is not None
            else _env_float("VELES_HISTORY_INTERVAL_S", 1.0))
        reg = registry or get_registry()
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(interval_s, reg), daemon=True,
                name="history-pump")
            self._thread.start()
        return self

    def _loop(self, interval_s, registry):
        while not self._stop.wait(interval_s):
            try:
                self.ingest(registry.snapshot())
            except Exception:   # history must never kill its host
                pass

    def stop(self):
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)


_store = None
_store_lock = threading.Lock()


def get_history():
    """THE process history store (created on first use)."""
    global _store
    with _store_lock:
        if _store is None:
            _store = SeriesStore()
        return _store


def reset_history():
    """Tests only: stop the pump and drop the singleton."""
    global _store
    with _store_lock:
        if _store is not None:
            _store.stop()
        _store = None
