"""Cluster metrics federation: slave registries, one master pane
(``veles_tpu/telemetry/federation.py``).

Every process has its own :class:`~veles_tpu_torch.telemetry.registry.
MetricsRegistry`, so a master + N slaves run exposes N+1
disjoint ``/metrics`` endpoints. This module federates them without a
new socket: each slave piggybacks a compact **delta-encoded registry
snapshot** on the heartbeat messages it already sends
(:class:`~veles_tpu_torch.parallel.coordinator.CoordinatorClient`), and the
master merges the deltas into a :class:`FederatedRegistry` — a
per-slave store of series that renders into the master's own
``/metrics`` / ``/metrics.json`` with a ``{slave="<sid>"}`` label
appended, plus the ``/cluster.json`` health table.

Wire format (one heartbeat's ``"telemetry"`` value)::

    {"v": 1, "seq": 7, "full": true?,            # seq = per-encoder
     "series": [["c"|"g", name, {labels}, value],
                ["h", name, {labels}, {"count": n, "sum": s,
                                       "p50": ..., "p95": ..., "p99": ...}],
                ...],
     "removed": [[name, {labels}], ...]}         # series that vanished

Rows carry ABSOLUTE values, not increments — a lost delta only leaves
series stale, never wrong, and the master heals staleness by asking
for a full push (``{"resync": true}`` in the heartbeat ack) whenever
it sees a sequence gap. Duplicate deliveries (same ``seq``) are
dropped, so the merge is idempotent. Counters stay monotonic across a
slave restart: when a raw counter goes backwards the previous value is
folded into a per-series base offset.

Cardinality is bounded on the master: at most :attr:`FederatedRegistry.
MAX_SLAVES` feeds of :attr:`FederatedRegistry.MAX_SERIES_PER_SLAVE`
series each (overflow counted in ``veles_federation_dropped_series_
total``), and a feed is garbage-collected the moment the coordinator
drops its slave — a churny run cannot grow the registry without bound.
"""

import threading
import time
import uuid

from veles_tpu_torch.telemetry.registry import get_registry

#: bump when the delta wire format changes incompatibly
WIRE_VERSION = 1

_KIND_TAG = {"counters": "c", "gauges": "g", "histograms": "h"}
_TAG_KIND = {"c": "counters", "g": "gauges", "h": "histograms"}


def flatten_snapshot(snap):
    """``registry.snapshot()`` -> ``{(name, labelkey): (tag, name,
    labels, data)}`` where ``data`` is a float for counters/gauges and
    the summary dict for histograms."""
    out = {}
    for kind, tag in _KIND_TAG.items():
        for name, family in snap.get(kind, {}).items():
            for entry in family.get("series", ()):
                labels = entry.get("labels") or {}
                key = (name, tuple(sorted(labels.items())))
                if tag == "h":
                    data = {k: v for k, v in entry.items()
                            if k != "labels"}
                else:
                    data = entry.get("value", 0.0)
                out[key] = (tag, name, labels, data)
    return out


class SnapshotEncoder(object):
    """Slave side: delta-encode the local registry for the heartbeat.

    ``encode()`` snapshots the registry and returns only the series
    that changed since the last call (``None`` when nothing did — the
    heartbeat then carries no telemetry at all). The first call, and
    any call after :meth:`mark_resync`, sends the full snapshot."""

    def __init__(self, registry=None, exclude_prefixes=()):
        self._registry = registry or get_registry()
        self._exclude = tuple(exclude_prefixes)
        self._lock = threading.Lock()
        #: stream generation: lets the master tell a RESTARTED encoder
        #: (new process, seq back at 1) from a replayed old delta
        self._gen = uuid.uuid4().hex[:8]
        self._seq = 0
        self._sent = {}
        self._full = True

    def mark_resync(self):
        """Master saw a gap: send everything on the next beat."""
        with self._lock:
            self._full = True

    def encode(self):
        rows = flatten_snapshot(self._registry.snapshot())
        if self._exclude:
            rows = {key: row for key, row in rows.items()
                    if not key[0].startswith(self._exclude)}
        with self._lock:
            full = self._full
            changed = [[row[0], row[1], row[2], row[3]]
                       for key, row in sorted(rows.items())
                       if full or self._sent.get(key) != row[3]]
            removed = [] if full else \
                [[name, dict(labelkey)]
                 for name, labelkey in self._sent
                 if (name, labelkey) not in rows]
            if not changed and not removed and not full:
                return None
            self._sent = {key: row[3] for key, row in rows.items()}
            self._full = False
            self._seq += 1
            delta = {"v": WIRE_VERSION, "gen": self._gen,
                     "seq": self._seq, "series": changed}
            if full:
                delta["full"] = True
            if removed:
                delta["removed"] = removed
            return delta


class _SlaveFeed(object):
    """Master-side state for one slave's metric stream."""

    __slots__ = ("gen", "seq", "series", "bases", "last_raw",
                 "last_update", "need_full")

    def __init__(self):
        self.gen = None      # encoder stream generation
        self.seq = 0
        self.series = {}     # key -> (tag, name, labels, data)
        self.bases = {}      # key -> counter restart offset
        self.last_raw = {}   # key -> last raw counter value
        self.last_update = 0.0
        self.need_full = False


class FederatedRegistry(object):
    """Master side: merge per-slave snapshot deltas, bounded, GC'd."""

    MAX_SLAVES = 256
    MAX_SERIES_PER_SLAVE = 1024

    def __init__(self, registry=None, max_slaves=None,
                 max_series_per_slave=None):
        self._lock = threading.Lock()
        self._feeds = {}
        self.run_info = {}
        if max_slaves is not None:
            self.MAX_SLAVES = max_slaves
        if max_series_per_slave is not None:
            self.MAX_SERIES_PER_SLAVE = max_series_per_slave
        registry = registry or get_registry()
        self._registry = registry
        self._m_applies = registry.counter(
            "veles_federation_applies_total",
            "Slave snapshot deltas merged")
        self._m_duplicates = registry.counter(
            "veles_federation_duplicates_total",
            "Deltas dropped as duplicate/reordered deliveries")
        self._m_resyncs = registry.counter(
            "veles_federation_resyncs_total",
            "Full-snapshot resyncs requested after a sequence gap")
        self._m_dropped = registry.counter(
            "veles_federation_dropped_series_total",
            "Series dropped by the per-slave cardinality cap")
        self._m_slaves = registry.gauge(
            "veles_federation_slaves", "Slave metric feeds tracked")
        self._m_apply_ms = registry.histogram(
            "veles_federation_apply_ms",
            "Master time merging one slave delta")

    def set_run_info(self, **info):
        """Attach run-level context (trace id, master id) that
        ``cluster_report()`` surfaces."""
        with self._lock:
            self.run_info.update(info)

    # -- merging -----------------------------------------------------------

    def apply(self, sid, delta):
        """Merge one piggybacked delta; returns heartbeat-ack hints
        (``{"resync": True}`` when the slave should send a full
        snapshot). Safe against duplicates, reorders and restarts."""
        if not isinstance(delta, dict) or \
                not isinstance(delta.get("seq"), int):
            return {}
        t0 = time.perf_counter()
        seq = delta["seq"]
        full = bool(delta.get("full"))
        gap = False
        with self._lock:
            feed = self._feeds.get(sid)
            if feed is None:
                if len(self._feeds) >= self.MAX_SLAVES:
                    return {}
                feed = self._feeds[sid] = _SlaveFeed()
            gen = delta.get("gen")
            if feed.gen is None or gen == feed.gen:
                if feed.gen is not None and seq <= feed.seq:
                    # duplicate/reordered delivery from the SAME
                    # encoder stream: dropping it keeps apply()
                    # exactly idempotent (and protects the counter
                    # restart heuristic from replayed old values)
                    self._m_duplicates.inc()
                    return {}
                if feed.seq:
                    gap = seq != feed.seq + 1 and not full
                else:
                    # a BRAND-NEW feed joining mid-stream (re-created
                    # after a drop, or promoted past the slave cap):
                    # everything that stopped churning before now is
                    # missing — only a full push heals that
                    gap = not full
            else:
                # NEW encoder stream behind the same sid: the slave
                # process restarted. Start the series view from
                # scratch but KEEP counter bases/last_raw, so the raw
                # values going backwards fold into the base and the
                # federated counters stay monotonic.
                feed.series.clear()
                feed.seq = 0
                gap = not full
            feed.gen = gen
            if full:
                feed.series.clear()
                feed.need_full = False
            for row in delta.get("series") or ():
                try:
                    tag, name, labels, data = row
                    labels = dict(labels)
                    key = (str(name), tuple(sorted(
                        (str(k), str(v)) for k, v in labels.items())))
                except (TypeError, ValueError):
                    continue  # one malformed row must not kill the beat
                if key not in feed.series and \
                        len(feed.series) >= self.MAX_SERIES_PER_SLAVE:
                    self._m_dropped.inc()
                    continue
                if tag == "c":
                    try:
                        raw = float(data)
                    except (TypeError, ValueError):
                        continue
                    last = feed.last_raw.get(key)
                    if last is not None and raw < last:
                        # slave restart: fold the old total into the
                        # base so the federated counter never decreases
                        feed.bases[key] = feed.bases.get(key, 0.0) + last
                    feed.last_raw[key] = raw
                    data = feed.bases.get(key, 0.0) + raw
                elif tag == "g":
                    try:
                        data = float(data)
                    except (TypeError, ValueError):
                        continue
                elif tag == "h":
                    if not isinstance(data, dict):
                        continue
                    data = dict(data)
                else:
                    continue
                feed.series[key] = (tag, str(name), labels, data)
            for row in delta.get("removed") or ():
                try:
                    name, labels = row
                    key = (str(name), tuple(sorted(
                        (str(k), str(v)) for k, v in dict(labels).items())))
                except (TypeError, ValueError):
                    continue
                feed.series.pop(key, None)
            feed.seq = seq
            feed.last_update = time.time()
            if gap:
                feed.need_full = True
            # need_full persists until a full snapshot actually
            # arrives: every ack keeps asking, so one lost resync
            # request cannot leave the view stale forever
            want_resync = feed.need_full
            self._m_slaves.set(len(self._feeds))
        self._m_applies.inc()
        self._m_apply_ms.observe((time.perf_counter() - t0) * 1e3)
        if want_resync:
            self._m_resyncs.inc()
            return {"resync": True}
        return {}

    def remove_slave(self, sid):
        """GC one slave's feed (coordinator drop path)."""
        with self._lock:
            removed = self._feeds.pop(sid, None)
            self._m_slaves.set(len(self._feeds))
        return removed is not None

    def reset(self):
        """Tests: drop every feed and the run info."""
        with self._lock:
            self._feeds.clear()
            self.run_info = {}
            self._m_slaves.set(0)

    # -- reading -----------------------------------------------------------

    def slaves(self):
        """Per-feed summary: ``{sid: {seq, series, age_s}}``."""
        now = time.time()
        with self._lock:
            return {sid: {"seq": feed.seq,
                          "series": len(feed.series),
                          "age_s": round(now - feed.last_update, 3)}
                    for sid, feed in self._feeds.items()}

    def series_rows(self):
        """``[(sid, tag, name, labels, data)]`` — a consistent copy."""
        with self._lock:
            return [(sid, tag, name, dict(labels), data
                     if not isinstance(data, dict) else dict(data))
                    for sid, feed in self._feeds.items()
                    for tag, name, labels, data in feed.series.values()]

    def merged_snapshot(self, registry=None):
        """The local registry snapshot with every federated series
        folded in under an added ``slave`` label — the cluster-wide
        ``/metrics.json`` body."""
        snap = (registry or self._registry).snapshot()
        for sid, tag, name, labels, data in self.series_rows():
            bucket = snap[_TAG_KIND[tag]]
            family = bucket.get(name)
            if family is None:
                family = bucket[name] = {"help": "", "series": []}
            labels = dict(labels)
            if "slave" in labels:
                # an in-process master+slave (or a master-under-
                # master) pushes series that already carry a slave
                # label; rename it the way Prometheus does on a
                # target-label clash instead of misattributing the
                # inner slave's data to the pushing feed
                labels["exported_slave"] = labels.pop("slave")
            labels["slave"] = sid
            if tag == "h":
                entry = dict(data)
                entry["labels"] = labels
            else:
                entry = {"value": data, "labels": labels}
            family["series"].append(entry)
        return snap


def render_snapshot_prometheus(snap):
    """Prometheus text exposition of a (merged) snapshot dict — THE
    shared renderer from :mod:`~veles_tpu_torch.telemetry.registry`, so the
    local and federated expositions cannot drift apart."""
    from veles_tpu_torch.telemetry.registry import render_snapshot
    return render_snapshot(snap)


#: THE process federation (master side); slaves never touch it.
_federation = None
_federation_lock = threading.Lock()


def get_federation():
    global _federation
    with _federation_lock:
        if _federation is None:
            _federation = FederatedRegistry()
        return _federation


def reset_federation():
    """Tests only."""
    global _federation
    with _federation_lock:
        if _federation is not None:
            _federation.reset()
        _federation = None


def render_cluster_prometheus(registry=None):
    """One cluster-wide exposition: the local registry plus every
    federated slave series (identical to the local rendering when no
    slave feeds exist — the common standalone case)."""
    return render_snapshot_prometheus(
        get_federation().merged_snapshot(registry))


def cluster_snapshot(registry=None):
    """Cluster-wide ``/metrics.json`` body."""
    return get_federation().merged_snapshot(registry)


def cluster_report():
    """The ``/cluster.json`` body: per-slave health + telemetry-feed
    state + active alerts + run identity, all JSON-primitive."""
    from veles_tpu_torch.telemetry import alerts, health
    fed = get_federation()
    feeds = fed.slaves()
    table = health.get_scorer().table()
    slaves = {}
    for sid in set(feeds) | set(table):
        entry = dict(table.get(sid) or {"state": "unknown"})
        entry["telemetry"] = feeds.get(sid)
        slaves[sid] = entry
    return {"generated_t": time.time(),
            "run": dict(fed.run_info),
            "slaves": slaves,
            "alerts_active": alerts.get_engine().active()}
