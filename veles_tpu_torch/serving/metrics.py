"""Serving metrics: QPS, queue depth, batch occupancy, latency tails
(the port of ``veles_tpu/serving/metrics.py``).

One :class:`ServingMetrics` instance per hosted model is shared by the
batcher, the replica pool and the HTTP frontend. Everything is
lock-protected plain Python -- recording a sample is a deque append,
far below the cost of the forward pass it measures. ``snapshot()``
renders the JSON served at ``/metrics.json`` and pushed to a status
dashboard, in the JAX package's schema.

The reservoir and nearest-rank percentiles are the telemetry registry's
(:mod:`veles_tpu_torch.telemetry.registry`), and every sample is also
mirrored into the shared registry, so the serving counters appear in
the Prometheus text at ``/metrics`` next to the training series.

Percentiles come from a bounded reservoir of the most recent
``reservoir_size`` latencies (exact over that window, not an estimate
over all time — the window is what an operator watching a live service
wants). QPS is counted over a sliding ``qps_window`` seconds.
"""

import collections
import threading
import time

from veles_tpu_torch.telemetry.registry import (Reservoir, get_registry,
                                                percentile)

__all__ = ["ServingMetrics", "percentile"]


class _EndpointStats(object):
    """Counters + latency reservoir for one endpoint."""

    def __init__(self, reservoir_size, qps_window):
        self.requests = 0
        self.responses = collections.Counter()  # status code -> count
        self.latencies_ms = Reservoir(reservoir_size)
        self.arrivals = collections.deque()     # timestamps, qps window
        self.qps_window = qps_window

    def record(self, status, latency_ms, now):
        self.requests += 1
        self.responses[int(status)] += 1
        if latency_ms is not None:
            self.latencies_ms.add(float(latency_ms))
        self.arrivals.append(now)
        horizon = now - self.qps_window
        while self.arrivals and self.arrivals[0] < horizon:
            self.arrivals.popleft()

    def snapshot(self, now):
        horizon = now - self.qps_window
        while self.arrivals and self.arrivals[0] < horizon:
            self.arrivals.popleft()
        lat = self.latencies_ms.sorted_values()
        return {
            "requests": self.requests,
            "responses": {str(k): v for k, v in
                          sorted(self.responses.items())},
            "qps": round(len(self.arrivals) / self.qps_window, 2),
            "p50_ms": round(percentile(lat, 50), 3),
            "p95_ms": round(percentile(lat, 95), 3),
            "p99_ms": round(percentile(lat, 99), 3),
        }


class ServingMetrics(object):
    """Shared, thread-safe metrics hub for one serving process."""

    def __init__(self, reservoir_size=4096, qps_window=10.0,
                 registry=None, model_label="default"):
        self._lock = threading.Lock()
        self._reservoir_size = reservoir_size
        self._qps_window = qps_window
        self._endpoints = {}
        self._rejected = 0          # admission-control 503s
        self._cached = 0            # requests answered from the cache
        self._deadline_shed = 0     # expired-in-queue drops (504)
        self._batches = 0
        self._batch_rows = 0
        self._batch_capacity = 0    # sum of bucket sizes actually run
        self._occupancy = collections.deque(maxlen=reservoir_size)
        self._queue_depth_fn = None
        self._replica_stats_fn = None
        self._cache_stats_fn = None
        self._started = time.time()
        self._model = {}
        self.model_label = str(model_label)
        # mirror into the process-wide registry (Prometheus /metrics)
        registry = registry or get_registry()
        self._m_requests = registry.counter(
            "veles_serving_requests_total", "Requests per endpoint",
            labels=("endpoint", "status"))
        self._m_latency = registry.histogram(
            "veles_serving_latency_ms", "End-to-end request latency",
            labels=("endpoint",), reservoir_size=reservoir_size)
        # engine-side families carry the model label: one ServingMetrics
        # per hosted model would otherwise merge its series with every
        # other model's (the endpoint-labeled families above are
        # already distinguished by their per-route paths)
        label = {"model": self.model_label}
        self._m_rejected = registry.counter(
            "veles_serving_rejected_total",
            "Requests shed by admission control (503)",
            labels=("model",)).labels(**label)
        self._m_batches = registry.counter(
            "veles_serving_batches_total", "Engine batches run",
            labels=("model",)).labels(**label)
        self._m_batch_rows = registry.counter(
            "veles_serving_batch_rows_total", "Real samples batched",
            labels=("model",)).labels(**label)
        self._m_occupancy = registry.histogram(
            "veles_serving_batch_occupancy",
            "Real rows / compiled bucket size per batch",
            labels=("model",),
            reservoir_size=reservoir_size).labels(**label)
        self._m_queue_depth = registry.gauge(
            "veles_serving_queue_depth",
            "Live admission-queue depth (refreshed on snapshot)",
            labels=("model",)).labels(model=self.model_label)
        self._m_deadline_shed = registry.counter(
            "veles_serving_deadline_shed_total",
            "Requests shed at dequeue because their client deadline "
            "had already passed (no compute spent)",
            labels=("model",)).labels(**label)

    # -- wiring ------------------------------------------------------------

    def attach_queue_depth(self, fn):
        """``fn() -> int``: live depth of the admission queue."""
        self._queue_depth_fn = fn

    def attach_replica_stats(self, fn):
        """``fn() -> list of per-replica dicts`` (see ReplicaPool)."""
        self._replica_stats_fn = fn

    def attach_cache_stats(self, fn):
        """``fn() -> dict`` (see :class:`ResultCache.stats`)."""
        self._cache_stats_fn = fn

    def record_cache_hit(self):
        """A request was answered from the result cache (no batch)."""
        with self._lock:
            self._cached += 1

    def record_deadline_shed(self):
        """A queued request expired before compute and was dropped."""
        with self._lock:
            self._deadline_shed += 1
        self._m_deadline_shed.inc()

    def set_model(self, name, version):
        with self._lock:
            self._model = {"name": name, "version": version}

    # -- recording ---------------------------------------------------------

    def record_request(self, endpoint, status, latency_ms=None):
        now = time.time()
        with self._lock:
            stats = self._endpoints.get(endpoint)
            if stats is None:
                stats = self._endpoints[endpoint] = _EndpointStats(
                    self._reservoir_size, self._qps_window)
            stats.record(status, latency_ms, now)
            if int(status) == 503:
                self._rejected += 1
        # registry mirrors outside our lock: it takes its own (only) one
        self._m_requests.labels(endpoint=endpoint,
                                status=str(int(status))).inc()
        if latency_ms is not None:
            self._m_latency.labels(endpoint=endpoint).observe(latency_ms)
        if int(status) == 503:
            self._m_rejected.inc()

    def record_batch(self, rows, bucket):
        """One engine batch ran: ``rows`` real samples padded to
        ``bucket``. Occupancy = rows / bucket — the fraction of the
        compiled batch that was real work."""
        occupancy = float(rows) / max(int(bucket), 1)
        with self._lock:
            self._batches += 1
            self._batch_rows += int(rows)
            self._batch_capacity += int(bucket)
            self._occupancy.append(occupancy)
        self._m_batches.inc()
        self._m_batch_rows.inc(int(rows))
        self._m_occupancy.observe(occupancy)

    # -- reading -----------------------------------------------------------

    def snapshot(self):
        now = time.time()
        with self._lock:
            occ = sorted(self._occupancy)
            per_endpoint = {name: stats.snapshot(now)
                            for name, stats in self._endpoints.items()}
            total_qps = round(sum(e["qps"] for e in per_endpoint.values()),
                              2)
            out = {
                "uptime_s": round(now - self._started, 1),
                "model": dict(self._model),
                "qps": total_qps,
                "rejected_total": self._rejected,
                "cached_total": self._cached,
                "deadline_shed_total": self._deadline_shed,
                "endpoints": per_endpoint,
                "batches": {
                    "count": self._batches,
                    "rows": self._batch_rows,
                    "mean_size": round(
                        self._batch_rows / max(self._batches, 1), 2),
                    "occupancy_mean": round(
                        sum(occ) / max(len(occ), 1), 3),
                    "occupancy_p50": round(percentile(occ, 50), 3),
                },
            }
        # callables outside the lock: they take their own locks
        out["queue_depth"] = (self._queue_depth_fn()
                              if self._queue_depth_fn is not None else 0)
        # mirror into the registry so alert rules (serving_queue_deep)
        # and the federated cluster view can see the depth — refreshed
        # by every snapshot (the status reporter ticks it every ~2 s)
        self._m_queue_depth.set(out["queue_depth"])
        if self._replica_stats_fn is not None:
            out["replicas"] = self._replica_stats_fn()
        if self._cache_stats_fn is not None:
            out["cache"] = self._cache_stats_fn()
        return out

    def dashboard_block(self):
        """The condensed block pushed to web_status ``/update`` and
        rendered on ``/status.html`` (QPS, queue depth, p95)."""
        snap = self.snapshot()
        lat = [e for e in snap["endpoints"].values()]
        p95 = max([e["p95_ms"] for e in lat], default=0.0)
        return {
            "qps": snap["qps"],
            "queue_depth": snap["queue_depth"],
            "p95_ms": p95,
            "rejected_total": snap["rejected_total"],
            "batch_mean_size": snap["batches"]["mean_size"],
            "model": snap["model"],
        }
