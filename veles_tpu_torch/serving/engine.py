"""The dynamic batcher: coalesce requests, one forward per batch.

The port of ``veles_tpu/serving/engine.py`` ``DynamicBatcher``. Requests
enter through :meth:`DynamicBatcher.submit` (one sample -> one
:class:`concurrent.futures.Future`) or, for a batch request,
:meth:`DynamicBatcher.submit_many`, which queues its rows together. Two strata sit in front of the
batch queue:

* the **result cache** (:class:`~veles_tpu_torch.serving.cache.
  ResultCache`): a hit returns an already-resolved future before
  admission is consulted -- the stored host row, bit for bit, with no
  forward and no kernel on the card;
* **per-tenant admission** (:class:`~veles_tpu_torch.serving.admission.
  AdmissionController`); :class:`EngineOverloaded` becomes HTTP 503 +
  ``Retry-After`` in the frontend.

The batcher thread collects up to ``max_batch_size`` samples or waits at
most ``batch_timeout_ms`` past the first sample of a batch, and keeps
growing a batch while every replica is busy. Collected batches go to
the replica pool and results scatter back row by row to the waiting
futures and, on the way out, into the cache -- epoch-fenced, so a row
computed against a swapped-out model version is dropped, not cached.
A request whose client deadline passed while it queued is shed at
dequeue, before any compute (HTTP 504). The optional
:class:`~veles_tpu_torch.serving.metrics.ServingMetrics` records every
batch, cache hit and deadline shed.
"""

import concurrent.futures
import queue
import threading
import time

import numpy


class EngineOverloaded(Exception):
    """Admission queue full — retry later (HTTP 503)."""

    def __init__(self, message="serving queue is full", retry_after=1):
        super(EngineOverloaded, self).__init__(message)
        self.retry_after = int(retry_after)


class DeadlineExceeded(Exception):
    """The request's client deadline passed while it queued (HTTP
    504)."""


class _Request(object):
    __slots__ = ("sample", "future", "tenant", "cache_key", "cache_token",
                 "deadline")

    def __init__(self, sample, tenant=None, cache_key=None,
                 cache_token=None, deadline=None):
        self.sample = sample
        self.future = concurrent.futures.Future()
        self.tenant = tenant
        self.cache_key = cache_key
        self.cache_token = cache_token
        #: absolute wall time (or None) past which nobody waits
        self.deadline = deadline


class DynamicBatcher(object):
    """Cache -> admit -> collect -> pad -> forward -> scatter."""

    def __init__(self, pool, max_batch_size=None, batch_timeout_ms=5.0,
                 max_queue=256, metrics=None, cache=None, admission=None):
        self.pool = pool
        self.max_batch_size = int(max_batch_size or pool.max_batch_size)
        self.batch_timeout_s = float(batch_timeout_ms) / 1000.0
        self._queue = queue.Queue()
        # admission bounds TOTAL outstanding samples (queued here and
        # dispatched to a replica but not yet scattered)
        self.max_queue = int(max_queue)
        if admission is None:
            from veles_tpu_torch.serving.admission import \
                AdmissionController
            admission = AdmissionController(capacity=self.max_queue)
        self.admission = admission
        self.cache = cache
        self.metrics = metrics
        if metrics is not None:
            metrics.attach_queue_depth(self.queue_depth)
            metrics.attach_replica_stats(pool.stats)
            if cache is not None:
                metrics.attach_cache_stats(cache.stats)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._batch_loop,
                                        daemon=True, name="batcher")
        self._thread.start()

    # -- request side ------------------------------------------------------

    def submit(self, sample, tenant=None, qos=None, deadline=None):
        """One sample in, one Future out; EngineOverloaded when the
        tenant's share (or the engine) is full. A cache hit resolves
        immediately: no admission, no batch, no forward."""
        future, request = self._prepare(sample, tenant, qos, deadline)
        if request is not None:
            self._enqueue([request])
        return future

    def submit_many(self, samples, tenant=None, qos=None, deadline=None):
        """:meth:`submit` for each of ``samples`` (a batch request),
        their queue entries put together once every row is keyed and
        admitted: the batcher's window then sees the whole request
        instead of the rows that the hashing let through within it.
        Rows admitted before a refused one still complete."""
        futures, requests = [], []
        try:
            for sample in samples:
                future, request = self._prepare(sample, tenant, qos,
                                                deadline)
                futures.append(future)
                if request is not None:
                    requests.append(request)
        finally:
            if requests:
                self._enqueue(requests)
        return futures

    def _prepare(self, sample, tenant, qos, deadline):
        """(future, request): a cache hit's resolved future and None, or
        an admitted request not yet queued and its future."""
        sample = numpy.ascontiguousarray(sample, numpy.float32)
        model = self.pool.model
        expected = model.sample_shape
        if tuple(sample.shape) != expected:
            try:
                sample = sample.reshape(expected)
            except ValueError:
                raise ValueError(
                    "sample shape %s does not match the model's %s" %
                    (tuple(sample.shape), expected))
        if self._stop.is_set():
            raise EngineOverloaded("engine stopped", retry_after=5)
        cache_key = cache_token = None
        if self.cache is not None:
            cache_key = self.cache.key_for(sample, model.name,
                                           model.version)
            hit = self.cache.get(cache_key)
            if hit is not None:
                future = concurrent.futures.Future()
                future.set_result(hit)       # read-only cached row
                if self.metrics is not None:
                    self.metrics.record_cache_hit()
                return future, None
            cache_token = self.cache.token()
        # returns the accounting bucket (an unknown tenant past the cap
        # aliases to "overflow"): settle must use the same one
        tenant = self.admission.admit(tenant, qos=qos)
        request = _Request(sample, tenant=tenant, cache_key=cache_key,
                           cache_token=cache_token, deadline=deadline)
        return request.future, request

    def _enqueue(self, requests):
        for request in requests:
            self._queue.put(request)
        if self._stop.is_set():
            # stop() may have drained the queue between the check and
            # the put: drain again so no future is left unresolved
            self._drain_stopped()

    def _drain_stopped(self):
        while True:
            try:
                request = self._queue.get_nowait()
            except queue.Empty:
                break
            request.future.set_exception(
                EngineOverloaded("engine stopped", retry_after=5))
            self.admission.settle(request.tenant)

    def queue_depth(self):
        """Outstanding samples (queued + in a replica)."""
        return self.admission.total_outstanding()

    # -- batcher thread ----------------------------------------------------

    def _collect(self):
        """Block for the first sample, then fill the batch until the
        window closes or it is full — and while every replica is busy,
        keep growing past the window."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return None
        batch = [first]
        deadline = time.time() + self.batch_timeout_s
        while len(batch) < self.max_batch_size:
            remaining = deadline - time.time()
            if remaining <= 0:
                if self.pool.any_idle() or self._stop.is_set():
                    break
                remaining = 0.001  # all replicas busy: keep growing
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                if remaining > 0.002 or self.pool.any_idle() \
                        or self._stop.is_set():
                    break
        return batch

    def _shed_expired(self, requests):
        """Drop entries whose client deadline passed, before compute."""
        now = time.time()
        live = []
        for r in requests:
            if r.deadline is not None and now > r.deadline:
                self.admission.settle(r.tenant)
                if not r.future.done():
                    r.future.set_exception(DeadlineExceeded(
                        "deadline passed %.0f ms ago while queued"
                        % ((now - r.deadline) * 1000.0)))
                if self.metrics is not None:
                    self.metrics.record_deadline_shed()
            else:
                live.append(r)
        return live

    def _batch_loop(self):
        while not self._stop.is_set():
            requests = self._collect()
            if not requests:
                continue
            requests = self._shed_expired(requests)
            if not requests:
                continue
            batch = numpy.stack([r.sample for r in requests])
            self.pool.submit(batch, self._scatter_cb(requests))
        self._drain_stopped()

    def _scatter_cb(self, requests):
        def scatter(result, bucket, error):
            for r in requests:
                self.admission.settle(r.tenant)
            if error is not None:
                for r in requests:
                    if not r.future.done():
                        r.future.set_exception(error)
                return
            if self.metrics is not None:
                self.metrics.record_batch(len(requests), bucket)
            for i, r in enumerate(requests):
                row = numpy.array(result[i], copy=True)
                if self.cache is not None and r.cache_key is not None:
                    # the same array goes to the client and the cache:
                    # frozen, a later hit returns it bit for bit
                    row.setflags(write=False)
                    self.cache.put(r.cache_key, row, r.cache_token)
                if not r.future.done():
                    r.future.set_result(row)
        return scatter

    # -- lifecycle ---------------------------------------------------------

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)
