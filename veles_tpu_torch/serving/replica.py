"""Model replicas: warm buckets, least-loaded dispatch, hot-swap.

The port of ``veles_tpu/serving/replica.py``. A :class:`Replica` runs
the model's forward on a worker thread draining its private queue.
Batch shapes are padded to power-of-two buckets up to
``max_batch_size`` (:func:`bucket_for`); PyTorch has no jit to warm, so
``warm()`` runs the forward once per bucket under
``torch.inference_mode()``, which builds the kernels, picks cuDNN's
algorithms and grows the caching allocator before the first request.
The sweep is the ``replica_warmup`` startup phase, and it notes each
bucket's analytic forward FLOPs and bytes in the cost book
(``serve_forward:b<bucket>``, from :func:`veles_tpu_torch.models.build.
model_cost`); every served forward is timed under that op, from the
padded batch's upload to its copy back to the host (the forward's own
wait for the card). A pool given an ``op_name`` (a frontend's second and
later routes) files its rows as ``serve_forward:<op_name>:b<bucket>``,
so that two models' forwards never share a row.

:class:`ReplicaPool` fans batches out by least queued work and
hot-swaps the model (each replica drains what it accepted, swaps,
re-warms, rejoins), and grows or shrinks under live traffic with zero
in-flight loss. Replicas of one pool share the model's weights on the
device.
"""

import logging
import queue
import threading
import time

import numpy
from torch import nn

from veles_tpu_torch.models.build import forward_cost, model_cost
from veles_tpu_torch.nn.base import ForwardBase
from veles_tpu_torch.telemetry import profiler

_log = logging.getLogger(__name__)


def bucket_for(n, max_batch_size):
    """Smallest power-of-two >= n, clamped to max_batch_size."""
    if n >= max_batch_size:
        return max_batch_size
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch_size)


def buckets_upto(max_batch_size):
    out, b = [], 1
    while b < max_batch_size:
        out.append(b)
        b <<= 1
    out.append(max_batch_size)
    return out


class _Swap(object):
    """Queue sentinel: drain, then swap to ``model``."""

    def __init__(self, model):
        self.model = model
        self.done = threading.Event()

def _model_cost(model):
    """:func:`model_cost` of a served model's layer chain, or None for a
    module that is not one (nothing is noted then)."""
    module = model.module
    if not isinstance(module, nn.Sequential) or not all(
            isinstance(m, ForwardBase) for m in module):
        return None
    return model_cost(module)


class Replica(object):
    """One warm copy of the model with a private dispatch queue."""

    #: load charged while a swap is queued/running, so dispatch routes
    #: around a swapping replica
    SWAP_LOAD = 1 << 20

    def __init__(self, model, index=0, max_batch_size=64, warm=True,
                 op_name=None):
        self.index = index
        self.op_prefix = "serve_forward:%s" % (
            "" if op_name is None else op_name + ":")
        self.max_batch_size = int(max_batch_size)
        self._queue = queue.Queue()
        self._pending = 0           # queued + running rows, approx load
        self._pending_lock = threading.Lock()
        self._retired = False       # out of dispatch, refusing batches
        self.batches_done = 0
        self.rows_done = 0
        self._stop = threading.Event()
        self._bind(model, warm=warm)
        self._thread = threading.Thread(
            target=self._work_loop, daemon=True,
            name="replica-%d" % index)
        self._thread.start()

    # -- model binding -----------------------------------------------------

    def _bind(self, model, warm=True):
        self.model = model
        self.warmed_buckets = []
        if warm:
            self.warm()

    def warm(self):
        """Run the forward once per batch bucket ahead of traffic, and
        note each bucket's analytic cost."""
        book = profiler.get_cost_book()
        cost = _model_cost(self.model)
        t0 = time.perf_counter()
        with profiler.phase("replica_warmup"):
            for bucket in buckets_upto(self.max_batch_size):
                self.model(numpy.zeros(
                    (bucket,) + self.model.sample_shape, numpy.float32))
                if cost is not None:
                    book.note_cost("%sb%d" % (self.op_prefix, bucket),
                                   *forward_cost(cost, bucket))
                self.warmed_buckets.append(bucket)
        _log.info("replica %d warm: %s v%d, buckets %s in %.2f s",
                  self.index, self.model.name, self.model.version,
                  self.warmed_buckets, time.perf_counter() - t0)

    # -- inference ---------------------------------------------------------

    def infer(self, batch):
        """Synchronous padded forward (runs on the worker thread)."""
        rows = batch.shape[0]
        bucket = bucket_for(rows, self.max_batch_size)
        if rows < bucket:
            pad = numpy.zeros((bucket - rows,) + batch.shape[1:],
                              batch.dtype)
            batch = numpy.concatenate([batch, pad], axis=0)
        with profiler.timed_op("%sb%d" % (self.op_prefix, bucket)):
            out = self.model(batch)
        return out[:rows], bucket

    @property
    def load(self):
        with self._pending_lock:
            return self._pending

    def submit(self, batch, on_done):
        """Queue a batch; ``on_done(result_rows, bucket, error)`` fires
        on the worker thread. Returns False (nothing queued) once the
        replica is retired."""
        with self._pending_lock:
            if self._retired:
                return False
            self._pending += int(batch.shape[0])
        self._queue.put((batch, on_done))
        return True

    def retire(self, retired=True):
        """Leave dispatch: later :meth:`submit` calls are refused."""
        with self._pending_lock:
            self._retired = retired

    def swap(self, model):
        """Queue a drain-then-swap; returns an event set when done."""
        op = _Swap(model)
        with self._pending_lock:
            if self._retired:
                op.done.set()
                return op.done
            self._pending += self.SWAP_LOAD
        self._queue.put(op)
        return op.done

    def _work_loop(self):
        while not self._stop.is_set():
            try:
                item = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                break
            if isinstance(item, _Swap):
                try:
                    self._bind(item.model)
                    _log.info("replica %d promoted to %s v%d", self.index,
                              item.model.name, item.model.version)
                finally:
                    with self._pending_lock:
                        self._pending -= self.SWAP_LOAD
                    item.done.set()
                continue
            batch, on_done = item
            try:
                result, bucket = self.infer(batch)
                error = None
            except Exception as e:  # scatter the failure, don't die
                result, bucket = None, 0
                error = e
                _log.exception("replica %d batch failed", self.index)
            finally:
                with self._pending_lock:
                    self._pending -= int(batch.shape[0])
            self.batches_done += 1
            self.rows_done += int(batch.shape[0])
            on_done(result, bucket, error)

    def wait_drained(self, timeout=60.0):
        """Block until everything this replica accepted was answered.
        Callers must have removed it from dispatch first."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.load == 0 and self._queue.empty():
                return True
            time.sleep(0.005)
        return self.load == 0 and self._queue.empty()

    def stop(self):
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=10)
        # fail whatever was still queued
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, _Swap):
                with self._pending_lock:
                    self._pending -= self.SWAP_LOAD
                item.done.set()
            elif item is not None:
                batch, on_done = item
                on_done(None, 0, RuntimeError("replica stopped"))

    def stats(self):
        return {"index": self.index, "load": self.load,
                "batches": self.batches_done, "rows": self.rows_done,
                "model": self.model.name, "version": self.model.version}


class ReplicaPool(object):
    """Elastic replica set: least-loaded dispatch, atomic swap,
    grow/shrink under live traffic."""

    def __init__(self, model, n_replicas=1, max_batch_size=64,
                 warm=True, op_name=None):
        self.max_batch_size = int(max_batch_size)
        self.op_name = op_name
        self._dispatch_lock = threading.Lock()
        self._rr = 0
        self._warm = bool(warm)
        self._next_index = 0
        self._model = model
        self.replicas = []
        for _ in range(max(1, int(n_replicas))):
            self.add_replica()

    @property
    def model(self):
        return self._model

    def pick(self):
        """Least-loaded replica; round-robin breaks ties."""
        with self._dispatch_lock:
            self._rr += 1
            order = self.replicas[self._rr % len(self.replicas):] + \
                self.replicas[:self._rr % len(self.replicas)]
            return min(order, key=lambda r: r.load)

    def any_idle(self):
        """True when some replica has no queued or running work."""
        with self._dispatch_lock:
            replicas = list(self.replicas)
        return any(r.load == 0 for r in replicas)

    def submit(self, batch, on_done):
        # the picked replica may retire between pick() and submit():
        # it refuses atomically and the batch is re-picked
        while not self.pick().submit(batch, on_done):
            pass

    # -- elasticity --------------------------------------------------------

    def size(self):
        with self._dispatch_lock:
            return len(self.replicas)

    def add_replica(self):
        """Grow by one replica, warmed BEFORE it enters dispatch."""
        with self._dispatch_lock:
            index = self._next_index
            self._next_index += 1
            current = self._model
        replica = Replica(current, index=index,
                          max_batch_size=self.max_batch_size,
                          warm=self._warm, op_name=self.op_name)
        while True:
            with self._dispatch_lock:
                if replica.model is self._model:
                    self.replicas.append(replica)
                    n = len(self.replicas)
                    break
                # swap() promoted the pool while this replica warmed
                current = self._model
            replica.swap(current).wait(120)
        _log.info("pool grew to %d replica(s) (+ replica %d)", n, index)
        return replica

    def remove_replica(self, timeout=60.0):
        """Shrink by one: leave dispatch first, drain, then stop. The
        last replica is never removed; returns the replica or None."""
        with self._dispatch_lock:
            if len(self.replicas) <= 1:
                return None
            victim = min(self.replicas, key=lambda r: r.load)
            self.replicas.remove(victim)
            n = len(self.replicas)
        victim.retire()
        if not victim.wait_drained(timeout):
            _log.warning("replica %d did not drain in %.0fs; returning it "
                         "to dispatch", victim.index, timeout)
            victim.retire(False)
            with self._dispatch_lock:
                self.replicas.append(victim)
            return None
        victim.stop()
        _log.info("pool shrank to %d replica(s) (- replica %d)", n,
                  victim.index)
        return victim

    # -- swap / stats / lifecycle -------------------------------------------

    def swap(self, model, timeout=120.0):
        """Hot-swap every replica, one at a time."""
        with self._dispatch_lock:
            self._model = model
            replicas = list(self.replicas)
        for replica in replicas:
            if not replica.swap(model).wait(timeout):
                raise TimeoutError(
                    "replica %d did not finish the swap in %.0fs" %
                    (replica.index, timeout))
        _log.info("pool promoted to %s v%d", model.name, model.version)

    def stats(self):
        with self._dispatch_lock:
            replicas = list(self.replicas)
        return [r.stats() for r in replicas]

    def stop(self):
        with self._dispatch_lock:
            replicas = list(self.replicas)
            self.replicas = []
        for replica in replicas:
            replica.stop()
