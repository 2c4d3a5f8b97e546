"""The input pipeline of out-of-core training (``veles_tpu/loader/
prefetch.py``).

* :class:`PrefetchPipeline` -- an ordered, bounded-depth background
  pipeline. Worker threads run the host ETL of item N+k (a shard's row
  gather into pinned memory and its host-to-device copy) while the step
  thread computes item N. ``VELES_PREFETCH`` sets the depth (default 2;
  0 runs every item inline on the step thread, no threads at all).
* :class:`StagingRing` -- ``slots`` device staging slots the transfers
  land in, so at most ``slots`` staged items are on the device however
  long the epoch. The JAX package leans on PJRT, which defers a
  buffer's free until the programs reading it finish; PyTorch's caching
  allocator promises nothing across streams, so the ring orders every
  reuse itself:

  - each ring copies on a ``torch.cuda.Stream`` of its own, enqueued
    from the worker threads, and records a ``ready`` event after the copy;
    the consumer makes its current stream wait on it
    (:meth:`Staged.wait`) before the item's first use;
  - the consumer :meth:`StagingRing.release`\\ s an item after its last
    kernel by recording a ``released`` event on its stream. A slot whose
    buffers are reused (``reuse=True``, the dataset shards) is refilled
    only after the copy stream waits on that event; a slot whose
    buffers are made anew (the offloaded layer groups, whose shapes
    differ) drops its old occupant only once that event has completed
    on the host, so the old memory is idle when the allocator takes it
    back. Staged tensors also ``record_stream`` the consumer's stream.

* :class:`HostRing` -- the pinned host buffers a shard is gathered into
  (``index_select(..., out=pinned)``), one per slot, each rewritten only
  after its previous copy to the device completed. On a CUDA device a
  buffer that cannot be pinned raises; on the CPU nothing is pinned.
* residency planning -- :func:`plan_residency` ("resident" when the
  dataset fits the device budget, "streamed" when it does not;
  ``VELES_STREAM``, ``VELES_DEVICE_BUDGET_MB``) and
  :func:`shard_batches` (``VELES_SHARD_MB``); :func:`gather_rows` and
  :func:`local_indices` keep the -1 padding contract of the device
  gather exactly.

While a pipeline's workers run, the interpreter's thread switch
interval is :data:`SWITCH_INTERVAL_S` (restored when the last pipeline
closes): the step thread runs Python between its launches, and a worker
would otherwise wait up to the default 5 ms for the GIL at each of the
dozen calls a shard makes.

``VELES_ETL_THROTTLE_MS`` adds a sleep to each shard's host ETL: the
deliberately slow loader the overlap checks use.

Telemetry, as the JAX package's: each produced item is a
``prefetch:produce`` span (on its worker thread) and each consumer wait
a ``prefetch:wait`` span and a ``veles_step_input_wait_ms`` sample; the
first wait of an input pipeline is the ``pipeline_fill`` startup phase.
The readings are also attributes (``wait_s``, ``first_wait_s``).
"""

import contextlib
import sys
import threading
import time
import weakref

import numpy
import torch

from veles_tpu_torch.envknob import env_knob
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.telemetry.registry import get_registry

#: live pipelines (weak): :func:`shutdown_all` closes any a crashed run
#: left behind
_live_lock = threading.Lock()
_live = weakref.WeakSet()

#: the interpreter's switch interval while pipeline workers run
SWITCH_INTERVAL_S = 0.0005
#: pipelines with running workers, and the interval they replaced
_switching = {"count": 0, "saved": None}


def _hold_switch_interval(hold):
    """Lower the switch interval for the first running pipeline and
    restore it after the last one."""
    with _live_lock:
        if hold:
            if _switching["count"] == 0:
                _switching["saved"] = sys.getswitchinterval()
                sys.setswitchinterval(min(_switching["saved"],
                                          SWITCH_INTERVAL_S))
            _switching["count"] += 1
        else:
            _switching["count"] -= 1
            if _switching["count"] == 0:
                sys.setswitchinterval(_switching["saved"])


def default_depth():
    """``VELES_PREFETCH`` (default 2; 0 = synchronous)."""
    return max(0, env_knob("VELES_PREFETCH", 2, parse=int,
                           on_error="default"))


def default_workers():
    """``VELES_PREFETCH_WORKERS`` ETL threads (default 1)."""
    return max(1, env_knob("VELES_PREFETCH_WORKERS", 1, parse=int,
                           on_error="default"))


def etl_throttle_s():
    """The per-shard ETL sleep of ``VELES_ETL_THROTTLE_MS``: a slow
    loader for checks of the overlap; 0 in production."""
    return max(0.0, env_knob("VELES_ETL_THROTTLE_MS", 0.0, parse=float,
                             on_error="default")) / 1e3


# -- the pipeline ------------------------------------------------------------


def input_wait_histogram():
    return get_registry().histogram(
        "veles_step_input_wait_ms",
        "Step-thread wait for the next prefetched input shard")


def starvation_gauge():
    return get_registry().gauge(
        "veles_input_starvation_fraction",
        "Input wait / wall fraction of the last streamed segment",
        labels=("phase",))


class PrefetchPipeline(object):
    """Ordered bounded-depth producer pipeline over ``n_items`` items.

    ``produce(i)`` runs on worker threads; the consumer calls
    :meth:`get` and receives the items strictly in index order. At most
    ``depth`` produced-but-unconsumed items exist at any time. A worker
    exception is re-raised by the :meth:`get` that reaches the failing
    index (after the pipeline closed). ``depth=0`` runs ``produce``
    inline on the consumer's thread. ``wait_hist`` (default
    ``veles_step_input_wait_ms``) receives each wait and ``fill_phase``
    names the startup phase of the first (None: none), so non-input
    consumers keep out of the input accounting."""

    def __init__(self, produce, n_items, depth=None, workers=None,
                 name="input", wait_hist=None, fill_phase="pipeline_fill"):
        self.produce = produce
        self.n_items = int(n_items)
        self.depth = default_depth() if depth is None else max(0, depth)
        self.workers = default_workers() if workers is None \
            else max(1, workers)
        self.name = name
        self.wait_s = 0.0          #: cumulative consumer wait
        self.first_wait_s = None   #: the wait for item 0 (warm fill)
        self._cond = threading.Condition()
        self._results = {}         # index -> ("ok", item) | ("error", e)
        self._next_claim = 0
        self._next_get = 0
        self._stop = False
        self._threads = []
        self._switching = False
        self._wait_hist = (input_wait_histogram() if wait_hist is None
                           else wait_hist)
        self._fill_phase = fill_phase

    def start(self):
        if self.depth == 0 or self.n_items == 0:
            return self
        _hold_switch_interval(True)
        self._switching = True
        for k in range(min(self.workers, self.n_items)):
            t = threading.Thread(
                target=self._work, daemon=True,
                name="veles-prefetch-%s-%d" % (self.name, k))
            t.start()
            self._threads.append(t)
        with _live_lock:
            _live.add(self)
        return self

    def _work(self):
        while True:
            with self._cond:
                while (not self._stop and
                       self._next_claim < self.n_items and
                       self._next_claim - self._next_get >= self.depth):
                    self._cond.wait(0.1)
                if self._stop or self._next_claim >= self.n_items:
                    return
                i = self._next_claim
                self._next_claim += 1
            try:
                with tracing.span("prefetch:produce", index=i,
                                  pipeline=self.name):
                    out = ("ok", self.produce(i))
            except BaseException as e:  # delivered to the consumer
                out = ("error", e)
            with self._cond:
                self._results[i] = out
                self._cond.notify_all()
                if out[0] == "error":
                    # claimed indices still complete, so the consumer
                    # reaches this error without gaps
                    self._next_claim = self.n_items

    def get(self):
        """The next item in order: ``(item, wait_s)``; re-raises a
        worker's exception at its index."""
        i = self._next_get
        if i >= self.n_items:
            raise IndexError("pipeline of %d items exhausted"
                             % self.n_items)
        start = time.perf_counter()
        if self.depth == 0:
            try:
                payload = self.produce(i)
                kind = "ok"
            except BaseException as e:
                kind, payload = "error", e
            self._next_get = i + 1
        else:
            with self._cond:
                while i not in self._results and not self._stop:
                    self._cond.wait(0.1)
                if i not in self._results:
                    raise RuntimeError(
                        "prefetch pipeline %r closed while the step "
                        "thread waited for item %d" % (self.name, i))
                kind, payload = self._results.pop(i)
                self._next_get = i + 1
                self._cond.notify_all()
        wait = time.perf_counter() - start
        self.wait_s += wait
        self._wait_hist.observe(wait * 1e3)
        tracing.add_complete("prefetch:wait", start, wait, index=i,
                             pipeline=self.name)
        if self.first_wait_s is None:
            self.first_wait_s = wait
            if self._fill_phase:
                from veles_tpu_torch.telemetry import profiler
                profiler.record_phase(self._fill_phase, wait)
        if kind == "error":
            self.close()
            raise payload
        return payload, wait

    def __iter__(self):
        while self._next_get < self.n_items:
            yield self.get()[0]

    def close(self, timeout=10.0):
        """Stop the workers and join every pipeline thread."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout)
        self._threads = [t for t in self._threads if t.is_alive()]
        if self._switching and not self._threads:
            self._switching = False
            _hold_switch_interval(False)
        with _live_lock:
            if not self._threads:
                _live.discard(self)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False


def shutdown_all(timeout=10.0):
    """Close every live pipeline, so no worker thread outlives a run."""
    with _live_lock:
        pipes = list(_live)
    for p in pipes:
        p.close(timeout)


# -- device staging ----------------------------------------------------------


def _leaves(tree):
    """The tensors of a tree of tuples, lists and dicts, in order (a
    dict's in its insertion order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(item, leaves) for item in tree)
    return next(leaves)


def _is_cuda(device):
    return torch.device(device).type == "cuda"


class Staged(object):
    """One item placed by a :class:`StagingRing`: ``tree`` (the device
    tensors, the host tree's structure), the ``started`` and ``ready``
    events recorded before and after its copy (None off CUDA) and its
    slot."""

    def __init__(self, tree, started, ready, slot, ring):
        self.tree = tree
        self.started = started
        self.ready = ready
        self.slot = slot
        self._ring = ring

    def wait(self):
        """Order the consumer's current stream after the copy; the
        staged tensors record that stream, so the allocator never hands
        their memory to another stream while its kernels may still read
        them. Returns the tree."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self._ring.device)
            stream.wait_event(self.ready)
            for leaf in _leaves(self.tree):
                leaf.record_stream(stream)
        return self.tree


class StagingRing(object):
    """A fixed ring of ``slots`` device staging slots.

    :meth:`place` copies a tree (nested tuples, lists and dicts) of host
    tensors through the next slot on the ring's copy stream and returns
    a :class:`Staged`; the consumer calls :meth:`Staged.wait` before the
    first use and :meth:`release` after the last. With ``reuse`` a
    slot keeps its device buffers (refilled in place when the next
    tree's leaves have the same trailing shapes and dtypes and no more
    rows: a short last shard is a view of its first rows); without it
    every placement makes its own (the offloaded layer groups). On the
    CPU the copies are plain synchronous ``copy_``\\ s."""

    def __init__(self, slots, device, reuse=True):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.reuse = reuse
        self._cond = threading.Condition()
        n = max(1, int(slots))
        self._buffers = [None] * n     # the slot's device leaves
        self._released = [True] * n    # the consumer released the slot
        self._events = [None] * n      # its ``released`` event
        self._pos = 0
        self._closed = False
        self._stream = None

    @property
    def slots(self):
        return len(self._buffers)

    @property
    def copy_stream(self):
        """The ring's own copy stream (made on first use; None off
        CUDA)."""
        if self._stream is None and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def resident_bytes(self):
        """Bytes of device memory the slots hold now."""
        with self._cond:
            return sum(leaf.numel() * leaf.element_size()
                       for buffers in self._buffers if buffers
                       for leaf in buffers)

    def _claim(self):
        """The next slot, once its previous occupant was released."""
        with self._cond:
            idx = self._pos % len(self._buffers)
            self._pos += 1
            while not self._released[idx] and not self._closed:
                self._cond.wait(0.1)
            if self._closed:
                raise RuntimeError("staging ring closed")
            self._released[idx] = False
            return idx, self._buffers[idx], self._events[idx]

    def _order_refill(self, stream, event):
        """The copy stream waits for the consumer's ``released`` event
        of the slot's previous occupant before refilling its buffers."""
        stream.wait_event(event)

    def _fits(self, buffers, leaves):
        return (buffers is not None and len(buffers) == len(leaves) and
                all(b.dtype == h.dtype and b.shape[1:] == h.shape[1:] and
                    (b.dim() > 0 and b.shape[0] >= h.shape[0] or
                     b.shape == h.shape)
                    for b, h in zip(buffers, leaves)))

    def place(self, host_tree, after=()):
        """Copy ``host_tree`` through the next slot; ``after`` lists
        events the copy must follow (an offloaded group's last
        writeback). Returns a :class:`Staged`."""
        leaves = [torch.as_tensor(h) for h in _leaves(host_tree)]
        cuda = self.device.type == "cuda"
        if cuda:
            for h in leaves:
                if h.device.type == "cpu" and not h.is_pinned():
                    raise RuntimeError(
                        "staging ring: a host tensor of %s %s is not "
                        "pinned; every copy to the card goes from "
                        "pinned memory" % (tuple(h.shape), h.dtype))
        idx, buffers, released = self._claim()
        try:
            stream = self.copy_stream
            if self.reuse and self._fits(buffers, leaves):
                if cuda and released is not None:
                    self._order_refill(stream, released)
            else:
                if cuda and released is not None:
                    # the old occupant's memory goes back to the
                    # allocator only once the consumer is done with it
                    released.synchronize()
                buffers = None
                self._buffers[idx] = None
            started = ready = None
            with (torch.cuda.stream(stream) if cuda
                  else contextlib.nullcontext()):
                for e in after:
                    if e is not None:
                        stream.wait_event(e)
                if cuda:
                    started = torch.cuda.Event(enable_timing=True)
                    started.record(stream)
                if buffers is None:
                    buffers = [torch.empty(h.shape, dtype=h.dtype,
                                           device=self.device)
                               for h in leaves]
                views = [b if b.shape == h.shape else b[:h.shape[0]]
                         for b, h in zip(buffers, leaves)]
                for v, h in zip(views, leaves):
                    v.copy_(h, non_blocking=cuda)
                if cuda:
                    ready = torch.cuda.Event(enable_timing=True)
                    ready.record(stream)
        except BaseException:
            with self._cond:
                self._released[idx] = True
                self._cond.notify_all()
            raise
        with self._cond:
            if self._closed:
                # clear() raced this placement: keep nothing
                self._released[idx] = True
                raise RuntimeError("staging ring closed")
            self._buffers[idx] = buffers if self.reuse else None
            self._events[idx] = None
        return Staged(_rebuild(host_tree, iter(views)), started, ready,
                      idx, self)

    def release(self, staged, stream=None):
        """The consumer is done with ``staged``: record ``released`` on
        ``stream`` (its current stream by default) and free the slot."""
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(stream if stream is not None
                         else torch.cuda.current_stream(self.device))
        with self._cond:
            self._events[staged.slot] = event
            self._released[staged.slot] = True
            self._cond.notify_all()

    def reopen(self):
        """Start a new sequence of placements from slot 0, also after
        :meth:`clear`. The pipeline of the last sequence is closed, so a
        slot it placed but nobody consumed is free again (its copy is
        ordered before any refill on the same copy stream)."""
        with self._cond:
            self._closed = False
            self._pos = 0
            self._released = [True] * len(self._released)

    def clear(self):
        """Drop every slot's buffers (after the device is done with
        them) and refuse placements until :meth:`reopen`."""
        with self._cond:
            self._closed = True
            events = [e for e in self._events if e is not None]
            self._buffers = [None] * len(self._buffers)
            self._events = [None] * len(self._events)
            self._released = [True] * len(self._released)
            self._cond.notify_all()
        for e in events:
            e.synchronize()


class HostRing(object):
    """``slots`` sets of host buffers a shard is gathered into; on a
    CUDA device they are pinned (a failure to pin raises) and set ``i``
    is rewritten only after the copy that last read it completed
    (:meth:`guard`)."""

    def __init__(self, slots, pin):
        self.pin = bool(pin)
        self._buffers = [None] * max(1, int(slots))
        self._events = [None] * len(self._buffers)

    def buffers(self, i, shapes):
        """Set ``i % slots`` as tensors of ``shapes`` (``[(shape,
        dtype)]``), made (pinned) on first use or when too small; the
        first rows are returned as views."""
        slot = i % len(self._buffers)
        event = self._events[slot]
        if event is not None:
            event.synchronize()
            self._events[slot] = None
        bufs = self._buffers[slot]
        if bufs is None or any(b.dtype != dtype or
                               b.shape[1:] != tuple(shape[1:]) or
                               b.shape[0] < shape[0]
                               for b, (shape, dtype) in zip(bufs, shapes)):
            bufs = [torch.empty(tuple(shape), dtype=dtype,
                                pin_memory=self.pin)
                    for shape, dtype in shapes]
            if self.pin and not all(b.is_pinned() for b in bufs):
                raise RuntimeError("could not pin %s host bytes" % sum(
                    b.numel() * b.element_size() for b in bufs))
            self._buffers[slot] = bufs
        return [b[:shape[0]] for b, (shape, _) in zip(bufs, shapes)]

    def guard(self, i, event):
        """Set ``i % slots`` is read by the copy ending in ``event``."""
        self._events[i % len(self._buffers)] = event


def default_placer(device=None):
    """Host tensor -> a tensor on ``device`` (the card by default),
    copied synchronously: the one-off placement of serving warm-ups;
    training goes through :class:`StagingRing`."""
    device = torch.device(device) if device is not None \
        else torch.device("cuda")
    return lambda host: torch.as_tensor(host).to(device)


def warmup_ring(slots=2, device=None):
    """A small :class:`StagingRing` (``slots`` reused slots) for staging
    a sequence of warm-up batches with a bounded device footprint."""
    return StagingRing(slots, device if device is not None else "cuda")


# -- residency planning ------------------------------------------------------


def device_budget_bytes(device=None):
    """Bytes of device memory the dataset may occupy resident.

    ``VELES_DEVICE_BUDGET_MB`` wins (``0`` = unknown); else 60% of the
    card's total memory (``torch.cuda.mem_get_info``); else None (the
    CPU: unknown, stay resident)."""
    mb = env_knob("VELES_DEVICE_BUDGET_MB", parse=float,
                  on_error="default")
    if mb is not None:
        return mb * 1e6 if mb > 0 else None
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    try:
        _, total = torch.cuda.mem_get_info(device)
    except RuntimeError:
        return None
    return 0.6 * total


def plan_residency(dataset_bytes, device=None, force=None):
    """``"resident"`` or ``"streamed"`` for a dataset of
    ``dataset_bytes``. ``force`` (or ``VELES_STREAM``: ``1``/``force``/
    ``on`` stream always, ``0``/``off``/``no`` never) overrides the
    budget comparison."""
    if force is None:
        env = env_knob("VELES_STREAM")
        if env in ("1", "force", "on", "yes", "true"):
            force = True
        elif env in ("0", "off", "no", "false"):
            force = False
    if force is not None:
        return "streamed" if force else "resident"
    budget = device_budget_bytes(device)
    if budget is not None and dataset_bytes > budget:
        return "streamed"
    return "resident"


def shard_batches(batch_bytes, depth=None, budget_bytes=None):
    """Minibatches per streamed shard: ``VELES_SHARD_MB`` (default 256)
    a shard, shrunk so the ring's ``depth + 2`` shards fit the budget
    when one is known."""
    target = env_knob("VELES_SHARD_MB", 256.0, parse=float,
                      on_error="default") * 1e6
    depth = default_depth() if depth is None else depth
    if budget_bytes:
        target = min(target, budget_bytes / (depth + 2))
    return max(1, int(target // max(1, batch_bytes)))


# -- host ETL ----------------------------------------------------------------


def gather_rows(data, truth, indices, out=None):
    """One shard's host ETL: rows of ``data`` and ``truth`` (host
    tensors or arrays) at the global sample ``indices``.

    The device gather's padding contract: index -1 gives a zero data
    row, and the truth is taken at ``max(idx, 0)`` (the loss masks it).
    ``out`` (``(data_rows, truth_rows)``, pinned buffers of a
    :class:`HostRing`) receives the rows; else they are fresh tensors.
    Pure over its inputs: safe from worker threads."""
    throttle = etl_throttle_s()
    if throttle:
        time.sleep(throttle)
    data = torch.as_tensor(data)
    truth = torch.as_tensor(truth)
    indices = torch.as_tensor(numpy.asarray(indices).reshape(-1))
    safe = indices.clamp(min=0).long()
    if out is None:
        rows = data.index_select(0, safe)
        picked = truth.index_select(0, safe)
    else:
        rows, picked = out
        torch.index_select(data, 0, safe, out=rows)
        torch.index_select(truth, 0, safe, out=picked)
    invalid = indices < 0
    if bool(invalid.any()):
        rows[invalid] = 0
    return rows, picked


def local_indices(global_idx):
    """The shard-local index matrix of a shard built by
    :func:`gather_rows`: row i of the shard stands for global sample
    ``global_idx.flat[i]``; pads stay -1."""
    global_idx = numpy.asarray(global_idx)
    flat = global_idx.reshape(-1)
    local = numpy.where(flat < 0, -1,
                        numpy.arange(flat.size)).astype(numpy.int32)
    return local.reshape(global_idx.shape)
