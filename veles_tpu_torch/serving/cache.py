"""Content-addressed result cache in front of the dynamic batcher (the
port of ``veles_tpu/serving/cache.py``).

The cheapest inference is the one never run: serving traffic from
millions of users is heavily repeat-skewed (the same image thumbnail,
the same feature row, the same canned prompt), and the engine's
responses are deterministic per model version — the replica scatter
returns bit-identical rows for identical inputs regardless of which
bucket the batch padded to. So a hit can short-circuit the whole
admission → batch → forward → scatter path into one dict lookup.

**Key.** ``sha1(model name | version | dtype | shape | sample bytes)``
— the canonical (contiguous ``float32``, shape-normalized) input bytes
the engine would batch, plus the model identity. The compiled bucket
is deliberately NOT part of the key: the lookup happens *before*
admission (the point is to skip the batcher and the card). The key of
the same input and model identity is the JAX package's. A hit returns
the stored host row bit for bit; no kernel runs.

**Bounds.** LRU over both an entry count and a byte budget (key bytes
+ stored result ``nbytes``), plus a TTL — an entry older than
``ttl_s`` is a miss and is dropped on touch. Eviction is O(1) per
entry (``OrderedDict``).

**Invalidation.** ``invalidate()`` bumps an epoch and clears the
store atomically — the hot-swap/promotion hook. In-flight requests
that sampled the OLD model carry the epoch they were admitted under
(:meth:`token`); ``put`` discards any insert whose token is stale, so
a result computed by v1 can never be served after the pool promoted
to v2 (the swap-atomicity contract the frontend test hammers).

Telemetry (the JAX package's names):
``veles_serving_cache_{hits,misses,evictions,stale_puts}_total{model}``,
``veles_serving_cache_bytes`` / ``_entries`` gauges, and a windowed
``veles_serving_cache_hit_ratio``
gauge (the series the ``serving_cache_collapse`` alert rule watches —
only published once the window holds enough lookups to mean
something, so an idle cache never fires it).
"""

import collections
import hashlib
import logging
import threading
import time

from veles_tpu_torch.telemetry.registry import get_registry

_log = logging.getLogger(__name__)

#: lookups the hit-ratio window must hold before the gauge publishes —
#: a ratio over three requests is noise, not a collapse signal
HIT_RATIO_MIN_WINDOW = 50


class ResultCache(object):
    """Bounded, TTL'd, epoch-invalidated LRU of per-sample results."""

    def __init__(self, max_bytes=64 << 20, max_entries=100000,
                 ttl_s=300.0, model="default", registry=None,
                 ratio_window=512):
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()  # key -> _Entry
        self.max_bytes = int(max_bytes)
        self.max_entries = int(max_entries)
        self.ttl_s = float(ttl_s)
        self.model = str(model)
        self._bytes = 0
        self._epoch = 0
        self._window = collections.deque(maxlen=int(ratio_window))
        self._window_hits = 0   # running count of 1s in `_window`
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        registry = registry or get_registry()
        label = {"model": self.model}
        self._m_hits = registry.counter(
            "veles_serving_cache_hits_total",
            "Result-cache hits (forward skipped)",
            labels=("model",)).labels(**label)
        self._m_misses = registry.counter(
            "veles_serving_cache_misses_total",
            "Result-cache misses", labels=("model",)).labels(**label)
        self._m_evictions = registry.counter(
            "veles_serving_cache_evictions_total",
            "Result-cache evictions (LRU/TTL/byte budget)",
            labels=("model",)).labels(**label)
        self._m_stale = registry.counter(
            "veles_serving_cache_stale_puts_total",
            "Inserts discarded because the model swapped mid-flight",
            labels=("model",)).labels(**label)
        self._g_bytes = registry.gauge(
            "veles_serving_cache_bytes", "Bytes resident in the cache",
            labels=("model",)).labels(**label)
        self._g_entries = registry.gauge(
            "veles_serving_cache_entries", "Entries resident",
            labels=("model",)).labels(**label)
        self._g_ratio = registry.gauge(
            "veles_serving_cache_hit_ratio",
            "Hit ratio over the recent lookup window",
            labels=("model",)).labels(**label)

    # -- keying ------------------------------------------------------------

    @staticmethod
    def key_for(sample, name, version):
        """Content address of one canonical (normalized) sample."""
        h = hashlib.sha1()
        h.update(("%s|%d|%s|%s|" % (name, version, sample.dtype,
                                    sample.shape)).encode())
        h.update(sample.tobytes())
        return h.digest()

    def token(self):
        """The epoch a request was admitted under; pass to :meth:`put`
        so a result computed against a swapped-out model is dropped."""
        with self._lock:
            return self._epoch

    # -- lookup / insert ---------------------------------------------------

    def get(self, key, now=None):
        """Result array for ``key`` or None (miss/expired)."""
        now = time.time() if now is None else now
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and now - entry.t <= self.ttl_s:
                self._entries.move_to_end(key)
                self.hits += 1
                self._record_lookup_locked(1)
                hit = entry.value
            else:
                if entry is not None:       # expired: drop on touch
                    self._evict_locked(key)
                self.misses += 1
                self._record_lookup_locked(0)
                hit = None
            self._publish_locked()
        (self._m_hits if hit is not None else self._m_misses).inc()
        return hit

    def put(self, key, value, token, now=None):
        """Insert (a copy is NOT taken — callers hand over ownership);
        silently dropped when ``token`` predates an invalidation."""
        now = time.time() if now is None else now
        size = len(key) + int(getattr(value, "nbytes", 64))
        with self._lock:
            if token != self._epoch:
                self._m_stale.inc()
                return False
            if size > self.max_bytes:
                return False                # bigger than the whole budget
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.size
            self._entries[key] = _Entry(value, now, size)
            self._bytes += size
            evicted = 0
            while (self._bytes > self.max_bytes or
                   len(self._entries) > self.max_entries):
                victim, entry = self._entries.popitem(last=False)
                self._bytes -= entry.size
                self.evictions += 1
                evicted += 1
            self._publish_locked()
        if evicted:
            self._m_evictions.inc(evicted)
        return True

    def _evict_locked(self, key):
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= entry.size
            self.evictions += 1
            self._m_evictions.inc()

    # -- invalidation ------------------------------------------------------

    def invalidate(self):
        """Atomically drop everything and fence in-flight inserts
        (hot swap / promotion hook). Returns entries dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._bytes = 0
            self._epoch += 1
            self._publish_locked()
        if n:
            _log.debug("cache %s invalidated: %d entries dropped",
                       self.model, n)
        return n

    # -- reading -----------------------------------------------------------

    def _record_lookup_locked(self, hit):
        """Window append with a running hit count — the ratio gauge
        publishes on every lookup, so summing the window there would
        be O(window) work inside the hot-path lock."""
        if len(self._window) == self._window.maxlen:
            self._window_hits -= self._window.popleft()
        self._window.append(hit)
        self._window_hits += hit

    def _publish_locked(self):
        self._g_bytes.set(self._bytes)
        self._g_entries.set(len(self._entries))
        if len(self._window) >= min(HIT_RATIO_MIN_WINDOW,
                                    self._window.maxlen):
            self._g_ratio.set(self._window_hits /
                              float(len(self._window)))

    def hit_ratio(self):
        """All-time hit ratio (stats/snapshot; the gauge is windowed)."""
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def stats(self):
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_ratio": round(self.hits /
                                   max(self.hits + self.misses, 1), 4),
                "epoch": self._epoch,
            }

    def __len__(self):
        with self._lock:
            return len(self._entries)


class _Entry(object):
    __slots__ = ("value", "t", "size")

    def __init__(self, value, t, size):
        self.value = value
        self.t = t
        self.size = size
