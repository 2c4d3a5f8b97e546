"""Telemetry-driven elastic scaling of the serving replica pool (the port
of ``veles_tpu/serving/autoscale.py``).

A fixed warm pool either over-provisions the quiet hours or sheds a
burst. The :class:`Autoscaler` closes the loop on the signals the
engine publishes -- admission-queue depth, replica occupancy, shed
counters -- and grows or shrinks the pool inside ``[min_replicas,
max_replicas]``:

* **scale-up is fast**: one sustained breach window (``up_for_s``,
  default 1 s) of queue depth per replica above ``up_queue_per_
  replica`` — or ANY shedding — adds a replica. The new replica runs
  its forward once per bucket on the card *before* joining dispatch
  (``veles_phase_ms{phase="replica_warmup"}``) while the others keep
  serving, so burst traffic never lands on a cold replica.
* **scale-down is slow**: the pool must be idle (empty queue, no
  replica load, no recent shed) for ``down_idle_for_s`` (default
  30 s) before one replica is drained — and the drain removes it from
  dispatch first, then waits for everything it accepted, so **zero
  in-flight requests die** (``ReplicaPool.remove_replica``).
* **flap never happens**: separate up/down thresholds (hysteresis),
  per-direction cooldowns, and any scale action resets the opposite
  direction's evidence window. The ``autoscale_flap`` alert rule
  (``telemetry/alerts.py``) fires if transitions still churn.

Reaction time -- first breach tick to the new replica serving -- lands
in the ``veles_autoscale_reaction_s`` histogram and in
:attr:`Autoscaler.transitions`. The tick thread reads counters and
calls the pool; it touches no CUDA stream itself.

Drive it with :meth:`start` (a daemon tick thread) or call
:meth:`tick` yourself with an explicit ``now`` for deterministic
tests.
"""

import logging
import threading
import time

from veles_tpu_torch.telemetry.registry import get_registry

_log = logging.getLogger(__name__)


class Autoscaler(object):
    """Grow/shrink one :class:`ReplicaPool` from live engine signals."""

    def __init__(self, pool, batcher, min_replicas=1, max_replicas=4,
                 up_queue_per_replica=8.0, up_for_s=1.0,
                 up_cooldown_s=3.0, down_idle_for_s=30.0,
                 down_cooldown_s=30.0, interval_s=0.5,
                 registry=None, model="default"):
        if max_replicas < min_replicas:
            raise ValueError("max_replicas %d < min_replicas %d"
                             % (max_replicas, min_replicas))
        self.pool = pool
        self.batcher = batcher
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = int(max_replicas)
        self.up_queue_per_replica = float(up_queue_per_replica)
        self.up_for_s = float(up_for_s)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_idle_for_s = float(down_idle_for_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.interval_s = float(interval_s)
        self.model = str(model)
        self._breach_since = None
        self._idle_since = None
        self._last_up = None
        self._last_down = None
        self._last_shed_total = None
        self._shed_seen_at = None
        self._stop = threading.Event()
        self._thread = None
        self.transitions = []           # (t, direction, size) history
        registry = registry or get_registry()
        label = {"model": self.model}
        self._g_replicas = registry.gauge(
            "veles_autoscale_replicas", "Current replica-pool size",
            labels=("model",)).labels(**label)
        self._g_target = registry.gauge(
            "veles_autoscale_bounds",
            "Configured pool bounds", labels=("model", "bound"))
        self._g_target.labels(model=self.model,
                              bound="min").set(self.min_replicas)
        self._g_target.labels(model=self.model,
                              bound="max").set(self.max_replicas)
        self._m_transitions = registry.counter(
            "veles_autoscale_transitions_total",
            "Scale actions taken", labels=("model", "direction"))
        self._h_reaction = registry.histogram(
            "veles_autoscale_reaction_s",
            "Breach start -> new replica serving",
            labels=("model",))
        self._g_replicas.set(self.pool.size())

    # -- signal sampling ---------------------------------------------------

    def _shed_delta(self):
        """Samples shed since the last tick (engine admission)."""
        stats = self.batcher.admission.stats()
        total = sum(t["shed"] for t in stats["tenants"].values())
        delta = 0 if self._last_shed_total is None else \
            max(0, total - self._last_shed_total)
        self._last_shed_total = total
        return delta

    def signals(self):
        """One consistent sample of the scaling inputs."""
        depth = self.batcher.queue_depth()
        stats = self.pool.stats()
        return {
            "replicas": len(stats),
            "queue_depth": depth,
            "busy_replicas": sum(1 for s in stats if s["load"] > 0),
            "shed_delta": self._shed_delta(),
        }

    # -- the control decision ----------------------------------------------

    def tick(self, now=None):
        """Evaluate once; perform at most one scale action. Returns
        ``+1``/``-1``/``0`` for up/down/hold."""
        now = time.monotonic() if now is None else now
        sig = self.signals()
        n = sig["replicas"]
        self._g_replicas.set(n)
        if sig["shed_delta"] > 0:
            self._shed_seen_at = now
        if n < self.min_replicas:
            return self._scale_up(now, "below min_replicas")

        # -- up evidence: deep queue per replica, or active shedding
        pressured = (sig["queue_depth"] >
                     self.up_queue_per_replica * n) or \
            sig["shed_delta"] > 0
        if pressured:
            self._idle_since = None
            if self._breach_since is None:
                self._breach_since = now
            held = now - self._breach_since >= self.up_for_s
            cooled = self._last_up is None or \
                now - self._last_up >= self.up_cooldown_s
            if held and cooled and n < self.max_replicas:
                return self._scale_up(
                    now, "depth %d over %d replicas, shed +%d"
                    % (sig["queue_depth"], n, sig["shed_delta"]))
            return 0
        self._breach_since = None

        # -- down evidence: truly idle, long enough, nothing shed
        # recently (a shedding service is NOT idle no matter the queue)
        idle = (sig["queue_depth"] == 0 and
                sig["busy_replicas"] == 0 and
                (self._shed_seen_at is None or
                 now - self._shed_seen_at >= self.down_idle_for_s))
        if idle and n > self.min_replicas:
            if self._idle_since is None:
                self._idle_since = now
            held = now - self._idle_since >= self.down_idle_for_s
            cooled = ((self._last_down is None or
                       now - self._last_down >= self.down_cooldown_s)
                      and (self._last_up is None or
                           now - self._last_up >= self.down_cooldown_s))
            if held and cooled:
                return self._scale_down(now)
        else:
            self._idle_since = None
        return 0

    def _scale_up(self, now, why):
        breach = self._breach_since
        t0 = time.monotonic()
        self.pool.add_replica()         # warms before joining dispatch
        warm_s = time.monotonic() - t0
        # reaction = evidence window (in the tick clock, injectable by
        # tests) + the real warm-up the new replica just paid
        done = now + warm_s
        self._last_up = done
        self._breach_since = None
        self._idle_since = None
        size = self.pool.size()
        self._g_replicas.set(size)
        self._m_transitions.labels(model=self.model,
                                   direction="up").inc()
        if breach is not None:
            self._h_reaction.labels(model=self.model).observe(
                max(0.0, done - breach))
        self.transitions.append((done, "up", size))
        _log.info("scale up -> %d replica(s): %s", size, why)
        return 1

    def _scale_down(self, now):
        victim = self.pool.remove_replica()
        if victim is None:
            return 0                    # drain stalled; retry later
        self._last_down = now
        self._idle_since = None
        size = self.pool.size()
        self._g_replicas.set(size)
        self._m_transitions.labels(model=self.model,
                                   direction="down").inc()
        self.transitions.append((now, "down", size))
        _log.info("scale down -> %d replica(s): idle %.0fs", size,
                  self.down_idle_for_s)
        return -1

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="autoscaler-%s" % self.model)
            self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                _log.exception("autoscaler tick failed")

    def stop(self):
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10)
