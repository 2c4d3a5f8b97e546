"""Per-slave health / straggler scoring with hysteresis
(``veles_tpu/telemetry/health.py``).

VELES's master schedules from observed slave behavior (heartbeats with
timeout-based death detection, per-slave load metrics); the
coordinator's reaper already handles *death*. This module detects the
worse failure mode for a synchronous epoch: the slave that is ALIVE
but slow — the straggler every other slave ends up waiting on.

A :class:`HealthScorer` keeps, per slave, EWMAs of the signals the
control plane already measures (job wall time, heartbeat RTT, exchange
encode/decode time) plus the observed heartbeat cadence. Each
evaluation compares every slave's EWMAs against the **median of its
peers** (ratios, so the score is load- and model-size-invariant) and
adds a **silence** component — heartbeat age over the slave's own
beat-gap EWMA — which is what catches a SIGSTOP'd/paused process
within a few intervals. The score is the worst component ratio.

Hysteresis, both ways:

* entering ``straggler`` needs the score at/above ``enter_ratio`` for
  ``enter_evals`` CONSECUTIVE evaluations, and the job-time component
  only counts once ``job_streak`` consecutive jobs ran slow — so one
  slow job (a GC pause, a shard fault) cannot flap a slave;
* returning to ``healthy`` needs the score below ``exit_ratio`` (a
  LOWER bar than entry) for ``exit_evals`` consecutive evaluations.

State surfaces as ``veles_slave_health_state{slave}`` (0 healthy / 1
straggler) and ``veles_slave_health_score{slave}`` gauges — the series
the SLO alert engine's ``slave_straggler`` rule and the coordinator's
straggler drop (``straggler_drop_s``) consume — and the
``/cluster.json`` table.
"""

import collections
import logging
import threading
import time

from veles_tpu_torch.telemetry.registry import get_registry, percentile

log = logging.getLogger("veles.health")

#: EWMA smoothing factor for every component
ALPHA = 0.3

#: ratio denominators are floored per component so small absolute
#: values can never look like a 2x straggler — only meaningfully
#: large signals move the score. The RTT floor is deliberately far
#: above loopback/LAN numbers: a slave's own compute holds its GIL
#: and inflates its self-measured heartbeat RTT by tens of ms (seen
#: on a 2-core CPU run), which is load, not a degraded link; a
#: genuinely swapping host or saturated path measures hundreds.
FLOORS_MS = {"rtt_ms": 100.0, "job_ms": 50.0,
             "encode_ms": 10.0, "decode_ms": 10.0}


class _Ewma(object):
    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def update(self, x):
        x = float(x)
        self.value = x if self.value is None else \
            ALPHA * x + (1.0 - ALPHA) * self.value


class _SlaveHealth(object):
    __slots__ = ("ewma", "last_beat", "gap_ewma", "slow_streak",
                 "job_seen", "state", "breach_streak", "clear_streak",
                 "score", "components", "since")

    def __init__(self, now):
        self.ewma = {}            # component -> _Ewma
        self.last_beat = None     # monotonic time of the last beat
        self.gap_ewma = _Ewma()   # observed inter-beat gap (s)
        self.slow_streak = 0      # consecutive slow jobs
        self.job_seen = 0         # jobs observed (warmup gating)
        self.state = "healthy"
        self.breach_streak = 0
        self.clear_streak = 0
        self.score = 1.0
        self.components = {}
        self.since = now


class HealthScorer(object):
    """Scores slaves; thread-safe; cheap enough to run per heartbeat."""

    def __init__(self, registry=None, enter_ratio=2.0, exit_ratio=1.3,
                 enter_evals=2, exit_evals=3, job_streak=2,
                 job_warmup=2, silence_min_s=0.25,
                 min_eval_interval_s=0.05):
        self.enter_ratio = enter_ratio
        self.exit_ratio = exit_ratio
        self.enter_evals = enter_evals
        self.exit_evals = exit_evals
        self.job_streak = job_streak
        self.job_warmup = job_warmup
        self.silence_min_s = silence_min_s
        self._min_eval_interval_s = min_eval_interval_s
        self._lock = threading.Lock()
        self._slaves = {}
        self._medians = {}
        self._last_eval = 0.0
        self._transitions = collections.deque(maxlen=256)
        registry = registry or get_registry()
        self._m_score = registry.gauge(
            "veles_slave_health_score",
            "Worst peer-relative component ratio (1 = at the median)",
            labels=("slave",))
        self._m_state = registry.gauge(
            "veles_slave_health_state",
            "0 healthy, 1 straggler", labels=("slave",))
        self._m_transitions = registry.counter(
            "veles_slave_health_transitions_total",
            "Health state transitions", labels=("slave", "to"))

    # -- feeding -----------------------------------------------------------

    def observe(self, sid, job_ms=None, rtt_ms=None, encode_ms=None,
                decode_ms=None, beat=False, now=None, create=True):
        """Fold one observation batch into the slave's EWMAs.

        ``create=False`` drops observations for unknown slaves —
        callers running OUTSIDE the coordinator lock (the launcher's
        encode/decode timers) use it so a slave reaped mid-callback
        cannot be resurrected as a permanent phantom after
        :meth:`remove` already ran."""
        now = time.monotonic() if now is None else now
        with self._lock:
            st = self._slaves.get(sid)
            if st is None:
                if not create:
                    return
                st = self._slaves[sid] = _SlaveHealth(now)
            if beat:
                if st.last_beat is not None:
                    st.gap_ewma.update(max(now - st.last_beat, 1e-6))
                st.last_beat = now
            if job_ms is not None:
                # a slave's first jobs absorb its kernel builds — honest
                # wall time, dishonest straggler evidence (the peers
                # compiled before it joined): gate them out
                st.job_seen += 1
                if st.job_seen <= self.job_warmup:
                    job_ms = None
            for name, value in (("job_ms", job_ms), ("rtt_ms", rtt_ms),
                                ("encode_ms", encode_ms),
                                ("decode_ms", decode_ms)):
                if value is None:
                    continue
                ewma = st.ewma.get(name)
                if ewma is None:
                    ewma = st.ewma[name] = _Ewma()
                ewma.update(value)
            if job_ms is not None:
                # the raw-job slow streak is the anti-flap guard: the
                # job component only scores once >=job_streak raw jobs
                # in a row ran slower than enter_ratio x the peer median
                median = self._medians.get("job_ms")
                if median is not None and float(job_ms) > \
                        self.enter_ratio * max(median,
                                               FLOORS_MS["job_ms"]):
                    st.slow_streak += 1
                else:
                    st.slow_streak = 0

    # -- scoring -----------------------------------------------------------

    def evaluate(self, now=None, force=False):
        """Re-score every slave (throttled; call freely per beat)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if not force and \
                    now - self._last_eval < self._min_eval_interval_s:
                return
            self._last_eval = now
            # peer medians per component (over every slave with data)
            medians = {}
            for name in FLOORS_MS:
                values = sorted(
                    st.ewma[name].value for st in self._slaves.values()
                    if st.ewma.get(name) is not None and
                    st.ewma[name].value is not None)
                if values:
                    medians[name] = percentile(values, 50)
            self._medians = medians
            # expected beat cadence across the fleet: the fallback for
            # a slave silenced before its OWN gap EWMA formed (paused
            # right after its first beat — it must still be flaggable)
            gap_values = sorted(
                st.gap_ewma.value for st in self._slaves.values()
                if st.gap_ewma.value is not None)
            gap_median = percentile(gap_values, 50) if gap_values \
                else None
            for sid, st in self._slaves.items():
                components = {}
                peers = len(self._slaves) - 1
                for name, floor in FLOORS_MS.items():
                    ewma = st.ewma.get(name)
                    if peers < 1 or ewma is None or ewma.value is None \
                            or name not in medians:
                        continue
                    ratio = ewma.value / max(medians[name], floor)
                    if name == "job_ms" and \
                            st.slow_streak < self.job_streak:
                        # one slow job must not flip the state
                        ratio = min(ratio, 1.0)
                    components[name] = round(ratio, 3)
                gap = st.gap_ewma.value
                if gap is None:
                    gap = gap_median
                if st.last_beat is not None and gap is not None:
                    age = now - st.last_beat
                    if age >= self.silence_min_s:
                        components["silence"] = round(
                            age / max(gap, 0.05), 3)
                st.components = components
                st.score = max(components.values()) if components \
                    else 1.0
                self._m_score.labels(slave=sid).set(st.score)
                if st.state == "healthy":
                    st.breach_streak = st.breach_streak + 1 \
                        if st.score >= self.enter_ratio else 0
                    if st.breach_streak >= self.enter_evals:
                        self._transition(sid, st, "straggler", now)
                else:
                    st.clear_streak = st.clear_streak + 1 \
                        if st.score < self.exit_ratio else 0
                    if st.clear_streak >= self.exit_evals:
                        self._transition(sid, st, "healthy", now)
                self._m_state.labels(slave=sid).set(
                    1.0 if st.state == "straggler" else 0.0)

    def _transition(self, sid, st, to, now):
        """State flip + transition log. Caller holds ``self._lock``
        (only ``evaluate`` enters here, under it)."""
        st.state = to
        st.since = now
        st.breach_streak = 0
        st.clear_streak = 0
        self._transitions.append({
            "t": time.time(), "slave": sid, "to": to,
            "score": st.score, "components": dict(st.components)})
        self._m_transitions.labels(slave=sid, to=to).inc()
        (log.warning if to == "straggler" else log.info)(
            "slave %s -> %s (score %.2f, components %s)",
            sid, to, st.score, st.components)

    # -- reading / lifecycle ----------------------------------------------

    def state(self, sid):
        with self._lock:
            st = self._slaves.get(sid)
            return st.state if st is not None else None

    def table(self):
        """``{sid: {state, score, components, state_age_s,
        beat_age_s}}`` — the /cluster.json health columns."""
        now = time.monotonic()
        with self._lock:
            return {sid: {
                "state": st.state,
                "score": round(st.score, 3),
                "components": dict(st.components),
                "state_age_s": round(now - st.since, 3),
                "beat_age_s": None if st.last_beat is None
                else round(now - st.last_beat, 3),
            } for sid, st in self._slaves.items()}

    def transitions(self):
        with self._lock:
            return list(self._transitions)

    def remove(self, sid):
        """Forget a dropped slave and GC its labeled children (the
        transition HISTORY stays in the bounded ring + logs)."""
        with self._lock:
            removed = self._slaves.pop(sid, None)
        self._m_score.remove(slave=sid)
        self._m_state.remove(slave=sid)
        self._m_transitions.remove(slave=sid)
        return removed is not None

    def reset(self):
        with self._lock:
            slaves = list(self._slaves)
            self._slaves.clear()
            self._medians = {}
            self._transitions.clear()
            self._last_eval = 0.0
        for sid in slaves:
            self._m_score.remove(slave=sid)
            self._m_state.remove(slave=sid)
            self._m_transitions.remove(slave=sid)


_scorer = None
_scorer_lock = threading.Lock()


def get_scorer():
    """THE process health scorer (master side)."""
    global _scorer
    with _scorer_lock:
        if _scorer is None:
            _scorer = HealthScorer()
        return _scorer


def reset_scorer():
    """Tests only."""
    global _scorer
    with _scorer_lock:
        if _scorer is not None:
            _scorer.reset()
        _scorer = None
