"""Rule-based SLO alerting over the metrics registry (the port's copy of
``veles_tpu/telemetry/alerts.py``).

An :class:`AlertEngine` evaluates declarative rules against the live
registry and exposes the result three ways:

* ``veles_alerts_active{rule}`` gauges (1 firing / 0 clear);
* ``/alerts.json`` on the serving frontend
  (:meth:`AlertEngine.report`);
* structured log lines on every transition (logger ``veles.alerts``,
  message is a JSON object — grep-able, shippable).

Three rule kinds::

    # threshold: aggregated series value vs a bound, with hysteresis
    {"name": "serving_p95_high", "metric": "veles_serving_latency_ms",
     "field": "p95", "agg": "max", "op": ">", "threshold": 500.0,
     "for_s": 10.0, "clear_for_s": 10.0}

    # increase: a counter moved by more than `threshold` in `window_s`
    {"name": "non_finite_loss", "kind": "increase",
     "metric": "veles_flight_detector_trips_total",
     "labels": {"detector": "non_finite_loss"}, "window_s": 300.0}

    # burn_rate: multi-window error-budget burn (SRE-workbook style) —
    # fires only when EVERY window burns faster than its factor
    {"name": "serving_shed_burn", "kind": "burn_rate",
     "numerator": "veles_serving_rejected_total",
     "denominator": "veles_serving_requests_total",
     "objective": 0.01, "windows": [[60, 14.4], [300, 6.0]]}

``labels`` match a SUBSET of a series' labels; ``agg`` folds the
matching series (``max``/``min``/``sum``/``avg``); ``field`` picks the
histogram statistic (``p50``/``p95``/``p99``/``count``/``sum``).
Hysteresis: a threshold rule must breach continuously for ``for_s``
before firing and stay clear for ``clear_for_s`` before clearing, so
one noisy sample cannot flap an alert. Rate kinds keep a bounded
sample history per rule and refuse to fire until the history actually
spans the window (no guessing from partial data).

Extra rules load from the JSON file named by ``VELES_ALERT_RULES``
(either ``{"rules": [...]}`` or a bare list).

:data:`DEFAULT_RULES` are the JAX package's, as data. The slaves' rules
(``slave_straggler``, ``slave_dead``) read the series of the master's
health scorer and coordinator; rules on series the port does not
publish (the scheduler, the SPMD supervisor) find none and never fire;
they stay so that one rule file serves both packages.
"""

import collections
import json
import logging
import os
import threading
import time

from veles_tpu_torch.envknob import env_knob
from veles_tpu_torch.telemetry.registry import get_registry

log = logging.getLogger("veles.alerts")

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

_AGGS = {
    "max": max,
    "min": min,
    "sum": sum,
    "avg": lambda values: sum(values) / len(values),
}

_KINDS = ("threshold", "increase", "burn_rate")


class Rule(object):
    """One validated alert rule (see the module docstring)."""

    _FIELDS = frozenset([
        "name", "kind", "metric", "labels", "field", "agg", "op",
        "threshold", "for_s", "clear_for_s", "window_s", "numerator",
        "denominator", "objective", "windows", "severity",
        "description"])

    def __init__(self, name, kind="threshold", metric=None, labels=None,
                 field="value", agg="max", op=">", threshold=None,
                 for_s=0.0, clear_for_s=0.0, window_s=60.0,
                 numerator=None, denominator=None, objective=None,
                 windows=None, severity="warning", description=""):
        if not name:
            raise ValueError("alert rule needs a name")
        if kind not in _KINDS:
            raise ValueError("rule %s: unknown kind %r (one of %s)"
                             % (name, kind, _KINDS))
        if op not in _OPS:
            raise ValueError("rule %s: unknown op %r" % (name, op))
        if agg not in _AGGS:
            raise ValueError("rule %s: unknown agg %r" % (name, agg))
        if kind == "burn_rate":
            if not numerator or not denominator or not objective:
                raise ValueError(
                    "rule %s: burn_rate needs numerator, denominator "
                    "and objective" % name)
            windows = [(float(w), float(f))
                       for w, f in (windows or [(60.0, 14.4),
                                                (300.0, 6.0)])]
        elif not metric:
            raise ValueError("rule %s: needs a metric" % name)
        if kind == "threshold" and threshold is None:
            raise ValueError("rule %s: needs a threshold" % name)
        self.name = name
        self.kind = kind
        self.metric = metric
        self.labels = dict(labels or {})
        self.field = field
        self.agg = agg
        self.op = op
        self.threshold = 0.0 if threshold is None else float(threshold)
        self.for_s = float(for_s)
        self.clear_for_s = float(clear_for_s)
        self.window_s = float(window_s)
        self.numerator = numerator
        self.denominator = denominator
        self.objective = float(objective) if objective else None
        self.windows = windows
        self.severity = severity
        self.description = description

    @classmethod
    def from_dict(cls, spec):
        unknown = set(spec) - cls._FIELDS
        if unknown:
            # a typo'd key would otherwise silently disable the intent
            raise ValueError("alert rule %r: unknown keys %s"
                             % (spec.get("name"), sorted(unknown)))
        return cls(**spec)

    def describe(self):
        out = {"name": self.name, "kind": self.kind,
               "severity": self.severity}
        if self.description:
            out["description"] = self.description
        if self.kind == "burn_rate":
            out.update(numerator=self.numerator,
                       denominator=self.denominator,
                       objective=self.objective,
                       windows=[list(w) for w in self.windows])
        else:
            out.update(metric=self.metric, op=self.op,
                       threshold=self.threshold)
            if self.labels:
                out["labels"] = dict(self.labels)
            if self.kind == "threshold":
                out.update(field=self.field, agg=self.agg,
                           for_s=self.for_s)
            else:
                out["window_s"] = self.window_s
        return out


class _RuleState(object):
    __slots__ = ("firing", "since", "breach_since", "clear_since",
                 "value", "samples")

    def __init__(self):
        self.firing = False
        self.since = None
        self.breach_since = None
        self.clear_since = None
        self.value = None
        self.samples = collections.deque(maxlen=4096)


#: shipped defaults, the JAX package's rules as data. Operators
#: extend (not replace) via VELES_ALERT_RULES.
DEFAULT_RULES = (
    {"name": "serving_p95_high", "metric": "veles_serving_latency_ms",
     "field": "p95", "agg": "max", "op": ">", "threshold": 500.0,
     "for_s": 10.0, "clear_for_s": 10.0,
     "description": "serving p95 latency above 500 ms"},
    {"name": "serving_queue_deep", "metric": "veles_serving_queue_depth",
     "agg": "max", "op": ">", "threshold": 64.0, "for_s": 10.0,
     "clear_for_s": 10.0,
     "description": "admission queue backing up"},
    {"name": "serving_shed_burn", "kind": "burn_rate",
     "numerator": "veles_serving_rejected_total",
     "denominator": "veles_serving_requests_total",
     "objective": 0.01, "windows": [[60.0, 14.4], [300.0, 6.0]],
     "severity": "critical",
     "description": "shedding >1% of requests at multi-window burn"},
    {"name": "serving_cache_collapse",
     "metric": "veles_serving_cache_hit_ratio", "agg": "min",
     "op": "<", "threshold": 0.05, "for_s": 30.0, "clear_for_s": 30.0,
     "description": "result-cache hit ratio collapsed (<5% over the "
                    "recent lookup window) — an invalidation storm or "
                    "a traffic shift away from repeats; the gauge only "
                    "publishes once the window is mature, so an idle "
                    "or cache-less server never fires this"},
    {"name": "autoscale_flap", "kind": "increase",
     "metric": "veles_autoscale_transitions_total", "window_s": 60.0,
     "threshold": 4.0, "clear_for_s": 120.0,
     "description": "5+ replica scale transitions within a minute — "
                    "the hysteresis/cooldown settings are too tight "
                    "for this traffic shape"},
    {"name": "tenant_shed_burn",
     "metric": "veles_serving_tenant_shed_ratio", "agg": "max",
     "op": ">", "threshold": 0.5, "for_s": 10.0, "clear_for_s": 30.0,
     "severity": "critical",
     "description": "some tenant is shedding over half of its recent "
                    "requests — its share is exhausted (raise its "
                    "weight, or its clients must back off)"},
    {"name": "input_starvation",
     "metric": "veles_input_starvation_fraction", "agg": "max",
     "op": ">", "threshold": 0.5, "for_s": 15.0, "clear_for_s": 15.0,
     "description": "step thread starved for input half the time"},
    {"name": "non_finite_loss", "kind": "increase",
     "metric": "veles_flight_detector_trips_total",
     "labels": {"detector": "non_finite_loss"}, "window_s": 300.0,
     "threshold": 0.0, "clear_for_s": 300.0, "severity": "critical",
     "description": "NaN/Inf loss detected by the flight recorder"},
    {"name": "slave_straggler", "metric": "veles_slave_health_state",
     "agg": "max", "op": ">=", "threshold": 1.0, "for_s": 0.0,
     "clear_for_s": 2.0,
     "description": "a slave is flagged straggler by the health scorer"},
    {"name": "slave_dead", "kind": "increase",
     "metric": "veles_slave_drops_total", "window_s": 300.0,
     "threshold": 0.0, "clear_for_s": 300.0, "severity": "critical",
     "description": "a slave was dropped (death/timeout/straggler) "
                    "and its jobs requeued in the last 5 minutes"},
    {"name": "spmd_participant_lost", "kind": "increase",
     "metric": "veles_spmd_participants_lost_total",
     "window_s": 300.0, "threshold": 0.0, "clear_for_s": 300.0,
     "severity": "critical",
     "description": "an SPMD mesh participant was lost in the last 5 "
                    "minutes; the elastic supervisor re-forms the "
                    "mesh at the surviving world size"},
    {"name": "job_stuck", "metric": "veles_sched_oldest_pending_s",
     "agg": "max", "op": ">", "threshold": 300.0, "for_s": 30.0,
     "clear_for_s": 30.0,
     "description": "a scheduler job has been runnable (pending or "
                    "preempted) for over 5 minutes without a grant — "
                    "the pool is oversubscribed or a gang cannot fit"},
    {"name": "preempt_storm", "kind": "increase",
     "metric": "veles_sched_preemptions_total", "window_s": 60.0,
     "threshold": 5.0, "clear_for_s": 120.0,
     "description": "6+ preemptions within a minute — tenants are "
                    "thrashing each other; raise the min-run thrash "
                    "guard or rebalance tenant weights"},
    {"name": "tenant_starvation",
     "metric": "veles_sched_tenant_wait_s", "agg": "max", "op": ">",
     "threshold": 120.0, "for_s": 30.0, "clear_for_s": 30.0,
     "severity": "critical",
     "description": "some tenant's oldest runnable job has waited "
                    "over 2 minutes while others run — weighted-fair "
                    "placement is not reaching it (weights, pool "
                    "size, or a stuck victim gang)"},
    {"name": "job_loss_plateau",
     "metric": "veles_sched_job_loss_age_s", "agg": "max", "op": ">",
     "threshold": 600.0, "for_s": 30.0, "clear_for_s": 30.0,
     "description": "some job's federated training loss has not "
                    "CHANGED for over 10 minutes while its gang keeps "
                    "beating — training is wedged (dead optimizer, "
                    "zero LR, or a stuck input pipeline), not dead"},
    {"name": "job_mfu_collapse",
     "metric": "veles_sched_job_mfu", "agg": "min", "op": "<",
     "threshold": 0.05, "for_s": 60.0, "clear_for_s": 60.0,
     "description": "some job's model FLOPs utilization has sat "
                    "under 5% for a minute — the gang is burning its "
                    "grant on stalls (input wait, host sync, or a "
                    "pathological shard layout)"},
    {"name": "gang_silent",
     "metric": "veles_sched_beat_age_s", "agg": "max", "op": ">",
     "threshold": 30.0, "for_s": 10.0, "clear_for_s": 10.0,
     "severity": "critical",
     "description": "a RUNNING gang has pushed no beat-carried "
                    "telemetry delta for 30+ seconds — its rank-0 "
                    "pusher (or the whole gang) is hung while the "
                    "processes still look alive to the scheduler"},
)


class AlertEngine(object):
    """Evaluates rules; drive via :meth:`start` or external ticks."""

    def __init__(self, registry=None, rules=None,
                 min_eval_interval_s=0.25):
        self._registry = registry or get_registry()
        self._lock = threading.Lock()
        self._rules = []
        self._states = {}
        self._last_eval = 0.0
        self._min_eval_interval_s = min_eval_interval_s
        self._transitions = collections.deque(maxlen=256)
        self._stop = threading.Event()
        self._thread = None
        self._m_active = self._registry.gauge(
            "veles_alerts_active", "1 while the rule fires",
            labels=("rule",))
        self._m_transitions = self._registry.counter(
            "veles_alerts_transitions_total",
            "Alert fire/clear transitions", labels=("rule", "to"))
        self._m_evals = self._registry.counter(
            "veles_alerts_evaluations_total", "Rule evaluation sweeps")
        for spec in (DEFAULT_RULES if rules is None else rules):
            self.add_rule(spec)

    def add_rule(self, rule):
        if not isinstance(rule, Rule):
            rule = Rule.from_dict(dict(rule))
        with self._lock:
            self._rules = [r for r in self._rules
                           if r.name != rule.name] + [rule]
            # ALWAYS a fresh state: a replaced rule must not inherit
            # the old one's sample history (kind/window changes would
            # misjudge or crash) or its firing flag
            self._states[rule.name] = _RuleState()
        return rule

    def load_rules(self, path):
        with open(path) as f:
            spec = json.load(f)
        rules = spec["rules"] if isinstance(spec, dict) else spec
        for rule in rules:
            self.add_rule(rule)

    # -- series resolution -------------------------------------------------

    def _series_values(self, metric, labels, field):
        family = self._registry.get(metric)
        if family is None:
            return []
        values = []
        for series_labels, child in family.series():
            if any(str(series_labels.get(k)) != str(v)
                   for k, v in labels.items()):
                continue
            if family.kind == "histogram":
                if field == "count":
                    values.append(float(child.count))
                elif field == "sum":
                    values.append(float(child.sum))
                else:
                    try:
                        q = float(field.lstrip("p"))
                    except ValueError:
                        q = 95.0
                    values.append(float(child.percentile(q)))
            else:
                values.append(float(child.value))
        return values

    def _value(self, metric, labels, field="value", agg="sum"):
        values = self._series_values(metric, labels, field)
        return _AGGS[agg](values) if values else None

    @staticmethod
    def _window_ref(samples, now, window_s):
        """Newest sample at least ``window_s`` old (None = history too
        short to judge this window — refuse to fire on guesses)."""
        ref = None
        for sample in samples:
            if now - sample[0] >= window_s:
                ref = sample
            else:
                break
        return ref

    # -- evaluation --------------------------------------------------------

    def _check(self, rule, state, now):
        """-> (condition_bool, display_value)."""
        if rule.kind == "threshold":
            value = self._value(rule.metric, rule.labels, rule.field,
                                rule.agg)
            if value is None:
                return False, None
            return _OPS[rule.op](value, rule.threshold), value
        if rule.kind == "increase":
            # an unminted counter is a zero, not an unknown — sample
            # it so the history matures while the run is still quiet
            # (burn_rate below treats absent counters the same way)
            cur = self._value(rule.metric, rule.labels,
                              agg="sum") or 0.0
            state.samples.append((now, cur))
            ref = self._window_ref(state.samples, now, rule.window_s)
            self._prune(state.samples, now, rule.window_s)
            if ref is None:
                return False, 0.0
            inc = cur - ref[1]
            if inc < 0:  # counter reset upstream
                inc = cur
            return _OPS[rule.op](inc, rule.threshold), inc
        # burn_rate
        num = self._value(rule.numerator, rule.labels, agg="sum") or 0.0
        den = self._value(rule.denominator, rule.labels, agg="sum") or 0.0
        state.samples.append((now, num, den))
        longest = max(w for w, _ in rule.windows)
        worst_burn = None
        fired = True
        for window_s, factor in rule.windows:
            ref = self._window_ref(state.samples, now, window_s)
            if ref is None:
                fired = False
                continue
            dn, dd = num - ref[1], den - ref[2]
            rate = (dn / dd) if dd > 0 else 0.0
            burn = rate / rule.objective
            if worst_burn is None or window_s == rule.windows[0][0]:
                worst_burn = burn
            if burn <= factor:
                fired = False
        self._prune(state.samples, now, longest)
        return fired, worst_burn

    @staticmethod
    def _prune(samples, now, window_s):
        # keep a little slack past the window so _window_ref always
        # finds a reference once the history matured
        horizon = now - 2.0 * max(window_s, 1.0)
        while samples and samples[0][0] < horizon:
            samples.popleft()

    def evaluate(self, now=None, force=False):
        """One sweep over every rule. Cheap; call per heartbeat/tick."""
        now = time.time() if now is None else now
        with self._lock:
            if not force and \
                    now - self._last_eval < self._min_eval_interval_s:
                return
            self._last_eval = now
            rules = list(self._rules)
            self._m_evals.inc()
            for rule in rules:
                state = self._states[rule.name]
                try:
                    condition, value = self._check(rule, state, now)
                except Exception:
                    log.warning("alert rule %s failed to evaluate",
                                rule.name, exc_info=True)
                    continue
                state.value = value
                if condition:
                    state.clear_since = None
                    if state.breach_since is None:
                        state.breach_since = now
                    if not state.firing and \
                            now - state.breach_since >= rule.for_s:
                        self._transition(rule, state, True, now)
                else:
                    state.breach_since = None
                    if state.firing:
                        if state.clear_since is None:
                            state.clear_since = now
                        if now - state.clear_since >= rule.clear_for_s:
                            self._transition(rule, state, False, now)
                self._m_active.labels(rule=rule.name).set(
                    1.0 if state.firing else 0.0)

    def _transition(self, rule, state, firing, now):
        state.firing = firing
        state.since = now
        state.breach_since = None
        state.clear_since = None
        to = "firing" if firing else "clear"
        record = {"t": time.time(), "rule": rule.name, "to": to,
                  "severity": rule.severity, "value": state.value,
                  "description": rule.description}
        self._transitions.append(record)
        self._m_transitions.labels(rule=rule.name, to=to).inc()
        # structured line: the message IS a JSON object, so a log
        # shipper needs no custom parser to route on severity/rule
        (log.warning if firing else log.info)(
            "ALERT %s", json.dumps(record, default=str))

    # -- reading / lifecycle ----------------------------------------------

    def active(self):
        with self._lock:
            return sorted(r.name for r in self._rules
                          if self._states[r.name].firing)

    def report(self, evaluate=True):
        """The ``/alerts.json`` body."""
        if evaluate:
            self.evaluate()
        with self._lock:
            rules = []
            for rule in self._rules:
                state = self._states[rule.name]
                entry = rule.describe()
                entry.update(firing=state.firing, value=state.value,
                             since=state.since)
                rules.append(entry)
            return {"generated_t": time.time(), "rules": rules,
                    "transitions": list(self._transitions)}

    def start(self, interval_s=1.0):
        """Background evaluation thread (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, args=(interval_s,), daemon=True,
                name="alert-engine")
            self._thread.start()
        return self

    def _loop(self, interval_s):
        while not self._stop.wait(interval_s):
            try:
                self.evaluate()
            except Exception:
                log.warning("alert sweep failed", exc_info=True)

    def stop(self):
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)


_engine = None
_engine_lock = threading.Lock()


def get_engine():
    """THE process alert engine: default rules + VELES_ALERT_RULES."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = AlertEngine()
            path = env_knob("VELES_ALERT_RULES")
            if path:
                try:
                    _engine.load_rules(path)
                except (OSError, ValueError, KeyError) as e:
                    log.warning("could not load VELES_ALERT_RULES "
                                "%s: %s", path, e)
        return _engine


def reset_engine():
    """Tests only: stop the thread and drop the singleton."""
    global _engine
    with _engine_lock:
        if _engine is not None:
            _engine.stop()
        _engine = None
