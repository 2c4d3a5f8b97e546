"""Process-wide metrics registry: labeled Counters, Gauges, Histograms
(the port's copy of ``veles_tpu/telemetry/registry.py``).

One :class:`MetricsRegistry` per process (``get_registry()``) is shared
by training, the serving engine and the telemetry threads. Two render
paths:

* :meth:`MetricsRegistry.snapshot` -- a JSON-able dict, served at
  ``/metrics.json`` by the serving frontend;
* :meth:`MetricsRegistry.render_prometheus` -- the Prometheus text
  exposition format (histograms render as summaries with ``quantile``
  labels), served at ``/metrics``.

Both are byte for byte the JAX package's for the same sequence of
calls, so a dashboard or an alert rule written for ``veles_tpu`` reads
the port unchanged.

Percentiles are exact nearest-rank over a bounded reservoir of the most
recent ``reservoir_size`` observations.

Thread safety: the registry's single lock is the only lock of the
registry layer (tracing appends to a lock-free deque); recording a
sample is an acquire, some arithmetic and a deque append.
"""

import collections
import re
import threading

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def percentile(sorted_values, q):
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_values:
        return 0.0
    rank = max(0, min(len(sorted_values) - 1,
                      int(round(q / 100.0 * (len(sorted_values) - 1)))))
    return float(sorted_values[rank])


class Reservoir(object):
    """Bounded window of the most recent observations."""

    __slots__ = ("_values",)

    def __init__(self, size=4096):
        self._values = collections.deque(maxlen=size)

    def add(self, value):
        self._values.append(float(value))

    def sorted_values(self):
        return sorted(self._values)

    def percentile(self, q):
        return percentile(self.sorted_values(), q)

    def __len__(self):
        return len(self._values)


def _label_key(label_names, kwargs):
    try:
        return tuple(str(kwargs[name]) for name in label_names)
    except KeyError as e:
        raise ValueError("missing label %s (expected %s)"
                         % (e, ", ".join(label_names)))


class _Metric(object):
    """A metric family: children keyed by label-value tuples."""

    kind = None

    def __init__(self, registry, name, help="", label_names=()):
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._children = {}

    def labels(self, **kwargs):
        key = _label_key(self.label_names, kwargs)
        if len(kwargs) != len(self.label_names):
            raise ValueError("expected labels %s, got %s"
                             % (self.label_names, sorted(kwargs)))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    def _make_child(self):
        return self._child_cls(self._lock)

    def _default(self):
        if self.label_names:
            raise ValueError("metric %s has labels %s; use .labels()"
                             % (self.name, self.label_names))
        return self.labels()

    def reset(self):
        """Drop every child (tests / per-run benches)."""
        with self._lock:
            self._children.clear()

    def remove(self, **labels):
        """Drop children matching ``labels``; a SUBSET of the label
        names removes every child whose values match on those names
        (``family.remove(slave=sid)`` clears all of a dead slave's
        series regardless of its other labels). Returns the number of
        children removed — label cardinality stays bounded only if
        somebody actually calls this when the labeled entity dies."""
        unknown = set(labels) - set(self.label_names)
        if unknown:
            raise ValueError("unknown labels %s (family %s has %s)"
                             % (sorted(unknown), self.name,
                                self.label_names))
        match = {name: str(value) for name, value in labels.items()}
        removed = 0
        with self._lock:
            for key in list(self._children):
                values = dict(zip(self.label_names, key))
                if all(values[name] == want
                       for name, want in match.items()):
                    del self._children[key]
                    removed += 1
        return removed

    def series(self):
        """[(labels_dict, child)] — a consistent copy."""
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self.label_names, key)), child)
                for key, child in items]


class _CounterChild(object):
    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, n=1):
        with self._lock:
            self.value += n


class Counter(_Metric):
    """Monotonically increasing count (name it ``*_total``)."""

    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, n=1):
        self._default().inc(n)

    @property
    def value(self):
        return self._default().value


class _GaugeChild(object):
    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def set(self, value):
        with self._lock:
            self.value = float(value)

    def inc(self, n=1):
        with self._lock:
            self.value += n

    def dec(self, n=1):
        with self._lock:
            self.value -= n


class Gauge(_Metric):
    """A value that goes up and down."""

    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value):
        self._default().set(value)

    def inc(self, n=1):
        self._default().inc(n)

    def dec(self, n=1):
        self._default().dec(n)

    @property
    def value(self):
        return self._default().value


class _HistogramChild(object):
    __slots__ = ("count", "sum", "reservoir", "_lock")

    def __init__(self, lock, reservoir_size=4096):
        self.count = 0
        self.sum = 0.0
        self.reservoir = Reservoir(reservoir_size)
        self._lock = lock

    def observe(self, value):
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            self.reservoir.add(value)

    def percentile(self, q):
        with self._lock:
            return self.reservoir.percentile(q)

    def summary(self, quantiles=(50, 95, 99)):
        with self._lock:
            count, total = self.count, self.sum
            values = self.reservoir.sorted_values()
        out = {"count": count, "sum": round(total, 6)}
        for q in quantiles:
            out["p%g" % q] = round(percentile(values, q), 6)
        return out


class Histogram(_Metric):
    """Windowed distribution: count + sum + exact recent percentiles."""

    kind = "histogram"

    def __init__(self, registry, name, help="", label_names=(),
                 reservoir_size=4096):
        super(Histogram, self).__init__(registry, name, help, label_names)
        self._reservoir_size = reservoir_size

    def _make_child(self):
        return _HistogramChild(self._lock, self._reservoir_size)

    def observe(self, value):
        self._default().observe(value)

    def percentile(self, q):
        return self._default().percentile(q)


def _escape_label(value):
    return str(value).replace("\\", "\\\\").replace("\"", "\\\"") \
        .replace("\n", "\\n")


def _fmt_labels(labels, extra=()):
    pairs = list(labels.items()) + list(extra)
    if not pairs:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _escape_label(v))
                             for k, v in pairs)


class MetricsRegistry(object):
    """Thread-safe get-or-create registry of metric families."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics = {}

    # -- creation ----------------------------------------------------------

    def _get_or_create(self, cls, name, help, labels, **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % name)
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(
                    self, name, help=help, label_names=labels, **kwargs)
                return metric
        if not isinstance(metric, cls):
            raise ValueError("metric %s already registered as %s"
                             % (name, metric.kind))
        if tuple(labels) != metric.label_names:
            raise ValueError("metric %s already registered with labels %s"
                             % (name, metric.label_names))
        return metric

    def counter(self, name, help="", labels=()):
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(), reservoir_size=4096):
        return self._get_or_create(Histogram, name, help, labels,
                                   reservoir_size=reservoir_size)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def clear(self):
        """Drop every metric (tests only — live handles go stale)."""
        with self._lock:
            self._metrics.clear()

    # -- rendering ---------------------------------------------------------

    def snapshot(self):
        """JSON-able dump of every family and labeled series. Runs
        under the registry lock so each count/sum/percentile triple is
        mutually consistent (mutators take the same lock)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            metrics = list(self._metrics.values())
            for metric in metrics:
                series = []
                for labels, child in metric.series():
                    if metric.kind == "histogram":
                        entry = child.summary()
                    else:
                        entry = {"value": child.value}
                    if labels:
                        entry["labels"] = labels
                    series.append(entry)
                out[metric.kind + "s"][metric.name] = {
                    "help": metric.help, "series": series}
        return out

    def render_prometheus(self):
        """Prometheus text exposition (0.0.4): counters and gauges as
        themselves, histograms as summaries with ``quantile`` labels.
        The snapshot is taken under the registry lock (consistent
        triples); rendering works on the copy."""
        return render_snapshot(self.snapshot())


def render_snapshot(snap):
    """Prometheus text exposition of a :meth:`MetricsRegistry.
    snapshot` dict — THE renderer, shared with the federation's
    merged cluster view (which folds slave series into a snapshot
    before rendering)."""
    families = []
    for kind, ptype in (("counters", "counter"), ("gauges", "gauge"),
                        ("histograms", "summary")):
        for name, family in snap.get(kind, {}).items():
            families.append((name, ptype, family))
    lines = []
    for name, ptype, family in sorted(families):
        if family.get("help"):
            lines.append("# HELP %s %s"
                         % (name, family["help"].replace("\n", " ")))
        lines.append("# TYPE %s %s" % (name, ptype))
        for entry in family.get("series", ()):
            labels = entry.get("labels") or {}
            if ptype == "summary":
                for q, key in ((0.5, "p50"), (0.95, "p95"),
                               (0.99, "p99")):
                    lines.append("%s%s %s" % (
                        name,
                        _fmt_labels(labels, [("quantile", "%g" % q)]),
                        repr(float(entry.get(key, 0.0)))))
                lines.append("%s_count%s %d"
                             % (name, _fmt_labels(labels),
                                int(entry.get("count", 0))))
                lines.append("%s_sum%s %s"
                             % (name, _fmt_labels(labels),
                                repr(float(entry.get("sum", 0.0)))))
            else:
                lines.append("%s%s %s" % (name, _fmt_labels(labels),
                                          repr(float(entry["value"]))))
    return "\n".join(lines) + "\n"


#: THE process-wide registry.
REGISTRY = MetricsRegistry()


def get_registry():
    return REGISTRY
