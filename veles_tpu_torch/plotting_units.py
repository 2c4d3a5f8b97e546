"""Concrete plotter units (``veles_tpu/plotting_units.py``).

The accumulating metric curve, the confusion-matrix plot, histograms,
image mosaics, curve sets, the max/min table and the per-slave load
view. Each captures its data in ``fill()`` on the host (:func:`_to_host`
copies a tensor off the card: the one sync a plot costs) and renders in
``redraw()`` inside the graphics client.
"""

import numpy

from veles_tpu_torch.plotter import Plotter


def _to_host(value):
    """A tensor (on any device), an array or a number as numpy: a
    snapshot must unpickle where there is no card."""
    detach = getattr(value, "detach", None)
    if detach is not None:
        value = detach().cpu().numpy()
    return numpy.asarray(value)


class AccumulatingPlotter(Plotter):
    """Curve of a scalar metric over time (AccumulatingPlotter).

    ``input`` is a linked attribute; ``input_field`` optionally selects
    a key/index inside it. Appends one point per run.
    """

    def __init__(self, workflow, **kwargs):
        super(AccumulatingPlotter, self).__init__(workflow, **kwargs)
        self.input_field = kwargs.get("input_field", None)
        self.label = kwargs.get("label", self.name)
        self.plot_style = kwargs.get("plot_style", "-")
        self.values = []
        self.demand("input")

    def fill(self):
        value = self.input
        if self.input_field is not None:
            try:
                value = value[self.input_field]
            except TypeError:
                value = getattr(value, self.input_field)
        if self.clear_plot:
            del self.values[:]
        self.values.append(float(_to_host(value)))

    def redraw(self, figure):
        axes = figure.add_subplot(111)
        axes.plot(self.values, self.plot_style, label=self.label)
        axes.set_xlabel("updates")
        axes.set_ylabel(self.label)
        axes.grid(True)
        if len(self.values) > 1:
            axes.legend(loc="best")
        figure.suptitle(self.name)


class EpochMetricPlotter(AccumulatingPlotter):
    """Per-epoch normalized metric curve from a Decision unit.

    ``input`` links to the decision's ``epoch_history``; ``klass``
    selects which sample-class curve to plot ("train"/"validation"/
    "test").
    """

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("input_field", None)
        super(EpochMetricPlotter, self).__init__(workflow, **kwargs)
        self.klass = kwargs.get("klass", "validation")
        self.label = kwargs.get("label", self.klass)

    def fill(self):
        history = self.input
        if not history:
            return
        stats = history[-1].get(self.klass)
        if stats and "normalized" in stats:
            self.values.append(float(stats["normalized"]))


class MatrixPlotter(Plotter):
    """Confusion-matrix heatmap with per-cell counts (MatrixPlotter)."""

    def __init__(self, workflow, **kwargs):
        super(MatrixPlotter, self).__init__(workflow, **kwargs)
        self.matrix = None
        self.reversed_labels_mapping = kwargs.get(
            "reversed_labels_mapping", None)
        self.demand("input")

    def fill(self):
        matrix = _to_host(self.input).copy()
        if matrix.ndim == 1:  # evaluator ships it flattened
            side = int(round(numpy.sqrt(matrix.size)))
            matrix = matrix.reshape(side, side)
        self.matrix = matrix

    def redraw(self, figure):
        axes = figure.add_subplot(111)
        num = self.matrix.shape[0]
        axes.imshow(self.matrix, interpolation="nearest", cmap="Blues")
        threshold = self.matrix.max() / 2.0 if self.matrix.size else 0
        for (row, col), count in numpy.ndenumerate(self.matrix):
            axes.text(col, row, "%d" % count, ha="center", va="center",
                      color="white" if count > threshold else "black")
        labels = (self.reversed_labels_mapping or
                  [str(i) for i in range(num)])
        axes.set_xticks(range(num))
        axes.set_yticks(range(num))
        axes.set_xticklabels(labels)
        axes.set_yticklabels(labels)
        axes.set_xlabel("predicted")
        axes.set_ylabel("target")
        figure.suptitle(self.name)


class SimpleHistogram(Plotter):
    """Histogram of a flat array (Histogram / MultiHistogram family)."""

    def __init__(self, workflow, **kwargs):
        super(SimpleHistogram, self).__init__(workflow, **kwargs)
        self.bins = kwargs.get("bins", 50)
        self.data = None
        self.demand("input")

    def fill(self):
        self.data = _to_host(self.input).ravel().copy()

    def redraw(self, figure):
        axes = figure.add_subplot(111)
        axes.hist(self.data, bins=self.bins)
        axes.grid(True)
        figure.suptitle(self.name)


class ImagePlotter(Plotter):
    """Mosaic of 2D slices (ImagePlotter / Weights2D).

    ``input`` is an array whose first axis indexes samples/filters; up
    to ``limit`` slices are tiled into a square grid.
    """

    def __init__(self, workflow, **kwargs):
        super(ImagePlotter, self).__init__(workflow, **kwargs)
        self.limit = kwargs.get("limit", 16)
        self.color = kwargs.get("color", False)
        self.images = None
        self.demand("input")

    def fill(self):
        data = _to_host(self.input)
        if data.ndim == 1:
            data = data[numpy.newaxis]
        count = min(self.limit, data.shape[0])
        images = []
        for i in range(count):
            img = data[i]
            if img.ndim == 1:  # flat sample → squarest 2D reshape
                side = int(numpy.sqrt(img.size))
                while img.size % side:
                    side -= 1
                img = img.reshape(side, img.size // side)
            images.append(numpy.array(img, dtype=numpy.float32))
        self.images = images

    def redraw(self, figure):
        count = len(self.images)
        side = int(numpy.ceil(numpy.sqrt(count)))
        for i, img in enumerate(self.images):
            axes = figure.add_subplot(side, side, i + 1)
            if img.ndim == 3 and self.color:
                lo, hi = img.min(), img.max()
                axes.imshow((img - lo) / max(hi - lo, 1e-30))
            else:
                if img.ndim == 3:
                    img = img.mean(axis=-1)
                axes.imshow(img, interpolation="nearest", cmap="gray")
            axes.axis("off")
        figure.suptitle(self.name)


class ImmediatePlotter(Plotter):
    """N curves rendered together on one axes (reference
    ``veles/plotting_units.py:480-530``).

    ``inputs`` is a list of array-ish series; ``input_fields[i]``
    optionally selects an int index or attribute inside ``inputs[i]``;
    ``input_styles[i]`` is the matplotlib line style. Unlike the
    reference (which redrew from live unit attributes), ``fill()``
    captures every series host-side so the snapshot travels the graphics
    pipe self-contained.
    """

    DEFAULT_STYLES = ["k-", "g-", "b-", "r-", "c-", "m-"]

    def __init__(self, workflow, **kwargs):
        super(ImmediatePlotter, self).__init__(workflow, **kwargs)
        self.inputs = list(kwargs.get("inputs", []))
        self.input_fields = list(kwargs.get("input_fields", []))
        self.input_styles = list(kwargs.get("input_styles", []))
        self.ylim = kwargs.get("ylim")
        self.series = []

    def fill(self):
        self.series = []
        for i, value in enumerate(self.inputs):
            field = (self.input_fields[i]
                     if i < len(self.input_fields) else None)
            if field is not None:
                if isinstance(field, int):
                    value = value[field]
                else:
                    value = getattr(value, field)
            self.series.append(
                numpy.asarray(_to_host(value), numpy.float64).ravel())

    def redraw(self, figure):
        axes = figure.add_subplot(111)
        if self.ylim is not None:
            axes.set_ylim(self.ylim[0], self.ylim[1])
        for i, series in enumerate(self.series):
            style = (self.input_styles[i] if i < len(self.input_styles)
                     else self.DEFAULT_STYLES[i % len(self.DEFAULT_STYLES)])
            axes.plot(series, style)
        axes.grid(True)
        figure.suptitle(self.name)


class AutoHistogramPlotter(SimpleHistogram):
    """Histogram of a 1D series with the bin count chosen by the
    Freedman-Diaconis rule (reference ``plotting_units.py:629-678``)."""

    def fill(self):
        super(AutoHistogramPlotter, self).fill()
        data = self.data
        if data is None or data.size < 2:
            self.bins = None
            return
        data = data.astype(numpy.float64)
        iqr = (numpy.percentile(data, 75, method="higher") -
               numpy.percentile(data, 25, method="lower"))
        span = float(data.max() - data.min())
        if iqr <= 0 or span <= 0:
            self.bins = 3
            return
        width = 2.0 * iqr * data.size ** (-1.0 / 3.0)
        self.bins = max(3, int(round(span / width)))

    def redraw(self, figure):
        if self.bins is None:
            return  # <2 points: nothing meaningful to draw (reference
            # AutoHistogramPlotter.redraw returned early the same way)
        super(AutoHistogramPlotter, self).redraw(figure)


class MultiHistogram(Plotter):
    """Grid of per-row histograms of a 2D input — one histogram per
    neuron/filter (reference ``plotting_units.py:681-766``).

    ``input`` is (rows, ...); the first ``hist_number`` rows (capped by
    ``limit``) are each binned into ``n_bars`` buckets. Counts are
    computed vectorized in ``fill()``; the snapshot carries only the
    (rows, n_bars) counts plus per-row ranges.
    """

    def __init__(self, workflow, **kwargs):
        super(MultiHistogram, self).__init__(workflow, **kwargs)
        self.limit = kwargs.get("limit", 64)
        self.n_bars = kwargs.get("n_bars", 25)
        self.hist_number = min(kwargs.get("hist_number", 16), self.limit)
        self.counts = None
        self.ranges = None
        self.demand("input")

    def fill(self):
        data = _to_host(self.input)
        rows = min(self.hist_number, data.shape[0])
        counts = numpy.zeros((rows, self.n_bars), numpy.int64)
        ranges = numpy.zeros((rows, 2), numpy.float64)
        for i in range(rows):
            row = numpy.asarray(data[i], numpy.float64).ravel()
            lo, hi = float(row.min()), float(row.max())
            ranges[i] = lo, hi
            if hi > lo:
                counts[i] = numpy.histogram(
                    row, bins=self.n_bars, range=(lo, hi))[0]
        self.counts, self.ranges = counts, ranges

    def redraw(self, figure):
        rows = self.counts.shape[0]
        n_cols = max(1, int(round(numpy.sqrt(rows))))
        n_rows = int(numpy.ceil(rows / n_cols))
        for i in range(rows):
            axes = figure.add_subplot(n_rows, n_cols, i + 1)
            lo, hi = self.ranges[i]
            centers = numpy.linspace(lo, hi, num=self.n_bars,
                                     endpoint=True)
            width = (hi - lo) / self.n_bars * 0.8 if hi > lo else 0.8
            axes.bar(centers, self.counts[i], width=width)
            axes.grid(True)
            if n_rows > 4:
                axes.set_yticklabels([])
            if n_cols > 3:
                axes.set_xticklabels([])
        figure.suptitle(self.name)


class TableMaxMin(Plotter):
    """max/min table over a list of arrays (reference
    ``plotting_units.py:769-819``): one column per watched tensor, two
    rows. ``y`` holds the arrays, ``col_labels`` their names."""

    def __init__(self, workflow, **kwargs):
        super(TableMaxMin, self).__init__(workflow, **kwargs)
        self.y = list(kwargs.get("y", []))
        self.col_labels = list(kwargs.get("col_labels", []))
        self.values = None

    def fill(self):
        if len(self.col_labels) != len(self.y):
            raise ValueError(
                "col_labels (%d) must match y (%d)" %
                (len(self.col_labels), len(self.y)))
        values = numpy.zeros((2, len(self.y)), numpy.float64)
        for i, value in enumerate(self.y):
            arr = _to_host(value)
            values[0, i] = arr.max()
            values[1, i] = arr.min()
        self.values = values

    def redraw(self, figure):
        axes = figure.add_subplot(111)
        axes.axis("off")
        cells = [["%.6f" % v for v in row] for row in self.values]
        table = axes.table(cellText=cells, rowLabels=["max", "min"],
                           colLabels=self.col_labels, loc="center")
        table.set_fontsize(14)
        figure.suptitle(self.name)


class SlaveStats(Plotter):
    """Per-slave load/latency view of a running coordinator (reference
    ``plotting_units.py:822-905`` drew slave iteration timings from
    apply_data_from_slave callbacks).

    Here the master-side coordinator already keeps the authoritative
    registry, so ``fill()`` reads ``server.snapshot_slaves()`` and
    accumulates a per-slave series of job completion rates; no
    protocol hooks needed. The same snapshot feeds the web dashboard.
    """

    def __init__(self, workflow, **kwargs):
        super(SlaveStats, self).__init__(workflow, **kwargs)
        self.period = kwargs.get("period", 100)
        self.server = kwargs.get("server")
        self._last_jobs = {}
        # sid -> list of (jobs_since_last, staleness_s, n_in_flight);
        # redraw() stacks one subplot per element
        self.history = {}
        self.labels = {}   # sid -> "sid (pid)"

    def fill(self):
        import time as _time
        server = self.server
        if server is None:
            return
        now = _time.time()
        snapshot = server.snapshot_slaves()  # ONE consistent copy
        for slave in snapshot:
            done = slave.jobs_done
            if slave.id not in self._last_jobs:
                # first sight: seed the baseline, record no delta — a
                # slave with a lifetime of prior jobs (or one
                # reconnecting) must not spike the per-tick series
                self._last_jobs[slave.id] = done
                self.labels[slave.id] = "%s (pid %s)" % (slave.id,
                                                         slave.pid)
                continue
            delta = done - self._last_jobs[slave.id]
            self._last_jobs[slave.id] = done
            series = self.history.setdefault(slave.id, [])
            series.append((delta, now - slave.last_seen,
                           len(slave.jobs_in_flight)))
            if len(series) > 2 * self.period:
                del series[:len(series) - self.period]
            self.labels[slave.id] = "%s (pid %s)" % (slave.id, slave.pid)
        # forget slaves the coordinator dropped
        alive = {s.id for s in snapshot}
        for sid in list(self.history):
            if sid not in alive:
                self.history.pop(sid)
                self.labels.pop(sid, None)
                self._last_jobs.pop(sid, None)

    def redraw(self, figure):
        if not self.history:
            return
        panes = (("jobs completed per tick", 0),
                 ("staleness (s)", 1),
                 ("jobs in flight", 2))
        for row, (ylabel, elem) in enumerate(panes, start=1):
            axes = figure.add_subplot(len(panes), 1, row)
            for sid in sorted(self.history):
                series = self.history[sid][-self.period:]
                axes.plot([p[elem] for p in series],
                          label=self.labels.get(sid, sid))
            axes.set_ylabel(ylabel)
            axes.set_ylim(bottom=0)
            axes.grid(True)
            if row == 1:
                axes.legend(loc="best")
            if row == len(panes):
                axes.set_xlabel("fill ticks")
        figure.suptitle(self.name)

    def __getstate__(self):
        # the live server handle must not ride the snapshot
        state = super(SlaveStats, self).__getstate__()
        state["server"] = None
        return state
