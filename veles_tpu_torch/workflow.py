"""Workflow: the container unit that owns and schedules the graph
(``veles_tpu/workflow.py``).

Execution uses a deterministic single-threaded signal queue: units fire
control signals into a FIFO; a unit runs when its barrier of incoming
links is complete and its gates allow. :meth:`Workflow.run` is that
eager drain (``python -m veles_tpu_torch --eager``); by default the
port's training runs through ``train.runner.FusedRunner``, which fires
the same units at epoch boundaries.

A unit may :meth:`Workflow.defer` work to the end of the loop iteration
in flight: the snapshotter does, so that an eager snapshot taken on an
epoch's last minibatch holds every gradient unit's update of that
minibatch, not only those that ran before it in the queue.

:meth:`Workflow.add_plotters` wires the standard plot set
(``plotting_units.py``) after the decision, gated to epoch boundaries,
and :meth:`Workflow.graph_description` is the control-flow graph as the
web_status dashboard draws it.

Master/slave (``veles_tpu/workflow.py``): the workflow aggregates its
units' distribution protocol -- a job is every unit's payload
(:meth:`Workflow.generate_data_for_slave`), or a *segment* of up to N
contiguous same-class loader minibatches beside the other units'
payloads (:meth:`Workflow.generate_segment_for_slave`, run by
``train.segment.SegmentExecutor``); :meth:`Workflow.do_job` is the
eager slave's one-minibatch job; a slave joining mid-run gets the live
weights, decision state, epoch cursors and random streams in its
handshake (:meth:`Workflow.generate_resync_for_slave`).
"""

import collections
import hashlib
import time

from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import StartPoint, EndPoint, Repeater
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.units import Container


class NoMoreJobs(Exception):
    """The master's workflow has stopped: no job to hand out."""


class Workflow(Container):
    """A graph of units with start/end points and a run loop."""

    hide_from_registry = False

    def __init__(self, workflow=None, **kwargs):
        self._units = []
        super(Workflow, self).__init__(workflow, **kwargs)
        self.stopped = Bool(True)
        self.is_running = False
        self.start_point = StartPoint(self)
        self.end_point = EndPoint(self)
        self._run_time = 0.0
        self.fitness = None  # set by evaluation units for genetics

    def init_unpickled(self):
        super(Workflow, self).init_unpickled()
        self._signals_ = collections.deque()
        self._aborted_ = False
        self._draining_ = False
        self._deferred_ = []
        self.on_finished_callbacks_ = []

    # Workflow.stopped shadows Unit.stopped (which proxies to the parent).
    @property
    def stopped(self):
        return self._stopped

    @stopped.setter
    def stopped(self, value):
        if isinstance(value, Bool):
            self._stopped = value
        else:
            self._stopped.value = bool(value)

    # -- unit ownership ----------------------------------------------------

    @property
    def units(self):
        return list(self._units)

    @property
    def units_in_dependency_order(self):
        """BFS from start_point, then any unreachable units in add order."""
        order = self.start_point.dependent_units()
        for unit in self._units:
            if unit not in order:
                order.append(unit)
        return [u for u in order if u is not self]

    def add_ref(self, unit):
        if unit is self:
            raise ValueError("workflow cannot own itself")
        if unit not in self._units:
            self._units.append(unit)

    def del_ref(self, unit):
        if unit in self._units:
            self._units.remove(unit)

    def index_of(self, unit):
        return self._units.index(unit)

    def change_unit(self, old, new_unit, save_gates=True):
        """Swap a unit in an already-linked (possibly snapshot-restored)
        graph, preserving its control links.

        The reference's ``Workflow.change_unit``
        (``veles/workflow.py:977-1051``) is what made its
        snapshot-then-modify loop usable: restore, replace one unit
        (typically the decision), resume. ``old`` is a unit or its
        name; ``new_unit`` takes over every control link into and out
        of ``old`` and (with ``save_gates``) its gate objects. Data
        links (``link_attrs``) and gate EXPRESSIONS other units built
        from the old unit's Bools (e.g. ``repeater.gate_block =
        decision.complete``) reference live objects and must be re-made
        by the caller — same contract as the reference, which left its
        "data links transmission" TODO unresolved. Returns ``new_unit``.
        """
        old_unit = self[old] if isinstance(old, str) else old
        if old_unit is new_unit:
            return new_unit
        sources = list(old_unit.links_from)
        dependents = list(old_unit.links_to)
        gate_block, gate_skip = old_unit.gate_block, old_unit.gate_skip
        old_unit.unlink_all()
        self.del_ref(old_unit)
        self.add_ref(new_unit)
        if sources:
            new_unit.link_from(*sources)
        for dst in dependents:
            dst.link_from(new_unit)
        if save_gates:
            new_unit.gate_block = gate_block
            new_unit.gate_skip = gate_skip
        return new_unit

    def __iter__(self):
        return iter(self._units)

    def __len__(self):
        return len(self._units)

    def __getitem__(self, key):
        if isinstance(key, str):
            for unit in self._units:
                if unit.name == key:
                    return unit
            raise KeyError(key)
        return self._units[key]

    # -- lifecycle ---------------------------------------------------------

    def initialize(self, **kwargs):
        """Initialize all units in dependency order with partial retry.

        A unit returning True from initialize() is re-queued and retried
        after the others — the reference's partial-initialization contract
        (``veles/workflow.py:303-349``).
        """
        self.event("initialize", "begin")
        pending = [u for u in self.units_in_dependency_order]
        max_rounds = len(pending) + 1
        for _ in range(max_rounds):
            retry = []
            for unit in pending:
                if unit._initialize_wrapped(**kwargs) is True:
                    retry.append(unit)
            if not retry:
                break
            if len(retry) == len(pending):
                raise RuntimeError(
                    "initialization deadlock: %s never became ready" %
                    ", ".join(u.name for u in retry))
            pending = retry
        else:
            raise RuntimeError("initialization did not converge")
        self._is_initialized = True
        self.event("initialize", "end")
        return None

    def signal_fired(self, src):
        """Enqueue control signals from ``src`` to its dependents."""
        for dst in src.links_to:
            self._signals_.append((dst, src))

    def run(self):
        """Run the graph to completion (until the end point fires)."""
        self.event("run", "begin")
        self.stopped <<= False
        self._aborted_ = False
        self.is_running = True
        start = time.perf_counter()
        try:
            self._signals_.clear()
            self._deferred_ = []
            for unit in self._units:
                unit.reset_fired()
            self.start_point._run_wrapped()
            self.signal_fired(self.start_point)
            self._draining_ = True
            self._drain()
        finally:
            self._draining_ = False
            self.is_running = False
            elapsed = time.perf_counter() - start
            self._run_time += elapsed
            if tracing.enabled():
                tracing.add_complete("workflow:%s" % self.name, start,
                                     elapsed, units=len(self._units))
            self.event("run", "end")

    def _drain(self):
        # Signals already in flight when the end point fires still run:
        # a loop iteration completes atomically (gates block *new*
        # iterations via Repeater.gate_block). This is what makes a
        # snapshot taken at the stop boundary bit-identical to the same
        # point of an uninterrupted run. An explicit stop() (abort) is
        # different: it discards everything in flight immediately.
        signals = self._signals_
        while signals or self._deferred_:
            if self._aborted_:
                signals.clear()
                self._deferred_ = []
                break
            if self._deferred_ and all(isinstance(d, (EndPoint, Repeater))
                                       for d, _ in signals):
                # the iteration in flight is done: only the loop's
                # anchors are left to fire
                deferred, self._deferred_ = self._deferred_, []
                for fn in deferred:
                    fn()
                continue
            dst, src = signals.popleft()
            if bool(self.stopped) and isinstance(dst, (EndPoint, Repeater)):
                # the end point already ran once; Repeaters anchor loops,
                # so blocking them after the stop guarantees termination
                # even for cycles whose gates are not wired to the stop
                # condition — in-flight units of the current iteration
                # still finish (snapshot-exactness contract)
                continue
            if bool(dst.gate_block):
                continue
            if not dst.open_gate(src):
                continue
            if bool(dst.gate_skip):
                self.signal_fired(dst)
                continue
            dst._run_wrapped()
            if not (isinstance(dst, EndPoint)):
                self.signal_fired(dst)

    def defer(self, fn):
        """Call ``fn()`` once the eager loop iteration in flight has
        finished (when only signals to repeaters or the end point are
        queued), or now outside the eager scheduler."""
        if self._draining_:
            self._deferred_.append(fn)
        else:
            fn()

    def on_workflow_finished(self):
        if bool(self.stopped):
            return  # idempotent: multiple paths may reach the end point
        self.stopped <<= True
        for callback in list(self.on_finished_callbacks_):
            callback()

    def stop(self):
        """Abort: halt the loop now, discarding in-flight signals."""
        self._aborted_ = True
        self.on_workflow_finished()

    def add_finished_callback(self, callback):
        self.on_finished_callbacks_.append(callback)

    def make_fused_runner(self):
        """Hook for workflows with a runner of their own. None (the
        default) lets the launcher run the standard ``FusedRunner``."""
        return None

    # -- distributed protocol aggregation ---------------------------------

    def _distributed_units(self):
        return list(self.units_in_dependency_order)

    def generate_initial_data_for_slave(self, slave=None):
        return [(unit.name, unit.generate_data_for_slave_locked(slave))
                for unit in self._distributed_units()
                if unit.negotiates_on_connect]

    def apply_initial_data_from_master(self, data):
        """The handshake's payload: the ``negotiates_on_connect`` units'
        list, or, from a master mid-run, ``{"units": ..., "resync":
        ...}`` with the full-push resync."""
        if isinstance(data, dict):
            resync = data.get("resync")
            if resync:
                self.apply_resync_from_master(resync)
            data = data.get("units")
        for name, payload in data or []:
            self[name].apply_data_from_master(payload)

    def generate_resync_for_slave(self, slave=None):
        """What a slave joining mid-run needs to act as a resident one
        from its first job: every non-loader unit's payload (weights,
        decision state), the loader's epoch cursors as numbers (its own
        payload would advance the serving order) and the random
        streams."""
        from veles_tpu_torch import prng
        loader = getattr(self, "loader", None)
        units = [(u.name, u.generate_data_for_slave_locked(slave))
                 for u in self._distributed_units()
                 if u is not loader and not u.negotiates_on_connect]
        resync = {"units": units, "random": prng.dump_states()}
        if loader is not None:
            resync["epoch"] = int(loader.epoch_number)
            resync["served"] = int(loader.samples_served)
        return resync

    def apply_resync_from_master(self, resync):
        """Slave side of :meth:`generate_resync_for_slave`."""
        from veles_tpu_torch import prng
        prng.restore_states(resync.get("random"))
        for name, payload in resync.get("units") or []:
            if payload is None:
                continue
            try:
                self[name].apply_data_from_master(payload)
            except KeyError:
                self.warning("resync names unknown unit %r; skipped",
                             name)
        loader = getattr(self, "loader", None)
        if loader is not None and "epoch" in resync:
            loader.epoch_number = int(resync["epoch"])
            loader.samples_served = int(resync.get("served", 0))

    def generate_data_for_slave(self, slave=None):
        """One job: every unit's payload, or None (the slave idles a
        moment) while a unit withholds data (the decision bounding the
        epoch run-ahead). Never blocks: the asking thread may be the one
        whose update would release it."""
        if bool(self.stopped):
            raise NoMoreJobs()
        units = self._distributed_units()
        if not all(u.has_data_for_slave for u in units):
            return None
        return [(u.name, u.generate_data_for_slave_locked(slave))
                for u in units]

    def generate_segment_for_slave(self, slave=None, max_minibatches=8):
        """A segment job: the non-loader units' payloads once, and up to
        ``max_minibatches`` contiguous same-class loader minibatches,
        each registered in the loader's pending set (a dropped slave's
        minibatches requeue one by one). A requeued minibatch goes out
        alone."""
        if bool(self.stopped):
            raise NoMoreJobs()
        units = self._distributed_units()
        if not all(u.has_data_for_slave for u in units):
            return None
        loader = self.loader
        replay = bool(loader.failed_minibatches)
        batches = [loader.generate_data_for_slave_locked(slave)]
        while (not replay and len(batches) < max_minibatches and
               not batches[-1]["last"] and
               not loader.failed_minibatches):
            batches.append(loader.generate_data_for_slave_locked(slave))
        others = [(u.name, u.generate_data_for_slave_locked(slave))
                  for u in units if u is not loader]
        return {"units": others, "batches": batches}

    def apply_data_from_master(self, job):
        for name, payload in job:
            if payload is not None:
                self[name].apply_data_from_master(payload)

    def generate_data_for_master(self):
        return [(u.name, u.generate_data_for_master())
                for u in self._distributed_units()]

    def apply_data_from_slave(self, update, slave=None):
        for name, payload in update or []:
            if payload is not None:
                self[name].apply_data_from_slave_locked(payload, slave)

    def do_job(self, job):
        """Slave side of a one-minibatch job: apply it, run the graph
        once (the decision closes the loop after the minibatch), return
        the update."""
        self.apply_data_from_master(job)
        self.run()
        return self.generate_data_for_master()

    def drop_slave(self, slave=None):
        for unit in self._distributed_units():
            unit.drop_slave(slave)

    # -- results / stats / integrity --------------------------------------

    def gather_results(self):
        """Aggregate metrics from IResultProvider units into one dict."""
        from veles_tpu_torch.result_provider import IResultProvider
        results = {}
        for unit in self._units:
            if isinstance(unit, IResultProvider):
                results.update(unit.get_metric_values() or {})
        return results

    def print_stats(self, top=5):
        """Log the slowest units (``veles/workflow.py:788-825``)."""
        timed = sorted(self._units, key=lambda u: -u.run_time)[:top]
        total = sum(u.run_time for u in self._units) or 1e-12
        self.info("workflow \"%s\": %.3f s total unit time over %d units",
                  self.name, total, len(self._units))
        for unit in timed:
            if unit.run_calls:
                self.info("  %-30s %8.3f s (%5.1f%%) in %d calls",
                          unit.name, unit.run_time,
                          100.0 * unit.run_time / total, unit.run_calls)

    @property
    def checksum(self):
        """Topology checksum guarding master/slave compatibility
        (``veles/workflow.py:851-866``)."""
        digest = hashlib.sha256()
        for unit in self._units:
            digest.update(type(unit).__name__.encode())
            digest.update(unit.name.encode())
            for dst in unit.links_to:
                digest.update(dst.name.encode())
        return digest.hexdigest()

    def generate_graph(self):
        """DOT source of the control-flow graph (``workflow.py:628-754``)."""
        lines = ["digraph %s {" % self.name.replace(" ", "_"),
                 '  rankdir="TB";']
        ids = {}
        for i, unit in enumerate(dict.fromkeys(
                [self.start_point, self.end_point] + self._units)):
            ids[unit] = "u%d" % i
            lines.append('  %s [label="%s\\n%s" shape=%s];' % (
                ids[unit], type(unit).__name__, unit.name,
                "ellipse" if unit.view_group == "PLUMBING" else "box"))
        for unit in ids:
            for dst in unit.links_to:
                if dst in ids:
                    lines.append("  %s -> %s;" % (ids[unit], ids[dst]))
        lines.append("}")
        return "\n".join(lines)

    def graph_description(self):
        """The JSON-able control-flow graph the web_status dashboard
        draws: ``{"nodes": [{id, name, type, group}], "edges": [[src,
        dst]]}``."""
        units = list(dict.fromkeys(
            [self.start_point, self.end_point] + self._units))
        ids = {unit: i for i, unit in enumerate(units)}
        nodes = [{"id": ids[u], "name": u.name,
                  "type": type(u).__name__,
                  "group": u.view_group} for u in units]
        edges = [[ids[src], ids[dst]] for src in units
                 for dst in src.links_to if dst in ids]
        return {"nodes": nodes, "edges": edges}

    def add_plotters(self, klasses=("train", "validation"),
                     confusion=True):
        """Wire the standard plot set: one epoch-metric curve a sample
        class, and the confusion heatmap when the evaluator has a
        confusion matrix, chained after ``self.decision`` and run only
        at epoch boundaries (``~loader.epoch_ended`` skips them), so
        they never sit on the training path. Plotters added to an
        initialized workflow initialize here. A master's ``SlaveStats``
        chart is the launcher's (``Launcher._start_slave_stats``): a
        master never runs its graph."""
        from veles_tpu_torch.plotting_units import (EpochMetricPlotter,
                                                    MatrixPlotter)
        self.plotters = []
        prev = self.decision
        for klass in klasses:
            plotter = EpochMetricPlotter(
                self, name="%s %s" % (klass, self.decision.METRIC_NAME),
                klass=klass)
            plotter.link_from(prev)
            plotter.link_attrs(self.decision, ("input", "epoch_history"))
            plotter.gate_skip = ~self.loader.epoch_ended
            self.plotters.append(plotter)
            prev = plotter
        evaluator = getattr(self, "evaluator", None)
        if confusion and evaluator is not None and \
                hasattr(evaluator, "confusion_matrix"):
            plotter = MatrixPlotter(self, name="confusion")
            plotter.link_from(prev)
            plotter.link_attrs(evaluator, ("input", "confusion_matrix"))
            plotter.gate_skip = ~self.loader.epoch_ended
            self.plotters.append(plotter)
        for plotter in self.plotters:
            if not plotter.is_initialized:
                plotter._initialize_wrapped()
        return self.plotters

    def package_export(self, path, precision="float32"):
        """Write the inference package of the forward chain
        (:func:`veles_tpu_torch.export.package.export_workflow`)."""
        from veles_tpu_torch.export.package import export_workflow
        return export_workflow(self, path, precision=precision)

    @property
    def computing_power(self):
        """The device's rating (``accelerated_units.DeviceBenchmark``);
        0 without a device."""
        from veles_tpu_torch.accelerated_units import DeviceBenchmark
        device = getattr(self, "device", None)
        if device is None:
            return 0.0
        return DeviceBenchmark.estimate(device)

    def __getstate__(self):
        state = super(Workflow, self).__getstate__()
        state.pop("is_running", None)
        return state

    def __setstate__(self, state):
        super(Workflow, self).__setstate__(state)
        self.is_running = False
