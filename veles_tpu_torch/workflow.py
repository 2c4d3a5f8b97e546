"""Workflow: the container unit that owns and schedules the graph
(``veles_tpu/workflow.py``).

Execution uses a deterministic single-threaded signal queue: units fire
control signals into a FIFO; a unit runs when its barrier of incoming
links is complete and its gates allow. :meth:`Workflow.run` is that
eager drain; the port's training runs through ``train.runner.
FusedRunner``, which fires the same units at epoch boundaries. The
JAX package's master/slave data methods, plotters and tracing spans are
not ported yet.
"""

import collections
import hashlib
import time

from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.plumbing import StartPoint, EndPoint, Repeater
from veles_tpu_torch.units import Container


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
            for unit in self._units:
                unit.reset_fired()
            self.start_point._run_wrapped()
            self.signal_fired(self.start_point)
            self._drain()
        finally:
            self.is_running = False
            self._run_time += time.perf_counter() - start
            self.event("run", "end")

    def _drain(self):
        # Signals already in flight when the end point fires still run:
        # a loop iteration completes atomically (gates block *new*
        # iterations via Repeater.gate_block). This is what makes a
        # snapshot taken at the stop boundary bit-identical to the same
        # point of an uninterrupted run. An explicit stop() (abort) is
        # different: it discards everything in flight immediately.
        signals = self._signals_
        while signals:
            dst, src = signals.popleft()
            if self._aborted_:
                continue
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
