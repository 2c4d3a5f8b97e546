"""The dataflow node type: Unit (``veles_tpu/units.py``).

A Unit is a node in a workflow graph with

* **control links** — ``a.link_from(b)`` means "a becomes runnable after
  b fires"; a unit with several incoming links waits for *all* of them
  (barrier semantics), then its fired-flags reset, which is what makes
  loops (via :class:`~veles_tpu_torch.plumbing.Repeater`) work;
* **gates** — shared :class:`~veles_tpu_torch.mutable.Bool` cells:
  ``gate_block`` suppresses both the unit and its subtree, ``gate_skip``
  skips the unit's body but still fires its dependents;
* **data links** — ``link_attrs`` makes attributes aliases of another
  unit's attributes (see :mod:`veles_tpu_torch.mutable`);
* **demand contract** — ``demand("x", "y")`` declares attributes that
  must be provided (set or linked) before ``initialize()``.

Execution is driven by the owning workflow's deterministic scheduler
(:mod:`veles_tpu_torch.workflow`). With tracing on, each run is a
``unit:<name>`` span; with tracing on or ``timings``, its wall time lands
in ``veles_unit_run_ms{unit}`` (and ``timings`` logs it), as in the JAX
package. A unit's span times the host: it ends when ``run()`` returns,
which for a unit that only issues work to the card is before the card
has done it.
"""

import time

from veles_tpu_torch.config import root
from veles_tpu_torch.distributable import Distributable
from veles_tpu_torch.mutable import Bool, link, unlink
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.telemetry.registry import get_registry
from veles_tpu_torch.unit_registry import UnitRegistry

_unit_run_ms = None


def _unit_run_hist():
    """Lazy: most processes never flip ``timings`` or enable tracing."""
    global _unit_run_ms
    if _unit_run_ms is None:
        _unit_run_ms = get_registry().histogram(
            "veles_unit_run_ms", "Per-unit run() wall time",
            labels=("unit",))
    return _unit_run_ms


class IUnit(object):
    """Documentation marker: units implement initialize() and run()."""


class Unit(Distributable, metaclass=UnitRegistry):
    """Base dataflow node. See module docstring for semantics."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        self.name = kwargs.pop("name", None) or type(self).__name__
        self.view_group = kwargs.pop("view_group",
                                     getattr(self, "view_group", "WORKER"))
        self.timings = kwargs.pop("timings", root.common.get("timings", False))
        super(Unit, self).__init__(**kwargs)
        self.links_from = {}
        self.links_to = []
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self.demanded = set()
        self._is_initialized = False
        self.run_calls = 0
        self.run_time = 0.0
        self._workflow = None
        self.workflow = workflow

    # -- identity ---------------------------------------------------------

    @property
    def workflow(self):
        return self._workflow

    @workflow.setter
    def workflow(self, value):
        if self._workflow is not None:
            self._workflow.del_ref(self)
        self._workflow = value
        if value is not None:
            value.add_ref(self)

    @property
    def is_standalone(self):
        return self.launcher.mode == "standalone" if self.launcher else True

    @property
    def is_master(self):
        return self.launcher.mode == "master" if self.launcher else False

    @property
    def is_slave(self):
        return self.launcher.mode == "slave" if self.launcher else False

    @property
    def launcher(self):
        from veles_tpu_torch.workflow import Workflow
        node = self._workflow
        while isinstance(node, Workflow):
            node = node.workflow
        return node

    @property
    def is_initialized(self):
        return self._is_initialized

    @property
    def stopped(self):
        return bool(self._workflow.stopped) if self._workflow else False

    # -- control links ----------------------------------------------------

    def link_from(self, *sources):
        """Run after all of ``sources``; returns self for chaining."""
        for src in sources:
            if src is self:
                raise ValueError("%s cannot link from itself" % self)
            self.links_from[src] = False
            if self not in src.links_to:
                src.links_to.append(self)
        return self

    def unlink_from(self, *sources):
        for src in sources:
            self.links_from.pop(src, None)
            if self in src.links_to:
                src.links_to.remove(self)
        return self

    def unlink_all(self):
        self.unlink_before()
        self.unlink_after()

    def unlink_before(self):
        for src in list(self.links_from):
            self.unlink_from(src)

    def unlink_after(self):
        for dst in list(self.links_to):
            dst.unlink_from(self)

    def insert_after(self, *chain):
        """Splice ``chain`` between self and self's current dependents."""
        dependents = list(self.links_to)
        for dst in dependents:
            dst.unlink_from(self)
        prev = self
        for unit in chain:
            unit.link_from(prev)
            prev = unit
        for dst in dependents:
            dst.link_from(prev)
        return prev

    def dependent_units(self):
        """BFS over control links from self (``veles/units.py:507-522``)."""
        seen = [self]
        pos = 0
        while pos < len(seen):
            for dst in seen[pos].links_to:
                if dst not in seen:
                    seen.append(dst)
            pos += 1
        return seen

    # -- data links --------------------------------------------------------

    def link_attrs(self, other, *names, two_way=False):
        """Alias attributes of ``other`` into self.

        Each name is either ``"attr"`` or ``("mine", "theirs")``
        (``veles/units.py:638-680``).
        """
        for name in names:
            if isinstance(name, tuple):
                mine, theirs = name
            else:
                mine = theirs = name
            link(self, mine, other, theirs, two_way=two_way)
        return self

    def unlink_attrs(self, *names):
        for name in names:
            unlink(self, name)

    def demand(self, *names):
        """Declare attributes that must be provided before initialize()."""
        self.demanded.update(names)

    def _check_demands(self):
        missing = sorted(n for n in self.demanded if not hasattr(self, n))
        if missing:
            raise AttributeError(
                "unit %s requires attribute(s) %s to be set or linked "
                "before initialize()" % (self.name, ", ".join(missing)))

    # -- lifecycle ---------------------------------------------------------

    def initialize(self, **kwargs):
        """Override in subclasses. Return True to request re-init later
        (partial initialization, ``veles/workflow.py:331-336``)."""
        return None

    def _initialize_wrapped(self, **kwargs):
        self._check_demands()
        from veles_tpu_torch.prng import get as get_rng
        rng = get_rng()
        state = rng.save_state()
        try:
            result = self.initialize(**kwargs)
        finally:
            # units must not perturb global RNG stream order during init
            # (reproducibility contract of ``veles/units.py:859-885``)
            if not getattr(self, "consumes_global_rng_on_init", False):
                rng.restore_state(state)
        self._is_initialized = result is not True
        return result

    def run(self):
        """Override in subclasses: the unit's compute body."""

    def _run_wrapped(self):
        if not self._is_initialized:
            raise RuntimeError("unit %s run before initialize" % self.name)
        if self.stopped and not getattr(self._workflow, "is_running", False) \
                and root.common.exceptions.get("run_after_stop", True):
            # running outside the workflow's drain is a bug; running
            # *during* the final drain is the normal end of a loop
            # iteration (see Workflow._drain)
            raise RuntimeError("unit %s run after workflow stop" % self.name)
        self.event("run", "begin")
        start = time.perf_counter()
        try:
            return self.run()
        finally:
            elapsed = time.perf_counter() - start
            self.run_calls += 1
            self.run_time += elapsed
            if tracing.enabled():
                tracing.add_complete("unit:%s" % self.name, start, elapsed,
                                     unit=type(self).__name__)
            if self.timings or tracing.enabled():
                _unit_run_hist().labels(unit=self.name).observe(
                    elapsed * 1e3)
            if self.timings:
                self.debug("%s ran in %.3f ms", self.name, elapsed * 1e3)
            self.event("run", "end")

    # -- gate machinery ----------------------------------------------------

    def open_gate(self, src):
        """Record that ``src`` fired; True when all inputs have fired.

        Resets the fired-flags on success so the unit can run again in the
        next loop iteration (``veles/units.py:524-543``).
        """
        if src is not None:
            if src not in self.links_from:
                return False
            self.links_from[src] = True
        if all(self.links_from.values()) or src is None:
            for key in self.links_from:
                self.links_from[key] = False
            return True
        return False

    def reset_fired(self):
        for key in self.links_from:
            self.links_from[key] = False

    # -- manual (workflow-less) firing ------------------------------------

    def run_dependent(self):
        """Fire dependents through the owning workflow's scheduler."""
        self._workflow.signal_fired(self)

    def describe(self):
        return "%s \"%s\" [%s]" % (type(self).__name__, self.name,
                                   self.view_group)

    def __repr__(self):
        return "<%s \"%s\">" % (type(self).__name__, self.name)

    def __getstate__(self):
        state = super(Unit, self).__getstate__()
        if self.stripped_pickle:
            state["links_from"] = {}
            state["links_to"] = []
            state["_workflow"] = None
            # attribute links point at other units: without this a
            # "stripped" unit still drags the whole graph along
            state["__linked__"] = {}
        return state


class TrivialUnit(Unit):
    """A do-nothing unit (useful as a join point)."""

    hide_from_registry = True

    def initialize(self, **kwargs):
        pass

    def run(self):
        pass


class Container(Unit):
    """Marker base for units that contain other units (Workflow)."""

    hide_from_registry = True
