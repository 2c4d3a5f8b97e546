"""Plumbing units: loop anchors and workflow endpoints
(``veles_tpu/plumbing.py``).

``Repeater`` is the loop anchor: its incoming fired-flags reset on every
pass, so linking the loop tail back into the Repeater re-triggers the
chain until a Decision-style unit blocks the path and opens the end
point.
"""

from veles_tpu_torch.units import TrivialUnit, Unit
from veles_tpu_torch.mutable import Bool


class Repeater(TrivialUnit):
    """Loop anchor: fires dependents every time any input fires.

    Unlike ordinary units (barrier over all inputs), a repeater opens on
    *any* single input — that is what lets ``start_point → repeater`` and
    ``loop_tail → repeater`` coexist without dead-locking the barrier.
    """

    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("view_group", "PLUMBING")
        super(Repeater, self).__init__(workflow, **kwargs)

    def open_gate(self, src):
        if src is not None and src in self.links_from:
            self.reset_fired()
            return True
        return src is None


class StartPoint(TrivialUnit):
    """The workflow's entry unit; owned by Workflow, never user-linked-from."""

    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "Start")
        kwargs.setdefault("view_group", "PLUMBING")
        super(StartPoint, self).__init__(workflow, **kwargs)


class EndPoint(TrivialUnit):
    """The workflow's exit unit: running it finishes the workflow."""

    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        kwargs.setdefault("name", "End")
        kwargs.setdefault("view_group", "PLUMBING")
        super(EndPoint, self).__init__(workflow, **kwargs)

    def open_gate(self, src):
        # the end point opens on any single input: any path reaching it
        # finishes the run (multiple producers may never all fire)
        if src is not None and src in self.links_from:
            self.reset_fired()
            return True
        return src is None

    def run(self):
        self.workflow.on_workflow_finished()


class FireStarter(Unit):
    """Resets a set of Bool flags when run (``veles/plumbing.py:92``)."""

    def __init__(self, workflow, **kwargs):
        self.fire = kwargs.pop("fire", [])
        super(FireStarter, self).__init__(workflow, **kwargs)

    def initialize(self, **kwargs):
        pass

    def run(self):
        for flag in self.fire:
            if isinstance(flag, Bool):
                flag <<= False
