"""Standalone doubles (``veles_tpu/dummy.py``): ``DummyLauncher`` quacks
like a Launcher in standalone mode with no services, and
``DummyWorkflow`` is a Workflow parented to one."""

from veles_tpu_torch.logger import Logger
from veles_tpu_torch.workflow import Workflow


class DummyLauncher(Logger):
    """Stand-in for Launcher: standalone mode, no services."""

    mode = "standalone"

    def __init__(self, **kwargs):
        super(DummyLauncher, self).__init__(**kwargs)
        self.device = kwargs.get("device")
        self.testing = kwargs.get("testing", False)
        self.stopped = False
        self.id = "dummy"
        self.log_id = "dummy"

    @property
    def is_standalone(self):
        return True

    @property
    def is_master(self):
        return False

    @property
    def is_slave(self):
        return False

    @property
    def is_interactive(self):
        return False

    def add_ref(self, workflow):
        self.workflow = workflow

    def del_ref(self, workflow):
        pass

    def on_workflow_finished(self):
        self.stopped = True

    def stop(self):
        self.stopped = True


class DummyWorkflow(Workflow):
    """A workflow owned by a fresh DummyLauncher."""

    hide_from_registry = True

    def __init__(self, **kwargs):
        super(DummyWorkflow, self).__init__(DummyLauncher(), **kwargs)
