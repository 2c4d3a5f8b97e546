"""The standalone launcher (``veles_tpu/launcher.py``).

A :class:`Launcher` owns the device and runs its workflow: ``initialize``
resolves the device (``-a/--backend`` and ``-d/--device``: ``auto``,
the default, is the CUDA card and raises without one; ``cpu`` is the
only way onto the CPU), applies ``--test`` (``set_testing``) and
initializes the workflow on the device; ``run`` runs the workflow's own
runner (``make_fused_runner``) or else :class:`~veles_tpu_torch.train.
runner.FusedRunner`.

Not in the port yet, and refused with ``NotImplementedError``: the
master/slave modes (``-l``/``-m``), ``--gspmd`` and ``--auto-resume``
(the parallel and fault-tolerance tiers), and the eager per-unit
scheduler (``--eager``, and the JAX launcher's fallback for a graph
``fused_compatible`` refuses), which needs the eager compute units.
"""

import time

import torch

from veles_tpu_torch.cmdline import CommandLineArgumentsRegistry
from veles_tpu_torch.logger import Logger

#: the JAX launcher's flags the port refuses, and what they wait for
NOT_PORTED = {
    "listen_address": "the master mode (-l) waits for the port's "
                      "distributed tier",
    "master_address": "the slave mode (-m) waits for the port's "
                      "distributed tier",
    "gspmd": "--gspmd waits for the port's parallel tier",
    "auto_resume": "--auto-resume waits for the port's fault-tolerance "
                   "tier",
    "eager": "--eager needs the eager compute units (GD, evaluator and "
             "loader run()), which the port does not have yet",
}


def resolve_backend(backend="auto", device=None):
    """The ``torch.device`` of ``-a/--backend`` and ``-d/--device``."""
    index = int(device) if device not in (None, "") else None
    if backend == "cpu":
        return torch.device("cpu")
    if backend not in ("auto", "cuda"):
        raise ValueError("backend must be auto, cuda or cpu, got %r"
                         % (backend,))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass -a cpu to "
            "run its plain PyTorch versions")
    return torch.device("cuda", index if index is not None else 0)


class Launcher(Logger, metaclass=CommandLineArgumentsRegistry):
    """Owns the device and runs the workflow, standalone."""

    def __init__(self, backend="auto", device=None, testing=False,
                 **kwargs):
        super(Launcher, self).__init__()
        for key, value in kwargs.items():
            if key not in NOT_PORTED:
                raise TypeError("unknown Launcher argument %r" % key)
            if value:
                raise NotImplementedError(NOT_PORTED[key])
        self.backend = backend
        self.device_index = device
        self.device = None
        self.testing = testing
        self.mode = "standalone"
        self.workflow = None
        self.stopped = False
        self.start_time = None
        #: "fused" once ``run`` picked the standard runner, "custom" for
        #: the workflow's own
        self.run_mode_used = None
        self.runner = None

    @staticmethod
    def init_parser(parser):
        parser.add_argument(
            "-l", "--listen", dest="listen_address", default=None,
            help="run as MASTER (not in the port yet)")
        parser.add_argument(
            "-m", "--master", dest="master_address", default=None,
            help="run as SLAVE (not in the port yet)")
        parser.add_argument(
            "--test", dest="testing", action="store_true",
            help="run the workflow in testing (forward-only) mode")
        parser.add_argument(
            "--eager", action="store_true",
            help="the eager per-unit scheduler (not in the port yet)")
        parser.add_argument(
            "--gspmd", nargs="?", const="auto", default=None,
            metavar="MESH", help="the GSPMD path (not in the port yet)")
        parser.add_argument(
            "--auto-resume", dest="auto_resume", default=None,
            metavar="DIR", help="auto-resume (not in the port yet)")
        parser.add_argument(
            "-a", "--backend", default="auto",
            choices=["auto", "cuda", "cpu"],
            help="where to run: auto (the CUDA card, the default), cuda "
                 "or cpu (the plain PyTorch versions)")
        parser.add_argument(
            "-d", "--device", default=None,
            help="CUDA device index")
        return parser

    @property
    def is_standalone(self):
        return True

    @property
    def is_master(self):
        return False

    @property
    def is_slave(self):
        return False

    def add_ref(self, workflow):
        self.workflow = workflow

    def del_ref(self, workflow):
        if self.workflow is workflow:
            self.workflow = None

    def on_workflow_finished(self):
        pass

    def initialize(self, **kwargs):
        """Resolve the device and initialize the workflow on it."""
        if self.workflow is None:
            raise RuntimeError("no workflow attached to this launcher")
        self.start_time = time.time()
        self.device = resolve_backend(self.backend, self.device_index)
        if self.testing:
            set_testing = getattr(self.workflow, "set_testing", None)
            if set_testing is None:
                raise NotImplementedError(
                    "--test: %s has no set_testing"
                    % type(self.workflow).__name__)
            set_testing(True)
        self.workflow.initialize(device=self.device, **kwargs)
        return self

    def run(self):
        """Run the workflow to its end through its own runner or the
        standard ``FusedRunner``."""
        from veles_tpu_torch.train.runner import FusedRunner, \
            fused_compatible
        workflow = self.workflow
        try:
            runner = workflow.make_fused_runner()
            if runner is not None:
                self.run_mode_used = "custom"
            else:
                reason = fused_compatible(workflow)
                if reason is not None:
                    raise NotImplementedError(
                        "the fused path cannot run this workflow (%s), "
                        "and the eager per-unit scheduler needs the eager "
                        "compute units, which the port does not have yet"
                        % reason)
                self.run_mode_used = "fused"
                runner = FusedRunner(workflow)
            self.runner = runner
            runner.run()
        finally:
            self.stop()
        return workflow

    def stop(self):
        self.stopped = True

    def __repr__(self):
        return "<Launcher standalone on %s>" % (self.device,)
