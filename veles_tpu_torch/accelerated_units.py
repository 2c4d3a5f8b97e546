"""Device-backed units (``veles_tpu/accelerated_units.py``).

An :class:`AcceleratedUnit` is given its ``torch.device`` at
``initialize(device=...)``: the card unless the caller asks for the CPU
(``device.resolve_device``). An :class:`AcceleratedWorkflow` resolves
the device once and hands it to every unit. The per-unit ``run()``
bodies of the JAX package (its eager execution) are not ported yet: the
port's units describe the model and keep its state, and
``train.runner.FusedRunner`` runs them.
"""

from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.units import Unit
from veles_tpu_torch.workflow import Workflow


class AcceleratedUnit(Unit):
    """Base for units whose work runs on the device."""

    hide_from_registry = True

    def __init__(self, workflow, **kwargs):
        super(AcceleratedUnit, self).__init__(workflow, **kwargs)
        self.device = None

    def initialize(self, device=None, **kwargs):
        self.device = resolve_device(device)
        return None

    def run(self):
        raise NotImplementedError(
            "%s has no eager run(): the port's eager compute units are "
            "not written yet, its workflows run through FusedRunner"
            % type(self).__name__)

    def __getstate__(self):
        state = super(AcceleratedUnit, self).__getstate__()
        state["device"] = None  # re-attached on initialize after restore
        return state


class DeviceBenchmark(object):
    """Computing-power rating of a device: ``ops.benchmark.
    gemm_benchmark``'s, cached per device."""

    _cache = {}

    @classmethod
    def estimate(cls, device, size=1000, repeats=3):
        key = (str(device), size, repeats)
        if key not in cls._cache:
            from veles_tpu_torch.ops.benchmark import gemm_benchmark
            cls._cache[key] = gemm_benchmark(
                size=size, repeats=repeats,
                device=device)["computing_power"]
        return cls._cache[key]


class AcceleratedWorkflow(Workflow):
    """Workflow owning a device; passes it down at initialize."""

    hide_from_registry = True

    def __init__(self, workflow=None, **kwargs):
        super(AcceleratedWorkflow, self).__init__(workflow, **kwargs)
        self.device = None

    def initialize(self, device=None, **kwargs):
        self.device = resolve_device(device)
        kwargs["device"] = self.device
        return super(AcceleratedWorkflow, self).initialize(**kwargs)

    @property
    def computing_power(self):
        return DeviceBenchmark.estimate(self.device)

    def __getstate__(self):
        state = super(AcceleratedWorkflow, self).__getstate__()
        state["device"] = None  # re-attached on initialize after restore
        return state
