"""MeanDispNormalizer unit (``veles_tpu/mean_disp_normalizer.py``).

``output = (input - mean) * rdisp`` with per-feature mean and
reciprocal dispersion, in float32 on the unit's device
(:func:`veles_tpu_torch.ops.normalize.mean_disp_normalize`).
"""

import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.ops.normalize import mean_disp_normalize


class MeanDispNormalizer(AcceleratedUnit):
    """Demands ``input``, ``mean`` and ``rdisp`` (tensors or numpy
    arrays); produces the normalized float32 ``output``."""

    def __init__(self, workflow, **kwargs):
        super(MeanDispNormalizer, self).__init__(workflow, **kwargs)
        self.input = None
        self.mean = None
        self.rdisp = None
        self.output = None
        self.demand("input", "mean", "rdisp")

    def initialize(self, device=None, **kwargs):
        super(MeanDispNormalizer, self).initialize(device=device, **kwargs)
        self.output = torch.zeros(tuple(self.input.shape),
                                  dtype=torch.float32, device=self.device)

    def _on_device(self, attr):
        return torch.as_tensor(getattr(self, attr)).to(self.device)

    def compute(self):
        self.output = mean_disp_normalize(
            self._on_device("input"), self._on_device("mean"),
            self._on_device("rdisp"))
