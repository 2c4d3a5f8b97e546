"""InputJoiner unit (``veles_tpu/input_joiner.py``).

Concatenates its inputs along the feature axis, each flattened to
(batch, -1), on the unit's device (:func:`veles_tpu_torch.ops.join.
join_arrays`).
"""

import numpy
import torch

from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.ops.join import join_arrays


class InputJoiner(AcceleratedUnit):
    """``output = concat(flatten(input_0), flatten(input_1), ...)``;
    the inputs are tensors or numpy arrays, linked or set."""

    def __init__(self, workflow, **kwargs):
        self.num_inputs = kwargs.pop("num_inputs", 2)
        super(InputJoiner, self).__init__(workflow, **kwargs)
        self.output = None
        for i in range(self.num_inputs):
            setattr(self, "input_%d" % i, None)
        self.demand(*("input_%d" % i for i in range(self.num_inputs)))

    @property
    def inputs(self):
        return [getattr(self, "input_%d" % i)
                for i in range(self.num_inputs)]

    def initialize(self, device=None, **kwargs):
        super(InputJoiner, self).initialize(device=device, **kwargs)
        shapes = [tuple(numpy.shape(i)) for i in self.inputs]
        width = sum(int(numpy.prod(s[1:])) for s in shapes)
        self.output = torch.zeros((shapes[0][0], width),
                                  dtype=torch.float32, device=self.device)

    def compute(self):
        self.output = join_arrays(*(
            torch.as_tensor(i).to(self.device) for i in self.inputs))
