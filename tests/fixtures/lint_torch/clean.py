"""Known-clean fixture: every checker of the port must report ZERO
findings here. Never imported."""

import threading

import torch

from veles_tpu_torch.envknob import env_knob
from veles_tpu_torch.ops import build


class DisciplinedCounter(object):
    """Every post-init write to guarded state holds the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.items = []

    def bump(self):
        with self._lock:
            self.count += 1
            self.items.append(self.count)

    def reset(self):
        with self._lock:
            self.count = 0
            self.items.clear()

    def _restock_locked(self, items):
        # the *_locked naming convention marks caller-holds-lock
        self.items.extend(items)


class ScaleFunction(torch.autograd.Function):
    """A step on the card: no host read, the kernel through launch."""

    @staticmethod
    def forward(ctx, x, steps):
        ctx.steps = int(steps)          # a host int, not a tensor
        return build.launch(
            build.binding("uniform_fill", "veles_uniform_fill").fill,
            x.device, x.shape[0], x.shape[1], 0, 0, 0.0, 1.0, -1) * x

    @staticmethod
    def backward(ctx, g):
        return g * ctx.steps, None


def documented_knob():
    # VELES_PREFETCH is catalogued in docs/torch/CONFIGURATION.md
    return env_knob("VELES_PREFETCH", 2, parse=int)
