"""Known-bad fixture: the step-hygiene codes (TRACE003, TRACE004,
TRACE007). Never imported (torch need not be installed to PARSE
this)."""

import random

import numpy
import torch

from veles_tpu_torch.ops import build


class NoisyFunction(torch.autograd.Function):
    """An autograd Function whose forward and backward do host work."""

    @staticmethod
    def forward(ctx, x):
        noise = numpy.random.uniform(size=3)      # TRACE003
        scale = x.mean().item()                   # TRACE004
        ctx.save_for_backward(x)
        return x * scale + float(noise.sum())

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        norm = torch.linalg.vector_norm(g)
        if float(norm) > 1.0:                     # TRACE004 (a tensor)
            g = g / norm
        return _jitter(g)


def _jitter(g):
    # tainted: called from the backward above
    return g * random.random()                    # TRACE003 via taint


class Trainer(object):
    def __init__(self, device):
        self.device = device
        self.losses = []

    def train_batch(self, x):
        loss = (x * x).sum()
        self.losses.append(loss.tolist())         # TRACE004
        torch.cuda.synchronize()                  # TRACE004
        return loss


def off_stream(x, device):
    fn = build.function("gemm_bias_act", "veles_gemm_bias_act", [])
    fn(x.data_ptr())                              # TRACE007: no stream
    build.binding("lrn_fwd", "veles_lrn_fwd").forward(x)   # TRACE007
    # through launch: the device's current stream, no finding
    return build.launch(build.function("lrn_bwd", "veles_lrn_bwd", []),
                        device, x.data_ptr())
