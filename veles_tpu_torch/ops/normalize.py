"""Mean/dispersion normalization (``veles_tpu/ops/normalize.py``):
``out = (x - mean) * rdisp``, broadcast over the sample axis."""

import torch


def mean_disp_normalize(x, mean, rdisp):
    """``(x - mean) * rdisp`` in float32, mean and rdisp broadcast over
    axis 0."""
    return (x.float() - mean.float()) * rdisp.float()


def compute_mean_disp(data):
    """Per-feature mean and reciprocal spread ``1 / (max - min)`` over
    axis 0; a feature whose spread is 0 gets rdisp 1."""
    data32 = data.float()
    mean = torch.mean(data32, 0)
    spread = torch.amax(data32, 0) - torch.amin(data32, 0)
    rdisp = torch.where(spread > 0, 1.0 / torch.clamp(spread, min=1e-12),
                        torch.ones_like(spread))
    return mean, rdisp
