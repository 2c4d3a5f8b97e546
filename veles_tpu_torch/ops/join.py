"""Input joining (``veles_tpu/ops/join.py``): several arrays joined
along the feature axis, each flattened to (batch, -1)."""

import torch


def join_arrays(*arrays):
    """Concatenate along axis 1, flattening each input to (batch, -1)."""
    if not arrays:
        raise ValueError("nothing to join")
    batch = arrays[0].shape[0]
    return torch.cat([a.reshape(batch, -1) for a in arrays], 1)
