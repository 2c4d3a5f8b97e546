"""Minibatch gather from a device-resident dataset
(``veles_tpu/ops/gather.py``).

The dataset lives on the device and each minibatch is gathered there by
index. Padding contract: an index below 0 marks a padded slot (a short
tail batch); its row is zero-filled and its label set to ``pad_label``.
"""

import torch


def gather_minibatch(data, indices, labels=None, pad_label=-1):
    """Rows of ``data`` (and ``labels``) at ``indices``.

    Returns (minibatch_data, minibatch_labels or None). Negative indices
    give zero rows and ``pad_label`` labels."""
    valid = indices >= 0
    safe = indices.clamp(min=0).long()
    rows = data.index_select(0, safe)
    rows = rows * valid.reshape((-1,) + (1,) * (rows.dim() - 1)).to(
        rows.dtype)
    if labels is None:
        return rows, None
    picked = labels.index_select(0, safe)
    picked = torch.where(
        valid.reshape((-1,) + (1,) * (picked.dim() - 1)), picked,
        torch.full_like(picked, pad_label))
    return rows, picked
