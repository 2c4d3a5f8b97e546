"""The numbers that decide a training cell's ``correct``, and their
limits.

The window's trainer is the one whose set-up epochs were recorded
(``drivers.train.Recorder``); the plain reference repeats those epochs
from the same inputs. These numbers compare the two; a cell holds
those that its ``workloads/<cell>.json`` gives a limit to:

* ``loss_gap``: the largest relative gap of a training step's loss,
  ``|L - L_ref| / |L_ref|``, over the recorded steps;
* ``eval_gap``: the same of each evaluation batch's loss, over the
  evaluation sweeps of set-up's epochs;
* ``grad_gap``: the first gradient as the solver took it (``g + wd *
  p``, worked out from the velocity after one step), by the worst leaf:
  ``|norm - norm_ref|`` over the larger of the reference's norm of that
  leaf and the median leaf's;
* ``out_grad_gap``: the first gradient's gap of the output layer's
  weights (the layer the loss reads), by the same measure: the one leaf
  whose gradient passes through no pooling and no dropout, so it is
  steady from seed to seed where the worst leaf swings with max-pool
  near-ties that two convolution algorithms round apart;
* ``change_gap``: the same of each parameter's change over the recorded
  steps, over the leaves whose reference gradient (without the decay)
  is at least a thousandth of the median leaf's: a leaf that the loss
  does not move moves by round-off alone;
* ``rows_gap``: the largest absolute difference between the rows and
  labels the timed path gathered for those steps and the dataset's rows
  the reference takes, in the order of its shuffles; exact, limit 0.
"""

import math
import statistics

import torch

NAMES = ("loss_gap", "eval_gap", "grad_gap", "out_grad_gap", "change_gap",
         "rows_gap")

#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of the change
SILENT_LEAF = 1e-3


def _norm(t):
    return float(torch.linalg.vector_norm(t.detach().double().cpu()))


def leaf_gaps(norms, ref_norms):
    """Each leaf's ``|norm - ref| / max(ref, median ref)``."""
    middle = statistics.median(ref_norms.values())
    return {k: abs(norms[k] - ref_norms[k]) / max(ref_norms[k], middle)
            for k in ref_norms}


def _relative(values, ref_values):
    if len(values) != len(ref_values):
        return math.inf
    return max((abs(a - b) / abs(b) for a, b in zip(values, ref_values)),
                default=0.0)


def numbers(side, ref, leaves=None):
    """The numbers of :data:`NAMES` of ``side`` (a dict of ``losses``,
    ``eval_losses``, the first ``grad``, the ``params`` after the steps
    and, where given, the gathered ``rows``) against ``ref``
    (``reference.train_epochs``'s output with the initial ``weights``
    and the training ``batches``); ``rows_gap`` only where ``side`` has
    rows. ``leaves`` (a dict), where given, gets each leaf's gap of
    ``grad`` and of ``change``."""
    out = {"loss_gap": _relative(side["losses"], ref["losses"])}
    evals = [v for e in side["eval_losses"] for v in e]
    ref_evals = [v for e in ref["eval_losses"] for v in e]
    out["eval_gap"] = _relative(evals, ref_evals)
    grad = side["grad"]
    gaps = {"grad": leaf_gaps(
        {k: _norm(grad[k]) if k in grad else 0.0 for k in ref["grad"]},
        {k: _norm(v) for k, v in ref["grad"].items()})}
    raw = {k: _norm(v) for k, v in ref["raw_grad"].items()}
    floor = SILENT_LEAF * statistics.median(raw.values())
    moved = [k for k in raw if raw[k] >= floor]
    start = {k: v.cpu() for k, v in ref["weights"].items()}
    params = side["params"]
    gaps["change"] = leaf_gaps(
        {k: _norm(params[k].cpu() - start[k]) if k in params else 0.0
         for k in moved},
        {k: _norm(ref["params"][k].cpu() - start[k]) for k in moved})
    out["grad_gap"] = max(gaps["grad"].values())
    output = max(i for i, k in gaps["grad"] if k == "weights")
    out["out_grad_gap"] = gaps["grad"][(output, "weights")]
    out["change_gap"] = max(gaps["change"].values())
    if leaves is not None:
        leaves.update(gaps)
    rows = side.get("rows")
    if rows is not None:
        gap = 0.0
        for (x, y), (x_ref, y_ref) in zip(rows, ref["batches"]):
            gap = max(gap, float((x.float() - x_ref.cpu().float()).abs()
                                 .max()),
                      float((y.long() - y_ref.cpu().long()).abs().max()))
        if len(rows) != len(ref["batches"]):
            gap = math.inf
        out["rows_gap"] = gap
    return out


def verdict(values, limits):
    """(correct, {name: {"value", "limit"}}) of the numbers against
    their limits, in the limits' order; a number missing or not finite
    fails."""
    shown = {}
    ok = True
    for name, limit in limits.items():
        value = values.get(name, math.inf)
        shown[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, shown
