"""Ensemble evaluation (``veles_tpu/ensemble/test.py``).

Reads the training results JSON, re-runs every member from its snapshot
in testing mode, and aggregates the member metrics (mean/std for numeric
metrics, the full per-member table for everything else).
"""

import json

import numpy

from veles_tpu_torch.ensemble.base import EnsembleManagerBase


def aggregate_metrics(member_results):
    """mean/std/min/max for every numeric metric across members."""
    table = {}
    for result in member_results:
        if not isinstance(result, dict):
            continue
        for key, value in result.items():
            if isinstance(value, (int, float)) and not isinstance(value,
                                                                  bool):
                table.setdefault(key, []).append(float(value))
    out = {}
    for key, values in table.items():
        arr = numpy.asarray(values)
        out[key] = {"mean": float(arr.mean()), "std": float(arr.std()),
                    "min": float(arr.min()), "max": float(arr.max()),
                    "n": len(values)}
    return out


class EnsembleTester(EnsembleManagerBase):
    """Test-mode manager: one job = evaluate member #i from its snapshot."""

    def __init__(self, workflow_file=None, config_file=None,
                 results_file=None, result_file="ensemble_test.json",
                 **kwargs):
        self.train_results = self._read(results_file)
        members = self.train_results.get("models") or []
        if not members:
            raise ValueError("no trained members in %s" % results_file)
        super(EnsembleTester, self).__init__(
            workflow_file=workflow_file, config_file=config_file,
            size=len(members), result_file=result_file, **kwargs)
        self.results_file = results_file

    @staticmethod
    def _read(results_file):
        if isinstance(results_file, dict):  # already-parsed (tests)
            return results_file
        with open(results_file) as f:
            return json.load(f)

    def snapshot_of(self, index):
        member = self.train_results["models"][index]
        if not isinstance(member, dict):
            return None
        for key in ("Snapshot", "snapshot", "snapshot_file"):
            if member.get(key):
                return member[key]
        return None

    def model_argv(self, index, result_path):
        snapshot = self.snapshot_of(index)
        if snapshot is None:
            raise ValueError(
                "member #%d has no snapshot in %s — cannot test" %
                (index, self.results_file))
        argv = self._base_argv(result_path, self.seed_base + index * 1000)
        argv.extend(["-w", str(snapshot), "--test"])
        argv.extend("%s=%r" % (k, v)
                    for k, v in self.model_overrides(index).items())
        return argv

    def gathered(self):
        return {"models": self.results, "size": self.size,
                "evaluations": self.evaluations,
                "aggregate": aggregate_metrics(
                    [r for r in self.results if r is not None])}
