"""Ensemble training (``veles_tpu/ensemble/train.py``).

Each member trains with a distinct seed on a ``train_ratio`` subsample
(both delivered as config overrides), snapshots itself, and reports its
metrics; the trainer collects all member results — including each
member's snapshot path, which the tester consumes — into one JSON.
"""

from veles_tpu_torch.ensemble.base import EnsembleManagerBase


class EnsembleTrainManager(EnsembleManagerBase):
    """Train-mode manager: one job = train member #i."""

    def __init__(self, train_ratio=0.8, **kwargs):
        super(EnsembleTrainManager, self).__init__(**kwargs)
        if not 0.0 < float(train_ratio) <= 1.0:
            raise ValueError("train_ratio must be in (0, 1] (got %s)"
                             % train_ratio)
        self.train_ratio = float(train_ratio)

    def model_overrides(self, index):
        overrides = super(EnsembleTrainManager, self).model_overrides(index)
        overrides["root.common.ensemble.train_ratio"] = self.train_ratio
        overrides["root.common.disable.plotting"] = True
        overrides["root.common.disable.publishing"] = True
        return overrides

    def model_argv(self, index, result_path):
        # per-member seed: reproducible but distinct member streams
        argv = self._base_argv(result_path, self.seed_base + index * 1000)
        argv.extend("%s=%r" % (k, v)
                    for k, v in self.model_overrides(index).items())
        return argv

    def gathered(self):
        out = super(EnsembleTrainManager, self).gathered()
        out["train_ratio"] = self.train_ratio
        fitnesses = [r.get("fitness", r.get("EvaluationFitness"))
                     for r in self.results if isinstance(r, dict)]
        out["fitnesses"] = [f for f in fitnesses if f is not None]
        return out


class EnsembleTrainer(EnsembleTrainManager):
    """CLI facade: ``--ensemble-train N:RATIO`` (``__main__.py``)."""

    def __init__(self, workflow_file, config_file=None, size=1,
                 train_ratio=0.8, result_file="ensemble.json", **kwargs):
        super(EnsembleTrainer, self).__init__(
            workflow_file=workflow_file, config_file=config_file,
            size=size, train_ratio=train_ratio, result_file=result_file,
            **kwargs)
