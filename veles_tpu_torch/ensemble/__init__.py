"""Model ensembles (``veles_tpu/ensemble/``): N models trained on
seed-varied, ``train_ratio``-subsampled data, every model's metrics
gathered into one results JSON, then the ensemble evaluated member by
member from its snapshots. Each member is a whole training run, in a
warm evaluator, a cold process or a slave's job.
"""

from veles_tpu_torch.ensemble.base import EnsembleManagerBase  # noqa: F401
from veles_tpu_torch.ensemble.train import (  # noqa: F401
    EnsembleTrainer, EnsembleTrainManager)
from veles_tpu_torch.ensemble.test import (  # noqa: F401
    EnsembleTester, aggregate_metrics)
