"""Genetic hyperparameter optimization (``veles_tpu/genetics/``).

``Tune`` leaves of the config tree are gray-coded into chromosomes; a
population evolves by roulette, tournament and random selection, four
crossovers and four mutations. A chromosome's fitness is a full
training run: in process, in a warm evaluator, in a cold process, as a
slave's job or, through ``sched/tenants.py``, as a scheduler job.
"""

from veles_tpu_torch.genetics.core import (  # noqa: F401
    Chromosome, Population, gray_decode, gray_encode)
from veles_tpu_torch.genetics.optimizer import (  # noqa: F401
    EvaluationError, GeneticsOptimizer, Tune, collect_tuneables,
    fix_config)
