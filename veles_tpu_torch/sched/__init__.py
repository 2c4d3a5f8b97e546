"""Training as a service: a multi-job gang scheduler over the elastic
tier (``veles_tpu/sched/``).

The elastic supervisor re-forms a world at any size, a sharded
checkpoint generation restores at any world size, and the fair-share
ledger of ``fairshare.py`` already meters serving tenants; so one pool
of device slots runs many training jobs:

* :mod:`veles_tpu_torch.sched.job`: :class:`JobSpec` (a workflow with
  its config overrides, or a raw command; tenant, QoS, elastic world
  range, retry budget) and the job FSM (``PENDING -> RUNNING ->
  PREEMPTED/RETRYING -> DONE/FAILED``), every transition counted in the
  ``veles_sched_*`` metric families;
* :mod:`veles_tpu_torch.sched.journal`: the write-ahead job journal
  (fsync'd JSONL events and compacted snapshots under ``--state-dir``),
  replayed at a restart, in the JAX package's format;
* :mod:`veles_tpu_torch.sched.scheduler`: the slot pool, gang placement,
  weighted-fair quotas, preemption as checkpoint and shrink, resume from
  the newest generation, recovery by adoption of live gangs, and the
  HTTP control surface;
* :mod:`veles_tpu_torch.sched.tenants`: the genetic optimizer and the
  ensemble trainer, each submitting a whole wave as concurrent jobs;
* :mod:`veles_tpu_torch.sched.cli`: ``python -m veles_tpu_torch sched
  serve|submit|status``.

On one card the pool's slots are ranks that share it: the scheduler
sets no device visibility per slot, and a gang of world > 1 runs the
elastic tier's backend rule (gloo on one card).
"""

from veles_tpu_torch.sched.job import (DONE, FAILED, PENDING, PREEMPTED,
                                 RETRYING, RUNNING, Job, JobSpec)
from veles_tpu_torch.sched.journal import JobJournal
from veles_tpu_torch.sched.scheduler import (DevicePool, Scheduler,
                                       SchedulerControl)
from veles_tpu_torch.sched.tenants import (ScheduledEnsembleTrainManager,
                                     ScheduledGeneticsOptimizer)

__all__ = ["JobSpec", "Job", "PENDING", "RUNNING", "PREEMPTED",
           "RETRYING", "DONE", "FAILED", "DevicePool", "JobJournal",
           "Scheduler", "SchedulerControl",
           "ScheduledGeneticsOptimizer", "ScheduledEnsembleTrainManager"]
