"""The scheduler's first native tenants: genetics and ensembles
(``veles_tpu/sched/tenants.py``).

The paper's headline workloads are populations of short training runs
— a genetics generation is ``population_size`` independent fitness
evaluations, an ensemble is ``size`` independent member trainings —
exactly the traffic a gang scheduler exists for. These subclasses keep
the serial optimizer's and trainer's EXACT result-file contract (same
module argv, same seeds, same fitness/gather parsing) and only change
WHO runs the subprocess: instead of one cold/warm evaluation at a time, the whole
wave is submitted as concurrent scheduler jobs and collected when the
scheduler reports them terminal.

Bit-exactness (pinned by ``tests/test_torch_sched.py``): the scheduled
genetics path reports the same best fitness as the serial path under
fixed seeds, because (a) :meth:`JobSpec.build_argv` mirrors
``GeneticsOptimizer._evaluate_subprocess`` argv construction
bit-for-bit, (b) every evaluation gets the same ``-s <seed>`` the
serial path passes, and (c) ``Population.update()``'s PRNG consumption
is untouched — fitness assignment order within a generation does not
feed the stream.
"""

import json
import os
import sys
import tempfile

from veles_tpu_torch.ensemble.train import EnsembleTrainManager
from veles_tpu_torch.fairshare import DEFAULT_QOS
from veles_tpu_torch.genetics.optimizer import (EvaluationError,
                                          GeneticsOptimizer)
from veles_tpu_torch.sched.job import DONE, JobSpec


class ScheduledGeneticsOptimizer(GeneticsOptimizer):
    """Genetics with generation-wide concurrent fitness evaluation.

    ``run()`` has the serial optimizer's exact shape — evaluate pending,
    log the generation, ``population.update()`` — but the pending wave
    goes through ``scheduler.submit`` as one job per chromosome, so a
    generation's wall clock is bounded by the pool, not by
    ``population_size`` serial runs.
    """

    def __init__(self, scheduler=None, tenant="genetics",
                 qos=DEFAULT_QOS, job_timeout_s=None, **kwargs):
        super(ScheduledGeneticsOptimizer, self).__init__(**kwargs)
        if scheduler is None:
            raise ValueError("ScheduledGeneticsOptimizer needs a "
                             "started Scheduler")
        self.scheduler = scheduler
        self.tenant = tenant
        self.qos = qos
        self.job_timeout_s = job_timeout_s

    def run(self):
        try:
            for _ in range(self.generations):
                self._evaluate_generation()
                best = self.population.best
                self.info(
                    "generation %d: best=%.6g avg=%.6g %s",
                    self.population.generation, best.fitness,
                    self.population.average_fitness,
                    self.overrides_for(best))
                if self.on_generation is not None:
                    self.on_generation(self.population)
                if self.population.generation < self.generations - 1:
                    self.population.update()
        finally:
            self.close_pool()
        self._write_results()
        return self.population.best

    def _evaluate_generation(self):
        pending = list(self.population.pending)
        if not pending:
            return
        if self.evaluator is not None:
            # in-process evaluators have nothing to schedule
            for chromo in pending:
                self.evaluate(chromo)
            return
        entries = []
        for chromo in pending:
            values = self.overrides_for(chromo)
            fd, result_path = tempfile.mkstemp(
                suffix=".json", prefix="veles_tpu_fitness_")
            os.close(fd)
            job = self.scheduler.submit(JobSpec(
                name="genetics-g%d" % self.population.generation,
                workflow=self.workflow_file, config=self.config_file,
                overrides=values, extra_argv=self.extra_argv,
                result_file=result_path, seed=self.seed,
                tenant=self.tenant, qos=self.qos))
            entries.append((chromo, job, result_path))
        self.scheduler.wait([job.id for _, job, _ in entries],
                            timeout_s=self.job_timeout_s)
        for chromo, job, result_path in entries:
            try:
                if job.state != DONE:
                    raise EvaluationError(
                        "scheduled fitness job %s ended %s: %s"
                        % (job.id, job.state, job.error))
                with open(result_path) as f:
                    results = json.load(f)
            finally:
                try:
                    os.unlink(result_path)
                except OSError:
                    pass
            chromo.fitness = self._fitness_from_results(results)
            self.debug("fitness %.6g for %s (%s)", chromo.fitness,
                       self.overrides_for(chromo), job.id)


class ScheduledEnsembleTrainManager(EnsembleTrainManager):
    """Ensemble training with members as concurrent scheduler jobs.

    Same per-member argv (``model_argv``: per-member seed + ensemble
    overrides) and the same gathered-results contract as the serial
    manager — a failed member lands as ``None`` in its slot, the rest
    of the ensemble survives.
    """

    def __init__(self, scheduler=None, tenant="ensemble",
                 qos=DEFAULT_QOS, job_timeout_s=None, **kwargs):
        super(ScheduledEnsembleTrainManager, self).__init__(**kwargs)
        if scheduler is None:
            raise ValueError("ScheduledEnsembleTrainManager needs a "
                             "started Scheduler")
        self.scheduler = scheduler
        self.tenant = tenant
        self.qos = qos
        self.job_timeout_s = job_timeout_s

    def run(self):
        if self.runner is not None:
            return super(ScheduledEnsembleTrainManager, self).run()
        entries = []
        for index in range(self.size):
            if self.results[index] is not None:
                continue
            fd, result_path = tempfile.mkstemp(
                suffix=".json", prefix="veles_tpu_ensemble_")
            os.close(fd)
            argv = [sys.executable, "-m", "veles_tpu_torch"] + \
                self.model_argv(index, result_path)
            job = self.scheduler.submit(JobSpec(
                name="ensemble-member-%d" % index, argv=argv,
                tenant=self.tenant, qos=self.qos))
            entries.append((index, job, result_path))
        self.info("submitted %d ensemble members to the scheduler",
                  len(entries))
        self.scheduler.wait([job.id for _, job, _ in entries],
                            timeout_s=self.job_timeout_s)
        for index, job, result_path in entries:
            try:
                if job.state != DONE:
                    self.warning("model #%d job %s ended %s: %s",
                                 index, job.id, job.state, job.error)
                    continue
                with open(result_path) as f:
                    self.results[index] = json.load(f)
            finally:
                try:
                    os.unlink(result_path)
                except OSError:
                    pass
        self.write_results()
        return self.results
