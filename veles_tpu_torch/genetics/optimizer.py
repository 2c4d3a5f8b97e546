"""Tune-able config leaves and the GeneticsOptimizer
(``veles_tpu/genetics/optimizer.py``).

:class:`Tune` subclasses ``float``, so a config file holding ``root.lr =
Tune(0.03, 0.001, 0.1)`` runs unchanged when not optimizing;
:func:`fix_config` replaces the leaves with plain floats. The optimizer
patches the config per chromosome (``root.path=value`` overrides), runs
the model and reads the fitness back from its results JSON: in process
through ``evaluator``, in a warm evaluator process
(``parallel/warm_pool.py``), or in a cold ``python -m veles_tpu_torch``
per chromosome; pending chromosomes go to slaves through the
distribution protocol.

Each evaluation through a process is recorded in
:attr:`GeneticsOptimizer.evaluations` (its generation, overrides, wall
seconds, fitness, the results JSON, and from a warm worker its pid, the
card's allocated bytes after the job and its kernel launch counts) and
written with the best chromosome to ``result_file``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

from veles_tpu_torch import prng
from veles_tpu_torch.config import Config, root
from veles_tpu_torch.distributable import Distributable, IDistributable
from veles_tpu_torch.genetics.core import Population


class Tune(float):
    """A float config leaf marked as optimizable: Tune(default, min, max)."""

    def __new__(cls, default, min_value, max_value):
        self = super(Tune, cls).__new__(cls, default)
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        return self

    def __repr__(self):
        return "Tune(%s, %s, %s)" % (float(self), self.min_value,
                                     self.max_value)

    # Tune survives config pickling inside snapshots
    def __getnewargs__(self):
        return (float(self), self.min_value, self.max_value)


def collect_tuneables(node=None, path="root"):
    """Walk the config tree, return [(dotted_path, Tune), ...] sorted."""
    node = root if node is None else node
    found = []
    for key, value in node.items():
        child_path = "%s.%s" % (path, key)
        if isinstance(value, Config):
            found.extend(collect_tuneables(value, child_path))
        elif isinstance(value, Tune):
            found.append((child_path, value))
    found.sort(key=lambda kv: kv[0])
    return found


def fix_config(node=None):
    """Replace Tune leaves with their plain-float defaults (parity with
    the reference's ``fix_config``, ``veles/genetics/config.py``)."""
    node = root if node is None else node
    for key, value in node.items():
        if isinstance(value, Config):
            fix_config(value)
        elif isinstance(value, Tune):
            setattr(node, key, float(value))


class EvaluationError(Exception):
    """A fitness run failed (``optimization_workflow.py:64``)."""


class GeneticsOptimizer(Distributable, IDistributable):
    """Evolve Tune leaves to maximize a fitness metric.

    Two evaluation paths:

    * ``evaluator=callable({path: value}) -> float`` — in-process, used
      by tests and by meta-workflows that can score without training;
    * default: run ``workflow config path=value ... --result-file
      tmp.json -s <seed>`` in a warm evaluator process (``warm``) or as
      a cold ``python -m veles_tpu_torch`` subprocess and read the
      fitness back.

    Fitness is looked up in the results JSON under ``fitness_key``
    ("fitness" by default, then "EvaluationFitness"); if neither exists,
    the negated first numeric metric is used so "smaller error is better"
    workflows optimize correctly without modification.
    """

    def __init__(self, workflow_file=None, config_file=None,
                 generations=10, population_size=20, evaluator=None,
                 fitness_key="fitness", result_file=None, seed=None,
                 extra_argv=(), rand=None, warm=True, **kwargs):
        super(GeneticsOptimizer, self).__init__(**kwargs)
        #: keep one evaluator process alive across chromosomes (no
        #: import, CUDA context or kernel load from the second fitness
        #: run on); False runs a cold process per chromosome
        self.warm = warm
        #: one entry per evaluation through a process
        self.evaluations = []
        self._pool_ = None
        self.workflow_file = workflow_file
        self.config_file = config_file
        self.generations = int(generations)
        self.population_size = int(population_size)
        self.evaluator = evaluator
        self.fitness_key = fitness_key
        self.result_file = result_file
        self.seed = seed if seed is not None else 1234
        self.extra_argv = list(extra_argv)
        self.rand = rand or prng.get()
        self.tuneables = collect_tuneables()
        if not self.tuneables:
            raise ValueError(
                "no Tune() leaves found in the config tree — nothing to "
                "optimize (declare e.g. root.lr = Tune(0.03, 0.001, 0.1))")
        self.population = Population(
            [t.min_value for _, t in self.tuneables],
            [t.max_value for _, t in self.tuneables],
            size=self.population_size, rand=self.rand)
        self.on_generation = None  # callback(population) for plots/logs

    # -- chromosome <-> config ---------------------------------------------

    def overrides_for(self, chromo):
        """{dotted.path: value} mapping for one chromosome."""
        return {path: float(v) for (path, _), v in
                zip(self.tuneables, chromo.numeric)}

    def _get_pool(self):
        if self._pool_ is None:
            from veles_tpu_torch.parallel.warm_pool import WarmPool
            self._pool_ = WarmPool(workers=1)
            # slave-mode evaluations never pass through run()'s
            # finally — reap the evaluator at interpreter exit too.
            # Registered ONCE per instance: a close_pool/_get_pool
            # cycle (every run(); each scheduler-driven generation)
            # must not stack a fresh atexit entry pinning this
            # optimizer alive per recreation
            if not self._atexit_registered_:
                import atexit
                atexit.register(self.close_pool)
                self._atexit_registered_ = True
        return self._pool_

    def close_pool(self):
        if getattr(self, "_pool_", None) is not None:
            self._pool_.close()
            self._pool_ = None

    def _evaluate_subprocess(self, values):
        argv = [self.workflow_file]
        if self.config_file:
            argv.append(self.config_file)
        argv.extend("%s=%r" % (path, value)
                    for path, value in values.items())
        fd, result_path = tempfile.mkstemp(suffix=".json",
                                           prefix="veles_tpu_fitness_")
        os.close(fd)
        argv.extend(["--result-file", result_path,
                     "-s", str(self.seed), "-v", "warning"])
        argv.extend(self.extra_argv)
        record = {"generation": self.population.generation,
                  "overrides": dict(values)}
        t0 = time.perf_counter()
        if self.warm:
            # warm evaluator (the worker deletes the result file; the
            # finally covers a worker that died before getting there)
            try:
                reply = self._get_pool().run(argv,
                                             result_file=result_path)
            except (RuntimeError, OSError, ValueError) as e:
                # hard evaluator death: keep genetics' raise-on-failure
                # semantics, but route it through the module's own
                # failure type (the pool already replaced the worker)
                raise EvaluationError("fitness evaluator died: %s" % e)
            finally:
                try:
                    os.unlink(result_path)
                except OSError:
                    pass
            if not reply.get("ok"):
                raise EvaluationError(
                    "fitness run failed: %s" %
                    reply.get("error", reply.get("code")))
            record.update(
                pid=reply.get("pid"),
                cuda_allocated=reply.get("cuda_allocated"),
                kernel_counts=reply.get("kernel_counts"))
            return self._recorded(record, t0, reply["result"])
        try:
            full = [sys.executable, "-m", "veles_tpu_torch"] + argv
            proc = subprocess.Popen(full, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            record["pid"] = proc.pid
            output, _ = proc.communicate()
            if proc.returncode != 0:
                raise EvaluationError(
                    "fitness run failed (%d): %s" %
                    (proc.returncode, output[-2000:].decode(
                        errors="replace")))
            with open(result_path) as f:
                results = json.load(f)
        finally:
            try:
                os.unlink(result_path)
            except OSError:
                pass
        return self._recorded(record, t0, results)

    def _recorded(self, record, t0, results):
        """The fitness of ``results``; the evaluation's record, with its
        wall seconds since ``t0``, joins :attr:`evaluations`."""
        fitness = self._fitness_from_results(results)
        record.update(wall_s=time.perf_counter() - t0, fitness=fitness,
                      result=results)
        self.evaluations.append(record)
        return fitness

    def _fitness_from_results(self, results):
        for key in (self.fitness_key, "EvaluationFitness"):
            if key in results:
                return float(results[key])
        for value in results.values():
            if isinstance(value, (int, float)):
                return -float(value)
        raise EvaluationError("no numeric metric in results %r" % results)

    def evaluate(self, chromo):
        values = self.overrides_for(chromo)
        if self.evaluator is not None:
            chromo.fitness = float(self.evaluator(values))
        else:
            chromo.fitness = self._evaluate_subprocess(values)
        self.debug("fitness %.6g for %s", chromo.fitness, values)
        return chromo.fitness

    # -- the run -----------------------------------------------------------

    @property
    def best(self):
        return self.population.best

    def run(self):
        try:
            for _ in range(self.generations):
                for chromo in self.population.pending:
                    self.evaluate(chromo)
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

    def _write_results(self):
        if not self.result_file:
            return
        best = self.population.best
        with open(self.result_file, "w") as f:
            json.dump({"fitness": best.fitness,
                       "config": self.overrides_for(best),
                       "generations": self.population.generation + 1,
                       "population_size": self.population_size,
                       "evaluations": self.evaluations}, f,
                      indent=2, default=str)
        self.info("wrote best config to %s", self.result_file)

    # -- task farming over the coordinator (strategy 2, SURVEY.md §2.4) ----
    #
    # Each job is one pending chromosome's override dict; the update is
    # its fitness. ``drop_slave`` requeues chromosomes a dead slave held
    # (the reference's elastic-recovery semantics,
    # ``optimization_workflow.py:181-221``).

    def init_unpickled(self):
        super(GeneticsOptimizer, self).init_unpickled()
        self._dispatched_ = {}
        self._pool_ = None
        self._atexit_registered_ = False

    @property
    def has_data_for_slave(self):
        return bool(self.population.pending or
                    all(c.fitness is not None for c in self.population) and
                    self.population.generation < self.generations)

    def generate_data_for_slave(self, slave):
        pending = [c for c in self.population.pending
                   if id(c) not in {id(x) for lst in
                                    self._dispatched_.values()
                                    for x in lst}]
        if not pending and not self.population.pending:
            if self.population.generation >= self.generations - 1:
                return None
            self.population.update()
            pending = self.population.pending
        if not pending:
            return None
        chromo = pending[0]
        self._dispatched_.setdefault(slave, []).append(chromo)
        return {"index": self.population.chromosomes.index(chromo),
                "values": self.overrides_for(chromo)}

    def apply_data_from_master(self, data):
        self._job_ = data

    def generate_data_for_master(self):
        values = self._job_["values"]
        if self.evaluator is not None:
            fitness = float(self.evaluator(values))
        else:
            fitness = self._evaluate_subprocess(values)
        return {"index": self._job_["index"], "fitness": fitness}

    def apply_data_from_slave(self, data, slave):
        chromo = self.population.chromosomes[data["index"]]
        chromo.fitness = data["fitness"]
        held = self._dispatched_.get(slave, [])
        self._dispatched_[slave] = [c for c in held if c is not chromo]

    def drop_slave(self, slave):
        self._dispatched_.pop(slave, None)
