"""Shared ensemble machinery (``veles_tpu/ensemble/base.py``): a slot
table of per-member results, jobs handed to slaves through the
distribution protocol with pending tracking and requeue on a drop, and
:meth:`EnsembleManagerBase.process_model`, which runs one member in a
warm evaluator process (``parallel/warm_pool.py``) or as a cold ``python
-m veles_tpu_torch`` and reads its metrics back from a results file.

Each member run through a process is recorded in
:attr:`EnsembleManagerBase.evaluations` (index, wall seconds, and from a
warm worker its pid, the card's allocated bytes after the job and its
kernel launch counts), written beside the members' results.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

from veles_tpu_torch.distributable import Distributable, IDistributable


class EnsembleManagerBase(Distributable, IDistributable):
    """N result slots; each job = one model index to process."""

    def __init__(self, workflow_file=None, config_file=None, size=1,
                 result_file=None, seed_base=1234, extra_argv=(),
                 runner=None, warm=True, **kwargs):
        super(EnsembleManagerBase, self).__init__(**kwargs)
        if int(size) < 1:
            raise ValueError("ensemble size must be > 0 (got %s)" % size)
        self.workflow_file = workflow_file
        self.config_file = config_file
        self.size = int(size)
        self.results = [None] * self.size
        self.result_file = result_file
        self.seed_base = int(seed_base)
        self.extra_argv = list(extra_argv)
        self.runner = runner  # callable(index) -> dict, for tests/in-proc
        #: keep one evaluator process alive across members (the second
        #: member onward pays no import, CUDA context or kernel load);
        #: False runs a cold process per member
        self.warm = warm
        #: one entry per member run through a process
        self.evaluations = []

    def init_unpickled(self):
        super(EnsembleManagerBase, self).init_unpickled()
        self._pending_ = {}
        self._pool_ = None
        self._atexit_registered_ = False

    def _get_pool(self):
        if self._pool_ is None:
            from veles_tpu_torch.parallel.warm_pool import WarmPool
            self._pool_ = WarmPool(workers=1)
            # slaves evaluate via generate_data_for_master and never
            # enter run()'s finally — make sure the evaluator process
            # is reaped at interpreter exit regardless. Registered
            # ONCE per instance: close_pool nulls _pool_, so repeated
            # run() cycles re-create the pool and would otherwise
            # stack a stale atexit entry per recreation
            if not self._atexit_registered_:
                import atexit
                atexit.register(self.close_pool)
                self._atexit_registered_ = True
        return self._pool_

    def close_pool(self):
        if getattr(self, "_pool_", None) is not None:
            self._pool_.close()
            self._pool_ = None

    # -- progress ----------------------------------------------------------

    @property
    def processed(self):
        return sum(1 for r in self.results if r is not None)

    @property
    def pending_indices(self):
        held = {i for s in self._pending_.values() for i in s}
        return [i for i, r in enumerate(self.results)
                if r is None and i not in held]

    @property
    def complete(self):
        return self.processed == self.size

    # -- one model ---------------------------------------------------------

    def model_overrides(self, index):
        """Config overrides marking which ensemble member this run is."""
        return {"root.common.ensemble.model_index": index,
                "root.common.ensemble.size": self.size}

    def model_argv(self, index, result_path):
        raise NotImplementedError

    def process_model(self, index):
        """Run model #index, return its results dict."""
        if self.runner is not None:
            return self.runner(index)
        fd, result_path = tempfile.mkstemp(
            suffix=".json", prefix="veles_tpu_ensemble_")
        os.close(fd)
        argv = self.model_argv(index, result_path)
        record = {"index": index}
        t0 = time.perf_counter()
        if self.warm:
            # warm evaluator: in-process main() in a long-lived worker
            # (the worker deletes the result file after reading it; the
            # finally covers a worker that died before getting there)
            try:
                reply = self._get_pool().run(argv,
                                             result_file=result_path)
            except (RuntimeError, OSError, ValueError) as e:
                # hard worker death — WarmPool.run's documented raise
                # set (RuntimeError on exit, OSError on a broken pipe,
                # ValueError on a truncated reply): the pool already
                # replaced the worker, so record this member as failed
                # and keep the rest of the ensemble
                self.warning("model #%d evaluator died: %s", index, e)
                return None
            finally:
                try:
                    os.unlink(result_path)
                except OSError:
                    pass
            if not reply.get("ok"):
                self.warning("model #%d failed: %s", index,
                             reply.get("error", reply.get("code")))
                return None
            record.update(
                pid=reply.get("pid"), wall_s=time.perf_counter() - t0,
                cuda_allocated=reply.get("cuda_allocated"),
                kernel_counts=reply.get("kernel_counts"))
            self.evaluations.append(record)
            return reply.get("result")
        try:
            full = [sys.executable, "-m", "veles_tpu_torch"] + argv
            self.debug("exec: %s", " ".join(full))
            proc = subprocess.Popen(full, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT)
            output, _ = proc.communicate()
            if proc.returncode != 0:
                self.warning(
                    "model #%d failed (%d): %s", index, proc.returncode,
                    output[-2000:].decode(errors="replace"))
                return None
            with open(result_path) as f:
                results = json.load(f)
            record.update(pid=proc.pid, wall_s=time.perf_counter() - t0)
            self.evaluations.append(record)
            return results
        finally:
            try:
                os.unlink(result_path)
            except OSError:
                pass

    def _base_argv(self, result_path, seed):
        """The module's arguments (no interpreter prefix: warm workers
        pass these straight to ``veles_tpu_torch.__main__.main``)."""
        argv = [self.workflow_file]
        if self.config_file:
            argv.append(self.config_file)
        argv.extend(["--result-file", result_path, "-s", str(seed),
                     "-v", "warning"])
        argv.extend(self.extra_argv)
        return argv

    # -- the run -----------------------------------------------------------

    def run(self):
        try:
            for index in range(self.size):
                if self.results[index] is None:
                    self.info("processing model %d / %d", index + 1,
                              self.size)
                    self.results[index] = self.process_model(index)
        finally:
            self.close_pool()
        self.write_results()
        return self.results

    def gathered(self):
        """The dict written to result_file; subclasses extend."""
        return {"models": self.results, "size": self.size,
                "evaluations": self.evaluations}

    def write_results(self):
        if not self.result_file:
            return
        with open(self.result_file, "w") as f:
            json.dump(self.gathered(), f, indent=2, default=str)
        self.info("wrote ensemble results to %s", self.result_file)

    # -- task farming (``base_workflow.py:103-131``) -----------------------

    @property
    def has_data_for_slave(self):
        return bool(self.pending_indices)

    def generate_data_for_slave(self, slave):
        free = self.pending_indices
        if not free:
            return None
        index = free[0]
        self._pending_.setdefault(slave, set()).add(index)
        self.info("enqueued model #%d / %d to %s", index + 1, self.size,
                  slave)
        return index

    def apply_data_from_master(self, data):
        self._job_index_ = int(data)

    def generate_data_for_master(self):
        return (self._job_index_, self.process_model(self._job_index_))

    def apply_data_from_slave(self, data, slave):
        index, result = data
        self._pending_.get(slave, set()).discard(index)
        self.results[index] = result

    def drop_slave(self, slave):
        requeued = self._pending_.pop(slave, set())
        if requeued:
            self.info("slave %s dropped, requeued models %s", slave,
                      sorted(requeued))
