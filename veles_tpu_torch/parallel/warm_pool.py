"""Warm evaluator processes for ensemble and genetics job farming
(``veles_tpu/parallel/warm_pool.py``).

A cold ``python -m veles_tpu_torch`` per ensemble member or chromosome
pays the interpreter, the ``torch`` import, CUDA context creation and
the kernels' load before any useful work. A :class:`WarmPool` keeps N
evaluator processes alive instead: each imports the port once, then
loops running ``veles_tpu_torch.__main__.main`` in process, one job per
JSON line on stdin, one reply per line on stdout. The kernels are built
once per process (``ops/build.py`` keeps the loaded libraries), so the
second job onward neither rebuilds nor reloads them.

The device comes from each job's own argv: the card by default, ``-a
cpu`` when the caller asks for the CPU. A job that finds no card raises
in its worker (reported in the reply), as a cold run would.

Config residue: jobs override the same dotted config paths every run
(the ensemble's ``model_index``/``size``, the genetics' tuned leaves)
and re-seed through ``-s``, so successive jobs in one process overwrite
each other's state: the contract that makes in-process reuse sound.
After each job the worker drops the job's workflow, collects garbage
and, on a process that touched the card, empties the caching allocator,
so the card's memory does not grow with every job; the reply carries
``torch.cuda.memory_allocated()`` after that release
(``cuda_allocated``, None when CUDA was never initialized) and the
process's kernel launch counts so far (``kernel_counts``,
``ops.launch_report``).

The worker redirects stray stdout into stderr at startup and keeps a
private dup of the real stdout for the protocol, so a workflow that
prints cannot corrupt the job stream.
"""

import json
import os
import subprocess
import sys
import threading

from veles_tpu_torch.logger import Logger


def _release():
    """Free what the last job left: garbage first, then the caching
    allocator's idle blocks. Returns the reply's memory and kernel
    fields. Touches CUDA only where a job initialized it."""
    import gc
    gc.collect()
    allocated = None
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        allocated = int(torch.cuda.memory_allocated())
    counts = {}
    if "veles_tpu_torch.ops" in sys.modules:
        from veles_tpu_torch.ops import launch_report
        counts = launch_report()
    return {"cuda_allocated": allocated, "kernel_counts": counts}


def _worker_main():
    """Loop: one JSON job per stdin line -> one JSON reply line."""
    proto_out = os.fdopen(os.dup(sys.stdout.fileno()), "w", buffering=1)
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    sys.stdout = sys.stderr
    from veles_tpu_torch.__main__ import Main
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            job = json.loads(line)
            if job.get("cmd") == "exit":
                break
            argv = list(job["argv"])
            result_file = job.get("result_file")
            # the Main, and with it the workflow, its trainer and their
            # tensors, is dropped when run() returns
            code = Main().run(argv)
            reply = {"ok": code == 0, "code": code, "pid": os.getpid()}
            if code == 0 and result_file:
                with open(result_file) as fin:
                    reply["result"] = json.load(fin)
        except SystemExit as e:
            reply = {"ok": (e.code or 0) == 0, "code": e.code,
                     "pid": os.getpid()}
        except Exception as e:  # noqa: BLE001 -- report, keep serving
            reply = {"ok": False, "error": "%s: %s" % (
                type(e).__name__, e), "pid": os.getpid()}
        finally:
            rf = None
            try:
                rf = job.get("result_file")
            except Exception:
                pass
            if rf:
                try:
                    os.unlink(rf)
                except OSError:
                    pass
        reply.update(_release())
        proto_out.write(json.dumps(reply) + "\n")
        proto_out.flush()


class WarmWorker(object):
    """One persistent evaluator process."""

    def __init__(self, env=None):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch.parallel.warm_pool"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=env, text=True, bufsize=1)
        self.jobs_done = 0

    @property
    def pid(self):
        return self.proc.pid

    def run(self, argv, result_file=None):
        """Execute one job; blocks until the reply line arrives."""
        job = {"argv": list(argv)}
        if result_file:
            job["result_file"] = result_file
        self.proc.stdin.write(json.dumps(job) + "\n")
        self.proc.stdin.flush()
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(
                "warm evaluator died (rc=%s)" % self.proc.poll())
        self.jobs_done += 1
        return json.loads(line)

    def close(self):
        try:
            self.proc.stdin.write('{"cmd": "exit"}\n')
            self.proc.stdin.flush()
            self.proc.stdin.close()
            self.proc.wait(timeout=10)
        except Exception:
            self.proc.kill()


class WarmPool(Logger):
    """N warm workers with a simple checkout discipline.

    With one card the sensible N is 1 (evaluations contend for it):
    the point is warmth, not parallelism; more workers serve CPU runs
    and pure-host fitness runs.
    """

    def __init__(self, workers=1, env=None):
        super(WarmPool, self).__init__()
        self._env = env
        self._workers = [WarmWorker(env) for _ in range(workers)]
        self._free = list(self._workers)
        self._cv = threading.Condition()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def pids(self):
        return [w.pid for w in self._workers]

    def run(self, argv, result_file=None):
        with self._cv:
            while not self._free:
                self._cv.wait()
            worker = self._free.pop()
        try:
            reply = worker.run(argv, result_file)
        except (RuntimeError, OSError, ValueError):
            # the worker died (BrokenPipeError on write, empty/corrupt
            # reply): replace it so the pool keeps serving, surface the
            # failure — a narrower catch would leak the checked-out
            # worker and deadlock every later run() at workers=1
            try:
                worker.close()
            except Exception:
                pass
            with self._cv:
                self._workers.remove(worker)
                replacement = WarmWorker(self._env)
                self._workers.append(replacement)
                self._free.append(replacement)
                self._cv.notify()
            raise
        with self._cv:
            self._free.append(worker)
            self._cv.notify()
        return reply

    def close(self):
        # empty the pool under the lock and WAKE waiters (a run()
        # blocked on an empty free list would otherwise sleep forever);
        # worker shutdown happens outside it — close() blocks up to
        # 10 s per worker
        with self._cv:
            workers, self._workers = self._workers, []
            self._free = []
            self._cv.notify_all()
        for worker in workers:
            worker.close()


if __name__ == "__main__":
    _worker_main()
