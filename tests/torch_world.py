"""Run a function on every rank of a fresh world of processes: the
harness of the port's multi-rank tests and of ``chip_smoke.py``'s
sequence, expert and pipeline worlds (which loads this file by path).

:func:`run_world` starts ``n`` Python processes, each joining one world
at a file store under a work directory (so concurrent worlds never
share a port), runs ``fn(*args)`` on every rank and returns each rank's
report: ``value`` (what ``fn`` returned, pickled back), ``seconds`` and
``bad_modules`` (any ``jax`` or ``veles_tpu`` module the rank loaded).
The whole world has one wall limit: a rank still running at it is
killed and the call raises ``TimeoutError``; a rank that failed raises
``RuntimeError`` with its traceback. ``fn`` is pickled by reference, so
it lives in a module the ranks import (not ``__main__``); the ranks
start with nothing of the caller's process. ``backend`` is the
launcher's: ``cpu`` keeps the ranks on the CPU (gloo), ``auto`` puts
them on the host's cards by the tier's rule.
"""

import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback

#: the program of each rank
_RANK = ("import sys; from torch_world import rank_main; "
         "sys.exit(rank_main(sys.argv[1], int(sys.argv[2])))")

#: this file's directory and the repository's root, both on the ranks'
#: path
_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)


def rank_main(workdir, rank):
    """One rank: join the world, run the task, write the report."""
    t0 = time.perf_counter()
    with open(os.path.join(workdir, "task.pickle"), "rb") as fin:
        fn, args, n, backend = pickle.load(fin)
    report = {"rank": rank}
    code = 0
    try:
        import torch.distributed as dist
        from veles_tpu_torch.parallel import mesh
        store = dist.FileStore(os.path.join(workdir, "store"), n)
        mesh.init_world(store, n, rank, backend,
                        spec=("file://" + workdir, n, rank))
        try:
            report["value"] = fn(*args)
        finally:
            mesh.shutdown_multihost()
    except BaseException:
        report["error"] = traceback.format_exc()
        code = 1
    report["seconds"] = time.perf_counter() - t0
    report["bad_modules"] = sorted(
        m for m in sys.modules if m in ("jax", "veles_tpu") or
        m.startswith(("jax.", "veles_tpu.")))
    with open(os.path.join(workdir, "rank%d.pickle" % rank), "wb") as fout:
        pickle.dump(report, fout)
    return code


def run_world(fn, n, args=(), backend="cpu", timeout=120.0, workdir=None,
              env=None):
    """``fn(*args)`` on each of ``n`` ranks; the reports by rank (see
    the module docstring)."""
    own = workdir is None
    if own:
        workdir = tempfile.mkdtemp(prefix="veles_world_")
    with open(os.path.join(workdir, "task.pickle"), "wb") as fout:
        pickle.dump((fn, args, n, backend), fout)
    environ = dict(os.environ if env is None else env)
    paths = [_ROOT, _HERE]
    module = sys.modules.get(fn.__module__)
    if "." not in fn.__module__ and getattr(module, "__file__", None):
        # a top-level module (a test's helper): the ranks import it from
        # its directory
        paths.append(os.path.dirname(os.path.abspath(module.__file__)))
    environ["PYTHONPATH"] = os.pathsep.join(
        paths + [p for p in environ.get("PYTHONPATH", "").split(os.pathsep)
                 if p])
    logs = [os.path.join(workdir, "rank%d.log" % r) for r in range(n)]
    procs = []
    for r in range(n):
        with open(logs[r], "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK, workdir, str(r)], env=environ,
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise TimeoutError(
                    "a world of %d ranks overran its %.0f s limit" %
                    (n, timeout))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    reports = []
    for r in range(n):
        path = os.path.join(workdir, "rank%d.pickle" % r)
        if not os.path.exists(path):
            with open(logs[r], "rb") as log:
                tail = log.read()[-4000:].decode(errors="replace")
            raise RuntimeError("rank %d of %d left no report (exit %s):\n%s"
                               % (r, n, procs[r].returncode, tail))
        with open(path, "rb") as fin:
            reports.append(pickle.load(fin))
    failed = [rep for rep in reports if "error" in rep]
    if failed:
        raise RuntimeError("rank %d of %d failed:\n%s" % (
            failed[0]["rank"], n, failed[0]["error"]))
    if own:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    return reports
