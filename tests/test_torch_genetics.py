"""The port's genetic optimizer and warm evaluator pool against the JAX
package's (``veles_tpu/genetics/``, ``veles_tpu/parallel/warm_pool.py``),
on the CPU.

* The engine, bit for bit under one seed: gray codes, each of the four
  mutations, the four crossovers and the three selections, and a
  population evolved generation by generation through the in-process
  evaluator; the ``prng`` draws the engine makes (``randint``, ``rand``,
  ``normal``) pinned to JAX's stream.
* ``Tune`` (a float, pickled whole), ``collect_tuneables`` /
  ``fix_config``, the fitness fallback and the task-farming protocol
  with a dropped slave, each against JAX's on the same calls.
* The results JSON lists the metrics in the JAX workflow's order, so
  the fallback fitness (the negated first numeric value) is the same
  metric in both packages.
* ``--optimize 2:3`` of a tiny ``MnistWorkflow`` through each package's
  CLI (``-a cpu`` for the port): the same best configuration and the
  same fitnesses (error counts: equal, a bound of 0).
* The warm pool: one process serves every job, two jobs in it give the
  results of two cold processes in every value, a failing job leaves the
  worker alive, a job that asks for the card on a host without one
  fails in its reply (no fallback to the CPU), and the reply carries the
  card's allocated bytes (None here) and the kernel launch counts.
* ``ops.launch_report()``, the launch counts a warm worker replies with.
* A subprocess that imports the new modules loads neither ``jax`` nor
  any ``veles_tpu`` module.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu import genetics as jax_genetics  # noqa: E402
from veles_tpu.config import root as jax_root  # noqa: E402
from veles_tpu_torch import genetics, prng  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: a subprocess's wall limit
PROC_S = 240

TINY_MNIST = '''
import numpy
from {package}.config import root
from {package}.models.mnist import MnistWorkflow


class TinyProvider(object):
    def __call__(self):
        rng = numpy.random.RandomState(0)
        x = rng.rand(80, 6, 6).astype(numpy.float32)
        y = (x.reshape(80, -1).sum(1) > 18).astype(numpy.int32)
        return x[:60], y[:60], x[60:], y[60:]


def run(load, main):
    load(MnistWorkflow, provider=TinyProvider(), layers=(8,),
         minibatch_size=20, max_epochs=2,
         learning_rate=float(root.ga.lr))
    main()
'''

TINY_CONFIG = '''
from {package}.genetics import Tune
root.ga.lr = Tune(0.1, 0.01, 0.5)
'''


def _files(tmp_path, package):
    wf = tmp_path / ("ga_%s.py" % package)
    wf.write_text(TINY_MNIST.format(package=package))
    cfg = tmp_path / ("ga_%s_config.py" % package)
    cfg.write_text(TINY_CONFIG.format(package=package))
    return str(wf), str(cfg)


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.fixture(autouse=True)
def _clean_config():
    yield
    for tree in (root, jax_root):
        for name in ("ga", "ga_opt"):
            tree.__dict__.pop(name, None)


def _pair(seed):
    return (prng.RandomGenerator("t").seed(seed),
            jax_prng.RandomGenerator("t").seed(seed))


# -- the engine ---------------------------------------------------------------


def test_gray_code_equals_jax():
    n = numpy.arange(1 << 16, dtype=numpy.int64)
    got = genetics.gray_encode(n)
    numpy.testing.assert_array_equal(got, jax_genetics.gray_encode(n))
    numpy.testing.assert_array_equal(genetics.gray_decode(got), n)
    numpy.testing.assert_array_equal(genetics.gray_decode(got),
                                     jax_genetics.gray_decode(got))


@pytest.mark.parametrize("draw", ["randint", "rand", "normal"])
def test_prng_draws_equal_jax(draw):
    """The draws ``core.py`` makes, from one seed, equal JAX's stream."""
    ours, theirs = _pair(7)
    calls = {"randint": [(16,), (1, 100, 5), (3,)],
             "rand": [(), (4,), ()],
             "normal": [(0.0, 0.3), (1.0, 2.0), (0.0, 1e-3)]}[draw]
    for args in calls:
        numpy.testing.assert_array_equal(getattr(ours, draw)(*args),
                                         getattr(theirs, draw)(*args))


@pytest.mark.parametrize("kind", ["binary_point", "altering", "gaussian",
                                  "uniform"])
def test_mutation_equals_jax(kind):
    ours, theirs = _pair(11)
    lo, hi = [-5.0, 0.0, 1e-3], [5.0, 1.0, 0.5]
    a = genetics.Chromosome(lo, hi, rand=ours)
    b = jax_genetics.Chromosome(lo, hi, rand=theirs)
    for _ in range(12):
        a.mutate(kind, n_points=3, probability=0.7, rand=ours)
        b.mutate(kind, n_points=3, probability=0.7, rand=theirs)
        numpy.testing.assert_array_equal(a.codes, b.codes)
        numpy.testing.assert_array_equal(a.numeric, b.numeric)
        assert a.fitness is None
        assert (a.numeric >= lo).all() and (a.numeric <= hi).all()


@pytest.mark.parametrize("kind", ["pointed", "uniform", "arithmetic",
                                  "geometric"])
def test_crossover_equals_jax(kind):
    ours, theirs = _pair(3)
    a = genetics.Population([0.0] * 3, [1.0] * 3, size=4, rand=ours)
    b = jax_genetics.Population([0.0] * 3, [1.0] * 3, size=4, rand=theirs)
    for _ in range(5):
        x = getattr(a, "cross_" + kind)(a[0], a[1])
        y = getattr(b, "cross_" + kind)(b[0], b[1])
        numpy.testing.assert_array_equal(x.codes, y.codes)


@pytest.mark.parametrize("kind", ["roulette", "random", "tournament"])
def test_selection_equals_jax(kind):
    ours, theirs = _pair(5)
    a = genetics.Population([-1.0], [1.0], size=6, rand=ours)
    b = jax_genetics.Population([-1.0], [1.0], size=6, rand=theirs)
    for pop in (a, b):
        for i, c in enumerate(pop):
            c.fitness = float(numpy.sin(3 * i))
    for _ in range(10):
        assert a.chromosomes.index(getattr(a, "select_" + kind)()) == \
            b.chromosomes.index(getattr(b, "select_" + kind)())


def test_population_evolves_as_jax_s_generation_by_generation():
    """Eight generations of the in-process optimizer under one seed:
    every generation's chromosomes (codes and fitnesses) are JAX's, bit
    for bit, and so are the best and the results file."""
    for tree in (root, jax_root):
        tree.ga_opt.x = genetics.Tune(0.0, -4.0, 4.0) if tree is root \
            else jax_genetics.Tune(0.0, -4.0, 4.0)
        tree.ga_opt.y = genetics.Tune(0.5, -4.0, 4.0) if tree is root \
            else jax_genetics.Tune(0.5, -4.0, 4.0)

    def fitness(v):
        return -((v["root.ga_opt.x"] - 1.0) ** 2 +
                 (v["root.ga_opt.y"] - 2.0) ** 2)

    seen = {"port": [], "jax": []}
    runs = {}
    for name, module in (("port", genetics), ("jax", jax_genetics)):
        rand = (prng if name == "port" else jax_prng).RandomGenerator(
            "evolve").seed(21)
        opt = module.GeneticsOptimizer(generations=8, population_size=9,
                                       evaluator=fitness, rand=rand)
        opt.on_generation = lambda pop, key=name: seen[key].append(
            [(c.codes.tolist(), c.fitness) for c in pop])
        runs[name] = (opt, opt.run())
    assert len(seen["port"]) == 8
    assert seen["port"] == seen["jax"]
    (opt, best), (jopt, jbest) = runs["port"], runs["jax"]
    assert best.fitness == jbest.fitness
    assert opt.overrides_for(best) == jopt.overrides_for(jbest)


# -- Tune and the config tree -------------------------------------------------


def test_tune_is_a_float_and_pickles_whole():
    t = genetics.Tune(0.03, 0.001, 0.1)
    assert t * 2 == 0.06 and t.min_value == 0.001
    back = pickle.loads(pickle.dumps(t))
    assert isinstance(back, genetics.Tune)
    assert (float(back), back.min_value, back.max_value) == (0.03, 0.001,
                                                             0.1)
    assert repr(t) == repr(jax_genetics.Tune(0.03, 0.001, 0.1))


def test_collect_and_fix_config_equal_jax():
    for tree, tune in ((root, genetics.Tune), (jax_root, jax_genetics.Tune)):
        tree.ga.lr = tune(0.05, 0.01, 0.5)
        tree.ga.decay = 0.9
        tree.ga.sub.momentum = tune(0.8, 0.0, 1.0)
    got = [(p, float(t), t.min_value, t.max_value)
           for p, t in genetics.collect_tuneables() if p.startswith(
               "root.ga.")]
    want = [(p, float(t), t.min_value, t.max_value)
            for p, t in jax_genetics.collect_tuneables() if p.startswith(
                "root.ga.")]
    assert got == want == [("root.ga.lr", 0.05, 0.01, 0.5),
                           ("root.ga.sub.momentum", 0.8, 0.0, 1.0)]
    genetics.fix_config(root.ga)
    assert type(root.ga.lr) is float and root.ga.lr == 0.05
    assert type(root.ga.sub.momentum) is float


def test_optimizer_needs_tuneables():
    with pytest.raises(ValueError, match="Tune"):
        genetics.GeneticsOptimizer(evaluator=lambda v: 0.0)


@pytest.mark.parametrize("results", [
    {"fitness": 2.5, "n_err": 3}, {"EvaluationFitness": 1.25},
    {"validation error": 1.5, "loss": 0.2}, {"name": "x", "n_err": 7}])
def test_fitness_from_results_equals_jax(results):
    root.ga.x = genetics.Tune(0.0, -1.0, 1.0)
    jax_root.ga.x = jax_genetics.Tune(0.0, -1.0, 1.0)
    got = genetics.GeneticsOptimizer(evaluator=lambda v: 0.0)
    want = jax_genetics.GeneticsOptimizer(evaluator=lambda v: 0.0)
    assert got._fitness_from_results(results) == \
        want._fitness_from_results(results)


def test_fitness_without_a_number_raises():
    root.ga.x = genetics.Tune(0.0, -1.0, 1.0)
    opt = genetics.GeneticsOptimizer(evaluator=lambda v: 0.0)
    with pytest.raises(genetics.EvaluationError):
        opt._fitness_from_results({"name": "x"})


def test_task_farming_with_a_dropped_slave_equals_jax():
    """Master and slaves through the distribution protocol: slave s1
    takes a job and dies (``drop_slave``), its chromosome goes to s2;
    the jobs handed out, in order, and the final population are JAX's."""
    trace = {}
    for name, module, tree, gen in (
            ("port", genetics, root, prng),
            ("jax", jax_genetics, jax_root, jax_prng)):
        tree.ga.x = module.Tune(0.0, -4.0, 4.0)
        opt = module.GeneticsOptimizer(
            generations=3, population_size=4,
            evaluator=lambda v: -abs(v["root.ga.x"] - 1.0),
            rand=gen.RandomGenerator("farm").seed(13))
        assert opt.has_data_for_slave
        jobs = []
        lost = opt.generate_data_for_slave("s1")
        jobs.append(("s1", lost["index"]))
        opt.drop_slave("s1")
        while True:
            job = opt.generate_data_for_slave("s2")
            if job is None:
                break
            jobs.append(("s2", job["index"], job["values"]))
            opt.apply_data_from_master(job)
            opt.apply_data_from_slave(opt.generate_data_for_master(), "s2")
            if opt.population.generation >= opt.generations - 1 and \
                    not opt.population.pending:
                break
        trace[name] = (jobs, [(c.codes.tolist(), c.fitness)
                              for c in opt.population])
    assert trace["port"] == trace["jax"]
    assert trace["port"][0][1][1] == trace["port"][0][0][1]  # requeued


def test_results_keys_in_jax_s_order(tmp_path):
    """One epoch of the tiny ``MnistWorkflow`` through each CLI: the
    results JSON's keys in the same order, so the fallback fitness (the
    first numeric value, negated) reads the same metric."""
    from veles_tpu.__main__ import Main as JaxMain
    from veles_tpu_torch.__main__ import Main
    for tree, tune in ((root, genetics.Tune), (jax_root, jax_genetics.Tune)):
        tree.ga.lr = tune(0.1, 0.01, 0.5)
    keys = {}
    for name, main, extra in (("port", Main, ["-a", "cpu"]),
                              ("jax", JaxMain, [])):
        package = "veles_tpu_torch" if name == "port" else "veles_tpu"
        wf, _ = _files(tmp_path, package)
        out = str(tmp_path / ("%s.json" % name))
        assert main().run([wf, "-s", "3", "--result-file", out,
                           "-v", "warning"] + extra) == 0
        with open(out) as f:
            keys[name] = list(json.load(f))
    assert keys["port"] == keys["jax"]
    assert keys["port"][0] == "n_err"


def test_optimize_cli_equals_jax(tmp_path):
    """``--optimize 2:3`` of the tiny ``MnistWorkflow`` through both CLIs
    (the port's evaluations on the CPU, asked for with ``-a cpu``): the
    best configuration equal and every fitness (an error count) equal;
    the port's one warm worker served each evaluation."""
    results = {}
    for package, extra in (("veles_tpu_torch", ["-a", "cpu"]),
                           ("veles_tpu", [])):
        wf, cfg = _files(tmp_path, package)
        out = str(tmp_path / ("%s_best.json" % package))
        proc = subprocess.run(
            [sys.executable, "-m", package, "--optimize", "2:3", wf, cfg,
             "-s", "7", "--result-file", out, "-v", "warning"] + extra,
            env=_env(), capture_output=True, timeout=PROC_S, cwd=tmp_path)
        assert proc.returncode == 0, proc.stderr.decode()[-3000:]
        with open(out) as f:
            results[package] = json.load(f)
    got, want = results["veles_tpu_torch"], results["veles_tpu"]
    assert got["config"] == want["config"]
    assert got["fitness"] == want["fitness"]
    assert (got["generations"], got["population_size"]) == (2, 3)
    evaluations = got["evaluations"]
    # 3 of the first generation, 1 child of the second (2 survive)
    assert len(evaluations) == 4
    assert len({e["pid"] for e in evaluations}) == 1
    assert all(e["cuda_allocated"] is None for e in evaluations)
    assert all(e["result"]["n_err"] == -e["fitness"] for e in evaluations)
    assert max(e["fitness"] for e in evaluations) == got["fitness"]


# -- the warm pool ------------------------------------------------------------


def _job(wf, cfg, result, seed, *extra):
    return [wf, cfg, "root.ga.lr=0.2", "--result-file", result, "-s",
            str(seed), "-v", "warning"] + list(extra)


def test_warm_pool_two_jobs_equal_two_cold_processes(tmp_path):
    """Two jobs of different seeds in one warm worker give, in every
    value, the results of the same two jobs in cold processes; the one
    worker served both; a job that fails leaves it alive; a job that
    asks for the card on a host without one fails in its reply."""
    from veles_tpu_torch.parallel.warm_pool import WarmPool
    wf, cfg = _files(tmp_path, "veles_tpu_torch")
    warm = []
    with WarmPool(workers=1, env=_env()) as pool:
        for seed in (5, 6):
            result = str(tmp_path / ("warm%d.json" % seed))
            reply = pool.run(_job(wf, cfg, result, seed, "-a", "cpu"),
                             result_file=result)
            assert reply["ok"], reply
            assert not os.path.exists(result)  # the worker removed it
            assert reply["cuda_allocated"] is None
            assert set(reply["kernel_counts"]) == {
                "gemm_bias_act", "kahan_gemm", "lrn_fwd", "lrn_bwd",
                "column_reduce", "uniform_fill"}
            warm.append(reply)
        bad = pool.run(["/nonexistent_workflow.py"])
        assert not bad["ok"] and bad["pid"] == warm[0]["pid"]
        if not torch.cuda.is_available():
            nocard = pool.run(_job(wf, cfg, str(tmp_path / "c.json"), 5))
            assert not nocard["ok"]
            assert "no CUDA device" in nocard.get("error", "")
        again = pool.run(_job(wf, cfg, str(tmp_path / "w.json"), 5,
                              "-a", "cpu"), result_file=str(
                                  tmp_path / "w.json"))
        assert again["ok"] and again["result"] == warm[0]["result"]
        assert pool.pids == [warm[0]["pid"]]
    assert warm[1]["pid"] == warm[0]["pid"]
    assert warm[0]["result"] != warm[1]["result"]
    for seed, reply in zip((5, 6), warm):
        result = str(tmp_path / ("cold%d.json" % seed))
        proc = subprocess.run(
            [sys.executable, "-m", "veles_tpu_torch"] +
            _job(wf, cfg, result, seed, "-a", "cpu"), env=_env(),
            capture_output=True, timeout=PROC_S)
        assert proc.returncode == 0, proc.stderr.decode()[-3000:]
        with open(result) as f:
            assert json.load(f) == reply["result"]


def test_warm_pool_replaces_a_dead_worker(tmp_path):
    from veles_tpu_torch.parallel.warm_pool import WarmPool
    with WarmPool(workers=1, env=_env()) as pool:
        first = pool.pids[0]
        pool._workers[0].proc.kill()
        pool._workers[0].proc.wait()
        with pytest.raises((RuntimeError, OSError, ValueError)):
            pool.run(["/nonexistent_workflow.py"])
        assert pool.pids != [first]
        reply = pool.run(["/nonexistent_workflow.py"])
        assert not reply["ok"] and reply["pid"] == pool.pids[0]


def test_launch_report_reads_every_wrapper_counter(monkeypatch):
    """``ops.launch_report()`` (a warm worker's ``kernel_counts``) names
    every hand-written kernel, reads each wrapper's counters and is
    JSON-ready."""
    import collections
    from veles_tpu_torch.ops import launch_report
    from veles_tpu_torch.ops.gemm import linear_act
    form = (128, 9216, 4096, torch.float32, True)
    monkeypatch.setattr(linear_act, "launches", 3)
    monkeypatch.setattr(linear_act, "launches_by_form",
                        collections.Counter({form: 3}))
    monkeypatch.setattr(linear_act, "launches_by_variant",
                        collections.Counter({"tma_ws": 3}))
    report = json.loads(json.dumps(launch_report()))
    assert sorted(report) == ["column_reduce", "gemm_bias_act",
                              "kahan_gemm", "lrn_bwd", "lrn_fwd",
                              "uniform_fill"]
    assert report["gemm_bias_act"] == {"launches": 3,
                                       "forms": [[repr(form), 3]],
                                       "variants": {"tma_ws": 3}}


NO_JAX = """
import sys
import veles_tpu_torch.genetics, veles_tpu_torch.ensemble
import veles_tpu_torch.sched, veles_tpu_torch.sched.cli
import veles_tpu_torch.parallel.warm_pool, veles_tpu_torch.loader.ensemble
import veles_tpu_torch.__main__
bad = sorted(m for m in sys.modules if m in ("jax", "veles_tpu") or
             m.startswith(("jax.", "veles_tpu.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_new_modules_load_neither_jax_nor_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", NO_JAX], env=_env(),
                          capture_output=True, timeout=PROC_S)
    assert proc.returncode == 0, (proc.stdout.decode(),
                                  proc.stderr.decode()[-2000:])
