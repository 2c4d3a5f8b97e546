"""The port's eager per-unit path (``python -m veles_tpu_torch --eager``)
against the JAX package's eager ``workflow.run()`` and against the
port's own fused path, on the CPU.

* JAX parity: one and two eager epochs of the small AlexNet (dropout
  included) and of ``MnistWorkflow`` (momentum 0.9; a short tail batch
  too), the same ``-s 7`` on both sides: epoch histories (samples and
  metric sums equal, normalized metrics within 1e-12), parameters and
  SGD velocity within 1e-6 (read: 2.4e-7 and 1.5e-8). JAX's eager
  dropout draws a mask on every forward, evaluation minibatches
  included (its ``testing`` flag is set by ``--test`` alone), while
  both fused trainers and the port's eager units mask training
  minibatches only; so the test runs JAX's dropout as the identity off
  TRAIN minibatches, and hands the port the uniforms JAX drew, recorded
  through ``veles_tpu.nn.dropout.uniform``, in the order they were
  drawn. Nothing in ``veles_tpu`` changes.
* The port's eager run against its fused run: bit for bit (history,
  evaluator, parameters, velocity), with dropout from the Philox fill's
  plain version, and with a short tail batch.
* The CLI: ``--eager`` writes the fused run's result file; a graph with
  a custom unit falls back to eager, a workflow with two solvers runs
  fused (and matches JAX's eager run); ``publish_output``'s
  ``Output``/``Labels`` equal JAX's.
* Snapshots: an eager run snapshotted by ``SnapshotterToFile`` at each
  epoch's end resumes bit for bit, eager and fused (the snapshot holds
  every gradient unit's update of the epoch's last minibatch), and a
  snapshot taken at the stop boundary does the same.
* ``-i``: scripted console sessions in a subprocess (``main()`` once,
  a second ``main()`` warned and skipped, leaving the console runs, a
  failure inside the console sets the exit code).
* A subprocess guard: an eager epoch imports neither ``jax`` nor any
  ``veles_tpu`` module.
"""

import json
import os
import subprocess
import sys

import numpy
import pytest

torch = pytest.importorskip("torch")

import veles_tpu.nn.dropout as jax_dropout  # noqa: E402
from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher  # noqa: E402
from veles_tpu.loader.base import TRAIN as JAX_TRAIN  # noqa: E402
from veles_tpu.models.alexnet import AlexNetWorkflow as JaxAlexNet  # noqa
from veles_tpu.models.alexnet import \
    SyntheticImageLoader as JaxSyntheticImageLoader  # noqa: E402
from veles_tpu.models.mnist import MnistWorkflow as JaxMnist  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.convert import (layer_params,  # noqa: E402
                                     solver_state_to_jax)
from veles_tpu_torch.dummy import DummyLauncher  # noqa: E402
from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,  # noqa: E402
                                            SyntheticImageLoader,
                                            small_alexnet_layers)
from veles_tpu_torch.models.mnist import MnistWorkflow  # noqa: E402
from veles_tpu_torch.snapshotter import (SnapshotterToFile,  # noqa: E402
                                         dump_workflow, load_workflow)
from veles_tpu_torch.train.runner import FusedRunner  # noqa: E402
from veles_tpu_torch.units import TrivialUnit  # noqa: E402

from test_torch_workflow import (ALEXNET_FILE, MNIST_FILE,  # noqa: E402
                                 SMALL_LOADER, _assert_history,
                                 _jax_weights, _port_weights,
                                 workflow_file)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _provider(n_train=100, n_valid=30):
    """A 6x6 two-class provider (``tests/test_torch_workflow.py``'s,
    with sizes to choose)."""
    def provide():
        rng = numpy.random.RandomState(0)
        n = n_train + n_valid
        x = rng.rand(n, 6, 6).astype(numpy.float32)
        y = (x.reshape(n, -1).sum(1) > 18).astype(numpy.int32)
        return x[:n_train], y[:n_train], x[n_train:], y[n_train:]
    return provide


def _seed_both(spec="7"):
    from veles_tpu.__main__ import Main as JaxMain
    from veles_tpu_torch.__main__ import Main
    jax_prng._generators.clear()
    prng._generators.clear()
    JaxMain()._seed_random(spec)
    Main()._seed_random(spec)


def _pair(kind, epochs, n_train=100):
    """(JAX workflow, port workflow) of ``kind``, built and initialized
    under the same ``-s 7``."""
    _seed_both()
    if kind == "mnist":
        common = dict(provider=_provider(n_train), layers=(8,),
                      minibatch_size=20, max_epochs=epochs, momentum=0.9,
                      weights_decay=1e-3)
        jax_wf = JaxMnist(JaxDummyLauncher(), **common)
        port_wf = MnistWorkflow(DummyLauncher(), **common)
    else:
        jax_wf = JaxAlexNet(
            JaxDummyLauncher(), layers=small_alexnet_layers(10),
            loader_factory=lambda w: JaxSyntheticImageLoader(
                w, **SMALL_LOADER), max_epochs=epochs)
        port_wf = AlexNetWorkflow(
            DummyLauncher(), layers=small_alexnet_layers(10),
            loader_factory=lambda w: SyntheticImageLoader(
                workflow=w, **SMALL_LOADER), max_epochs=epochs)
    jax_wf.initialize(device=Device(backend="cpu"))
    port_wf.initialize(device="cpu")
    return jax_wf, port_wf


class Replay(object):
    """A uniform source handing over recorded uniforms in order."""

    def __init__(self, values):
        self.values = list(values)

    def __call__(self, shape, seed, batch_index, layer_index, device):
        value = self.values.pop(0)
        assert value.shape == tuple(shape)
        return torch.from_numpy(value).to(device)


@pytest.fixture
def jax_train_only_dropout(monkeypatch):
    """JAX's eager dropout as the identity off TRAIN minibatches, its
    uniforms recorded in draw order (the returned list)."""
    recorded = []
    uniform = jax_dropout.uniform

    def recording(key, shape):
        u = uniform(key, shape)
        recorded.append(numpy.array(u))
        return u

    run = jax_dropout.DropoutForward.jax_run

    def train_only(self):
        saved = self.testing
        self.testing = saved or \
            self.workflow.loader.minibatch_class != JAX_TRAIN
        try:
            run(self)
        finally:
            self.testing = saved

    monkeypatch.setattr(jax_dropout, "uniform", recording)
    monkeypatch.setattr(jax_dropout.DropoutForward, "jax_run", train_only)
    return recorded


def _assert_trained(jax_wf, port_wf, atol):
    for g, w in zip(_port_weights(port_wf), _jax_weights(jax_wf)):
        for k in w:
            numpy.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0)
    jax_gds = {gd.name: gd for gd in jax_wf.gds}
    for gd in port_wf.gds:
        if not gd.opt_state:
            continue
        got = solver_state_to_jax([gd.opt_state])[0]
        want = jax_gds[gd.name].opt_state
        for name, values in want.items():
            if isinstance(values, dict):
                for k, v in values.items():
                    numpy.testing.assert_allclose(
                        got[name][k], numpy.asarray(v), atol=atol, rtol=0)
            else:
                assert float(got[name]) == float(numpy.asarray(values))


def _eager_against_jax(jax_wf, port_wf, recorded):
    jax_wf.run()
    port_wf.uniform_source = Replay(recorded)
    port_wf.run()
    assert bool(port_wf.decision.complete)
    _assert_history(port_wf.decision.epoch_history,
                    jax_wf.decision.epoch_history)
    _assert_trained(jax_wf, port_wf, 1e-6)
    assert port_wf.decision.best_epoch == jax_wf.decision.best_epoch
    assert abs(port_wf.evaluator.loss - jax_wf.evaluator.loss) <= 1e-6


@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("kind", ["mnist", "alexnet"])
def test_eager_matches_jax_eager(kind, epochs, jax_train_only_dropout):
    jax_wf, port_wf = _pair(kind, epochs)
    _eager_against_jax(jax_wf, port_wf, jax_train_only_dropout)
    drawn = len(jax_train_only_dropout)
    # AlexNet: one dropout layer, 3 training minibatches an epoch
    assert drawn == (3 * epochs if kind == "alexnet" else 0)


def test_eager_short_tail_matches_jax_and_fused(jax_train_only_dropout):
    """110 training samples in batches of 20: the tail of 10 is padded
    with index -1, its gradient normalized by the padded batch."""
    jax_wf, port_wf = _pair("mnist", 2, n_train=110)
    _eager_against_jax(jax_wf, port_wf, jax_train_only_dropout)
    assert port_wf.loader.minibatch_size == 10
    _, fused = _pair("mnist", 2, n_train=110)
    FusedRunner(fused).run()
    _assert_bitwise(port_wf, fused)


def _assert_bitwise(a, b):
    assert a.decision.epoch_history == b.decision.epoch_history
    assert a.evaluator.loss == b.evaluator.loss
    assert a.evaluator.n_err == b.evaluator.n_err
    for fa, fb in zip(a.forwards, b.forwards):
        pb = layer_params(fb.module)
        for k, p in layer_params(fa.module).items():
            assert torch.equal(p, pb[k]), (fa.name, k)
    for ga, gb in zip(a.gds, b.gds):
        if ga.opt_state:
            sa = solver_state_to_jax([ga.opt_state])[0]
            sb = solver_state_to_jax([gb.opt_state])[0]
            for k, v in sb["velocity"].items():
                numpy.testing.assert_array_equal(sa["velocity"][k], v)
            assert float(sa["step"]) == float(sb["step"])


@pytest.mark.parametrize("kind", ["mnist", "alexnet"])
def test_eager_equals_fused_bitwise(kind):
    """The same graph, eager and fused, from the same seeds: the masks
    of the Philox fill's plain version in both (the fused trainer's draw
    order), every value equal."""
    _, eager = _pair(kind, 3)
    eager.run()
    _, fused = _pair(kind, 3)
    FusedRunner(fused).run()
    assert len(eager.decision.epoch_history) == 3
    _assert_bitwise(eager, fused)


def test_cli_eager_result_file_equals_fused(tmp_path):
    """``--eager`` runs the eager scheduler and writes the fused run's
    result file."""
    from veles_tpu_torch.__main__ import Main
    path = workflow_file(tmp_path, ALEXNET_FILE, "veles_tpu_torch", 2,
                         "cli")
    results = {}
    for mode, flags in (("fused", []), ("eager", ["--eager"])):
        prng._generators.clear()
        out = str(tmp_path / ("%s.json" % mode))
        main = Main()
        assert main.run([path, "-s", "7", "-a", "cpu", "--result-file",
                         out] + flags) == 0
        assert main.launcher.run_mode_used == mode
        results[mode] = json.load(open(out))
    assert results["eager"] == results["fused"]
    assert results["eager"]["epochs"] == 2


def test_custom_unit_falls_back_to_eager_as_jax_does():
    """A unit the fused trainer does not model: the launcher runs the
    graph eager, as the JAX launcher does, with the same result."""
    from veles_tpu.launcher import Launcher as JaxLauncher
    from veles_tpu.units import TrivialUnit as JaxTrivialUnit
    from veles_tpu_torch.launcher import Launcher
    _seed_both()
    common = dict(provider=_provider(), layers=(8,), minibatch_size=20,
                  max_epochs=2)
    jax_launcher = JaxLauncher(graphics=False, backend="cpu")
    jax_wf = JaxMnist(jax_launcher, **common)
    JaxTrivialUnit(jax_wf, name="custom").link_from(jax_wf.decision)
    launcher = Launcher(backend="cpu")
    port_wf = MnistWorkflow(launcher, **common)
    TrivialUnit(port_wf, name="custom").link_from(port_wf.decision)
    jax_launcher.initialize()
    launcher.initialize()
    jax_launcher.run()
    launcher.run()
    assert launcher.run_mode_used == jax_launcher.run_mode_used == "eager"
    _assert_history(port_wf.decision.epoch_history,
                    jax_wf.decision.epoch_history)
    _assert_trained(jax_wf, port_wf, 1e-6)


def test_two_solvers_fall_back_to_eager_and_match_jax():
    """AdaGrad on the head and SGD below it: the fused trainer keeps a
    solver per layer, so the launcher no longer falls back and runs
    fused; JAX's eager run agrees."""
    from veles_tpu_torch.launcher import Launcher
    _seed_both()
    common = dict(provider=_provider(), layers=(8,), minibatch_size=20,
                  max_epochs=2)
    jax_wf = JaxMnist(JaxDummyLauncher(), **common)
    launcher = Launcher(backend="cpu")
    port_wf = MnistWorkflow(launcher, **common)
    for wf in (jax_wf, port_wf):
        wf.gds[0].solver_name = "adagrad"
    jax_wf.initialize(device=Device(backend="cpu"))
    launcher.initialize()
    jax_wf.run()
    launcher.run()
    assert launcher.run_mode_used == "fused"
    assert sorted(port_wf.gds[0].opt_state) == ["accum"]
    _assert_history(port_wf.decision.epoch_history,
                    jax_wf.decision.epoch_history)
    _assert_trained(jax_wf, port_wf, 1e-6)


def test_publish_output_equals_jax():
    """Testing mode with ``publish_output``: one forward pass over every
    class, each minibatch's probabilities and labels recorded with the
    pad rows trimmed, the same as JAX's."""
    jax_wf, port_wf = _pair("mnist", 2, n_train=110)
    for wf in (jax_wf, port_wf):
        wf.evaluator.publish_output = True
        wf.set_testing(True)
        wf.run()
    got = port_wf.evaluator.get_metric_values()
    want = jax_wf.evaluator.get_metric_values()
    assert numpy.asarray(got["Output"]).shape == (140, 10)
    numpy.testing.assert_allclose(got["Output"], want["Output"],
                                  atol=1e-6, rtol=0)
    assert got["Labels"] == want["Labels"]
    # training records nothing
    _, trained = _pair("mnist", 1)
    trained.evaluator.publish_output = True
    trained.run()
    assert "Output" not in trained.evaluator.get_metric_values()


def _snapshotting_alexnet(directory, max_epochs=4):
    prng._generators.clear()
    prng.get().seed(3)
    prng.get("loader").seed(4)
    wf = AlexNetWorkflow(
        DummyLauncher(), layers=small_alexnet_layers(10),
        loader_factory=lambda w: SyntheticImageLoader(
            workflow=w, **SMALL_LOADER), max_epochs=max_epochs)
    snap = SnapshotterToFile(wf, directory=str(directory), compression="",
                             time_interval=0, name="snapshotter")
    snap.link_from(wf.decision)
    snap.gate_skip = ~wf.loader.epoch_ended
    wf.initialize(device="cpu")
    return wf


def _resume(path, eager):
    prng._generators.clear()
    wf = load_workflow(path)
    wf.workflow = DummyLauncher()
    wf.initialize(device="cpu")
    if eager:
        wf.run()
    else:
        FusedRunner(wf).run()
    return wf


@pytest.mark.parametrize("eager", [True, False])
def test_eager_epoch_snapshot_resumes_bitwise(tmp_path, eager):
    """The snapshotter fires on the decision's signal, before most
    gradient units have run on the epoch's last minibatch; it exports
    at the end of that loop iteration, so the snapshot after epoch 1
    resumes (eager, or fused) to the uninterrupted eager run."""
    full = _snapshotting_alexnet(tmp_path / "full")
    full.run()
    resumed = _resume(str(tmp_path / "full" / "wf.1.pickle"), eager)
    assert [h["epoch"] for h in resumed.decision.epoch_history] == \
        [0, 1, 2, 3]
    _assert_bitwise(resumed, full)


@pytest.mark.parametrize("eager", [True, False])
def test_stop_boundary_snapshot_resumes_bitwise(tmp_path, eager):
    """A snapshot of an eager run stopped by ``max_epochs`` at 2,
    resumed with 4: the uninterrupted 4 epochs, eager and fused."""
    full = _snapshotting_alexnet(tmp_path / "full")
    full.run()
    half = _snapshotting_alexnet(tmp_path / "half", max_epochs=2)
    half.run()
    path = tmp_path / "stopped.pickle"
    path.write_bytes(dump_workflow(half))
    prng._generators.clear()
    wf = load_workflow(str(path))
    wf.decision.max_epochs = 4
    wf.decision.complete <<= False
    wf.workflow = DummyLauncher()
    wf.initialize(device="cpu")
    if eager:
        wf.run()
    else:
        FusedRunner(wf).run()
    _assert_bitwise(wf, full)


def _console(tmp_path, script, stem):
    path = workflow_file(tmp_path, MNIST_FILE, "veles_tpu_torch", 2, stem)
    result = str(tmp_path / ("%s.json" % stem))
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch", path, "-s", "7", "-a",
         "cpu", "--eager", "-i", "--result-file", result],
        input=script.encode(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=dict(os.environ, PYTHONPATH=REPO),
        timeout=300)
    return proc.returncode, proc.stdout.decode(errors="replace"), result


def test_interactive_session_runs_once(tmp_path):
    """``-i``: the console opens after initialize with the workflow in
    scope; ``main()`` trains; a second ``main()`` warns and does not
    retrain; the results are written once."""
    code, out, result = _console(tmp_path, (
        "print('WF_NAME=' + workflow.name)\n"
        "print('EPOCHS_BEFORE=%d' % len(workflow.decision.epoch_history))\n"
        "main()\n"
        "print('EPOCHS_ONE=%d' % len(workflow.decision.epoch_history))\n"
        "main()\n"
        "print('EPOCHS_TWO=%d' % len(workflow.decision.epoch_history))\n"
        "print('MODE=' + launcher.run_mode_used)\n"), "twice")
    assert code == 0, out[-3000:]
    assert "interactive mode" in out
    assert "WF_NAME=MnistWorkflow" in out
    for line in ("EPOCHS_BEFORE=0", "EPOCHS_ONE=2", "EPOCHS_TWO=2",
                 "MODE=eager", "already ran"):
        assert line in out, out[-3000:]
    assert json.load(open(result))["epochs"] == 2


def test_interactive_exit_runs_and_failure_sets_the_exit_code(tmp_path):
    """Leaving the console without ``main()`` runs the workflow; a
    ``main()`` that fails inside the console makes the process fail."""
    code, out, result = _console(tmp_path, "", "exit")
    assert code == 0, out[-3000:]
    assert json.load(open(result))["epochs"] == 2
    code, out, _ = _console(
        tmp_path, "workflow.run = lambda: 1 / 0\nmain()\n"
        "print('STILL_HERE')\n", "fail")
    assert "STILL_HERE" in out and "ZeroDivisionError" in out
    assert code != 0


GUARD = """
import sys
from veles_tpu_torch.__main__ import main
assert main([sys.argv[1], "-s", "7", "-a", "cpu", "--eager"]) == 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "veles_tpu" or m.startswith("veles_tpu."))
print("LOADED", bad)
"""


def test_an_eager_epoch_loads_no_jax(tmp_path):
    path = workflow_file(tmp_path, ALEXNET_FILE, "veles_tpu_torch", 1,
                         "guard")
    out = subprocess.run(
        [sys.executable, "-c", GUARD, path], env=dict(os.environ,
                                                      PYTHONPATH=REPO),
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def _moe_pair(epochs=2):
    """(JAX workflow, port workflow): a token-sequence classifier with a
    Switch MoE layer whose load-balance loss has weight 0.01, built and
    initialized under the same ``-s 7``."""
    from veles_tpu.loader.fullbatch import ProviderLoader as JaxProvider
    from veles_tpu.standard_workflow import \
        StandardWorkflow as JaxStandard
    from veles_tpu_torch.loader.fullbatch import ProviderLoader
    from veles_tpu_torch.models.samples import SequenceProvider
    from veles_tpu_torch.standard_workflow import StandardWorkflow
    provider = SequenceProvider(n_train=60, n_valid=20, seq=4, dim=8,
                                n_classes=3)
    layers = [{"type": "moe", "n_experts": 4, "aux_loss_weight": 0.01},
              {"type": "softmax", "output_sample_shape": 3}]
    common = dict(layers=layers, loss="softmax", max_epochs=epochs,
                  learning_rate=0.1, momentum=0.9)
    _seed_both()
    jax_wf = JaxStandard(
        JaxDummyLauncher(), loader=lambda w: JaxProvider(
            w, provider=provider, minibatch_size=16, sequence=True),
        **common)
    port_wf = StandardWorkflow(
        DummyLauncher(), loader=lambda w: ProviderLoader(
            workflow=w, provider=provider, minibatch_size=16,
            sequence=True), **common)
    jax_wf.initialize(device=Device(backend="cpu"))
    port_wf.initialize(device="cpu")
    return jax_wf, port_wf


def test_eager_moe_with_aux_loss_trains_as_jax_eager(caplog):
    """An MoE layer with ``aux_loss_weight`` > 0 trains eagerly without
    the auxiliary term, as the JAX package's eager path does (the term
    is the fused loss's alone), and the port says so once: two epochs
    held to JAX's history, parameters and velocity within 1e-6 (5
    training minibatches an epoch, the last a short tail of 12)."""
    jax_wf, port_wf = _moe_pair()
    assert port_wf.forwards[0].module.aux_loss_weight == 0.01
    with caplog.at_level("INFO"):
        _eager_against_jax(jax_wf, port_wf, [])
    noted = [r for r in caplog.records
             if "trains without it" in r.getMessage()]
    assert len(noted) == 1
