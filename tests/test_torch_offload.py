"""The port's offloaded model state, on the CPU.

* Planning equals the JAX package's on the same inputs and knobs:
  ``OffloadPlan.build``, ``plan_offload``, ``group_budget_bytes`` and
  ``model_layer_bytes`` of the same model (``_STATE_FACTORS`` per
  solver).
* The offloaded walk of the small AlexNet (forward through groups
  0..G-2, then each group rematerialized from its saved input, its
  gradients by ``autograd.grad`` given the one handed down, the solver
  on its staged copies, the copy back into the host masters) equals the
  in-core run bit for bit over two epochs: losses, confusion,
  parameters, velocity, and the gradient norms (``tests/test_offload.py``
  holds JAX's to rtol 1e-5; the port's per-tensor norms stack in the
  in-core order and are equal), at depth 2 and 0, one or two workers,
  a short tail and one group a layer.
* A streamed dataset wins over offload; an upload's exception reaches
  the step loop; the masters of an offloaded run continue in-core and
  the other way round; ``FusedRunner`` end to end with the epoch's
  upload wait and overlap; and two epochs against JAX's offloaded
  ``FusedTrainer`` (the tolerances of ``tests/test_torch_train.py``).
"""

import threading

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.train import offload as jax_offload  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.models.alexnet import (ALEXNET_TRAINING,  # noqa: E402
                                            SyntheticImageLoader,
                                            small_alexnet_layers)
from veles_tpu_torch.models.build import build_training  # noqa: E402
from veles_tpu_torch.train import offload  # noqa: E402

from test_torch_prefetch import LOADER, _assert_bitwise  # noqa: E402


def _threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("veles-prefetch", "veles-offload"))]


@pytest.fixture(autouse=True)
def _no_threads_left():
    yield
    offload.shutdown_all()
    assert not _threads()


def _trainer(n_train=72, loader=None, seed=1, **residency):
    if loader is None:
        prng.get().seed(3)
        prng.get("loader").seed(4)
        loader = SyntheticImageLoader(**dict(LOADER, n_train=n_train))
    return build_training(small_alexnet_layers(10), (32, 32, 3), loader,
                          seed=seed, device="cpu",
                          **dict(ALEXNET_TRAINING, **residency))


def _run(trainer, epochs=2, first=0):
    history = [trainer.run_epoch(e) for e in range(first, first + epochs)]
    trainer.shutdown()
    return history


# -- planning -----------------------------------------------------------------


@pytest.mark.parametrize("layer_bytes,budget", [
    ([10, 10, 10], 25), ([30, 4, 4], 9), ([1, 2], 100), ([0, 5, 0, 0, 7], 6),
    ([302, 0, 134, 0, 33], 150), ([8], 1)])
def test_plan_build_equals_jax(layer_bytes, budget):
    got = offload.OffloadPlan.build(layer_bytes, budget)
    want = jax_offload.OffloadPlan.build(layer_bytes, budget)
    assert got.groups == want.groups
    assert got.group_bytes == want.group_bytes
    assert got.total_bytes == want.total_bytes
    assert got.n_groups == want.n_groups


@pytest.mark.parametrize("env", [
    {}, {"VELES_DEVICE_BUDGET_MB": "1"}, {"VELES_OFFLOAD": "0",
                                          "VELES_DEVICE_BUDGET_MB": "1"},
    {"VELES_OFFLOAD": "1"}, {"VELES_OFFLOAD": "on"},
    {"VELES_OFFLOAD_GROUP_MB": "3"}, {"VELES_DEVICE_BUDGET_MB": "40"},
    {"VELES_DEVICE_BUDGET_MB": "40", "VELES_OFFLOAD_DEPTH": "0"},
    {"VELES_OFFLOAD_GROUP_MB": "junk", "VELES_DEVICE_BUDGET_MB": "8"},
])
def test_offload_planning_equals_jax(monkeypatch, env):
    for name in ("VELES_OFFLOAD", "VELES_DEVICE_BUDGET_MB",
                 "VELES_OFFLOAD_GROUP_MB", "VELES_OFFLOAD_DEPTH"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for nbytes in (10.0, 0.5e6, 2e6, 1e15):
        for force in (None, True, False):
            assert offload.plan_offload(nbytes, "cpu", force) == \
                jax_offload.plan_offload(nbytes, force=force)
    for depth in (None, 0, 2, 5):
        assert offload.group_budget_bytes("cpu", depth) == \
            jax_offload.group_budget_bytes(depth=depth)
    assert offload.offload_depth() == jax_offload.offload_depth()
    assert offload.offload_workers() == jax_offload.offload_workers()


@pytest.mark.parametrize("solver", ["sgd", "adagrad", "adadelta", "adam"])
def test_model_layer_bytes_equal_jax(solver):
    from test_torch_train import _jax_trainer, _port_trainer
    jt = _jax_trainer(stage_s2d=False, solver=solver)
    pt = _port_trainer(jt, solver=solver)
    want = jax_offload.model_layer_bytes(jt.forwards, jt.solvers)
    got = offload.model_layer_bytes(
        pt.forwards, [pt.solver if p else None for p in pt.params])
    assert got == want and sum(got) > 0


# -- the offloaded walk -------------------------------------------------------


@pytest.mark.parametrize("depth,workers,group_mb,n_train", [
    (2, 2, "0.05", 72), (0, 1, "0.05", 72), (2, 1, "0.0001", 72),
    (3, 2, "0.05", 70)],
    ids=["depth2", "depth0", "a_group_a_layer", "short_tail"])
def test_offloaded_equals_incore_bitwise(monkeypatch, depth, workers,
                                         group_mb, n_train):
    monkeypatch.setenv("VELES_OFFLOAD_GROUP_MB", group_mb)
    incore = _trainer(n_train)
    want = _run(incore)
    trainer = _trainer(n_train, offload=True, offload_depth=depth,
                       offload_workers=workers)
    engine = trainer._offload_engine
    assert trainer.offloaded and engine.plan.n_groups >= 2
    if group_mb == "0.0001":
        assert engine.plan.groups == [(i, i + 1) for i in range(7)]
    got = _run(trainer)
    _assert_bitwise(trainer, incore, got, want)
    numpy.testing.assert_allclose(trainer.last_grad_norms.numpy(),
                                  incore.last_grad_norms.numpy(), rtol=1e-5)
    assert trainer.offload_wait_s > 0
    assert set(engine.overlap) == {"train", "eval"}
    assert engine.h2d_ms and engine.d2h_ms
    # the writebacks landed in the host masters the model holds
    for params in trainer.params:
        for p in params.values():
            assert p.device.type == "cpu"


def test_streamed_dataset_wins_over_offload(monkeypatch):
    monkeypatch.setenv("VELES_OFFLOAD", "1")
    monkeypatch.setenv("VELES_SHARD_MB", "0.1")
    trainer = _trainer(stream=True)
    assert trainer.streaming and not trainer.offloaded
    assert trainer._offload_engine is None and trainer.offload_wait_s == 0
    trainer.shutdown()
    monkeypatch.setenv("VELES_OFFLOAD", "0")
    monkeypatch.setenv("VELES_DEVICE_BUDGET_MB", "0.000001")
    monkeypatch.setenv("VELES_STREAM", "0")
    trainer = _trainer()
    assert not trainer.offloaded and not trainer.streaming
    trainer.shutdown()


def test_an_upload_exception_reaches_the_step_loop(monkeypatch):
    monkeypatch.setenv("VELES_OFFLOAD_GROUP_MB", "0.05")
    trainer = _trainer(offload=True)
    calls = [0]
    real = offload.OffloadEngine._masters

    def broken(self, g, with_states):
        calls[0] += 1
        if calls[0] >= 5:
            raise RuntimeError("host memory fell over")
        return real(self, g, with_states)

    monkeypatch.setattr(offload.OffloadEngine, "_masters", broken)
    with pytest.raises(RuntimeError, match="host memory fell over"):
        trainer.train_class()
    assert not _threads()
    trainer.shutdown()


@pytest.mark.parametrize("first,then", [(True, False), (False, True)],
                         ids=["offloaded_then_incore",
                              "incore_then_offloaded"])
def test_masters_continue_across_residencies(monkeypatch, first, then):
    """Epoch 0 in one residency, its parameters and solver state (as
    ``pull_params`` gives them) pushed into a trainer of the other, which
    runs epoch 1 over the same loader: equal to two in-core epochs."""
    monkeypatch.setenv("VELES_OFFLOAD_GROUP_MB", "0.05")
    reference = _trainer()
    want = _run(reference)
    a = _trainer(offload=first)
    history = _run(a, 1)
    params, states = a.pull_params()
    b = _trainer(loader=a.loader, seed=99, offload=then)
    assert b.offloaded == then
    b.push_params(params, states)
    history += _run(b, 1, first=1)
    _assert_bitwise(b, reference, history, want)


def test_offloaded_runner_end_to_end(monkeypatch):
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.alexnet import AlexNetWorkflow
    from veles_tpu_torch.train.runner import FusedRunner

    def run():
        prng.get().seed(3)
        prng.get("loader").seed(4)
        wf = AlexNetWorkflow(
            DummyLauncher(), layers=small_alexnet_layers(10),
            loader_factory=lambda w: SyntheticImageLoader(workflow=w,
                                                          **LOADER),
            max_epochs=2)
        wf.initialize(device="cpu")
        runner = FusedRunner(wf)
        runner.run()
        return wf, runner

    incore, _ = run()
    monkeypatch.setenv("VELES_OFFLOAD", "1")
    monkeypatch.setenv("VELES_OFFLOAD_GROUP_MB", "0.05")
    offloaded, runner = run()
    assert runner.trainer.offloaded
    assert offloaded.decision.epoch_history == \
        incore.decision.epoch_history
    for times in runner.epoch_times:
        assert times["offload_wait_s"] > 0
        assert 0 <= times["offload_overlap"] <= 1
    for fa, fb in zip(offloaded.forwards, incore.forwards):
        for k, p in fa.module.named_parameters():
            assert torch.equal(p, dict(fb.module.named_parameters())[k])
    assert not _threads()


def test_offloaded_matches_jax_offloaded_trainer(monkeypatch):
    from veles_tpu.train import FusedTrainer as JaxFusedTrainer
    from test_torch_train import (_assert_runs_match, _jax_trainer,
                                  _port_trainer, _run_both)
    monkeypatch.setenv("VELES_OFFLOAD_GROUP_MB", "0.01")
    jt = _jax_trainer(stage_s2d=False)
    jt = JaxFusedTrainer(jt.workflow, offload=True)
    assert jt.offloaded
    pt = _port_trainer(jt, offload=True)
    assert pt.offloaded
    assert pt._offload_engine.plan.groups == jt._offload_engine.plan.groups
    _assert_runs_match(*_run_both(jt, pt), pt)
    jt.shutdown()
    pt.shutdown()


def test_out_of_core_epochs_import_neither_jax_nor_the_jax_package():
    """A streamed and an offloaded training epoch in a fresh interpreter
    load neither jax nor any veles_tpu module."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, math\n"
        "from veles_tpu_torch.models.alexnet import (SyntheticImageLoader,\n"
        "    small_alexnet_layers)\n"
        "from veles_tpu_torch.models.build import build_training\n"
        "for kw in ({'stream': True}, {'offload': True}):\n"
        "    loader = SyntheticImageLoader(n_train=40, n_valid=16, side=32,\n"
        "                                  n_classes=10, minibatch_size=8)\n"
        "    t = build_training(small_alexnet_layers(10), (32, 32, 3),\n"
        "                       loader, seed=0, device='cpu', momentum=0.9,\n"
        "                       **kw)\n"
        "    assert t.streaming or t.offloaded\n"
        "    assert math.isfinite(t.run_epoch(0)['train']['loss'])\n"
        "    t.shutdown()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'veles_tpu' or "
        "k.startswith('veles_tpu.') or k == 'ml_dtypes')\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=repo, VELES_SHARD_MB="0.1",
               VELES_OFFLOAD_GROUP_MB="0.05", VELES_DATASET_CACHE="0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


@pytest.mark.parametrize("first,then", [("1", "0"), ("0", "1")],
                         ids=["offloaded_snapshot_incore",
                              "incore_snapshot_offloaded"])
def test_workflow_snapshots_resume_across_residencies(tmp_path, monkeypatch,
                                                      first, then):
    """``FusedRunner`` with a ``SnapshotterToFile`` each epoch: the
    snapshot after epoch 1 of an offloaded run resumes in-core (and the
    other way round) to the uninterrupted in-core run bit for bit."""
    from veles_tpu_torch.train.runner import FusedRunner
    from test_torch_eager import (_assert_bitwise as _assert_same_run,
                                  _resume, _snapshotting_alexnet)
    monkeypatch.setenv("VELES_OFFLOAD_GROUP_MB", "0.05")
    monkeypatch.setenv("VELES_OFFLOAD", "0")
    full = _snapshotting_alexnet(tmp_path / "full")
    FusedRunner(full).run()
    monkeypatch.setenv("VELES_OFFLOAD", first)
    cut = _snapshotting_alexnet(tmp_path / "cut", max_epochs=2)
    runner = FusedRunner(cut)
    runner.run()
    assert runner.trainer.offloaded == (first == "1")
    monkeypatch.setenv("VELES_OFFLOAD", then)
    resumed = _resume(str(tmp_path / "cut" / "wf.1.pickle"), eager=False)
    resumed.decision.max_epochs = 4
    resumed.decision.complete <<= False
    runner = FusedRunner(resumed)
    runner.run()
    assert runner.trainer.offloaded == (then == "1")
    _assert_same_run(resumed, full)
