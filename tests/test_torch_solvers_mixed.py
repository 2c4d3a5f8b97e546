"""A workflow whose layers use different solvers, trained by the port's
fused step against the JAX package's, on the CPU.

The model is mnist-fc (``MNIST_LAYERS``: a 100-unit tanh layer and the
softmax head) with the first layer on SGD and the head on Adam, at
``tests/test_torch_models.py``'s sizes and tolerances (losses 1e-5
absolute; the SGD layer's parameters and velocity 1e-6 absolute; the
Adam head's within that file's Adam bound). Built as the JAX package
builds it: a ``StandardWorkflow`` whose head gradient unit takes
``solver_name = "adam"`` before ``initialize()`` (the JAX
``FusedTrainer`` keeps one solver per layer).

* Two epochs of the port's ``FusedTrainer`` (one rule per layer)
  against the JAX ``FusedTrainer``: losses, metrics, gradient norms,
  parameters and every layer's solver state.
* The port's workflow with the same solvers runs fused:
  ``fused_compatible`` returns None, ``trainer_for`` gives each layer its
  gradient unit's rule, and the launcher's run mode is ``fused``.
* The launcher's ``--gspmd 1x1`` route takes it too, each layer on its
  solver, bit for bit the fused run.
* A JAX snapshot of the mixed workflow after one epoch (JAX's fused
  runner) continues one more epoch under the port's ``FusedRunner`` as
  under JAX's: the same history, parameters within the same bounds.
"""

import numpy
import pytest

torch = pytest.importorskip("torch")

from test_torch_models import (DIGITS, LOADER_SEED, MINIBATCH,  # noqa: E402
                               WEIGHT_SEED, _assert_close, _jax_epochs,
                               _seed_jax)

from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher  # noqa: E402
from veles_tpu.models import mnist as jax_mnist  # noqa: E402
from veles_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow  # noqa: E402
from veles_tpu.train import FusedTrainer as JaxFusedTrainer  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.convert import (params_to_jax,  # noqa: E402
                                     solver_state_to_jax)
from veles_tpu_torch.models.build import build_training  # noqa: E402
from veles_tpu_torch.models.mnist import (MNIST_LAYERS,  # noqa: E402
                                          MNIST_SAMPLE_SHAPE, MnistLoader)
from veles_tpu_torch.train.runner import (FusedRunner,  # noqa: E402
                                          fused_compatible, trainer_for)

#: the layers' solvers, in forward order
SOLVERS = ["sgd", "adam"]
HYPER = dict(learning_rate=0.01, weights_decay=1e-3)


def _head_gd(wf):
    return next(gd for gd in wf.gds if gd.forward is wf.forwards[-1])


def _jax_mixed(max_epochs=None):
    wf = JaxStandardWorkflow(
        JaxDummyLauncher(), loader=lambda w: jax_mnist.MnistLoader(
            w, provider=DIGITS, minibatch_size=MINIBATCH),
        layers=MNIST_LAYERS, loss="softmax", max_epochs=max_epochs, **HYPER)
    _head_gd(wf).solver_name = SOLVERS[-1]
    return wf


def _port_mixed(launcher=None):
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.standard_workflow import StandardWorkflow
    wf = StandardWorkflow(
        launcher or DummyLauncher(), loader=lambda w: MnistLoader(
            workflow=w, provider=DIGITS, minibatch_size=MINIBATCH),
        layers=MNIST_LAYERS, loss="softmax", max_epochs=2, **HYPER)
    _head_gd(wf).solver_name = SOLVERS[-1]
    return wf


def _assert_layers(rules, got_params, want_params, got_states,
                   want_states):
    for rule, got, want in zip(rules, got_params, want_params):
        for k in want:
            _assert_close(got[k], want[k], rule.name == "adam")
    for rule, got, want in zip(rules, got_states, want_states):
        for key, value in want.items():
            if isinstance(value, dict):
                for k in value:
                    _assert_close(got[key][k], value[k], rule.name == "adam")
            else:
                assert float(got[key]) == float(value)


def test_two_epochs_match_the_jax_fused_trainer():
    _seed_jax()
    wf = _jax_mixed()
    wf.initialize(device=Device(backend="cpu"))
    jt = JaxFusedTrainer(wf)
    assert [s.name for s in jt.solvers] == SOLVERS
    params, _ = jt.pull_params()
    prng.get().seed(WEIGHT_SEED)
    prng.get("loader").seed(LOADER_SEED)
    pt = build_training(
        MNIST_LAYERS, MNIST_SAMPLE_SHAPE,
        MnistLoader(provider=DIGITS, minibatch_size=MINIBATCH),
        params=[{k: numpy.asarray(v) for k, v in p.items()} for p in params],
        device="cpu", solver=SOLVERS, **HYPER)
    assert [rule.name for rule in pt.solvers] == SOLVERS
    assert pt.solver is None
    assert sorted(pt.states[0]) == ["step", "velocity"]
    assert sorted(pt.states[1]) == ["m", "t", "v"]
    params, states, jax_epochs = _jax_epochs(jt)
    for epoch, (valid, train, norms) in enumerate(jax_epochs):
        stats = pt.run_epoch(epoch)
        numpy.testing.assert_allclose(stats["validation"]["losses"],
                                      numpy.asarray(valid[0]), atol=1e-5,
                                      rtol=0)
        numpy.testing.assert_allclose(stats["train"]["losses"],
                                      numpy.asarray(train[0]), atol=1e-5,
                                      rtol=0)
        assert stats["train"]["metric"] == float(numpy.sum(train[1]))
        numpy.testing.assert_array_equal(stats["validation"]["confusion"],
                                         numpy.asarray(valid[2]))
        numpy.testing.assert_allclose(pt.last_grad_norms.numpy(), norms,
                                      rtol=1e-5, atol=0)
    _assert_layers(pt.solvers, params_to_jax(pt.model), params,
                   solver_state_to_jax(pt.states), states)
    assert float(pt.states[1]["t"]) == 6.0


def test_the_port_workflow_runs_fused():
    from veles_tpu_torch.launcher import Launcher
    prng.get().seed(WEIGHT_SEED)
    prng.get("loader").seed(LOADER_SEED)
    wf = _port_mixed()
    wf.initialize(device="cpu")
    assert fused_compatible(wf) is None
    trainer = trainer_for(wf)
    assert [rule.name for rule in trainer.solvers] == SOLVERS
    head = _head_gd(wf)
    assert trainer.states[-1] is head.opt_state
    launcher = Launcher(backend="cpu", graphics=False)
    _port_mixed(launcher)
    launcher.initialize()
    launcher.run()
    assert launcher.run_mode_used == "fused"
    assert len(launcher.workflow.decision.epoch_history) == 2


def test_gspmd_route_takes_the_mixed_workflow():
    from veles_tpu_torch.convert import layer_params
    from veles_tpu_torch.launcher import Launcher
    params = {}
    for gspmd in (None, "1x1"):
        prng.get().seed(WEIGHT_SEED)
        prng.get("loader").seed(LOADER_SEED)
        launcher = Launcher(backend="cpu", graphics=False, gspmd=gspmd)
        wf = _port_mixed(launcher)
        launcher.initialize()
        launcher.run()
        assert launcher.run_mode_used == (gspmd and "gspmd" or "fused")
        assert [rule.name for rule in launcher.runner.trainer.solvers] == \
            SOLVERS
        params[gspmd] = [layer_params(f.module) for f in wf.forwards]
    for got, want in zip(params["1x1"], params[None]):
        for k in want:
            assert torch.equal(got[k], want[k])


def test_jax_snapshot_continues_fused():
    from veles_tpu.snapshotter import dump_workflow as jax_dump
    from veles_tpu.snapshotter import load_workflow as jax_load
    from veles_tpu.train import FusedRunner as JaxFusedRunner
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.snapshotter import load_workflow
    _seed_jax()
    jax_wf = _jax_mixed(max_epochs=1)
    jax_wf.initialize(device=Device(backend="cpu"))
    JaxFusedRunner(jax_wf).run()
    jax_wf.decision.max_epochs = 2
    jax_wf.decision.complete.value = False
    blob = jax_dump(jax_wf)

    prng._generators.clear()
    got = load_workflow(blob)
    assert [gd.solver_name for gd in reversed(got.gds)] == SOLVERS
    got.workflow = DummyLauncher()
    got.initialize(device="cpu")
    assert fused_compatible(got) is None
    runner = FusedRunner(got)
    assert [rule.name for rule in runner.trainer.solvers] == SOLVERS
    runner.run()

    want = jax_load(blob)
    want.workflow = JaxDummyLauncher()
    want.initialize(device=Device(backend="cpu"))
    JaxFusedRunner(want).run()
    assert got.decision.epoch_history == want.decision.epoch_history
    assert len(got.decision.epoch_history) == 2
    jax_gds = {id(gd.forward): gd for gd in want.gds}
    _assert_layers(
        runner.trainer.solvers, params_to_jax(got.model),
        [{k: numpy.asarray(v.map_read()) for k, v in
          fwd.param_arrays().items()} for fwd in want.forwards],
        solver_state_to_jax(runner.trainer.states),
        [jax_gds[id(fwd)].opt_state for fwd in want.forwards])
