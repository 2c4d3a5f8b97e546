"""The port's solvers (``veles_tpu_torch.nn.optim``) against the JAX
package's rules, on the CPU.

A conv layer (4-D weights, HWIO in JAX and OIHW in the port) and a
fully-connected layer take three steps of each rule from the same
weights, on the same gradients, with weight decay and a bias learning
rate of its own (``lr_overrides``); the port updates in place, the JAX
rules return new arrays. The states cross both ways through
``convert``: a JAX state after one step, carried into the port, goes on
to the JAX result.

Tolerances: parameters 1e-6 absolute (weights ~0.3; float32 rounding of
a few operations a step, in the same order on both sides); states 1e-6
relative plus 1e-9 absolute (second moments of ~1e-3 and less; XLA's
and PyTorch's float32 ``sqrt``/``pow`` may round an ulp apart).
"""

import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.nn import optim as jax_optim  # noqa: E402
from veles_tpu_torch.convert import (from_jax_layout,  # noqa: E402
                                     layer_params, params_to_jax,
                                     sgd_state_from_jax, sgd_state_to_jax,
                                     solver_state_from_jax,
                                     solver_state_to_jax)
from veles_tpu_torch.models.build import build_model  # noqa: E402
from veles_tpu_torch.nn import optim  # noqa: E402

LAYERS = [{"type": "conv", "n_kernels": 4, "kx": 3, "ky": 2},
          {"type": "all2all", "output_sample_shape": 5}]
SAMPLE = (5, 6, 3)
HYPERS = {
    "sgd": {"learning_rate": 0.05, "weight_decay": 1e-3, "momentum": 0.9,
            "lr_decay": 0.9, "lr_overrides": {"bias": 0.2}},
    "adagrad": {"learning_rate": 0.05, "weight_decay": 1e-3,
                "lr_overrides": {"bias": 0.2}},
    "adadelta": {"learning_rate": 0.05, "weight_decay": 1e-3, "rho": 0.9,
                 "lr_overrides": {"bias": 0.2}},
    "adam": {"learning_rate": 0.05, "weight_decay": 1e-3,
             "lr_overrides": {"bias": 0.2}},
}
STEPS = 3


def _setup(seed=1):
    """(the port's modules, their JAX parameters, per-step JAX-layout
    gradients)."""
    model = build_model(LAYERS, SAMPLE, seed=seed, device="cpu",
                        trainable=True)
    params = [{k: numpy.array(v) for k, v in layer.items()}
              for layer in params_to_jax(model)]
    rng = numpy.random.RandomState(seed + 1)
    grads = [[{k: rng.randn(*v.shape).astype(numpy.float32)
               for k, v in layer.items()} for layer in params]
             for _ in range(STEPS)]
    return list(model), params, grads


def _jax_steps(rule, params, grads, hp, states=None, first=0):
    states = states or [rule.init({k: jnp.asarray(v) for k, v in p.items()})
                        for p in params]
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in params]
    for step in grads[first:]:
        out = [rule.update(p, {k: jnp.asarray(v) for k, v in g.items()}, s,
                           hp) for p, g, s in zip(params, step, states)]
        params = [o[0] for o in out]
        states = [o[1] for o in out]
    return params, states


def _port_steps(rule, modules, grads, hp, states=None, first=0):
    params = [layer_params(m) for m in modules]
    states = states or [rule.init(p) for p in params]
    for step in grads[first:]:
        for m, p, g, s in zip(modules, params, step, states):
            rule.update(p, from_jax_layout(m, g, p), s, hp)
    return states


def _assert_states_close(got, want):
    for mine, ref in zip(got, want):
        assert sorted(mine) == sorted(ref)
        for key, value in ref.items():
            if isinstance(value, dict):
                for k in value:
                    numpy.testing.assert_allclose(
                        mine[key][k], numpy.asarray(value[k]), rtol=1e-6,
                        atol=1e-9)
            else:
                assert mine[key].dtype == numpy.float32
                assert float(mine[key]) == float(value)


def _assert_params_close(modules, want):
    for got, ref in zip(params_to_jax(modules), want):
        for k in ref:
            numpy.testing.assert_allclose(got[k], numpy.asarray(ref[k]),
                                          atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(HYPERS))
def test_three_steps_match_jax(name):
    modules, params, grads = _setup()
    hp = HYPERS[name]
    want_params, want_states = _jax_steps(jax_optim.get_solver(name),
                                          params, grads, hp)
    before = [dict(layer_params(m)) for m in modules]
    states = _port_steps(optim.get_solver(name), modules, grads, hp)
    _assert_params_close(modules, want_params)
    _assert_states_close(solver_state_to_jax(states), want_states)
    # updated in place: the same parameter objects, moved
    for m, old in zip(modules, before):
        for k, p in layer_params(m).items():
            assert p is old[k]
    moved = numpy.abs(params_to_jax(modules)[1]["weights"] -
                      params[1]["weights"]).max()
    assert moved > 1e-3


@pytest.mark.parametrize("name", sorted(HYPERS))
def test_the_bias_rate_and_the_weight_decay_take_effect(name):
    """Controls on the same steps: with another weight decay, or without
    ``lr_overrides`` (where the rule has a rate), the parameters leave the
    JAX result's tolerance, so the match above sees both."""
    hp = HYPERS[name]
    controls = [dict(hp, weight_decay=0.5)]
    if name != "adadelta":  # AdaDelta takes no learning rate
        controls.append({k: v for k, v in hp.items()
                         if k != "lr_overrides"})
    for changed in controls:
        modules, params, grads = _setup()
        want_params, _ = _jax_steps(jax_optim.get_solver(name), params,
                                    grads, hp)
        _port_steps(optim.get_solver(name), modules, grads, changed)
        worst = max(float(numpy.abs(got[k] - numpy.asarray(ref[k])).max())
                    for got, ref in zip(params_to_jax(modules), want_params)
                    for k in ref)
        assert worst > 1e-5, changed


@pytest.mark.parametrize("name", sorted(HYPERS))
def test_states_cross_both_ways(name):
    """A JAX state after one step, carried into the port, takes the
    port to the JAX result after three; the port's state goes to the
    JAX layout and back bit for bit."""
    modules, params, grads = _setup(seed=4)
    hp = HYPERS[name]
    rule = jax_optim.get_solver(name)
    mid_params, mid_states = _jax_steps(rule, params, grads[:1], hp)
    want_params, _ = _jax_steps(rule, mid_params, grads, hp,
                                states=mid_states, first=1)
    for m, p in zip(modules, mid_params):
        with torch.no_grad():
            for k, v in from_jax_layout(m, {k: numpy.asarray(v) for k, v in
                                            p.items()},
                                        layer_params(m)).items():
                getattr(m, k).copy_(v)
    carried = solver_state_from_jax(modules, [
        {key: {k: numpy.asarray(v) for k, v in value.items()}
         if isinstance(value, dict) else numpy.asarray(value)
         for key, value in state.items()} for state in mid_states])
    states = _port_steps(optim.get_solver(name), modules, grads, hp,
                         states=carried, first=1)
    _assert_params_close(modules, want_params)
    back = solver_state_from_jax(modules, solver_state_to_jax(states))
    for mine, theirs in zip(states, back):
        for key, value in mine.items():
            if isinstance(value, dict):
                for k in value:
                    assert torch.equal(value[k], theirs[key][k])
            else:
                assert torch.equal(value, theirs[key])


def test_sgd_state_names_stay():
    assert sgd_state_to_jax is solver_state_to_jax
    assert sgd_state_from_jax is solver_state_from_jax


def test_get_solver_takes_a_name_or_a_rule():
    for name in ("sgd", "adagrad", "adadelta", "adam"):
        rule = optim.get_solver(name)
        assert rule.name == name and optim.get_solver(rule) is rule
        assert sorted(rule.init({"w": torch.zeros(2)})) == sorted(
            jax_optim.get_solver(name).init({"w": jnp.zeros(2)}))
    with pytest.raises(ValueError):
        optim.get_solver(jax_optim.Adam)
