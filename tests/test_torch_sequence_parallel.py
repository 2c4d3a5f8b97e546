"""The port's sequence- and expert-parallel plans against the JAX
package's, on the CPU.

Two worlds of ranks (``tests/torch_world.py`` ``run_world``: gloo
over a file store under the test's temporary directory, one wall limit
of ``WORLD_S`` seconds each), of 2 and of 4 ranks, run every case
(``tests/torch_seq_ranks.py``); the JAX package runs the same inputs on
meshes of the same sizes over the 8 virtual CPU devices.

* ``ring_attention`` and ``ulysses_attention``, causal and not, at 2 and
  4 ranks: the output and the gradients of q, k and v against JAX's
  sharded functions and against ``local_attention``, within ``ATOL``
  (the ring's streaming softmax adds in another order; read ~5e-7);
* the attention layer with ``use_ring`` (ring and Ulysses) and the moe
  layer with ``use_experts``: output, parameter and input gradients
  against the JAX units with the same plans attached (gradients within
  ``GRAD_SHARE`` of each tensor's norm);
* ``moe_ffn`` at 4 ranks and 4 experts, capacity factor 1.0 so tokens
  drop: output and the gradients of the tokens, the router and the
  experts against JAX's ``moe_ffn``;
* ``samples.sequence`` trained two epochs with the plans attached: with
  ``use_ring`` against the JAX ``FusedTrainer`` (the ring changes the
  plan, not the numbers), with ``use_experts`` (whose capacity pools per
  rank's shard of the batch's tokens) against the port's single process
  running that per-shard routing (``moe_ffn_reference``); losses within
  ``LOSS_ATOL``, parameters within ``PARAM_ATOL``;
* the controls that must fail: each attention case with a sharded
  backward that drops a term (``torch_seq_ranks.dropped_term``: the
  reverse ring's dK/dV carry, Ulysses's other ranks' parts) must miss
  the gradients by more than ``ATOL``, and ``moe_ffn`` without the sum
  of the router's gradient over the ranks must miss it by more than
  ``GRAD_SHARE``.
"""

import pickle
import types

import jax
import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

import torch_seq_ranks as ranks  # noqa: E402
from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher, DummyWorkflow  # noqa: E402
from veles_tpu.loader.base import VALIDATION  # noqa: E402
from veles_tpu.models import samples as jax_samples  # noqa: E402
from veles_tpu.nn.attention import \
    MultiHeadAttentionForward as JaxAttention  # noqa: E402
from veles_tpu.nn.moe import MoEForward as JaxMoE  # noqa: E402
from veles_tpu.parallel import ep as jax_ep  # noqa: E402
from veles_tpu.parallel import sequence as jax_sequence  # noqa: E402
from veles_tpu.parallel.mesh import build_mesh as jax_mesh  # noqa: E402
from veles_tpu.train import FusedTrainer as JaxFusedTrainer  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.convert import params_to_jax  # noqa: E402
from veles_tpu_torch.models import samples  # noqa: E402
from veles_tpu_torch.models.build import (build_model,  # noqa: E402
                                          build_training)
from veles_tpu_torch.nn.moe import MoEForward  # noqa: E402
from veles_tpu_torch.parallel import mesh  # noqa: E402
from veles_tpu_torch.parallel.ep import moe_ffn_reference  # noqa: E402
from veles_tpu_torch.parallel.sequence import (local_attention,  # noqa
                                               ulysses_attention)
from torch_world import run_world  # noqa: E402

WORLD_S = 120.0
ATOL = 2e-5
GRAD_SHARE = 1e-5
LOSS_ATOL = 1e-5
PARAM_ATOL = 1e-5
RNG = numpy.random.RandomState(23)
B, H, S, D = 2, 4, 16, 8
UNIT_SHAPE = (16, 16)   # (seq, dim) of the unit cases
QKV = [RNG.randn(B, H, S, D).astype(numpy.float32) for _ in range(4)]
ATTENTION = [("%s causal=%s" % (schedule, causal),
              tuple(QKV) + (causal, schedule))
             for schedule in ("ring", "ulysses") for causal in (False, True)]
#: the same cases with a sharded backward that drops a term
#: (``torch_seq_ranks.dropped_term``): the controls that must fail
CONTROLS = [(name + " control", args + (True,)) for name, args in ATTENTION]
MOE_X = RNG.randn(32, 8).astype(numpy.float32)
MOE_X[:, 0] = 2.0   # crowd the tokens onto few experts: some drop
MOE_ROUTER = (RNG.randn(8, 4) * 0.5).astype(numpy.float32)
MOE_ROUTER[0, 0] = 1.5
MOE_UP = (RNG.randn(4, 8, 16) * 0.3).astype(numpy.float32)
MOE_DOWN = (RNG.randn(4, 16, 8) * 0.3).astype(numpy.float32)
MOE_G = RNG.randn(32, 8).astype(numpy.float32)


def _jax_unit(cls, x_shape, seed, **kwargs):
    jax_prng._generators.clear()
    jax_prng.get().seed(seed)
    unit = cls(DummyWorkflow(), **kwargs)
    unit.input = numpy.zeros(x_shape, numpy.float32)
    unit.initialize(device=Device(backend="cpu"))
    return unit, {k: numpy.array(v.mem) for k, v in
                  unit.param_arrays().items()}


def _jax_workflow_params(moe):
    jax_prng.get().seed(ranks.WEIGHT_SEED)
    jax_prng.get("loader").seed(ranks.LOADER_SEED)
    wf = jax_samples.SequenceWorkflow(
        DummyLauncher(), provider=jax_samples.SequenceProvider(
            **ranks.PROVIDER), minibatch_size=16, heads=4, moe=moe,
        n_experts=4)
    wf.initialize(device=Device(backend="cpu"))
    jt = JaxFusedTrainer(wf)
    params, _ = jt.pull_params()
    return jt, [{k: numpy.asarray(v) for k, v in p.items()} for p in params]


@pytest.fixture(scope="module")
def units():
    rng = numpy.random.RandomState(3)
    attention, a_params = _jax_unit(JaxAttention, (4,) + UNIT_SHAPE, 77,
                                    heads=4, causal=True, name="mha")
    x = rng.randn(3, *UNIT_SHAPE).astype(numpy.float32)
    moe_x = rng.randn(4, 8, 8).astype(numpy.float32)
    moe_x[..., 0] = 2.0
    moe, m_params = _jax_unit(JaxMoE, moe_x.shape, 78, n_experts=4,
                              hidden=16, capacity_factor=1.0)
    m_params["weights"][0, 0] = 1.5
    return {"attention": (attention, a_params, x,
                          rng.randn(*x.shape).astype(numpy.float32)),
            "moe": (moe, m_params, moe_x,
                    rng.randn(*moe_x.shape).astype(numpy.float32))}


ATTENTION_LAYER = {"type": "attention", "heads": 4, "causal": True}
MOE_LAYER = {"type": "moe", "n_experts": 4, "hidden": 16,
             "capacity_factor": 1.0}


@pytest.fixture(scope="module")
def workflow_params():
    return {moe: _jax_workflow_params(moe)[1] for moe in (False, True)}


@pytest.fixture(scope="module")
def world2(units, workflow_params, tmp_path_factory):
    _, params, x, g = units["attention"]
    unit_cases = [(s, (ATTENTION_LAYER, params, UNIT_SHAPE, x, g),
                   {"schedule": s}) for s in ("ring", "ulysses")]
    workflows = [(s, (False, workflow_params[False], s))
                 for s in ("ring", "ulysses")]
    return run_world(ranks.sequence_world, 2,
                     (ATTENTION + CONTROLS, unit_cases, workflows),
                     timeout=WORLD_S,
                     workdir=str(tmp_path_factory.mktemp("world2")))


@pytest.fixture(scope="module")
def world4(units, workflow_params, tmp_path_factory):
    _, params, x, g = units["moe"]
    unit_cases = [("experts", (MOE_LAYER, params, x.shape[1:], x, g),
                   {"experts": True})]
    workflows = [("moe", (True, workflow_params[True], "ring"))]
    moe = (MOE_X, MOE_ROUTER, MOE_UP, MOE_DOWN, MOE_G, 1.0)
    return run_world(ranks.sequence_world, 4,
                     (ATTENTION + CONTROLS, unit_cases, workflows, moe),
                     timeout=WORLD_S,
                     workdir=str(tmp_path_factory.mktemp("world4")))


def _world(request, n):
    return request.getfixturevalue("world%d" % n)


def _jax_vjp(fn, args, cotangent):
    """(fn(*args), the gradients of sum(fn(*args) * cotangent)), one
    jitted trace."""
    def both(*args):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(jnp.asarray(cotangent))
    return jax.jit(both)(*args)


def _grad_close(got, want, share=GRAD_SHARE):
    want = numpy.asarray(want, numpy.float64)
    assert numpy.linalg.norm(got - want) <= share * max(
        numpy.linalg.norm(want), 1e-30)


# -- the attention functions ---------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", [c[0] for c in ATTENTION])
def test_attention_matches_jax_and_local(request, n, name):
    q, k, v, g, causal, schedule = dict(ATTENTION)[name]
    fn = jax_sequence.ring_attention if schedule == "ring" \
        else jax_sequence.ulysses_attention
    jm = jax_mesh({"seq": n}, devices=jax.devices()[:n])
    want_out, want_grads = _jax_vjp(
        lambda q, k, v: fn(q, k, v, jm, causal=causal), (q, k, v), g)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    local = local_attention(tq, tk, tv, causal=causal)
    (local * torch.from_numpy(g)).sum().backward()
    for report in _world(request, n):
        out, dq, dk, dv = report["value"]["attention"][name]
        numpy.testing.assert_allclose(out, numpy.asarray(want_out),
                                      atol=ATOL, rtol=0)
        numpy.testing.assert_allclose(out, local.detach().numpy(),
                                      atol=ATOL, rtol=0)
        for got, jax_grad, port_grad in zip((dq, dk, dv), want_grads,
                                            (tq.grad, tk.grad, tv.grad)):
            numpy.testing.assert_allclose(got, numpy.asarray(jax_grad),
                                          atol=ATOL, rtol=0)
            numpy.testing.assert_allclose(got, port_grad.numpy(),
                                          atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", [c[0] for c in ATTENTION])
def test_attention_control_that_drops_a_term_fails(request, n, name):
    """The reverse ring without its dK/dV carry, or Ulysses's inverse
    all_to_all without the other ranks' parts: the forward still
    matches, the gradients must not."""
    q, k, v, g, causal, schedule = dict(ATTENTION)[name]
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    local = local_attention(tq, tk, tv, causal=causal)
    (local * torch.from_numpy(g)).sum().backward()
    want = [t.grad.numpy() for t in (tq, tk, tv)]
    for report in _world(request, n):
        out, dq, dk, dv = report["value"]["attention"][name + " control"]
        numpy.testing.assert_allclose(out, local.detach().numpy(),
                                      atol=ATOL, rtol=0)
        worst = max(float(numpy.abs(got - w).max())
                    for got, w in zip((dq, dk, dv), want))
        assert worst > ATOL, worst


def test_ulysses_refuses_heads_that_do_not_divide_with_jax_s_message():
    three = types.SimpleNamespace(
        shape={"seq": 3},
        axis=lambda name: types.SimpleNamespace(name=name, size=3))
    q = torch.zeros((1, 4, 6, 2))
    with pytest.raises(ValueError) as port:
        ulysses_attention(q, q, q, three)
    jq = jnp.zeros((1, 4, 6, 2))
    with pytest.raises(ValueError) as jax_error:
        jax_sequence.ulysses_attention(
            jq, jq, jq, jax_mesh({"seq": 3}, devices=jax.devices()[:3]))
    assert str(port.value) == str(jax_error.value)


# -- the layers with their plans attached --------------------------------------


@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_use_ring_layer_matches_jax(world2, units, schedule):
    """Forward, weight, bias and input gradients against the JAX unit
    with the same plan on a 2-device seq mesh."""
    unit, params, x, g = units["attention"]
    unit.use_ring(jax_mesh({"seq": 2}, devices=jax.devices()[:2]),
                  schedule=schedule)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, want_grads = _jax_vjp(unit.apply, (jp, jnp.asarray(x)), g)
    for report in world2:
        out, grads, dx = report["value"]["units"][schedule]
        numpy.testing.assert_allclose(out, numpy.asarray(want), atol=ATOL,
                                      rtol=0)
        _grad_close(grads["weights"], want_grads[0]["weights"])
        _grad_close(grads["bias"], want_grads[0]["bias"])
        _grad_close(dx, want_grads[1])


def test_use_ring_checks_and_transient_state():
    model = build_model([ATTENTION_LAYER], UNIT_SHAPE, seed=0, device="cpu")
    layer = model[0]
    one = mesh.build_mesh({"seq": 1})
    with pytest.raises(ValueError, match="unknown sp schedule"):
        layer.use_ring(one, schedule="nope")
    three = types.SimpleNamespace(shape={"seq": 3})
    with pytest.raises(ValueError, match=r"ulysses needs heads \(4\) "
                                         r"divisible by the 'seq' axis"):
        layer.use_ring(three, schedule="ulysses")
    x = torch.from_numpy(RNG.randn(2, *UNIT_SHAPE).astype(numpy.float32))
    with torch.no_grad():
        local = model(x)
        assert layer.use_ring(one) is layer
        numpy.testing.assert_allclose(model(x).numpy(), local.numpy(),
                                      atol=ATOL, rtol=0)
    restored = pickle.loads(pickle.dumps(layer))
    assert restored._seq_grid is None and layer._seq_grid is one


def test_use_experts_layer_matches_jax(world4, units):
    """The moe layer's expert-parallel path against the JAX unit's on a
    4-device expert mesh: output, router, up and down gradients, the
    input's."""
    unit, params, x, g = units["moe"]
    unit.use_experts(jax_mesh({"expert": 4}, devices=jax.devices()[:4]))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want, want_grads = _jax_vjp(unit.apply, (jp, jnp.asarray(x)), g)
    for report in world4:
        out, grads, dx = report["value"]["units"]["experts"]
        numpy.testing.assert_allclose(out, numpy.asarray(want), atol=ATOL,
                                      rtol=0)
        for k in ("weights", "up", "down"):
            _grad_close(grads[k], want_grads[0][k])
        _grad_close(dx, want_grads[1])


def test_use_experts_needs_an_axis_as_wide_as_the_experts():
    model = build_model([MOE_LAYER], (8, 8), seed=0, device="cpu")
    with pytest.raises(ValueError, match="4 experts cannot shard over a "
                                         "1-wide 'expert' axis"):
        model[0].use_experts(mesh.build_mesh({"expert": 1}))
    restored = pickle.loads(pickle.dumps(model[0]))
    assert restored._ep_grid is None


def test_moe_ffn_matches_jax_with_drops_and_the_router_gradient(world4):
    jm = jax_mesh({"expert": 4}, devices=jax.devices()[:4])
    args = tuple(jnp.asarray(a) for a in (MOE_X, MOE_ROUTER, MOE_UP,
                                          MOE_DOWN))
    want, want_grads = _jax_vjp(
        lambda *a: jax_ep.moe_ffn(*a, jm, capacity_factor=1.0), args, MOE_G)
    want = numpy.asarray(want)
    dropped = int((numpy.abs(want).sum(axis=1) == 0).sum())
    assert dropped > 0
    tensors = [torch.from_numpy(a) for a in (MOE_X, MOE_ROUTER, MOE_UP,
                                             MOE_DOWN)]
    reference = moe_ffn_reference(*tensors, 4, 1.0)
    for report in world4:
        out, dx, drouter, dup, ddown = report["value"]["moe"]
        numpy.testing.assert_allclose(out, want, atol=ATOL, rtol=0)
        numpy.testing.assert_allclose(out, reference.numpy(), atol=ATOL,
                                      rtol=0)
        assert int((numpy.abs(out).sum(axis=1) == 0).sum()) == dropped
        for got, jax_grad in zip((dx, drouter, dup, ddown), want_grads):
            _grad_close(got, jax_grad)
        assert numpy.abs(drouter).max() > 0


def test_moe_control_without_the_router_s_sum_fails(world4):
    """The router's gradient left as each rank's own shard's part: the
    output still matches, the router's gradient must not."""
    jm = jax_mesh({"expert": 4}, devices=jax.devices()[:4])
    args = tuple(jnp.asarray(a) for a in (MOE_X, MOE_ROUTER, MOE_UP,
                                          MOE_DOWN))
    want, want_grads = _jax_vjp(
        lambda *a: jax_ep.moe_ffn(*a, jm, capacity_factor=1.0), args, MOE_G)
    want_router = numpy.asarray(want_grads[1], numpy.float64)
    for report in world4:
        out, _, drouter, _, _ = report["value"]["moe control"]
        numpy.testing.assert_allclose(out, numpy.asarray(want), atol=ATOL,
                                      rtol=0)
        assert numpy.linalg.norm(drouter - want_router) > GRAD_SHARE * \
            numpy.linalg.norm(want_router)


# -- training through the plans ------------------------------------------------


def _jax_epochs(jt, epochs=2):
    params, states = jt.pull_params()
    out = []
    for epoch in range(epochs):
        valid = jt.eval_class(params, VALIDATION)
        params, states, losses, _ = jt.train_class(params, states)
        out.append((numpy.asarray(valid[0]), numpy.asarray(losses)))
        jt.loader.epoch_number = epoch + 1
        jt.loader.shuffle()
    return out, [{k: numpy.asarray(v) for k, v in p.items()}
                 for p in params]


def _check_run(got, losses, params):
    for (gv, gt), (wv, wt) in zip(got["losses"], losses):
        numpy.testing.assert_allclose(gv, wv, atol=LOSS_ATOL, rtol=0)
        numpy.testing.assert_allclose(gt, wt, atol=LOSS_ATOL, rtol=0)
    for g, w in zip(got["params"], params):
        for k in w:
            numpy.testing.assert_allclose(g[k], w[k], atol=PARAM_ATOL,
                                          rtol=0)


@pytest.mark.parametrize("schedule", ["ring", "ulysses"])
def test_sequence_workflow_with_use_ring_trains_as_jax(world2, schedule):
    jt, _ = _jax_workflow_params(False)
    losses, params = _jax_epochs(jt)
    for report in world2:
        _check_run(report["value"]["workflows"][schedule], losses, params)


def _per_shard_forward(self, x):
    """The expert path's numbers in one process: the batch's tokens cut
    into one shard per expert, each routed with its own capacity."""
    tokens = x.reshape(-1, x.shape[-1])
    y = moe_ffn_reference(tokens, self.weights, self.up, self.down,
                          self.n_experts, self.capacity_factor)
    return (y.reshape(x.shape) + x).to(x.dtype)


def test_moe_workflow_with_use_experts_trains_as_per_shard_routing(
        world4, workflow_params, monkeypatch):
    monkeypatch.setattr(MoEForward, "forward", _per_shard_forward)
    prng.get().seed(ranks.WEIGHT_SEED)
    prng.get("loader").seed(ranks.LOADER_SEED)
    sample = samples.sequence(samples.SequenceProvider(**ranks.PROVIDER),
                              minibatch_size=16, heads=4, moe=True,
                              n_experts=4)
    t = build_training(sample.layers, sample.sample_shape, sample.loader,
                       params=workflow_params[True], device="cpu",
                       **sample.training)
    losses = []
    for epoch in range(2):
        stats = t.run_epoch(epoch)
        losses.append((stats["validation"]["losses"],
                       stats["train"]["losses"]))
    params = params_to_jax(t.model)
    for report in world4:
        _check_run(report["value"]["workflows"]["moe"], losses, params)
    assert losses[-1][1].mean() < losses[0][1].mean()


@pytest.mark.parametrize("n", [2, 4])
def test_ranks_load_neither_jax_nor_the_jax_package(request, n):
    for report in _world(request, n):
        assert report["bad_modules"] == []
