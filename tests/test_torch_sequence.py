"""The sequence models of the port (multi-head attention, the Switch MoE
FFN, ``models/samples.py``) against the JAX package, on the CPU.

Sizes are small: sequences of 8 tokens of width 16, 4 heads, 4 experts
of hidden width 16 or 64, a few dozen samples. The JAX side runs as its
own tests run it here: the layers' ``apply`` on the units' parameters,
``jax.grad`` of the same functions, and the JAX ``FusedTrainer`` over
``SequenceWorkflow``. Neither side reaches a Pallas kernel: attention
and the experts are XLA einsums in JAX and ``torch.matmul`` /
``torch.einsum`` in the port, and the port's projections take its K1
and K6 through their plain versions on CPU tensors.

Tolerances (float32): forwards 1e-5 absolute (O(1) outputs; XLA and
oneDNN add the same products in other orders, a few 1e-7), gradients
1e-5 of their norm, the load-balance loss 1e-6 absolute, per-batch
training losses 1e-5 absolute and parameters and velocities 1e-6
absolute after two epochs, as ``tests/test_torch_models.py`` holds the
BASELINE family. Routing decisions (top-1 expert, capacity drops) are
held exactly; the tests print the smallest top-1/top-2 margin of the
router probabilities they route, the distance that float32 noise would
have to cross to flip a choice. bf16 inputs: one bf16 ulp (2^-8
relative) on O(1) values, 1e-2.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher, DummyWorkflow  # noqa: E402
from veles_tpu.loader.base import VALIDATION  # noqa: E402
from veles_tpu.models import samples as jax_samples  # noqa: E402
from veles_tpu.nn import precision as jax_precision  # noqa: E402
from veles_tpu.nn.attention import \
    MultiHeadAttentionForward as JaxAttention  # noqa: E402
from veles_tpu.nn.moe import MoEForward as JaxMoE  # noqa: E402
from veles_tpu.parallel import ep as jax_ep  # noqa: E402
from veles_tpu.parallel.sequence import \
    local_attention as jax_local_attention  # noqa: E402
from veles_tpu.train import FusedTrainer as JaxFusedTrainer  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.convert import (params_from_jax,  # noqa: E402
                                     params_to_jax, solver_state_from_jax,
                                     solver_state_to_jax)
from veles_tpu_torch.loader.fullbatch import (ProviderLoader,  # noqa: E402
                                              TabularLoader)
from veles_tpu_torch.models import samples  # noqa: E402
from veles_tpu_torch.models.build import (build_model,  # noqa: E402
                                          build_training)
from veles_tpu_torch.nn.attention import \
    MultiHeadAttentionForward  # noqa: E402
from veles_tpu_torch.nn.moe import MoEForward  # noqa: E402
from veles_tpu_torch.parallel.ep import (capacity_of,  # noqa: E402
                                         load_balance_loss, moe_ffn_dense,
                                         moe_ffn_reference, route,
                                         router_probs)
from veles_tpu_torch.parallel.sequence import local_attention  # noqa: E402
from veles_tpu_torch.serving.model_store import ServeableModel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, DIM, HEADS, EXPERTS = 8, 16, 4, 4
WEIGHT_SEED, LOADER_SEED = 41, 42


def _rand(shape, seed, scale=1.0):
    return (numpy.random.RandomState(seed).randn(*shape) *
            scale).astype(numpy.float32)


def _grad_close(got, want, share=1e-5):
    got, want = numpy.asarray(got, numpy.float64), numpy.asarray(
        want, numpy.float64)
    assert got.shape == want.shape
    assert numpy.linalg.norm(got - want) <= share * numpy.linalg.norm(want)


def _margin(probs):
    """The smallest top-1 minus top-2 router probability."""
    top2 = numpy.sort(numpy.asarray(probs), axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


# -- local_attention ---------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_attention_matches_jax(causal, dtype):
    q, k, v = (_rand((2, 3, SEQ, 4), seed) for seed in (1, 2, 3))
    jt = getattr(jnp, dtype)
    want = jax_local_attention(*(jnp.asarray(a, jt) for a in (q, k, v)),
                               causal=causal)
    tt = getattr(torch, dtype)
    got = local_attention(*(torch.from_numpy(a).to(tt) for a in (q, k, v)),
                          causal=causal)
    assert got.dtype == tt
    tol = 1e-5 if dtype == "float32" else 1e-2
    numpy.testing.assert_allclose(got.float().numpy(),
                                  numpy.asarray(want, numpy.float32),
                                  atol=tol, rtol=tol)
    if causal:  # the first query sees only the first key
        numpy.testing.assert_allclose(
            got[:, :, 0].float().numpy(),
            torch.from_numpy(v).to(tt)[:, :, 0].float().numpy(), atol=0)


def test_local_attention_scale_and_gradients_match_jax():
    q, k, v, g = (_rand((2, 2, SEQ, 4), seed) for seed in (4, 5, 6, 7))

    def jloss(q, k, v):
        return jnp.sum(jax_local_attention(q, k, v, causal=True,
                                           scale=0.3) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (local_attention(*ts, causal=True, scale=0.3) *
     torch.from_numpy(g)).sum().backward()
    for t, w in zip(ts, want):
        _grad_close(t.grad.numpy(), w)


# -- the attention layer -----------------------------------------------------

def _jax_attention(causal, heads=HEADS, seq=SEQ, dim=DIM):
    jax_prng._generators.clear()
    jax_prng.get().seed(77)
    unit = JaxAttention(DummyWorkflow(), heads=heads, causal=causal,
                        name="mha")
    unit.input = numpy.zeros((4, seq, dim), numpy.float32)
    unit.initialize(device=Device(backend="cpu"))
    return unit, {k: numpy.array(v.mem) for k, v in
                  unit.param_arrays().items()}


def _port_layer(layers, params, policy="float32", sample=(SEQ, DIM)):
    return build_model(layers, sample, params=params, policy=policy,
                       device="cpu", trainable=True)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("policy", ["float32", "bfloat16_mixed"])
def test_attention_forward_and_gradients_match_jax(causal, policy):
    """Forward and the gradients of weights, bias and input against
    ``jax.grad`` of the JAX layer's ``apply`` under the same policy."""
    unit, params = _jax_attention(causal)
    x, g = _rand((3, SEQ, DIM), 8), _rand((3, SEQ, DIM), 9)
    jax_precision.set_policy(policy)
    try:
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        want = unit.apply(jp, jnp.asarray(x))
        want_grads = jax.grad(lambda p, x: jnp.sum(unit.apply(p, x) * g),
                              argnums=(0, 1))(jp, jnp.asarray(x))
    finally:
        jax_precision.set_policy("float32")
    model = _port_layer([{"type": "attention", "heads": HEADS,
                          "causal": causal}], [params], policy)
    xt = torch.from_numpy(x).requires_grad_()
    got = model(xt)
    numpy.testing.assert_allclose(got.detach().numpy(), numpy.asarray(want),
                                  atol=1e-5, rtol=0)
    (got * torch.from_numpy(g)).sum().backward()
    layer = model[0]
    _grad_close(layer.weights.grad.numpy(), want_grads[0]["weights"])
    _grad_close(layer.bias.grad.numpy(), want_grads[0]["bias"])
    _grad_close(xt.grad.numpy(), want_grads[1])


def test_attention_keeps_float32_under_bfloat16_mixed(monkeypatch):
    """The layer never casts to the policy's compute dtype: under
    ``bfloat16_mixed`` every projection runs K1 on float32 operands and
    the output is the float32 policy's, bit for bit; a bf16 input is
    widened (its product is JAX's within one bf16 ulp of the output)."""
    gemm = sys.modules["veles_tpu_torch.ops.gemm"]
    _, params = _jax_attention(False)
    x = _rand((2, SEQ, DIM), 10)
    seen = []
    plain = gemm.linear_act_plain

    def spied(x, w, *args, **kwargs):
        seen.append((x.dtype, w.dtype))
        return plain(x, w, *args, **kwargs)

    monkeypatch.setattr(gemm, "linear_act_plain", spied)
    layers = [{"type": "attention", "heads": HEADS, "causal": False}]
    out = {}
    for policy in ("float32", "bfloat16_mixed"):
        with torch.no_grad():
            out[policy] = _port_layer(layers, [params], policy)(
                torch.from_numpy(x))
    assert torch.equal(out["float32"], out["bfloat16_mixed"])
    assert len(seen) == 8 and set(seen) == {(torch.float32,
                                             torch.float32)}
    unit, _ = _jax_attention(False)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = unit.apply(jp, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = _port_layer(layers, [params])(torch.from_numpy(x).to(
            torch.bfloat16))
    assert got.dtype == torch.bfloat16
    numpy.testing.assert_allclose(got.float().numpy(),
                                  numpy.asarray(want, numpy.float32),
                                  atol=1e-2, rtol=1e-2)


def test_attention_init_shapes_and_ranges():
    """The filler takes fan_in = 4 * dim over the (4, dim, dim) weights
    and draws the (4, dim) bias from the same range, as JAX's does."""
    unit, params = _jax_attention(False)
    model = build_model([{"type": "attention", "heads": HEADS}], (SEQ, DIM),
                        seed=3, device="cpu")
    layer = model[0]
    s = 1.0 / numpy.sqrt(4 * DIM)
    for name, shape in (("weights", (4, DIM, DIM)), ("bias", (4, DIM))):
        got = getattr(layer, name).detach().numpy()
        assert got.shape == params[name].shape == shape
        for values in (got, params[name]):
            assert numpy.abs(values).max() <= s
            assert numpy.abs(values).max() > 0.9 * s
    assert tuple(layer.output_shape()) == (SEQ, DIM)
    with pytest.raises(ValueError, match="divisible"):
        build_model([{"type": "attention", "heads": 3}], (SEQ, DIM),
                    seed=0, device="cpu")


# -- the mixture of experts --------------------------------------------------

def _moe_weights(dim=8, hidden=16, experts=EXPERTS, seed=11):
    return (_rand((dim, experts), seed, 0.5),
            _rand((experts, dim, hidden), seed + 1, dim ** -0.5),
            _rand((experts, hidden, dim), seed + 2, hidden ** -0.5))


def _skewed(x, router):
    """Tokens pushed towards expert 0: most of each shard overflows."""
    x = x.copy()
    x[:, 0] = 3.0
    router = router.copy()
    router[0, 0] = 2.0
    return x, router


@pytest.mark.parametrize("skew", [False, True])
def test_moe_ffn_reference_matches_jax(skew):
    """The same expert for every token, the same capacity drops (forced
    by a skewed router on one side), outputs and gradients; a control
    with another capacity factor must differ where tokens dropped."""
    router, up, down = _moe_weights()
    x = _rand((32, 8), 12)
    if skew:
        x, router = _skewed(x, router)
    args = (x, router, up, down)
    want = jax_ep.moe_ffn_reference(*(jnp.asarray(a) for a in args),
                                    EXPERTS)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    got = moe_ffn_reference(*ts, EXPERTS)
    numpy.testing.assert_allclose(got.detach().numpy(), numpy.asarray(want),
                                  atol=1e-5, rtol=0)
    # routing, token by token, per shard of 8 tokens
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(4, 8, 8) @ router, -1)
    probs = router_probs(torch.from_numpy(x).reshape(4, 8, 8),
                         torch.from_numpy(router))
    expert, _, keep = route(probs, capacity_of(8, EXPERTS, 1.25))
    jexpert = jnp.argmax(jprobs, -1)
    onehot = jax.nn.one_hot(jexpert, EXPERTS)
    jpos = jnp.sum((jnp.cumsum(onehot, axis=1) - 1.0) * onehot, -1)
    numpy.testing.assert_array_equal(expert.numpy(), numpy.asarray(jexpert))
    numpy.testing.assert_array_equal(keep.numpy(), numpy.asarray(jpos < 3))
    print("moe routing: smallest top-1/top-2 margin %.3g, %d of 32 tokens "
          "dropped" % (_margin(jprobs), int((~keep).sum())))
    dropped = ~keep.reshape(-1)
    assert int(dropped.sum()) >= (12 if skew else 0)
    assert not got[dropped].any()
    g = _rand((32, 8), 13)

    def jloss(*a):
        return jnp.sum(jax_ep.moe_ffn_reference(*a, EXPERTS) * g)

    want_grads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in args))
    (got * torch.from_numpy(g)).sum().backward()
    for t, w in zip(ts, want_grads):
        _grad_close(t.grad.numpy(), w)
    control = moe_ffn_reference(*(torch.from_numpy(a) for a in args),
                                EXPERTS, capacity_factor=4.0)
    differs = numpy.abs(control.numpy() - numpy.asarray(want)).max() > 1e-3
    assert differs == bool(dropped.any())


def test_moe_ties_route_to_the_first_expert():
    """Equal router probabilities: both packages pick the first."""
    x = numpy.ones((4, 8), numpy.float32)
    router = numpy.zeros((8, EXPERTS), numpy.float32)
    router[:, 1] = router[:, 3] = 0.5
    probs = router_probs(torch.from_numpy(x), torch.from_numpy(router))
    jprobs = jax.nn.softmax(jnp.asarray(x) @ router, -1)
    assert probs.argmax(-1).tolist() == [1] * 4
    assert numpy.asarray(jnp.argmax(jprobs, -1)).tolist() == [1] * 4


@pytest.mark.parametrize("masked", [False, True])
def test_load_balance_loss_matches_jax(masked):
    probs = numpy.array(jax.nn.softmax(_rand((24, EXPERTS), 14), -1))
    weights = None
    if masked:
        weights = (numpy.arange(24) % 5 != 0).astype(numpy.float32)
    want = jax_ep.load_balance_loss(
        jnp.asarray(probs), None if weights is None else
        jnp.asarray(weights))
    got = load_balance_loss(torch.from_numpy(probs), None if weights is None
                            else torch.from_numpy(weights))
    assert abs(float(got) - float(want)) <= 1e-6
    unmasked = load_balance_loss(torch.from_numpy(probs))
    assert (abs(float(unmasked) - float(got)) > 1e-4) == masked


def _jax_moe(x, **kwargs):
    jax_prng._generators.clear()
    jax_prng.get().seed(78)
    unit = JaxMoE(DummyWorkflow(), n_experts=EXPERTS, **kwargs)
    unit.input = x
    unit.initialize(device=Device(backend="cpu"))
    return unit, {k: numpy.array(v.mem) for k, v in
                  unit.param_arrays().items()}


def test_moe_layer_matches_jax_and_is_batch_composition_independent():
    """The layer against the JAX unit's ``apply`` (per-sample capacity
    under ``vmap``), and each sample's row equal to the sample run
    alone; a control pools the capacity over the whole batch and must
    differ from both."""
    x = _rand((6, SEQ, 8), 15)
    x[:, :, 0] = 2.0   # crowd the tokens so each sample drops some
    unit, params = _jax_moe(x, hidden=16, capacity_factor=1.0)
    params["weights"][0, 0] = 1.5
    want = unit.apply({k: jnp.asarray(v) for k, v in params.items()},
                      jnp.asarray(x))
    model = _port_layer([{"type": "moe", "n_experts": EXPERTS,
                          "hidden": 16, "capacity_factor": 1.0}],
                        [params], sample=(SEQ, 8))
    layer = model[0]
    with torch.no_grad():
        got = model(torch.from_numpy(x))
        numpy.testing.assert_allclose(got.numpy(), numpy.asarray(want),
                                      atol=1e-5, rtol=0)
        for i in range(len(x)):
            alone = model(torch.from_numpy(x[i:i + 1]))
            numpy.testing.assert_allclose(alone.numpy(), got[i:i + 1].numpy(),
                                          atol=1e-6, rtol=0)
        pooled = moe_ffn_dense(
            torch.from_numpy(x).reshape(1, -1, 8), layer.weights, layer.up,
            layer.down, 1.0).reshape(x.shape) + torch.from_numpy(x)
    assert numpy.abs(pooled.numpy() - got.numpy()).max() > 1e-2


def test_moe_init_shapes_and_ranges():
    x = numpy.zeros((2, SEQ, DIM), numpy.float32)
    _, params = _jax_moe(x)
    model = build_model([{"type": "moe", "n_experts": EXPERTS}], (SEQ, DIM),
                        seed=4, device="cpu")
    layer = model[0]
    assert layer.hidden == 4 * DIM and layer.bias is None
    for name, shape, fan_in in (("weights", (DIM, EXPERTS), DIM),
                                ("up", (EXPERTS, DIM, 4 * DIM), DIM),
                                ("down", (EXPERTS, 4 * DIM, DIM), 4 * DIM)):
        got = getattr(layer, name).detach().numpy()
        assert got.shape == params[name].shape == shape
        s = 1.0 / numpy.sqrt(fan_in)
        for values in (got, params[name]):
            assert s * 0.9 < numpy.abs(values).max() <= s
    assert sorted(params) == ["down", "up", "weights"]


# -- convert -----------------------------------------------------------------

@pytest.mark.parametrize("solver", ["sgd", "adagrad", "adadelta", "adam"])
def test_convert_round_trips_moe_params_and_solver_state(solver):
    sample = samples.sequence(samples.SequenceProvider(
        n_train=24, n_valid=8, seq=SEQ, dim=DIM), minibatch_size=8,
        moe=True, n_experts=EXPERTS)
    trainer = build_training(sample.layers, sample.sample_shape,
                             sample.loader, seed=5, device="cpu",
                             solver=solver, learning_rate=0.01,
                             momentum=0.9)
    trainer.train_batch(torch.from_numpy(trainer._segment_indices(2)[0]),
                        0, 0)
    jax_params = params_to_jax(trainer.model)
    assert sorted(jax_params[1]) == ["down", "up", "weights"]
    assert sorted(jax_params[0]) == ["bias", "weights"]
    assert jax_params[0]["bias"].shape == (4, DIM)
    twin = build_model(sample.layers, sample.sample_shape, seed=6,
                       device="cpu")
    params_from_jax(twin, jax_params)
    for a, b in zip(trainer.model.parameters(), twin.parameters()):
        assert torch.equal(a, b)
    states = solver_state_to_jax(trainer.states)
    per_param = [v for v in states[1].values() if isinstance(v, dict)]
    assert per_param and all(sorted(v) == ["down", "up", "weights"]
                             for v in per_param)
    assert any(numpy.abs(v["up"]).max() > 0 for v in per_param)
    back = solver_state_from_jax(trainer.model, states)
    for got, want in zip(back, trainer.states):
        for key, value in want.items():
            if isinstance(value, dict):
                for k in value:
                    assert torch.equal(got[key][k], value[k])
            else:
                assert torch.equal(got[key], value)
    with pytest.raises(ValueError, match="up"):
        params_from_jax(twin, [jax_params[0], {"weights": jax_params[1][
            "weights"]}] + jax_params[2:])


# -- providers and the loader -----------------------------------------------

PROVIDERS = {
    "wine": (lambda m: m.WineProvider(n_train=30, n_valid=10)),
    "lines": (lambda m: m.LinesProvider(n_train=20, n_valid=6)),
    "kanji": (lambda m: m.KanjiProvider(n_train=12, n_valid=4)),
    "sequence": (lambda m: m.SequenceProvider(n_train=20, n_valid=6,
                                              seq=SEQ, dim=DIM)),
}


@pytest.mark.parametrize("name", sorted(PROVIDERS))
def test_provider_bytes_equal_jax(name):
    got = PROVIDERS[name](samples)()
    want = PROVIDERS[name](jax_samples)()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        numpy.testing.assert_array_equal(a, b)


def test_sequence_loader_keeps_samples_3d_and_tabular_normalizes():
    provider = samples.SequenceProvider(n_train=20, n_valid=6, seq=SEQ,
                                        dim=DIM)
    seq = ProviderLoader(provider=provider, sequence=True).initialize()
    assert tuple(seq.original_data.shape) == (26, SEQ, DIM)
    image = ProviderLoader(provider=provider).initialize()
    assert tuple(image.original_data.shape) == (26, SEQ, DIM, 1)
    wine = TabularLoader(provider=samples.WineProvider(n_train=30,
                                                       n_valid=10))
    assert wine.normalization_type == "mean_disp"
    train = wine.initialize().original_data[10:].numpy()
    numpy.testing.assert_allclose(train.mean(0), 0.0, atol=1e-5)


# -- training ----------------------------------------------------------------

N_TRAIN, N_VALID, MINIBATCH = 40, 12, 16


def _trainers(moe, aux_loss_weight=0.0):
    """(the JAX trainer over ``SequenceWorkflow``, the port's from its
    initial weights); 40 training samples in batches of 16 leave a tail
    of 8."""
    provider_args = dict(n_train=N_TRAIN, n_valid=N_VALID, seq=SEQ,
                         dim=DIM)
    jax_prng.get().seed(WEIGHT_SEED)
    jax_prng.get("loader").seed(LOADER_SEED)
    wf = jax_samples.SequenceWorkflow(
        DummyLauncher(), provider=jax_samples.SequenceProvider(
            **provider_args), minibatch_size=MINIBATCH, heads=HEADS,
        moe=moe, n_experts=EXPERTS)
    if aux_loss_weight:
        wf.forwards[1].aux_loss_weight = aux_loss_weight
    wf.initialize(device=Device(backend="cpu"))
    jt = JaxFusedTrainer(wf)
    params, _ = jt.pull_params()
    prng.get().seed(WEIGHT_SEED)
    prng.get("loader").seed(LOADER_SEED)
    sample = samples.sequence(samples.SequenceProvider(**provider_args),
                              minibatch_size=MINIBATCH, heads=HEADS,
                              moe=moe, n_experts=EXPERTS)
    layers = [dict(d) for d in sample.layers]
    if aux_loss_weight:
        layers[1]["aux_loss_weight"] = aux_loss_weight
    pt = build_training(
        layers, sample.sample_shape, sample.loader,
        params=[{k: numpy.asarray(v) for k, v in p.items()} for p in params],
        device="cpu", **sample.training)
    return jt, pt


def _jax_epochs(jt, epochs=2):
    params, states = jt.pull_params()
    out = []
    for epoch in range(epochs):
        valid = jt.eval_class(params, VALIDATION)
        params, states, losses, metrics = jt.train_class(params, states)
        out.append((valid, (losses, metrics)))
        jt.loader.epoch_number = epoch + 1
        jt.loader.shuffle()
    return params, states, out


def _check_two_epochs(jt, pt):
    params, states, jax_epochs = _jax_epochs(jt)
    for epoch, (valid, train) in enumerate(jax_epochs):
        stats = pt.run_epoch(epoch)
        assert stats["train"]["losses"].shape == (3,)
        numpy.testing.assert_allclose(stats["validation"]["losses"],
                                      numpy.asarray(valid[0]), atol=1e-5,
                                      rtol=0)
        numpy.testing.assert_allclose(stats["train"]["losses"],
                                      numpy.asarray(train[0]), atol=1e-5,
                                      rtol=0)
        assert stats["train"]["metric"] == float(jnp.sum(train[1]))
        numpy.testing.assert_array_equal(stats["validation"]["confusion"],
                                         numpy.asarray(valid[2]))
    for got, want in zip(params_to_jax(pt.model), params):
        assert sorted(got) == sorted(want)
        for k in want:
            numpy.testing.assert_allclose(got[k], numpy.asarray(want[k]),
                                          atol=1e-6, rtol=0)
    for got, want in zip(solver_state_to_jax(pt.states), states):
        for k, v in want.get("velocity", {}).items():
            numpy.testing.assert_allclose(got["velocity"][k],
                                          numpy.asarray(v), atol=1e-6,
                                          rtol=0)
    return params


@pytest.mark.parametrize("moe", [False, True])
def test_two_epochs_match_the_jax_fused_trainer(moe):
    jt, pt = _trainers(moe)
    assert [type(m) for m in pt.forwards][:2] == [
        MultiHeadAttentionForward, MoEForward if moe else
        MultiHeadAttentionForward]
    _check_two_epochs(jt, pt)


def test_aux_loss_is_added_by_the_trainer():
    """A non-zero ``aux_loss_weight`` on the moe layer: the trainer adds
    the load-balance loss over the batch's valid samples (the tail
    batch pads 8 rows) to the training loss, as the JAX trainer does,
    and two epochs match; the same run without it ends elsewhere."""
    jt, pt = _trainers(True, aux_loss_weight=0.5)
    idx = torch.from_numpy(pt._segment_indices(2)[2])
    assert int((idx >= 0).sum()) == 8
    x, _, valid = pt.loader.gather(idx)
    with torch.no_grad():
        h = pt.forwards[0](x)
        term = pt.forwards[1].aux_loss(h, valid)
        unmasked = pt.forwards[1].aux_loss(h)
    assert float(term) > 0 and abs(float(term) - float(unmasked)) > 1e-4
    want = _check_two_epochs(jt, pt)
    _, plain = _trainers(True)
    for epoch in range(2):
        plain.run_epoch(epoch)
    assert numpy.abs(params_to_jax(plain.model)[1]["weights"] -
                     numpy.asarray(want[1]["weights"])).max() > 1e-5


def test_bench_width_steps_match_jax():
    """``scripts/bench_all.py``'s attention widths (seq 256, dim 256, 8
    heads) at ``SequenceWorkflow``'s default rate of 0.1, cut to batches
    of 16 and 24 steps: the port's per-step training losses equal the
    JAX trainer's within 1e-3 relative (float32 sums in other orders,
    grown by the dynamics), and both climb: the mean of the last 8
    steps is above the first 8's. That rate does not train this model at
    these widths in either package (the card's sequence phase trains at
    0.01)."""
    provider_args = dict(n_train=384, n_valid=16, seq=256, dim=256)
    jax_prng.get().seed(5)
    jax_prng.get("loader").seed(6)
    wf = jax_samples.SequenceWorkflow(
        DummyLauncher(), provider=jax_samples.SequenceProvider(
            **provider_args), minibatch_size=16, heads=8)
    wf.initialize(device=Device(backend="cpu"))
    jt = JaxFusedTrainer(wf)
    params, states = jt.pull_params()
    prng.get().seed(5)
    prng.get("loader").seed(6)
    sample = samples.sequence(samples.SequenceProvider(**provider_args),
                              minibatch_size=16, heads=8)
    pt = build_training(
        sample.layers, sample.sample_shape, sample.loader,
        params=[{k: numpy.asarray(v) for k, v in p.items()} for p in params],
        device="cpu", **sample.training)
    want = numpy.asarray(jt.train_class(params, states)[2])
    got = pt.train_class()[0].numpy()
    print("bench-width losses at lr 0.1, JAX:", numpy.round(want, 4).tolist())
    assert got.shape == want.shape == (24,)
    numpy.testing.assert_allclose(got, want, rtol=1e-3, atol=0)
    assert want[-8:].mean() > want[:8].mean()


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_attention_products_run_under_the_policy_switches(monkeypatch,
                                                          policy):
    """With TF32 and bf16 reductions switched on by the caller, every
    ``torch.matmul`` and ``torch.einsum`` of a sequence training step
    and of a served forward (attention's and the experts' products, the
    projections' plain K1 and backward products, the head's) reads them
    off; the caller's switches are back after."""
    matmul = torch.backends.cuda.matmul
    switches = (matmul, "allow_tf32"), (
        matmul, "allow_bf16_reduced_precision_reduction")
    reads = []

    def spy(fn):
        def spied(*args, **kwargs):
            reads.append(tuple(getattr(o, n) for o, n in switches))
            return fn(*args, **kwargs)
        return spied

    sample = samples.sequence(samples.SequenceProvider(
        n_train=16, n_valid=8, seq=SEQ, dim=DIM), minibatch_size=8,
        moe=True, n_experts=EXPERTS)
    trainer = build_training(sample.layers, sample.sample_shape,
                             sample.loader, seed=7, device="cpu",
                             policy=policy, **sample.training)
    served = ServeableModel.from_layers(sample.layers, sample.sample_shape,
                                        seed=7, policy=policy, device="cpu")
    saved = [getattr(o, n) for o, n in switches]
    monkeypatch.setattr(torch, "matmul", spy(torch.matmul))
    monkeypatch.setattr(torch, "einsum", spy(torch.einsum))
    try:
        for o, n in switches:
            setattr(o, n, True)
        trainer.train_batch(torch.from_numpy(
            trainer._segment_indices(2)[0]), 0, 0)
        served(numpy.zeros((2, SEQ, DIM), numpy.float32))
        after = [getattr(o, n) for o, n in switches]
    finally:
        for (o, n), v in zip(switches, saved):
            setattr(o, n, v)
    assert after == [True, True]
    assert len(reads) > 20 and set(reads) == {(False, False)}


def test_sequence_paths_import_neither_jax_nor_the_jax_package():
    """A fresh interpreter builds, serves and trains an attention and an
    attention + MoE model on the CPU, and never loads jax or any
    veles_tpu module."""
    code = (
        "import sys, math, numpy\n"
        "from veles_tpu_torch.models import samples\n"
        "from veles_tpu_torch.models.build import build_training\n"
        "from veles_tpu_torch.serving.model_store import ServeableModel\n"
        "for moe in (False, True):\n"
        "    s = samples.sequence(samples.SequenceProvider(n_train=16, "
        "n_valid=8, seq=8, dim=16), minibatch_size=8, moe=moe)\n"
        "    m = ServeableModel.from_layers(s.layers, s.sample_shape, "
        "seed=1, device='cpu')\n"
        "    assert m(numpy.zeros((2, 8, 16), numpy.float32)).shape == "
        "(2, 8)\n"
        "    t = build_training(s.layers, s.sample_shape, s.loader, "
        "seed=1, device='cpu', **s.training)\n"
        "    assert math.isfinite(t.run_epoch()['train']['loss'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'veles_tpu' or "
        "m.startswith('veles_tpu.'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stdout + result.stderr
