"""The port's GPipe pipeline against the JAX package's and against the
sequential run, on the CPU.

One world of 2 ranks (``tests/torch_world.py`` ``run_world``:
gloo over a file store under the test's temporary directory, one wall
limit of ``WORLD_S`` seconds), each rank one stage
(``tests/torch_seq_ranks.py``); JAX runs the same inputs on a 2-device
``pipe`` mesh.

* ``pipeline_apply`` of two tanh(x @ W) stages over 4 microbatches, and
  three ``pipeline_train_step`` SGD steps of the mean MSE: outputs
  within ``ATOL``, losses within ``LOSS_RTOL`` relative, the stages'
  parameters within ``ATOL`` -- against JAX's ``pipeline_apply`` /
  ``pipeline_train_step`` and against the stages run in sequence;
* the heterogeneous conv -> relu -> pool | flatten -> fc trunk
  (``hetero_pipeline_apply`` / ``hetero_pipeline_train_step``, 2
  microbatches of 4, softmax cross-entropy): the same checks against
  JAX's heterogeneous pipeline (its parameters padded into one stack)
  and the sequential run;
* the flagship's trunk: the small AlexNet's layers (conv -> pool ->
  conv -> pool | fc -> dropout -> softmax, the port's modules under
  ``torch.func.functional_call``, dropout the identity) against JAX's
  heterogeneous pipeline over the JAX units' ``apply`` (its test's
  ``_flagship_stage_setup`` without the random key): outputs, loss and
  each stage's parameters after one step;
* pp x dp: the trunk on a 2-stage ``pipe`` x 2-rank ``data`` grid (a
  second world, of 4 ranks) against JAX's heterogeneous pipeline with
  its ``data_axis``; and with a K7 dropout after each stage
  (``seed``), against the stages run in one process with the
  pipeline's keys, a second seed changing the outputs.
"""

import jax
import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

import torch_seq_ranks as ranks  # noqa: E402
from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher  # noqa: E402
from veles_tpu.models.alexnet import AlexNetWorkflow  # noqa: E402
from veles_tpu.models.alexnet import \
    SyntheticImageLoader as JaxSyntheticImageLoader  # noqa: E402
from veles_tpu.nn.dropout import DropoutForward as JaxDropout  # noqa: E402
from veles_tpu.parallel import pp as jax_pp  # noqa: E402
from veles_tpu_torch.models.alexnet import small_alexnet_layers  # noqa
from veles_tpu.parallel.mesh import build_mesh as jax_mesh  # noqa: E402
from torch_world import run_world  # noqa: E402

WORLD_S = 120.0
ATOL = 1e-5
LOSS_RTOL = 1e-5
LR = 0.1
RNG = numpy.random.RandomState(17)
N_STAGES, N_MICRO, MB, DIM = 2, 4, 4, 16
STACK = (RNG.randn(N_STAGES, DIM, DIM) * 0.3).astype(numpy.float32)
XS = RNG.randn(N_MICRO, MB, DIM).astype(numpy.float32)
YS = RNG.randn(N_MICRO, MB, DIM).astype(numpy.float32)
# the trunk: 10x10x3 -> conv 3x3 (4) -> 8x8x4 -> pool -> 4x4x4 -> fc 5
TRUNK = [{"w": (RNG.randn(3, 3, 3, 4) * 0.3).astype(numpy.float32),
          "b": (RNG.randn(4) * 0.1).astype(numpy.float32)},
         {"w": (RNG.randn(64, 5) * 0.2).astype(numpy.float32),
          "b": (RNG.randn(5) * 0.1).astype(numpy.float32)}]
TRUNK_X = RNG.randn(2, 4, 10, 10, 3).astype(numpy.float32)
TRUNK_Y = RNG.randint(0, 5, (2, 4)).astype(numpy.int32)


def _port_trunk():
    """The trunk's parameters in the port's layouts (OIHW conv)."""
    conv = dict(TRUNK[0], w=numpy.ascontiguousarray(
        TRUNK[0]["w"].transpose(3, 2, 0, 1)))
    return [conv, dict(TRUNK[1])]


#: the flagship's trunk, cut after its second pooling
FLAGSHIP = small_alexnet_layers(10)
FLAGSHIP_SPLIT = 4


@pytest.fixture(scope="module")
def flagship():
    """The JAX small AlexNet's stage functions over its units, their
    parameters, and 2 microbatches of 8 of its data and labels."""
    jax_prng.get().seed(11)
    jax_prng.get("loader").seed(12)
    wf = AlexNetWorkflow(
        DummyLauncher(), loader_factory=lambda w: JaxSyntheticImageLoader(
            w, n_train=16, n_valid=8, side=32, n_classes=10,
            minibatch_size=8), layers=FLAGSHIP, max_epochs=1)
    wf.initialize(device=Device(backend="cpu"))
    groups = [wf.forwards[:FLAGSHIP_SPLIT], wf.forwards[FLAGSHIP_SPLIT:]]

    def make_stage(units, is_last):
        def stage(params_list, x):
            for i, unit in enumerate(units):
                if isinstance(unit, JaxDropout):
                    continue
                if is_last and unit is units[-1]:
                    x = unit.apply_for_grad(params_list[i], x)
                else:
                    x = unit.apply(params_list[i], x)
            return x
        return stage

    fns = [make_stage(g, g is groups[-1]) for g in groups]
    params = [[{k: numpy.asarray(a.mem) for k, a in
                unit.param_arrays().items()} for unit in g] for g in groups]
    data = numpy.asarray(wf.loader.original_data.mem[8:24], numpy.float32)
    labels = numpy.asarray(wf.loader.original_labels.mem[8:24], numpy.int32)
    return (fns, params, data.reshape((2, 8) + data.shape[1:]),
            labels.reshape(2, 8))


@pytest.fixture(scope="module")
def world(flagship, tmp_path_factory):
    _, params, xs, ys = flagship
    return run_world(ranks.pipeline_world, N_STAGES,
                     ((STACK, XS, YS, LR), (_port_trunk(), TRUNK_X,
                                            TRUNK_Y, LR),
                      (FLAGSHIP, (32, 32, 3), params[0] + params[1],
                       FLAGSHIP_SPLIT, xs, ys, LR)),
                     timeout=WORLD_S,
                     workdir=str(tmp_path_factory.mktemp("pipe")))


def _stage(w, x):
    return jnp.tanh(jnp.dot(x, w, preferred_element_type=jnp.float32))


def _mse(out, y):
    return jnp.mean(jnp.square(out - y))


def _sequential(params, xs):
    out = xs
    for s in range(N_STAGES):
        out = jax.vmap(lambda x: _stage(params[s], x))(out)
    return out


def test_pipeline_apply_matches_jax_and_sequential(world):
    jm = jax_mesh({"pipe": N_STAGES}, devices=jax.devices()[:N_STAGES])
    want = numpy.asarray(jax_pp.pipeline_apply(_stage, STACK, XS, jm))
    seq = numpy.asarray(_sequential(jnp.asarray(STACK), XS))
    for report in world:
        out = report["value"]["homogeneous"]["out"]
        numpy.testing.assert_allclose(out, want, atol=ATOL, rtol=0)
        numpy.testing.assert_allclose(out, seq, atol=ATOL, rtol=0)


def test_pipeline_train_step_matches_jax_and_sequential_sgd(world):
    jm = jax_mesh({"pipe": N_STAGES}, devices=jax.devices()[:N_STAGES])
    p_pipe = p_seq = jnp.asarray(STACK)
    pipe_losses, seq_losses = [], []

    def seq_loss(params):
        return jnp.mean(jax.vmap(_mse)(_sequential(params, XS), YS))

    for _ in range(3):
        p_pipe, loss = jax_pp.pipeline_train_step(
            _stage, p_pipe, XS, YS, _mse, jm, learning_rate=LR)
        pipe_losses.append(float(loss))
        loss, grads = jax.value_and_grad(seq_loss)(p_seq)
        p_seq = p_seq - LR * grads
        seq_losses.append(float(loss))
    for report in world:
        case = report["value"]["homogeneous"]
        for want in (pipe_losses, seq_losses):
            numpy.testing.assert_allclose(case["losses"], want,
                                          rtol=LOSS_RTOL)
        for want in (p_pipe, p_seq):
            numpy.testing.assert_allclose(
                case["params"], numpy.asarray(want)[case["stage"]],
                atol=ATOL, rtol=0)
    assert pipe_losses[-1] < pipe_losses[0]


def _jax_conv(p, x):
    y = jax.lax.conv_general_dilated(
        x, p["w"], (1, 1), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["b"]
    y = jax.nn.relu(y)
    return jax.lax.reduce_window(y, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                 (1, 2, 2, 1), "VALID")


def _jax_fc(p, x):
    return jnp.dot(x.reshape(x.shape[0], -1), p["w"]) + p["b"]


def _xent(out, y):
    logp = jax.nn.log_softmax(out)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def test_hetero_pipeline_matches_jax_and_sequential(world):
    """The trunk's outputs, its loss and each stage's parameters after
    one SGD step."""
    jm = jax_mesh({"pipe": N_STAGES}, devices=jax.devices()[:N_STAGES])
    fns = [_jax_conv, _jax_fc]
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in TRUNK]
    stacked, unflattens = jax_pp.stack_stage_params(params)
    want = numpy.asarray(jax_pp.hetero_pipeline_apply(
        fns, params, stacked, unflattens, TRUNK_X, jm))
    new_stack, loss = jax_pp.hetero_pipeline_train_step(
        fns, params, stacked, unflattens, TRUNK_X, TRUNK_Y, _xent, jm,
        learning_rate=LR)

    def seq_loss(plist):
        outs = jnp.stack([_jax_fc(plist[1], _jax_conv(plist[0], x))
                          for x in TRUNK_X])
        return jnp.mean(jax.vmap(_xent)(outs, TRUNK_Y)), outs

    (seq_value, seq_out), seq_grads = jax.value_and_grad(
        seq_loss, has_aux=True)(params)
    for report in world:
        case = report["value"]["hetero"]
        numpy.testing.assert_allclose(case["out"], want, atol=ATOL, rtol=0)
        numpy.testing.assert_allclose(case["out"], numpy.asarray(seq_out),
                                      atol=ATOL, rtol=0)
        numpy.testing.assert_allclose(case["loss"], float(loss),
                                      rtol=LOSS_RTOL)
        numpy.testing.assert_allclose(case["loss"], float(seq_value),
                                      rtol=LOSS_RTOL)
        stage = case["stage"]
        jax_new = unflattens[stage](new_stack[stage])
        for k, got in case["params"].items():
            if got.ndim == 4:
                got = got.transpose(2, 3, 1, 0)   # OIHW -> HWIO
            numpy.testing.assert_allclose(got, numpy.asarray(jax_new[k]),
                                          atol=ATOL, rtol=0)
            numpy.testing.assert_allclose(
                got, numpy.asarray(params[stage][k] -
                                   LR * seq_grads[stage][k]),
                atol=ATOL, rtol=0)


def test_flagship_trunk_pipelines_as_jax_s(world, flagship):
    fns, params, xs, ys = flagship
    jm = jax_mesh({"pipe": N_STAGES}, devices=jax.devices()[:N_STAGES])
    jparams = [[{k: jnp.asarray(v) for k, v in p.items()} for p in stage]
               for stage in params]
    stacked, unflattens = jax_pp.stack_stage_params(jparams)
    want = numpy.asarray(jax_pp.hetero_pipeline_apply(
        fns, jparams, stacked, unflattens, xs, jm))
    new_stack, loss = jax_pp.hetero_pipeline_train_step(
        fns, jparams, stacked, unflattens, xs, ys, _xent, jm,
        learning_rate=LR)
    for report in world:
        case = report["value"]["flagship"]
        numpy.testing.assert_allclose(case["out"], want, atol=ATOL, rtol=0)
        numpy.testing.assert_allclose(case["loss"], float(loss),
                                      rtol=LOSS_RTOL)
        stage = case["stage"]
        jax_new = unflattens[stage](new_stack[stage])
        for got, want_layer in zip(case["params"], jax_new):
            assert sorted(got) == sorted(want_layer)
            for k in got:
                numpy.testing.assert_allclose(
                    got[k], numpy.asarray(want_layer[k]), atol=ATOL, rtol=0)


SEED = 1234


@pytest.fixture(scope="module")
def data_world(tmp_path_factory):
    return run_world(ranks.data_pipeline_world, 4,
                     (_port_trunk(), TRUNK_X, TRUNK_Y, LR, SEED),
                     timeout=WORLD_S,
                     workdir=str(tmp_path_factory.mktemp("pipe_data")))


def _check_stage(case, want_new):
    for k, got in case["params"].items():
        if got.ndim == 4:
            got = got.transpose(2, 3, 1, 0)   # OIHW -> HWIO
        numpy.testing.assert_allclose(got, want_new[k], atol=ATOL, rtol=0)


def test_pipeline_with_a_data_axis_matches_jax(data_world):
    jm = jax_mesh({"pipe": N_STAGES, "data": 2},
                  devices=jax.devices()[:2 * N_STAGES])
    fns = [_jax_conv, _jax_fc]
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in TRUNK]
    stacked, unflattens = jax_pp.stack_stage_params(params)
    want = numpy.asarray(jax_pp.hetero_pipeline_apply(
        fns, params, stacked, unflattens, TRUNK_X, jm, data_axis="data"))
    new_stack, loss = jax_pp.hetero_pipeline_train_step(
        fns, params, stacked, unflattens, TRUNK_X, TRUNK_Y, _xent, jm,
        data_axis="data", learning_rate=LR)
    for report in data_world:
        case = report["value"]["deterministic"]
        numpy.testing.assert_allclose(case["out"], want, atol=ATOL, rtol=0)
        numpy.testing.assert_allclose(case["loss"], float(loss),
                                      rtol=LOSS_RTOL)
        _check_stage(case, {k: numpy.asarray(v) for k, v in unflattens[
            case["stage"]](new_stack[case["stage"]]).items()})


def test_stochastic_stages_use_the_pipeline_keys(data_world):
    out, loss, new = ranks.sequential_dropout(_port_trunk(), TRUNK_X,
                                              TRUNK_Y, LR, SEED)
    for report in data_world:
        case = report["value"]["dropout"]
        numpy.testing.assert_allclose(case["out"], out, atol=ATOL, rtol=0)
        numpy.testing.assert_allclose(case["loss"], loss, rtol=LOSS_RTOL)
        stage = new[case["stage"]]
        for k, got in case["params"].items():
            numpy.testing.assert_allclose(got, stage[k], atol=ATOL, rtol=0)
        assert numpy.abs(report["value"]["other seed"] - out).max() > 1e-2


def test_pipeline_ranks_load_neither_jax_nor_the_jax_package(world,
                                                              data_world):
    for report in world + data_world:
        assert report["bad_modules"] == []
