"""The BASELINE model family on the port against the JAX package's
``FusedTrainer`` and ``SOMFusedRunner``, on the CPU.

Each path is built in JAX as the JAX package builds it (``MnistWorkflow``
or ``StandardWorkflow`` with ``MnistLoader`` over ``golden_digits``,
``CifarWorkflow`` over ``golden_objects``, ``MnistAEWorkflow``) at the
models' own widths and reduced sample counts: 40 training samples in
minibatches of 16 (a short tail of 8) and 12 validation samples (one
padded batch). The port builds the same layers from the JAX initial
weights over its own loaders, with its streams seeded as the JAX run's
were, and both train two epochs.

Tolerances (float32): per-batch losses 1e-5 absolute; parameters and
solver state 1e-6 absolute (weights ~0.1; XLA's and oneDNN's products
and convolutions add in different orders); the gradient norms 1e-5
relative; error counts, confusion matrices and the epoch the decision
stops at exactly. Adam alone needs a looser bound (see
:func:`_assert_close`): its step ``lr * m / (sqrt(v) + eps)`` has the
size of ``lr`` whatever the gradient's, so where a weight's gradient
over the batch cancels to rounding noise (read: 10 of the first layer's
78400 weights) the two summation orders move it by up to 1.4e-3 of lr
apart.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher  # noqa: E402
from veles_tpu.loader.base import TRAIN, VALIDATION  # noqa: E402
from veles_tpu.models import mnist as jax_mnist  # noqa: E402
from veles_tpu.models.cifar import CifarWorkflow  # noqa: E402
from veles_tpu.models.mnist_ae import (KohonenWorkflow,  # noqa: E402
                                       MnistAEWorkflow)
from veles_tpu.nn import kohonen as jax_kohonen  # noqa: E402
from veles_tpu.standard_workflow import StandardWorkflow  # noqa: E402
from veles_tpu.train import FusedTrainer as JaxFusedTrainer  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.convert import (params_to_jax,  # noqa: E402
                                     solver_state_to_jax)
from veles_tpu_torch.datasets import golden_digits, golden_objects  # noqa
from veles_tpu_torch.models.build import (LAYER_TYPES,  # noqa: E402
                                          build_model, build_training)
from veles_tpu_torch.models.cifar import (CIFAR_LAYERS,  # noqa: E402
                                          CIFAR_SAMPLE_SHAPE,
                                          CIFAR_TRAINING, CifarLoader)
from veles_tpu_torch.models.mnist import (MNIST_LAYERS,  # noqa: E402
                                          MNIST_SAMPLE_SHAPE,
                                          MNIST_TRAINING, MnistLoader)
from veles_tpu_torch.models.mnist_ae import (AutoencoderLoader,  # noqa
                                             autoencoder_layers)
from veles_tpu_torch.models.parity import (AE_TRAINING,  # noqa: E402
                                           CONV_LAYERS, CONV_TRAINING)
from veles_tpu_torch.nn.kohonen import (SOMCodebook,  # noqa: E402
                                        som_quality)
from veles_tpu_torch.train.som import SOMRunner  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHT_SEED, LOADER_SEED = 21, 22
N_TRAIN, N_VALID, MINIBATCH = 40, 12, 16
DIGITS = golden_digits(N_TRAIN, N_VALID, seed=31)
OBJECTS = golden_objects(N_TRAIN, N_VALID, seed=32)


def _seed_jax():
    jax_prng.get().seed(WEIGHT_SEED)
    jax_prng.get("loader").seed(LOADER_SEED)


def _jax_fc(solver="sgd", **kwargs):
    if solver == "sgd":
        return jax_mnist.MnistWorkflow(
            DummyLauncher(), provider=DIGITS, layers=(100,),
            minibatch_size=MINIBATCH, **kwargs)
    return StandardWorkflow(
        DummyLauncher(), loader=lambda w: jax_mnist.MnistLoader(
            w, provider=DIGITS, minibatch_size=MINIBATCH),
        layers=MNIST_LAYERS, loss="softmax", solver=solver, **kwargs)


#: path -> (JAX workflow factory, port layers, sample shape, port loader
#: factory, build_training keywords)
PATHS = {
    "mnist-fc": (
        lambda: _jax_fc(learning_rate=0.1),
        MNIST_LAYERS, MNIST_SAMPLE_SHAPE,
        lambda: MnistLoader(provider=DIGITS, minibatch_size=MINIBATCH),
        dict(MNIST_TRAINING)),
    "mnist-fc-adam": (
        lambda: _jax_fc("adam", learning_rate=0.01, weights_decay=1e-3),
        MNIST_LAYERS, MNIST_SAMPLE_SHAPE,
        lambda: MnistLoader(provider=DIGITS, minibatch_size=MINIBATCH),
        dict(learning_rate=0.01, weights_decay=1e-3, solver="adam")),
    "mnist-conv": (
        lambda: StandardWorkflow(
            DummyLauncher(), loader=lambda w: jax_mnist.MnistLoader(
                w, provider=DIGITS, flatten=False,
                minibatch_size=MINIBATCH),
            layers=CONV_LAYERS, loss="softmax", **CONV_TRAINING),
        CONV_LAYERS, (28, 28, 1),
        lambda: MnistLoader(provider=DIGITS, flatten=False,
                            minibatch_size=MINIBATCH),
        dict(CONV_TRAINING)),
    "cifar-quick": (
        lambda: CifarWorkflow(DummyLauncher(), provider=OBJECTS,
                              minibatch_size=MINIBATCH),
        CIFAR_LAYERS, CIFAR_SAMPLE_SHAPE,
        lambda: CifarLoader(provider=OBJECTS, minibatch_size=MINIBATCH),
        dict(CIFAR_TRAINING)),
    "mnist-ae": (
        lambda: MnistAEWorkflow(DummyLauncher(), provider=DIGITS,
                                bottleneck=100, minibatch_size=MINIBATCH,
                                **AE_TRAINING),
        autoencoder_layers(784, 100), MNIST_SAMPLE_SHAPE,
        lambda: AutoencoderLoader(provider=DIGITS, minibatch_size=MINIBATCH),
        dict(AE_TRAINING, loss="mse")),
}


def _trainers(path, **overrides):
    """(the JAX trainer, the port's trainer from its initial weights)."""
    jax_factory, layers, sample, loader, hyper = PATHS[path]
    _seed_jax()
    wf = jax_factory()
    wf.initialize(device=Device(backend="cpu"))
    jt = JaxFusedTrainer(wf)
    params, _ = jt.pull_params()
    prng.get().seed(WEIGHT_SEED)
    prng.get("loader").seed(LOADER_SEED)
    hyper = dict(hyper, **overrides)
    pt = build_training(
        layers, sample, loader(),
        params=[{k: numpy.asarray(v) for k, v in p.items()} for p in params],
        device="cpu", **hyper)
    return jt, pt


def _jax_epochs(jt, epochs=2):
    """Per epoch: validation (losses, metrics, confusion), training
    (losses, metrics), the training batches' gradient norms."""
    params, states = jt.pull_params()
    out = []
    for epoch in range(epochs):
        valid = jt.eval_class(params, VALIDATION)
        params, states, losses, metrics = jt.train_class(params, states)
        out.append((valid, (losses, metrics),
                    numpy.asarray(jt.last_grad_norms)))
        jt.loader.epoch_number = epoch + 1
        jt.loader.shuffle()
    return params, states, out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_two_epochs_match_the_jax_fused_trainer(path):
    jt, pt = _trainers(path)
    assert pt.loss_kind == jt.loss_kind
    params, states, jax_epochs = _jax_epochs(jt)
    for epoch, (valid, train, norms) in enumerate(jax_epochs):
        stats = pt.run_epoch(epoch)
        assert stats["train"]["losses"].shape == (3,)
        numpy.testing.assert_allclose(stats["validation"]["losses"],
                                      numpy.asarray(valid[0]), atol=1e-5,
                                      rtol=0)
        numpy.testing.assert_allclose(stats["train"]["losses"],
                                      numpy.asarray(train[0]), atol=1e-5,
                                      rtol=0)
        for klass, (_, metrics) in (("validation", valid[:2]),
                                    ("train", train)):
            want = float(jnp.sum(metrics))
            if pt.loss_kind == "softmax":
                assert stats[klass]["metric"] == want
            else:
                assert abs(stats[klass]["metric"] - want) <= 1e-5 * want
        if pt.loss_kind == "softmax":
            numpy.testing.assert_array_equal(
                stats["validation"]["confusion"], numpy.asarray(valid[2]))
            assert stats["validation"]["confusion"].sum() == N_VALID
        else:
            assert valid[2] is None and "confusion" not in \
                stats["validation"]
            assert stats["validation"]["rmse"] == pytest.approx(
                (stats["validation"]["metric"] / N_VALID) ** 0.5)
        numpy.testing.assert_allclose(pt.last_grad_norms.numpy(), norms,
                                      rtol=1e-5, atol=0)
    adam = pt.solver.name == "adam"
    for got, want in zip(params_to_jax(pt.model), params):
        for k in want:
            _assert_close(got[k], want[k], adam)
    for got, want in zip(solver_state_to_jax(pt.states), states):
        for key, value in want.items():
            if isinstance(value, dict):
                for k in value:
                    _assert_close(got[key][k], value[k], adam)
            else:
                assert float(got[key]) == float(value) == 6.0


def _assert_close(got, want, adam):
    """1e-6 absolute; under Adam on all but 1 in 1000 elements, and
    the whole tensor within 1e-5 of its norm."""
    want = numpy.asarray(want)
    if not adam:
        numpy.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        return
    assert (numpy.abs(got - want) > 1e-6).mean() <= 1e-3
    assert numpy.linalg.norm(got - want) <= 1e-5 * numpy.linalg.norm(want)


def test_the_mse_loss_divides_by_the_valid_rows():
    """On the AE's short tail (8 of 16 rows valid) the MSE gradient
    divides by the 8 valid rows (``jax.grad`` of the JAX trainer's
    loss), where softmax's divides by the padded 16: the port's weight
    gradients within 1e-5 of their norm, and twice the gradient that a
    division by the padded batch would give."""
    jt, pt = _trainers("mnist-ae")
    params, _ = jt.pull_params()
    idx = jt._segment_indices(TRAIN)[2]
    assert (idx >= 0).sum() == 8
    x, truth = jt._gather(jt._data_args, jnp.asarray(idx))
    valid = jnp.asarray(idx) >= 0

    def loss(plist):
        out = jt._forward(plist, x, None, train=True)
        return jt._loss_and_metrics(out, truth, valid)[0]

    import jax
    want = jax.grad(loss)(params)
    pt.gradients(torch.from_numpy(idx), 2, 0)
    for layer, ref in zip(pt.params, want):
        got = layer["weights"].grad.numpy()
        ref = numpy.asarray(ref["weights"])
        assert numpy.linalg.norm(got - ref) <= 1e-5 * numpy.linalg.norm(ref)
        assert numpy.linalg.norm(got / 2 - ref) > 0.4 * numpy.linalg.norm(
            ref)


def test_train_stops_where_the_jax_decision_stops():
    """``train(max_epochs, fail_iterations)`` against the JAX trainer's
    ``train()`` with the decision's stop: the same epochs, best epoch
    and validation error rates, stopped before ``max_epochs``."""
    _seed_jax()
    wf = _jax_fc(learning_rate=0.1, max_epochs=8, fail_iterations=0)
    wf.initialize(device=Device(backend="cpu"))
    jt = JaxFusedTrainer(wf)
    params, _ = jt.pull_params()
    params = [{k: numpy.asarray(v) for k, v in p.items()} for p in params]
    want = jt.train()
    prng.get().seed(WEIGHT_SEED)
    prng.get("loader").seed(LOADER_SEED)
    pt = build_training(MNIST_LAYERS, MNIST_SAMPLE_SHAPE, MnistLoader(
        provider=DIGITS, minibatch_size=MINIBATCH), params=params,
        device="cpu", **MNIST_TRAINING)
    got = pt.train(8, fail_iterations=0)
    assert len(got) == len(want) < 8
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    assert [h["validation"]["normalized"] for h in got] == [
        h["validation"]["normalized"] for h in want]
    assert pt.best_epoch == wf.decision.best_epoch
    assert pt.best_metric == wf.decision.best_metric


def test_som_matches_the_jax_runner():
    """Two sweeps (``train(1)``; the JAX epoch counter stops at the
    epoch end where the loader's epoch number reaches 1) of a 4x3 map
    over linearly normalized digits in minibatches of 16, each class's
    tail padded: the codebook within 1e-5 of ``SOMFusedRunner``'s, and
    ``som_quality`` within 1e-5 of JAX's.

    The winners decide which rows move, so they are checked first: at
    every step the port's winners are ``_winners`` of the same codebook
    and rows, and each winner beats the runner-up by at least 2e-5 of
    the distances' scale, ten times what float32 rounding of a 784-term
    dot moves them (~1.7e-6): no winner of this data sits on a near
    tie."""
    sx, sy = 4, 3
    _seed_jax()
    wf = KohonenWorkflow(
        DummyLauncher(), loader_factory=lambda w: jax_mnist.MnistLoader(
            w, provider=DIGITS, minibatch_size=MINIBATCH), sx=sx, sy=sy,
        epochs=1)
    wf.initialize(device=Device(backend="cpu"))
    initial = numpy.array(wf.trainer.weights.map_read())
    prng.get().seed(WEIGHT_SEED)
    prng.get("loader").seed(LOADER_SEED)
    trainer = SOMCodebook(784, sx, sy, device="cpu")
    numpy.testing.assert_array_equal(trainer.weights.numpy(), initial)
    runner = SOMRunner(trainer, MnistLoader(provider=DIGITS,
                                            minibatch_size=MINIBATCH))
    step = trainer.step
    margins = []

    def checked_step(x):
        d = (torch.sum(trainer.weights ** 2, 1)[None, :] -
             2 * x @ trainer.weights.t())
        top2 = torch.topk(-d, 2, dim=1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min() /
                             d.abs().max()))
        want = numpy.asarray(jax_kohonen._winners(
            jnp.asarray(trainer.weights.numpy()), jnp.asarray(x.numpy())))
        win = step(x)
        numpy.testing.assert_array_equal(win.numpy(), want)
        return win

    trainer.step = checked_step
    runner.train(1)
    jax_runner = wf.make_fused_runner()
    assert type(jax_runner).__name__ == "SOMFusedRunner"
    jax_runner.run()
    assert trainer.time == wf.trainer.time == 2 * (1 + 3)
    assert min(margins) > 2e-5
    want = numpy.asarray(wf.trainer.weights.map_read())
    numpy.testing.assert_allclose(trainer.weights.numpy(), want, atol=1e-5,
                                  rtol=0)
    assert numpy.abs(trainer.weights.numpy() - initial).max() > 1e-2
    data = runner.loader.original_data[N_VALID:].numpy()
    got_q = som_quality(trainer.weights, sx, sy, data)
    want_q = jax_kohonen.som_quality(want, sx, sy, data)
    for k in want_q:
        assert got_q[k] == pytest.approx(want_q[k], abs=1e-5)
    assert got_q["quantization_error"] < som_quality(
        initial, sx, sy, data)["quantization_error"]


ALL_TYPES = [
    {"type": "conv", "n_kernels": 3, "kx": 3, "ky": 3, "padding": 1},
    {"type": "activation", "activation": "tanh"},
    {"type": "maxabs_pooling", "kx": 2, "ky": 2},
    {"type": "depooling", "kx": 2, "ky": 2},
    {"type": "deconv", "n_kernels": 4, "kx": 3, "ky": 3, "sliding": (2, 2),
     "padding": "SAME", "include_bias": True},
    {"type": "conv_tanh", "n_kernels": 4, "kx": 3, "ky": 3,
     "sliding": (2, 2)},
    {"type": "conv_sigmoid", "n_kernels": 4, "kx": 1, "ky": 1},
    {"type": "conv_str", "n_kernels": 4, "kx": 1, "ky": 1},
    {"type": "conv_relu", "n_kernels": 4, "kx": 1, "ky": 1},
    {"type": "norm", "n": 3},
    {"type": "avg_pooling", "kx": 2, "ky": 2},
    {"type": "max_pooling", "kx": 1, "ky": 1},
    {"type": "all2all_sigmoid", "output_sample_shape": 8},
    {"type": "all2all_str", "output_sample_shape": 8},
    {"type": "all2all_relu", "output_sample_shape": 8},
    {"type": "all2all_tanh", "output_sample_shape": 8},
    {"type": "dropout", "dropout_ratio": 0.3},
    {"type": "all2all", "output_sample_shape": 8},
    {"type": "softmax", "output_sample_shape": 10},
]


#: the sequence layers, on (seq, dim) samples
SEQUENCE_TYPES = [
    {"type": "attention", "heads": 2, "causal": True},
    {"type": "moe", "n_experts": 4, "hidden": 16},
    {"type": "softmax", "output_sample_shape": 3},
]


def test_every_layer_type_builds_and_trains():
    """Every type of ``veles_tpu/standard_workflow.py``: the image chain
    and the sequence chain each train an epoch under each solver."""
    from veles_tpu.standard_workflow import LAYER_TYPES as JAX_TYPES
    from veles_tpu_torch.models.samples import (SequenceProvider,
                                                sequence)
    chains = ({d["type"] for d in ALL_TYPES}, {d["type"] for d in
                                                SEQUENCE_TYPES})
    assert sorted(chains[0] | chains[1]) == sorted(LAYER_TYPES)
    assert sorted(JAX_TYPES) == sorted(LAYER_TYPES)
    for solver in ("sgd", "adagrad", "adadelta", "adam"):
        prng.get("loader").seed(1)
        loader = CifarLoader(synthetic_samples=20, minibatch_size=8)
        trainer = build_training(
            [dict(d) for d in ALL_TYPES], CIFAR_SAMPLE_SHAPE[:2] + (3,),
            loader, seed=3, device="cpu", solver=solver,
            learning_rate=0.01)
        stats = trainer.run_epoch(0)
        assert numpy.isfinite(stats["train"]["loss"])
        sample = sequence(SequenceProvider(n_train=20, n_valid=4, seq=4,
                                           dim=8, n_classes=3),
                          minibatch_size=8)
        trainer = build_training(
            [dict(d) for d in SEQUENCE_TYPES], sample.sample_shape,
            sample.loader, seed=3, device="cpu", solver=solver,
            learning_rate=0.01)
        stats = trainer.run_epoch(0)
        assert numpy.isfinite(stats["train"]["loss"])


@pytest.mark.parametrize("kind", ["attention", "moe"])
def test_attention_and_moe_name_the_later_slice(kind):
    """Both layers build and attach their sharded plans (ring attention,
    expert parallelism) on a grid of one rank, which computes the plan's
    numbers: the local attention's, and the expert path's routing of the
    batch's tokens as one shard (``moe_ffn_reference``)."""
    from veles_tpu_torch.parallel.ep import moe_ffn_reference
    from veles_tpu_torch.parallel.mesh import build_mesh
    layer = {"type": kind} if kind == "attention" else {
        "type": kind, "n_experts": 1}
    model = build_model([layer], (4, 8), seed=0, device="cpu")
    assert tuple(model[0].output_shape()) == (4, 8)
    x = torch.from_numpy(numpy.random.RandomState(2).randn(3, 4, 8).astype(
        numpy.float32))
    with torch.no_grad():
        if kind == "attention":
            want = model(x)
            model[0].use_ring(build_mesh({"seq": 1}))
        else:
            unit = model[0]
            want = moe_ffn_reference(x.reshape(-1, 8), unit.weights,
                                     unit.up, unit.down, 1).reshape(
                x.shape) + x
            model[0].use_experts(build_mesh({"expert": 1}))
        numpy.testing.assert_allclose(model(x).numpy(), want.numpy(),
                                      atol=1e-6, rtol=0)


def test_losses_and_truths_must_agree():
    with pytest.raises(ValueError, match="targets"):
        build_training(MNIST_LAYERS, MNIST_SAMPLE_SHAPE,
                       MnistLoader(provider=DIGITS), seed=0, device="cpu",
                       loss="mse")
    with pytest.raises(ValueError, match="loss must be"):
        build_training(MNIST_LAYERS, MNIST_SAMPLE_SHAPE,
                       MnistLoader(provider=DIGITS), seed=0, device="cpu",
                       loss="hinge")


def test_training_paths_import_neither_jax_nor_the_jax_package():
    """A fresh interpreter trains an epoch of mnist-fc, cifar-quick and
    mnist-ae and sweeps the SOM once, on the CPU, and never loads jax or
    any veles_tpu module."""
    code = (
        "import sys, math\n"
        "from veles_tpu_torch.datasets import golden_digits, "
        "golden_objects\n"
        "from veles_tpu_torch.models.build import build_training\n"
        "from veles_tpu_torch.models.mnist import MNIST_LAYERS, "
        "MnistLoader\n"
        "from veles_tpu_torch.models.cifar import CIFAR_LAYERS, "
        "CIFAR_TRAINING, CifarLoader\n"
        "from veles_tpu_torch.models.mnist_ae import AutoencoderLoader, "
        "autoencoder_layers\n"
        "from veles_tpu_torch.nn.kohonen import SOMCodebook\n"
        "from veles_tpu_torch.train.som import SOMRunner\n"
        "d, o = golden_digits(24, 8), golden_objects(24, 8)\n"
        "runs = [build_training(MNIST_LAYERS, (784,), MnistLoader("
        "provider=d, minibatch_size=8), seed=0, device='cpu', "
        "solver='adam'),\n"
        "        build_training(CIFAR_LAYERS, (32, 32, 3), CifarLoader("
        "provider=o, minibatch_size=8), seed=0, device='cpu', "
        "**CIFAR_TRAINING),\n"
        "        build_training(autoencoder_layers(784), (784,), "
        "AutoencoderLoader(provider=d, minibatch_size=8), seed=0, "
        "device='cpu', loss='mse', learning_rate=0.001)]\n"
        "for t in runs:\n"
        "    assert math.isfinite(t.run_epoch(0)['train']['loss'])\n"
        "SOMRunner(SOMCodebook(784, 4, 4, device='cpu'), MnistLoader("
        "provider=d, minibatch_size=8)).run_epoch()\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k.split('.')[0] == 'veles_tpu' or "
        "k == 'ml_dtypes')\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
