"""The port's training slice against the JAX package's, on the CPU.

A tiny AlexNet-like net on 21x21x3 -- space-to-depth conv (stride 4) ->
LRN -> max-pool -> fc -> dropout -> softmax(10) -- is built in JAX by
``AlexNetWorkflow`` over ``SyntheticImageLoader`` (40 training samples,
so minibatch 16 leaves a short tail of 8; 16 validation samples) and
trained by its ``FusedTrainer``. The port builds the same net from the
JAX initial weights (``params_from_jax``) over its own
``SyntheticImageLoader`` and trains it with its ``FusedTrainer``. JAX
runs its LRN through the fused Pallas pair in interpret mode
(``VELES_LRN=pallas``: the kernels the port ports); both sides draw the
same seeds through their ``prng`` registries.

Dropout: JAX's threefry numbers cannot come out of the port's Philox
fill, so the port is handed JAX's own ``jax.random.uniform`` numbers at
each (epoch, batch, layer) through the trainer's uniform source
(``JaxUniforms``). The Philox fill has its own tests
(``tests/test_torch_random.py``).

Tolerances (float32): a gradient of one batch is held to 1e-5 of its
layer's gradient norm (read: ~2.8e-7; XLA's and oneDNN's convolutions
and the LRN's window sums add in different orders). Two epochs of SGD
(6 steps) are held to 1e-5 on each batch loss (read: ~2e-7 on losses of
~2.3) and 1e-6 absolute on parameters and velocities (read: ~7e-9 on
weights of ~0.1).
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
from veles_tpu.dummy import DummyLauncher  # noqa: E402
from veles_tpu.loader.base import TRAIN, VALIDATION  # noqa: E402
from veles_tpu.models.alexnet import AlexNetWorkflow  # noqa: E402
from veles_tpu.models.alexnet import \
    SyntheticImageLoader as JaxSyntheticImageLoader  # noqa: E402
from veles_tpu.nn import precision as jax_precision  # noqa: E402
from veles_tpu.train import FusedTrainer as JaxFusedTrainer  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.convert import (params_to_jax,  # noqa: E402
                                     sgd_state_from_jax, sgd_state_to_jax,
                                     to_jax_layout)
from veles_tpu_torch.models.alexnet import (ALEXNET_TRAINING,  # noqa: E402
                                            SyntheticImageLoader)
from veles_tpu_torch.models.build import build_training  # noqa: E402
from veles_tpu_torch.nn.optim import get_solver  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = [
    {"type": "conv_str", "n_kernels": 8, "kx": 5, "ky": 5,
     "sliding": (4, 4), "padding": 2, "space_to_depth": True},
    {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_str", "output_sample_shape": 32},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 10},
]
SAMPLE = (21, 21, 3)
LOADER = dict(n_train=40, n_valid=16, side=21, n_classes=10,
              minibatch_size=16)
WEIGHT_SEED, LOADER_SEED = 7, 8


@pytest.fixture(autouse=True)
def _pallas_lrn(monkeypatch):
    monkeypatch.setenv("VELES_LRN", "pallas")


def _jax_trainer(stage_s2d=True, dtype="float32", **kwargs):
    jax_prng.get().seed(WEIGHT_SEED)
    jax_prng.get("loader").seed(LOADER_SEED)
    wf = AlexNetWorkflow(
        DummyLauncher(),
        loader_factory=lambda w: JaxSyntheticImageLoader(
            w, dtype=dtype, **LOADER),
        layers=TINY, max_epochs=2, **kwargs)
    wf.initialize(device=Device(backend="cpu"))
    return JaxFusedTrainer(wf, stage_s2d=stage_s2d)


class JaxUniforms(object):
    """A uniform source that hands the port the numbers the JAX trainer
    draws: epoch e's base key is ``fold_in(PRNGKey(seed), counter + e)``
    of the JAX dropout stream (``jax_key()``), batch b and layer i fold
    in after it."""

    def __init__(self, seed_value, counter):
        self.seed_value, self.counter = seed_value, counter
        self.bases = {}

    def base(self, epoch):
        return jax.random.fold_in(jax.random.PRNGKey(self.seed_value),
                                  self.counter + epoch)

    def __call__(self, shape, seed, batch_index, layer_index, device):
        if seed not in self.bases:
            self.bases[seed] = self.base(len(self.bases))
        key = jax.random.fold_in(jax.random.fold_in(
            self.bases[seed], batch_index), layer_index)
        return torch.from_numpy(numpy.array(
            jax.random.uniform(key, shape))).to(device)


def _port_trainer(jax_trainer, policy="float32", **kwargs):
    """The port's trainer from the JAX trainer's initial weights, its
    streams seeded as the JAX run's were."""
    params, _ = jax_trainer.pull_params()
    dropout_stream = jax_prng.get("default")
    source = JaxUniforms(dropout_stream.seed_value,
                         dropout_stream.save_state()[1])
    prng.get().seed(WEIGHT_SEED)
    prng.get("loader").seed(LOADER_SEED)
    hyper = dict(ALEXNET_TRAINING)
    hyper.update(kwargs)
    return build_training(
        TINY, SAMPLE, SyntheticImageLoader(**LOADER),
        params=[{k: numpy.asarray(v) for k, v in p.items()}
                for p in params], policy=policy, device="cpu",
        uniform_source=source, **hyper)


def _grad_share(port, reference):
    """Largest ||port - reference|| / ||reference|| over the layers'
    weight and bias gradients (JAX layout)."""
    worst = 0.0
    for got, want in zip(port, reference):
        for k in want:
            ref = numpy.asarray(want[k], numpy.float64)
            worst = max(worst, numpy.linalg.norm(got[k] - ref) /
                        numpy.linalg.norm(ref))
    return worst


def _gradients(jax_trainer, port_trainer, batch, perturb=None):
    """One batch's per-layer gradients from both trainers, JAX layout.
    ``perturb`` changes the port's uniform source (a control)."""
    params, _ = jax_trainer.pull_params()
    idx = jax_trainer._segment_indices(TRAIN)[batch]
    x, truth = jax_trainer._gather(jax_trainer._data_args,
                                   jnp.asarray(idx))
    valid = jnp.asarray(idx) >= 0
    source = port_trainer.uniform_source
    key = jax.random.fold_in(source.base(0), batch)

    def loss(plist):
        out = jax_trainer._forward(plist, x, key, train=True)
        return jax_trainer._loss_and_metrics(out, truth, valid)[0]

    want = jax.grad(loss)(params)
    source.bases = {0: source.base(0) if perturb is None else perturb}
    port_trainer.gradients(torch.from_numpy(idx), batch, 0)
    got = [to_jax_layout({k: p.grad for k, p in layer.items()})
           for layer in port_trainer.params]
    return got, [{k: numpy.asarray(v) for k, v in layer.items()}
                 for layer in want]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_data_bytes_and_index_matrices_match(dtype):
    """The port's synthetic data holds the JAX loader's bytes (bf16
    through ``ml_dtypes`` there, ``Tensor.to`` here: both round to
    nearest even), and the index matrices of two epochs, shuffles
    included, are equal."""
    jt = _jax_trainer(stage_s2d=False, dtype=dtype)
    prng.get("loader").seed(LOADER_SEED)
    loader = SyntheticImageLoader(dtype=dtype, **LOADER).initialize()
    ours = loader.original_data.contiguous().view(torch.uint8).numpy()
    theirs = numpy.ascontiguousarray(
        jt.loader.original_data.map_read()).view(numpy.uint8)
    assert ours.shape == theirs.shape
    numpy.testing.assert_array_equal(ours, theirs)
    numpy.testing.assert_array_equal(
        loader.original_labels.numpy(), jt.loader.original_labels.map_read())
    port = build_training(TINY, SAMPLE, loader, seed=1, device="cpu")
    for _ in range(2):
        for klass in (VALIDATION, TRAIN):
            numpy.testing.assert_array_equal(
                port._segment_indices(klass), jt._segment_indices(klass))
        assert (port._segment_indices(TRAIN) == -1).sum() == 8
        loader.shuffle()
        jt.loader.shuffle()


@pytest.mark.parametrize("batch", [0, 2], ids=["full", "short_tail"])
def test_one_batch_gradients_match_jax_grad(batch):
    """Every layer's weight and bias gradient of one batch against
    ``jax.grad`` of the JAX trainer's ``_forward`` + ``_loss_and_metrics``
    (grad loss over the padded batch); batch 2 is the short tail."""
    jt = _jax_trainer(stage_s2d=False)
    pt = _port_trainer(jt)
    got, want = _gradients(jt, pt, batch)
    assert _grad_share(got, want) < 1e-5
    # a control the check must see: the dropout masks of another key
    bad, _ = _gradients(jt, pt, batch, perturb=jax.random.PRNGKey(99))
    assert _grad_share(bad, want) > 0.1


def _run_both(jt, pt, epochs=2):
    """``epochs`` epochs in both: per-batch losses of each class."""
    params, states = jt.pull_params()
    jax_losses, port_losses = [], []
    for epoch in range(epochs):
        valid, _, _ = jt.eval_class(params, VALIDATION)
        params, states, train, _ = jt.train_class(params, states)
        jt.loader.epoch_number = epoch + 1
        jt.loader.shuffle()
        jax_losses.append((numpy.asarray(valid), numpy.asarray(train)))
        stats = pt.run_epoch(epoch)
        port_losses.append((stats["validation"]["losses"],
                            stats["train"]["losses"]))
    return params, states, jax_losses, port_losses


def _assert_runs_match(params, states, jax_losses, port_losses, pt):
    for (jv, jtr), (pv, ptr) in zip(jax_losses, port_losses):
        assert ptr.shape == jtr.shape == (3,)
        numpy.testing.assert_allclose(pv, jv, atol=1e-5, rtol=0)
        numpy.testing.assert_allclose(ptr, jtr, atol=1e-5, rtol=0)
    got_params = params_to_jax(pt.model)
    got_states = sgd_state_to_jax(pt.states)
    for i, want in enumerate(params):
        for k in want:
            numpy.testing.assert_allclose(got_params[i][k],
                                          numpy.asarray(want[k]),
                                          atol=1e-6, rtol=0)
            numpy.testing.assert_allclose(
                got_states[i]["velocity"][k],
                numpy.asarray(states[i]["velocity"][k]), atol=1e-6, rtol=0)
        if want:
            assert got_states[i]["step"] == float(states[i]["step"]) == 6.0


def test_two_epochs_match_losses_params_and_velocity():
    jt = _jax_trainer()
    pt = _port_trainer(jt)
    _assert_runs_match(*_run_both(jt, pt), pt)


def test_lr_decay_and_learning_rate_bias_match():
    """``lr_decay`` scales the rate by decay**step inside the velocity
    (not ``torch.optim.SGD``), and ``learning_rate_bias`` overrides the
    rate of every bias."""
    jt = _jax_trainer(lr_decay=0.8)
    for gd in jt.workflow.gds:
        gd.learning_rate_bias = 0.05
    jt = JaxFusedTrainer(jt.workflow)
    pt = _port_trainer(jt, lr_decay=0.8, learning_rate_bias=0.05)
    assert pt.hypers[0] == {"learning_rate": 0.01, "weight_decay": 5e-4,
                            "momentum": 0.9, "lr_decay": 0.8,
                            "lr_overrides": {"bias": 0.05}}
    _assert_runs_match(*_run_both(jt, pt), pt)


def test_bfloat16_policy_gradients():
    """Under the ``bfloat16`` policy both sides round activations,
    operands and conv outputs to bf16 at the same points, but the JAX
    chain takes the fc backward from the pre-activation in float32 where
    the port, as ``fused_linear``, casts dpre to bf16 before the
    products: one bf16 rounding (2^-8) apart. Read: 2.6e-3 of a layer's
    gradient norm; limit 2e-2. The dropout masks of another key read
    ~1 and must fail it."""
    jax_precision.set_policy("bfloat16")
    try:
        jt = _jax_trainer(stage_s2d=False)
        pt = _port_trainer(jt, policy="bfloat16")
        got, want = _gradients(jt, pt, 0)
        bad, _ = _gradients(jt, pt, 0, perturb=jax.random.PRNGKey(99))
    finally:
        jax_precision.set_policy(None)
    assert _grad_share(got, want) < 2e-2
    assert _grad_share(bad, want) > 2e-2


def test_state_dicts_cross_both_ways():
    """pull/push round-trips the trainer's state, and the SGD state
    crosses to the JAX layout and back unchanged."""
    jt = _jax_trainer()
    pt = _port_trainer(jt)
    pt.run_epoch(0)
    params, states = pt.pull_params()
    back = sgd_state_from_jax(pt.model, sgd_state_to_jax(pt.states))
    for mine, theirs in zip(pt.states, back):
        if mine:
            for k in mine["velocity"]:
                assert torch.equal(mine["velocity"][k], theirs["velocity"][k])
            assert torch.equal(mine["step"], theirs["step"])
    before = params_to_jax(pt.model)
    pt.run_epoch(1)
    pt.push_params(params, states)
    for a, b in zip(params_to_jax(pt.model), before):
        for k in b:
            numpy.testing.assert_array_equal(a[k], b[k])


def test_an_unknown_solver_raises():
    with pytest.raises(ValueError):
        get_solver("rmsprop")


def test_training_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_training(TINY, SAMPLE, SyntheticImageLoader(**LOADER), seed=1)


def test_training_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter that imports the port and trains one epoch
    (Philox dropout masks, K4/K6 plain versions) never loads jax or any
    veles_tpu module."""
    code = (
        "import sys, math\n"
        "from veles_tpu_torch.models.alexnet import SyntheticImageLoader\n"
        "from veles_tpu_torch.models.build import build_training\n"
        "layers = %r\n"
        "loader = SyntheticImageLoader(n_train=20, n_valid=8, side=21, "
        "n_classes=10, minibatch_size=8)\n"
        "t = build_training(layers, (21, 21, 3), loader, seed=0, "
        "device='cpu', learning_rate=0.01, momentum=0.9)\n"
        "stats = t.run_epoch(0)\n"
        "assert math.isfinite(stats['train']['loss'])\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'veles_tpu' or "
        "k.startswith('veles_tpu.') or k == 'ml_dtypes')\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n") % (TINY,)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
