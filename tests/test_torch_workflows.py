"""The model-family workflow classes, the parity harness and the
programmatic entry of the port against the JAX package's, on the CPU.

* Each class (``CifarWorkflow``, ``MnistAEWorkflow``, ``WineWorkflow``,
  ``LinesWorkflow``, ``KanjiWorkflow``, ``SequenceWorkflow`` with and
  without MoE) hands ``StandardWorkflow`` the JAX class's descriptors and
  training keywords, and its loader the same minibatch and
  normalization; built from the same seeds over the same small
  providers (a few hundred samples at most, kanji and the sequences cut)
  with the JAX initial weights carried over (``convert.params_from_jax``),
  two epochs through ``train.runner.trainer_for`` hold to JAX's
  ``FusedTrainer(wf)``: per-batch losses 1e-5 absolute, error counts and
  confusion exactly, parameters and SGD velocity 1e-6 absolute
  (``tests/test_torch_models.py``'s bounds).
* ``MnistAEWorkflow`` calls its provider as often as JAX's;
  ``_find_workflow_class`` picks JAX's class on each model file;
  ``Main().run`` trains a file that subclasses ``CifarWorkflow``;
  ``veles_tpu_torch.run`` gives ``veles_tpu.run``'s history.
* The harness: ``train_fc``, ``train_conv``, ``train_cifar`` (error
  rates exactly), ``train_ae`` and ``train_som`` (1e-5 relative) against
  JAX's. JAX's ``train_som`` runs its eager SOM loop, which is unsteady
  in some interpreters (ROADMAP §C, in the reference): the test has it
  run its workflow's ``SOMFusedRunner`` instead.
* The small API: ``apply_overrides``'s tree, the loaders' ``MAPPING``
  names, ``unit_sizes``' units, ``set_policy``'s order, ``Solver`` and
  ``GDAttention``; an import guard.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy
import pytest

torch = pytest.importorskip("torch")

import veles_tpu  # noqa: E402
from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.__main__ import Main as JaxMain  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher  # noqa: E402
from veles_tpu.loader.base import VALIDATION  # noqa: E402
from veles_tpu.models import cifar as jax_cifar  # noqa: E402
from veles_tpu.models import mnist_ae as jax_mnist_ae  # noqa: E402
from veles_tpu.models import parity as jax_parity  # noqa: E402
from veles_tpu.models import samples as jax_samples  # noqa: E402
from veles_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow  # noqa: E402
from veles_tpu.train import FusedTrainer as JaxFusedTrainer  # noqa: E402

import veles_tpu_torch  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.__main__ import Main  # noqa: E402
from veles_tpu_torch.convert import (params_from_jax,  # noqa: E402
                                     params_to_jax, solver_state_to_jax)
from veles_tpu_torch.datasets import golden_digits, golden_objects  # noqa
from veles_tpu_torch.dummy import DummyLauncher  # noqa: E402
from veles_tpu_torch.models import cifar, mnist_ae, parity  # noqa: E402
from veles_tpu_torch.models import samples  # noqa: E402
from veles_tpu_torch.standard_workflow import StandardWorkflow  # noqa
from veles_tpu_torch.train.runner import trainer_for  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHT_SEED, LOADER_SEED = 51, 52
OBJECTS = golden_objects(60, 20, seed=33)
DIGITS = golden_digits(60, 20, seed=34)

#: class -> (JAX factory, port factory), each given the launcher; the
#: providers are the JAX package's and the port's, drawn from the same
#: seeds
CLASSES = {
    "cifar": (
        lambda l: jax_cifar.CifarWorkflow(l, provider=OBJECTS,
                                          minibatch_size=16),
        lambda l: cifar.CifarWorkflow(l, provider=OBJECTS,
                                      minibatch_size=16)),
    "mnist_ae": (
        lambda l: jax_mnist_ae.MnistAEWorkflow(
            l, provider=DIGITS, minibatch_size=16, learning_rate=0.001,
            momentum=0.9),
        lambda l: mnist_ae.MnistAEWorkflow(
            l, provider=DIGITS, minibatch_size=16, learning_rate=0.001,
            momentum=0.9)),
    "wine": (
        lambda l: jax_samples.WineWorkflow(
            l, provider=jax_samples.WineProvider(n_train=200, n_valid=60)),
        lambda l: samples.WineWorkflow(
            l, provider=samples.WineProvider(n_train=200, n_valid=60))),
    "lines": (
        lambda l: jax_samples.LinesWorkflow(
            l, provider=jax_samples.LinesProvider(n_train=100, n_valid=30)),
        lambda l: samples.LinesWorkflow(
            l, provider=samples.LinesProvider(n_train=100, n_valid=30))),
    "kanji": (
        lambda l: jax_samples.KanjiWorkflow(
            l, provider=jax_samples.KanjiProvider(n_train=60, n_valid=20),
            minibatch_size=16),
        lambda l: samples.KanjiWorkflow(
            l, provider=samples.KanjiProvider(n_train=60, n_valid=20),
            minibatch_size=16)),
    "sequence": (
        lambda l: jax_samples.SequenceWorkflow(
            l, provider=jax_samples.SequenceProvider(
                n_train=40, n_valid=12, seq=8), minibatch_size=16),
        lambda l: samples.SequenceWorkflow(
            l, provider=samples.SequenceProvider(n_train=40, n_valid=12,
                                                 seq=8),
            minibatch_size=16)),
    "sequence-moe": (
        lambda l: jax_samples.SequenceWorkflow(
            l, provider=jax_samples.SequenceProvider(
                n_train=40, n_valid=12, seq=8), minibatch_size=16,
            moe=True, n_experts=4),
        lambda l: samples.SequenceWorkflow(
            l, provider=samples.SequenceProvider(n_train=40, n_valid=12,
                                                 seq=8),
            minibatch_size=16, moe=True, n_experts=4)),
}


def _seed():
    for registry in (jax_prng, prng):
        registry.get().seed(WEIGHT_SEED)
        registry.get("loader").seed(LOADER_SEED)


def _standard_arguments(monkeypatch, cls, factory, launcher):
    """The keywords ``factory(launcher)`` hands ``cls.__init__`` (the
    loader factory left out), and the workflow."""
    seen = {}
    init = cls.__init__

    def spy(self, workflow=None, **kwargs):
        seen.update(kwargs)
        init(self, workflow, **kwargs)

    monkeypatch.setattr(cls, "__init__", spy)
    wf = factory(launcher)
    monkeypatch.setattr(cls, "__init__", init)
    seen.pop("loader")
    seen["layers"] = [dict(d) for d in seen["layers"]]
    return seen, wf


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_descriptors_and_loader_equal_jax(name, monkeypatch):
    jax_factory, port_factory = CLASSES[name]
    want, jax_wf = _standard_arguments(monkeypatch, JaxStandardWorkflow,
                                       jax_factory, JaxDummyLauncher())
    got, port_wf = _standard_arguments(monkeypatch, StandardWorkflow,
                                       port_factory, DummyLauncher())
    assert got == want
    assert port_wf.loader.max_minibatch_size == \
        jax_wf.loader.max_minibatch_size
    assert port_wf.loader.normalization_type == \
        jax_wf.loader.normalization_type
    assert [type(f).__name__ for f in port_wf.forwards] == \
        [type(f).__name__ for f in jax_wf.forwards]


def _built(name):
    """(JAX trainer, port trainer) of one class, initialized on the CPU,
    the port's weights the JAX workflow's."""
    jax_factory, port_factory = CLASSES[name]
    _seed()
    jax_wf = jax_factory(JaxDummyLauncher())
    jax_wf.initialize(device=Device(backend="cpu"))
    jt = JaxFusedTrainer(jax_wf)
    params, _ = jt.pull_params()
    port_wf = port_factory(DummyLauncher())
    port_wf.initialize(device="cpu")
    params_from_jax(port_wf.model, [{k: numpy.asarray(v) for k, v in
                                     p.items()} for p in params])
    return jt, trainer_for(port_wf)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_two_epochs_match_jax_fused_trainer(name):
    jt, pt = _built(name)
    assert pt.loss_kind == jt.loss_kind
    params, states = jt.pull_params()
    for epoch in range(2):
        valid = jt.eval_class(params, VALIDATION)
        params, states, losses, metrics = jt.train_class(params, states)
        jt.loader.epoch_number = epoch + 1
        jt.loader.shuffle()
        stats = pt.run_epoch(epoch)
        numpy.testing.assert_allclose(stats["validation"]["losses"],
                                      numpy.asarray(valid[0]), atol=1e-5,
                                      rtol=0)
        numpy.testing.assert_allclose(stats["train"]["losses"],
                                      numpy.asarray(losses), atol=1e-5,
                                      rtol=0)
        for klass, got in (("validation", valid[1]), ("train", metrics)):
            want = float(jnp.sum(got))
            if pt.loss_kind == "softmax":
                assert stats[klass]["metric"] == want
            else:
                assert abs(stats[klass]["metric"] - want) <= 1e-5 * want
        if pt.loss_kind == "softmax":
            numpy.testing.assert_array_equal(
                stats["validation"]["confusion"], numpy.asarray(valid[2]))
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


class _Counted(object):
    def __init__(self, provider):
        self.provider, self.calls = provider, 0

    def __call__(self):
        self.calls += 1
        return self.provider()


def test_autoencoder_calls_its_provider_as_jax_does():
    counts = []
    for cls, launcher, device in (
            (jax_mnist_ae.MnistAEWorkflow, JaxDummyLauncher(),
             Device(backend="cpu")),
            (mnist_ae.MnistAEWorkflow, DummyLauncher(), "cpu")):
        provider = _Counted(DIGITS)
        wf = cls(launcher, provider=provider, minibatch_size=16)
        built = provider.calls
        wf.initialize(device=device)
        counts.append((built, provider.calls))
    assert counts[0] == counts[1] == (1, 2)


MODEL_FILES = ("cifar.py", "mnist_ae.py", "samples.py")


@pytest.mark.parametrize("path", MODEL_FILES)
def test_cli_picks_jax_s_class(path):
    picked = []
    try:
        for main, package in ((JaxMain(), "veles_tpu"),
                              (Main(), "veles_tpu_torch")):
            module = main._load_model(os.path.join(REPO, package, "models",
                                                   path))
            picked.append(main._find_workflow_class(module).__name__)
    finally:
        sys.modules.pop(os.path.splitext(path)[0], None)
    assert picked[1] == picked[0]
    assert picked[0] == {"cifar.py": "CifarWorkflow",
                         "mnist_ae.py": "MnistAEWorkflow",
                         "samples.py": "WineWorkflow"}[path]


CIFAR_FILE = textwrap.dedent('''
    from veles_tpu_torch.datasets import golden_objects
    from veles_tpu_torch.models.cifar import CifarWorkflow


    class SmallCifar(CifarWorkflow):
        def __init__(self, workflow=None, **kwargs):
            super(SmallCifar, self).__init__(
                workflow, provider=golden_objects(48, 16, seed=3),
                minibatch_size=16, max_epochs=1, **kwargs)
''')


def test_cli_trains_a_cifar_subclass(tmp_path):
    import json
    path = tmp_path / "small_cifar.py"
    path.write_text(CIFAR_FILE)
    result = tmp_path / "result.json"
    main = Main()
    try:
        assert main.run([str(path), "-a", "cpu", "-s", "7",
                         "--result-file", str(result)]) == 0
    finally:
        sys.modules.pop("small_cifar", None)
    wf = main.workflow
    assert type(wf).__name__ == "SmallCifar"
    assert bool(wf.decision.complete)
    assert len(wf.decision.epoch_history) == 1
    assert json.loads(result.read_text())


def test_run_gives_jax_s_history():
    histories, params = [], []
    for run, cls, provider_cls in (
            (veles_tpu.run, jax_samples.WineWorkflow,
             jax_samples.WineProvider),
            (veles_tpu_torch.run, samples.WineWorkflow,
             samples.WineProvider)):
        _seed()
        wf = run(cls, backend="cpu", max_epochs=3,
                 provider=provider_cls(n_train=200, n_valid=60))
        assert type(wf) is cls and bool(wf.decision.complete)
        histories.append(wf.decision.epoch_history)
        params.append(wf)
    want, got = histories
    assert len(want) == 3 and got == want
    jax_wf, port_wf = params
    for got, fwd in zip(params_to_jax(port_wf.model), jax_wf.forwards):
        for k in ("weights", "bias"):
            numpy.testing.assert_allclose(
                got[k], numpy.asarray(getattr(fwd, k).map_read()),
                atol=1e-6, rtol=0)


#: harness function -> (port call, JAX call, exact)
HARNESS = {
    "fc": (lambda: parity.train_fc(DIGITS, 2, device="cpu"),
           lambda: jax_parity.train_fc(DIGITS, 2, backend="cpu"), True),
    "conv": (lambda: parity.train_conv(DIGITS, 1, device="cpu"),
             lambda: jax_parity.train_conv(DIGITS, 1, backend="cpu"),
             True),
    "cifar": (lambda: parity.train_cifar(OBJECTS, 2, device="cpu"),
              lambda: jax_parity.train_cifar(OBJECTS, 2, backend="cpu"),
              True),
    "ae": (lambda: parity.train_ae(DIGITS, 2, device="cpu"),
           lambda: jax_parity.train_ae(DIGITS, 2, backend="cpu"), False),
}


@pytest.mark.parametrize("name", sorted(HARNESS))
def test_harness_equals_jax(name):
    port_call, jax_call, exact = HARNESS[name]
    want, got = jax_call(), port_call()
    if exact:
        assert got == want
    else:
        assert got == pytest.approx(want, rel=1e-5)


def test_harness_som_equals_jax(monkeypatch):
    monkeypatch.setattr(jax_mnist_ae.KohonenWorkflow, "run",
                        lambda self: self.make_fused_runner().run())
    want = jax_parity.train_som(DIGITS, 2, sx=4, sy=4, minibatch_size=16,
                                backend="cpu")
    got = parity.train_som(DIGITS, 2, sx=4, sy=4, minibatch_size=16,
                           device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    assert got["quantization_error"] < got["untrained_quantization_error"]


def test_apply_overrides_builds_jax_s_tree():
    from veles_tpu.config import apply_overrides as jax_apply
    from veles_tpu.config import root as jax_root
    from veles_tpu_torch.config import apply_overrides, root
    pairs = ["root.overridden.a.b=3", "overridden.c='x'",
             "overridden.d=[1, 2.5]", "overridden.e=plain text",
             "overridden.a.f={'k': None}"]
    try:
        jax_apply(pairs)
        apply_overrides(pairs)
        assert root.overridden.to_dict() == jax_root.overridden.to_dict()
        assert root.overridden.a.b == 3
        for apply in (jax_apply, apply_overrides):
            with pytest.raises(ValueError, match="key=value"):
                apply(["overridden.g"])
    finally:
        for tree in (root, jax_root):
            tree.__dict__.pop("overridden", None)


def test_loader_mappings_equal_jax():
    import veles_tpu.loader.ensemble  # noqa: F401
    import veles_tpu.loader.hdfs  # noqa: F401
    import veles_tpu.loader.sound  # noqa: F401
    import veles_tpu_torch.loader.ensemble  # noqa: F401
    import veles_tpu_torch.loader.hdfs  # noqa: F401
    import veles_tpu_torch.loader.sound  # noqa: F401
    from veles_tpu.loader.base import UserLoaderRegistry as JaxRegistry
    from veles_tpu_torch.loader.base import Loader, UserLoaderRegistry
    want = {k: v.__name__ for k, v in JaxRegistry.loaders.items()}
    got = {k: v.__name__ for k, v in UserLoaderRegistry.loaders.items()}
    assert got == want
    assert {"hdfs", "sound_file", "ensemble"} <= set(got)
    assert type(Loader) is UserLoaderRegistry


def test_mapped_unit_registry_maps_by_name():
    from veles_tpu_torch.unit_registry import MappedUnitRegistry

    class Base(object, metaclass=MappedUnitRegistry):
        hide_from_registry = True

    class Mapped(Base):
        hide_from_registry = True
        MAPPING = "test_mapped"

    assert MappedUnitRegistry.mapped["test_mapped"] is Mapped
    MappedUnitRegistry.mapped.pop("test_mapped")


def test_unit_sizes_name_jax_s_units():
    from veles_tpu.snapshotter import unit_sizes as jax_unit_sizes
    from veles_tpu_torch.snapshotter import unit_sizes
    _seed()
    jax_wf = jax_samples.WineWorkflow(
        JaxDummyLauncher(), provider=jax_samples.WineProvider(60, 20))
    jax_wf.initialize(device=Device(backend="cpu"))
    wf = samples.WineWorkflow(DummyLauncher(),
                              provider=samples.WineProvider(60, 20))
    wf.initialize(device="cpu")
    want, got = jax_unit_sizes(jax_wf), unit_sizes(wf)
    assert sorted(got) == sorted(want)
    assert all(size > 0 for size in got.values())
    assert not any(u.stripped_pickle for u in wf)


def test_set_policy_order_matches_jax(monkeypatch):
    from veles_tpu.config import root as jax_root
    from veles_tpu.nn import precision as jax_precision
    from veles_tpu_torch.config import root
    from veles_tpu_torch.nn import precision

    def both():
        return (jax_precision.get_policy().name,
                precision.active_policy().name)

    monkeypatch.delenv("VELES_PRECISION", raising=False)
    monkeypatch.setattr(jax_root.common.engine, "precision", "bfloat16",
                        raising=False)
    monkeypatch.setattr(root.common.engine, "precision_type", "bfloat16",
                        raising=False)
    try:
        assert both() == ("bfloat16", "bfloat16")
        monkeypatch.setenv("VELES_PRECISION", "bfloat16_mixed")
        assert both() == ("bfloat16_mixed", "bfloat16_mixed")
        jax_precision.set_policy("float32")
        precision.set_policy("float32")
        assert both() == ("float32", "float32")
        jax_precision.set_policy(None)
        precision.set_policy(None)
        assert both() == ("bfloat16_mixed", "bfloat16_mixed")
        with pytest.raises((KeyError, ValueError)):
            precision.set_policy("float8")
    finally:
        jax_precision.set_policy(None)
        precision.set_policy(None)


def test_set_policy_reaches_the_workflow_s_layers():
    from veles_tpu_torch.nn import precision
    precision.set_policy("bfloat16_mixed")
    try:
        _seed()
        wf = samples.WineWorkflow(DummyLauncher(),
                                  provider=samples.WineProvider(60, 20))
        wf.initialize(device="cpu")
        assert wf.forwards[0].policy.name == "bfloat16_mixed"
        assert precision.policy_of(wf.model).name == "bfloat16_mixed"
    finally:
        precision.set_policy(None)


def test_solver_base_and_gd_attention():
    from veles_tpu.nn import attention as jax_attention
    from veles_tpu_torch.nn import optim, units

    class Halving(optim.Solver):
        name = "halving"

        @staticmethod
        def init(params):
            return {}

        @staticmethod
        def update(params, grads, state, hp):
            with torch.no_grad():
                for k, p in params.items():
                    p.sub_(0.5 * grads[k])

    assert optim.get_solver(Halving) is Halving
    assert all(issubclass(rule, optim.Solver)
               for rule in optim.SOLVERS.values())
    with pytest.raises(NotImplementedError):
        optim.Solver.update({}, {}, {}, {})
    p = torch.ones(3, requires_grad=True)
    Halving.update({"w": p}, {"w": torch.full((3,), 2.0)}, {}, {})
    assert p.tolist() == [0.0, 0.0, 0.0]
    assert issubclass(units.GDAttention, units.GradientDescentBase)
    assert issubclass(jax_attention.GDAttention,
                      jax_attention.GradientDescentBase)
    assert units.GDAttention.__id__ == jax_attention.GDAttention.__id__


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = textwrap.dedent('''
        import sys
        import veles_tpu_torch
        assert "veles_tpu_torch.launcher" not in sys.modules
        from veles_tpu_torch import run
        from veles_tpu_torch.config import apply_overrides
        from veles_tpu_torch.loader.base import UserLoaderRegistry
        from veles_tpu_torch.models import cifar, mnist_ae, parity, samples
        from veles_tpu_torch.nn.optim import Solver
        from veles_tpu_torch.nn.precision import set_policy
        from veles_tpu_torch.nn.units import GDAttention
        from veles_tpu_torch.snapshotter import unit_sizes
        from veles_tpu_torch.unit_registry import MappedUnitRegistry
        bad = sorted(m for m in sys.modules if m == "jax" or
                     m.startswith("jax.") or m == "veles_tpu" or
                     m.startswith("veles_tpu."))
        print(bad)
    ''')
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_remaining_small_names_are_jax_s():
    from veles_tpu import units as jax_units
    from veles_tpu.nn import activation as jax_activation
    from veles_tpu_torch import units
    from veles_tpu_torch.export import native
    from veles_tpu_torch.nn import activation
    x = numpy.linspace(-2.0, 2.0, 9, dtype=numpy.float32)
    numpy.testing.assert_array_equal(
        activation.mul_by_const(torch.from_numpy(x), 2.5).numpy(),
        numpy.asarray(jax_activation.mul_by_const(jnp.asarray(x), 2.5)))
    assert units.IUnit.__doc__ == jax_units.IUnit.__doc__
    assert not issubclass(units.Unit, units.IUnit)
    assert callable(native.test_binary_path)


def test_xorshift_is_the_reference_generator_bit_for_bit():
    from veles_tpu.ops import random as jax_random
    from veles_tpu_torch.ops import random
    state = numpy.array([0x0123456789ABCDEF, 0xFEDCBA9876543210],
                        dtype=numpy.uint64)
    got_state, got = random.fill_xorshift(state, 64)
    want_state, want = jax_random.fill_xorshift(state, 64)
    numpy.testing.assert_array_equal(got, want)
    numpy.testing.assert_array_equal(got_state, want_state)
    assert random.xorshift128plus(state)[1] == \
        jax_random.xorshift128plus(state)[1]
