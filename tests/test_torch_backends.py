"""The matmul precision of the port's training and serving paths, and the
kernel wrappers' launch path.

``Policy.backends()`` holds TF32 and bf16 reduced-precision reductions
off for each whole unit of work (a training step, an evaluation sweep,
a served batch), and cuDNN's TF32 off under ``float32``, whatever the
caller switched on, and gives the caller's switches back after. These
tests switch everything on, run one CPU step and one served forward of
a small AlexNet, and read the switches from inside the products the
guard must cover: K1's plain product and its two backward products
(``torch.matmul``), the head's logits product, and the head's backward
(its bias gradient's ``BiasAddNHWC.backward``, which autograd runs in
the same pass as the head's product's backward; the two convolutions'
biases take the same function).

The static guard: no module under ``veles_tpu_torch/ops`` other than
``build.py`` builds a library, a stream object or a device context.
Every wrapper goes through ``build.function`` and ``build.launch``.
"""

import ast
import contextlib
import os
import shutil

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu_torch.loader.base import VALIDATION  # noqa: E402
from veles_tpu_torch.models.alexnet import (  # noqa: E402
    SyntheticImageLoader, small_alexnet_layers)
from veles_tpu_torch.models.build import build_training  # noqa: E402
from veles_tpu_torch.nn.base import BiasAddNHWC  # noqa: E402
from veles_tpu_torch.ops import build  # noqa: E402
from veles_tpu_torch.nn.precision import (full_float32,  # noqa: E402
                                          get_policy, policy_of)
from veles_tpu_torch.serving.model_store import ServeableModel  # noqa: E402

OPS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "veles_tpu_torch", "ops")
_MATMUL = torch.backends.cuda.matmul
SWITCHES = ((_MATMUL, "allow_tf32"),
            (_MATMUL, "allow_bf16_reduced_precision_reduction"),
            (torch.backends.cudnn, "allow_tf32"))


def _read():
    return tuple(getattr(owner, name) for owner, name in SWITCHES)


@pytest.fixture
def switched_on():
    """Every switch on, as a caller may leave them; restored after."""
    saved = _read()
    for owner, name in SWITCHES:
        setattr(owner, name, True)
    yield
    for (owner, name), value in zip(SWITCHES, saved):
        setattr(owner, name, value)


@pytest.fixture
def spy(monkeypatch):
    """{site: [switches read at each call]} for torch.matmul and the
    bias gradients of the convolutions and the head."""
    reads = {"matmul": [], "bias_backward": []}
    matmul = torch.matmul
    backward = BiasAddNHWC.backward

    def spied_matmul(*args, **kwargs):
        reads["matmul"].append(_read())
        return matmul(*args, **kwargs)

    def spied_backward(ctx, g):
        reads["bias_backward"].append(_read())
        return backward(ctx, g)

    monkeypatch.setattr(torch, "matmul", spied_matmul)
    monkeypatch.setattr(BiasAddNHWC, "backward",
                        staticmethod(spied_backward))
    return reads


def _held(policy):
    """The switches as the policy holds them: matmul's off, cuDNN's off
    under float32 and the caller's (on) otherwise."""
    return (False, False, policy != "float32")


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_a_training_step_holds_the_policy_switches(switched_on, spy,
                                                   policy):
    loader = SyntheticImageLoader(n_train=16, n_valid=8, side=32,
                                  n_classes=10, minibatch_size=8)
    trainer = build_training(small_alexnet_layers(10), (32, 32, 3), loader,
                             seed=3, policy=policy, device="cpu",
                             learning_rate=0.01, momentum=0.9)
    # building the model under float32 sets the process switches once
    # (configure_backends); the caller switches them on again after
    for owner, name in SWITCHES:
        setattr(owner, name, True)
    assert trainer.policy is get_policy(policy)
    idx = torch.from_numpy(trainer._segment_indices(1)[0])
    loss, _ = trainer.train_batch(idx, 0, 11)
    assert numpy.isfinite(float(loss))
    assert _read() == (True, True, True)
    # the fc layer's product, its two backward products, the head's
    assert len(spy["matmul"]) >= 4
    assert len(spy["bias_backward"]) == 3  # conv1, conv2, the head
    for site, reads in spy.items():
        assert set(reads) == {_held(policy)}, (site, reads)
    spy["matmul"].clear()
    trainer.eval_class(VALIDATION)
    assert spy["matmul"] and set(spy["matmul"]) == {_held(policy)}
    assert _read() == (True, True, True)


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_a_served_forward_holds_the_policy_switches(switched_on, spy,
                                                    policy):
    model = ServeableModel.from_layers(small_alexnet_layers(10),
                                       (32, 32, 3), seed=2, policy=policy,
                                       device="cpu")
    for owner, name in SWITCHES:
        setattr(owner, name, True)
    out = model(numpy.zeros((2, 32, 32, 3), numpy.float32))
    assert out.shape == (2, 10)
    assert spy["matmul"] and set(spy["matmul"]) == {_held(policy)}
    assert _read() == (True, True, True)


def test_policy_of_reads_the_layers_policy():
    model = ServeableModel.from_layers(small_alexnet_layers(10),
                                       (32, 32, 3), seed=2,
                                       policy="bfloat16_mixed",
                                       device="cpu").module
    assert policy_of(model) is get_policy("bfloat16_mixed")
    assert policy_of(torch.nn.Linear(2, 2)) is get_policy("float32")


def test_backends_nest_with_full_float32_and_restore(switched_on):
    """Entered in either order and nested, the guards hold the switches
    off and the last one out restores the caller's."""
    with get_policy("float32").backends():
        assert _read() == (False, False, False)
        with full_float32(), get_policy("bfloat16").backends():
            assert _read() == (False, False, False)
        assert _read() == (False, False, False)
    assert _read() == (True, True, True)
    with full_float32():
        with get_policy("bfloat16").backends():
            assert _read() == (False, False, True)
        assert _read() == (False, False, True)
    assert _read() == (True, True, True)
    with contextlib.suppress(RuntimeError):
        with get_policy("float32").backends():
            raise RuntimeError("a step that fails")
    assert _read() == (True, True, True)


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


@pytest.mark.parametrize("module", sorted(
    f for f in os.listdir(OPS) if f.endswith(".py") and f != "build.py"))
def test_wrappers_stay_on_the_short_launch_path(module):
    """No module of ``ops`` but ``build.py`` calls ``build.library``,
    ``torch.cuda.current_stream`` or ``torch.cuda.device``, nor imports
    ``library`` from ``build``: each call site takes the lock, a stream
    object or a device context on every call."""
    with open(os.path.join(OPS, module)) as f:
        tree = ast.parse(f.read())
    banned = {"build.library", "torch.cuda.current_stream",
              "torch.cuda.device"}
    found = [(_dotted(node.func), node.lineno) for node in ast.walk(tree)
             if isinstance(node, ast.Call) and _dotted(node.func) in banned]
    found += [("import library", node.lineno) for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and
              (node.module or "").endswith("build") and
              any(alias.name == "library" for alias in node.names)]
    assert not found, found


def _calls(tree, name):
    return [node for node in ast.walk(tree)
            if isinstance(node, ast.Call) and _dotted(node.func) == name]


@pytest.mark.parametrize("module", ["lrn.py", "random.py", "reduce.py"])
def test_bindings_launch_through_the_short_path(module):
    """K3's, K6's and K7's wrappers reach their CPython bindings only as
    ``build.launch(build.binding(...).<function>, device, ...)``: the
    raw current stream, no device context on the current card, one C
    call that allocates and launches. K7 does not resolve its C function
    for ctypes at all (K4, in lrn.py, does)."""
    with open(os.path.join(OPS, module)) as f:
        tree = ast.parse(f.read())
    bindings = _calls(tree, "build.binding")
    launched = [call.args[0].value for call in _calls(tree, "build.launch")
                if isinstance(call.args[0], ast.Attribute)]
    assert bindings and all(any(b is l for l in launched) for b in bindings)
    if module == "random.py":
        assert not _calls(tree, "build.function")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """build.py pointed at a copy of csrc/, with a stand-in compiler
    name: a target's name is computed, nothing is built."""
    for name in build.sources() + build.headers():
        shutil.copy(os.path.join(build.CSRC, name), tmp_path)
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "cxx", lambda: "g++")
    return tmp_path


@pytest.mark.parametrize("source", ["lrn_fwd.cu", "lrn_bwd.cu",
                                    "uniform_fill_binding.cpp"])
def test_an_edited_header_rebuilds_the_kernels(csrc_copy, source):
    """A library's name hashes its source, every csrc/*.cuh header for a
    kernel, and its command: the same tree gives the same name, and an
    edit of the LRN kernels' shared header gives each kernel a new one
    (a binding, which includes no kernel header, keeps its name)."""
    assert "lrn_common.cuh" in build.headers()
    before = build._target(source)
    assert build._target(source) == before
    with open(csrc_copy / "lrn_common.cuh", "a") as f:
        f.write("// edited\n")
    assert (build._target(source) != before) == source.endswith(".cu")
