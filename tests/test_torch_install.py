"""The port as an installed package, on the CPU.

One wheel of a copy of the tree (``pip wheel --no-deps
--no-build-isolation --no-index``, as ``deploy/torch/deploy.sh``
installs offline) is built and installed with ``--target`` into a
temporary directory, once for the module. The tests hold that:

- the wheel ships every kernel source and header that
  ``ops/build.py`` reads and the analysis baseline, and nothing of a
  checkout's ``csrc/build/``;
- its console scripts are the JAX package's, unchanged, and the
  port's seven, each a ``main`` of ``veles_tpu_torch``;
- the installed copy, imported from a directory outside the tree with
  only the target on ``PYTHONPATH``, is the target's, its ``csrc/`` is
  the tree's byte for byte, it loads neither ``jax`` nor ``veles_tpu``,
  and each new script answers ``--help``;
- ``ops/build.py`` puts a new library into ``csrc/build/`` when the
  package can be written and into the per-user cache when it cannot,
  uses a library wherever it already lies, and refuses a missing
  ``csrc/`` with a ``RuntimeError`` while CPU tensors still take the
  plain versions;
- the installed CLI trains the small AlexNet on the CPU for one epoch
  bit for bit as the tree's does, and its forward of weights converted
  by ``params_from_jax`` matches the JAX package's forward within
  ``tests/test_torch_serving.py``'s tolerance (atol 1e-5: float32 sums
  in another order).
"""

import configparser
import hashlib
import json
import os
import shutil
import stat
import subprocess
import sys
import zipfile

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher  # noqa: E402
from veles_tpu.models.alexnet import (AlexNetWorkflow,  # noqa: E402
                                      SyntheticImageLoader)
from veles_tpu.models.alexnet import \
    small_alexnet_layers as jax_small_alexnet_layers  # noqa: E402
from veles_tpu.serving.model_store import \
    ServeableModel as JaxServeableModel  # noqa: E402
from veles_tpu_torch.ops import build  # noqa: E402
from veles_tpu_torch.ops.gemm import linear_act, linear_act_plain  # noqa
from veles_tpu_torch.ops.lrn import (lrn_backward,  # noqa: E402
                                     lrn_backward_plain, lrn_forward,
                                     lrn_forward_plain)
from veles_tpu_torch.ops.random import (uniform_fill,  # noqa: E402
                                        uniform_fill_plain)
from veles_tpu_torch.ops.reduce import column_sum, column_sum_plain  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "veles_tpu_torch", "csrc")
PIP = [sys.executable, "-m", "pip", "--disable-pip-version-check",
       "--no-cache-dir"]
TOL = dict(atol=1e-5, rtol=0)
#: what the wheel must carry besides the Python files: each csrc source
#: and header, and the analysis baseline
SHIPPED = sorted(
    ["veles_tpu_torch/csrc/" + name for name in os.listdir(CSRC)
     if name.endswith((".cu", ".cuh", "_binding.cpp"))] +
    ["veles_tpu_torch/analysis/baseline.json"])
#: the JAX package's console scripts, as they were before the port had
#: any but its CLI
JAX_SCRIPTS = {
    "veles-tpu": "veles_tpu.__main__:main",
    "veles-tpu-forge-server": "veles_tpu.forge.server:main",
    "veles-tpu-forge": "veles_tpu.forge.client:main",
    "veles-tpu-web-status": "veles_tpu.web_status:main",
    "veles-tpu-serve": "veles_tpu.serving.frontend:main",
    "veles-tpu-compare-snapshots": "veles_tpu.scripts.compare_snapshots:main",
    "veles-tpu-frontend": "veles_tpu.scripts.generate_frontend:main",
}
PORT_SCRIPTS = {
    "veles-tpu-torch": "veles_tpu_torch.__main__:main",
    "veles-tpu-torch-forge-server": "veles_tpu_torch.forge.server:main",
    "veles-tpu-torch-forge": "veles_tpu_torch.forge.client:main",
    "veles-tpu-torch-web-status": "veles_tpu_torch.web_status:main",
    "veles-tpu-torch-serve": "veles_tpu_torch.serving.frontend:main",
    "veles-tpu-torch-compare-snapshots":
        "veles_tpu_torch.scripts.compare_snapshots:main",
    "veles-tpu-torch-frontend":
        "veles_tpu_torch.scripts.generate_frontend:main",
}
#: the small AlexNet the CLI runs trains (one epoch, 32x32x3, 10
#: classes); after the run it writes its history and parameters to
#: ``root.inst.out`` (.json, .npz)
WORKFLOW_FILE = """
import json

import numpy

from veles_tpu_torch.config import root
from veles_tpu_torch.convert import layer_params
from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,
                                            SyntheticImageLoader,
                                            small_alexnet_layers)


def run(load, main):
    wf, _ = load(AlexNetWorkflow, layers=small_alexnet_layers(10),
                 max_epochs=1, loader_factory=lambda wf: SyntheticImageLoader(
                     workflow=wf, n_train=128, n_valid=64, side=32,
                     n_classes=10, minibatch_size=64))
    main()
    numpy.savez(root.inst.out + ".npz", **{
        "%d.%s" % (i, k): p.detach().cpu().numpy()
        for i, f in enumerate(wf.forwards)
        for k, p in layer_params(f.module).items()})
    with open(root.inst.out + ".json", "w") as f:
        json.dump(wf.decision.epoch_history, f)
"""
#: run from outside the tree on the installed copy: where it was
#: imported from, its csrc, the console scripts' modules imported, the
#: forward of JAX weights (``argv[1]``: an .npz of the layers' dicts and
#: the inputs; the output written to ``argv[2]``), the modules it loaded
INSTALLED_CHECK = """
import importlib, json, sys
import numpy
import veles_tpu_torch
from veles_tpu_torch.models.alexnet import small_alexnet_layers
from veles_tpu_torch.ops import build
from veles_tpu_torch.serving.model_store import ServeableModel
for module in %r:
    assert callable(importlib.import_module(module).main), module
with numpy.load(sys.argv[1]) as data:
    arrays = {k: data[k] for k in data.files}
layers = small_alexnet_layers(10)
params = [{k.split(".", 1)[1]: v for k, v in arrays.items()
           if k.split(".", 1)[0] == str(i)} for i in range(len(layers))]
# the weights go in through convert.params_from_jax
model = ServeableModel.from_layers(layers, (32, 32, 3), params=params,
                                   device="cpu")
numpy.save(sys.argv[2], model(arrays["inputs"]))
print(json.dumps({
    "file": veles_tpu_torch.__file__, "csrc": build.CSRC,
    "sources": build.sources(), "headers": build.headers(),
    "loaded": sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "ml_dtypes", "veles_tpu"))}))
""" % (sorted({v.split(":")[0] for v in PORT_SCRIPTS.values()}),)


def _copy_tree(dest):
    """The tree's installable files, with a stand-in library planted in
    the copy's ``csrc/build/`` (a checkout's build must never ship)."""
    ignore = shutil.ignore_patterns("__pycache__", "build", "*.pyc")
    for name in ("veles_tpu", "veles_tpu_torch"):
        shutil.copytree(os.path.join(REPO, name), os.path.join(dest, name),
                        ignore=ignore)
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(os.path.join(REPO, name), dest)
    planted = os.path.join(dest, "veles_tpu_torch", "csrc", "build")
    os.makedirs(planted)
    with open(os.path.join(planted, "gemm_bias_act-0000.so"), "wb") as f:
        f.write(b"\0")


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    root = tmp_path_factory.mktemp("wheel")
    tree = root / "tree"
    _copy_tree(str(tree))
    out = root / "dist"
    subprocess.run(PIP + ["wheel", "--no-deps", "--no-build-isolation",
                          "--no-index", "-q", "-w", str(out), str(tree)],
                   check=True, capture_output=True, timeout=600)
    (path,) = out.glob("*.whl")
    return str(path)


@pytest.fixture(scope="module")
def target(wheel, tmp_path_factory):
    where = tmp_path_factory.mktemp("target")
    subprocess.run(PIP + ["install", "--no-deps", "--no-index", "-q",
                          "--target", str(where), wheel],
                   check=True, capture_output=True, timeout=600)
    return str(where)


def _installed_env(target):
    """The environment of a process that runs the installed copy: only
    the target on PYTHONPATH, its scripts first on PATH."""
    return dict(os.environ, PYTHONPATH=target, PATH=os.pathsep.join(
        [os.path.join(target, "bin"), os.environ.get("PATH", "")]))


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("name", SHIPPED)
def test_the_wheel_ships_each_kernel_source_and_the_baseline(wheel, name):
    with zipfile.ZipFile(wheel) as z:
        assert name in z.namelist()
        assert hashlib.sha256(z.read(name)).hexdigest() == _digest(
            os.path.join(REPO, name))


def test_the_wheel_ships_what_build_reads_and_no_built_library(wheel):
    """Every file that ``sources()`` and ``headers()`` list, and not
    one file of the copy's ``csrc/build/`` (a library was planted
    there)."""
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
    csrc = sorted(n.rsplit("/", 1)[1] for n in names
                  if n.startswith("veles_tpu_torch/csrc/"))
    assert csrc == sorted(build.sources() + build.headers())
    assert not [n for n in names if "/csrc/build" in n]


def _entry_points(wheel):
    with zipfile.ZipFile(wheel) as z:
        (name,) = [n for n in z.namelist()
                   if n.endswith(".dist-info/entry_points.txt")]
        text = z.read(name).decode()
    parser = configparser.ConfigParser()
    parser.optionxform = str
    parser.read_string(text)
    return dict(parser["console_scripts"])


def test_the_jax_package_console_scripts_are_unchanged(wheel):
    scripts = _entry_points(wheel)
    assert {k: v for k, v in scripts.items()
            if not v.startswith("veles_tpu_torch")} == JAX_SCRIPTS


@pytest.mark.parametrize("script", sorted(PORT_SCRIPTS))
def test_each_port_console_script_is_a_main_of_the_port(wheel, script):
    import importlib
    scripts = _entry_points(wheel)
    assert scripts[script] == PORT_SCRIPTS[script]
    assert len([v for v in scripts.values()
                if v.startswith("veles_tpu_torch.")]) == len(PORT_SCRIPTS)
    module, attr = scripts[script].split(":")
    assert callable(getattr(importlib.import_module(module), attr))


@pytest.fixture(scope="module")
def jax_forward(tmp_path_factory):
    """JAX's small AlexNet (weights from the prng registry, seed 42) as a
    served model: (its per-layer weights and the inputs in one .npz, its
    forward of the inputs)."""
    prng.get().seed(42)
    prng.get("loader").seed(43)
    wf = AlexNetWorkflow(
        DummyLauncher(),
        loader_factory=lambda wf_: SyntheticImageLoader(
            wf_, n_train=8, n_valid=4, side=32, n_classes=10,
            minibatch_size=4),
        layers=jax_small_alexnet_layers(10), max_epochs=1)
    wf.initialize(device=Device(backend="cpu"))
    model = JaxServeableModel.from_workflow(wf, name="small_alexnet")
    inputs = numpy.random.RandomState(0).uniform(
        -1, 1, (6, 32, 32, 3)).astype(numpy.float32)
    arrays = {"inputs": inputs}
    for i, (_, params) in enumerate(model.layers):
        arrays.update(("%d.%s" % (i, k), numpy.asarray(v))
                      for k, v in params.items())
    path = str(tmp_path_factory.mktemp("jax") / "weights.npz")
    numpy.savez(path, **arrays)
    return path, numpy.asarray(model(inputs))


@pytest.fixture(scope="module")
def installed(target, jax_forward, tmp_path_factory):
    """INSTALLED_CHECK's report, from a directory outside the tree, and
    the installed copy's forward of JAX's weights."""
    cwd = tmp_path_factory.mktemp("outside")
    out = str(cwd / "forward.npy")
    proc = subprocess.run(
        [sys.executable, "-c", INSTALLED_CHECK, jax_forward[0], out],
        cwd=str(cwd), env=_installed_env(target), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1]), numpy.load(out)


def test_the_installed_copy_is_the_targets_and_loads_no_jax(target,
                                                           installed):
    report, _ = installed
    package = os.path.join(target, "veles_tpu_torch")
    assert report["file"] == os.path.join(package, "__init__.py")
    assert report["csrc"] == os.path.join(package, "csrc")
    assert report["sources"] == build.sources()
    assert report["headers"] == build.headers()
    for name in report["sources"] + report["headers"]:
        assert _digest(os.path.join(report["csrc"], name)) == _digest(
            os.path.join(CSRC, name)), name
    assert report["loaded"] == []


def test_the_installed_forward_of_jax_weights_matches_jax(jax_forward,
                                                          installed):
    _, got = installed
    want = jax_forward[1]
    assert got.shape == want.shape == (6, 10)
    numpy.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("script", sorted(set(PORT_SCRIPTS) -
                                          {"veles-tpu-torch"}))
def test_each_new_console_script_answers_help(target, tmp_path, script):
    proc = subprocess.run(
        [os.path.join(target, "bin", script), "--help"], cwd=str(tmp_path),
        env=_installed_env(target), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("usage:")


def _cli_run(argv, env, cwd, out):
    path = os.path.join(cwd, "small_alexnet.py")
    with open(path, "w") as f:
        f.write(WORKFLOW_FILE)
    proc = subprocess.run(
        argv + [path, "-s", "7", "-a", "cpu", "root.inst.out=%r" % out],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with numpy.load(out + ".npz") as data:
        params = {k: data[k] for k in data.files}
    with open(out + ".json") as f:
        return params, json.load(f)


def test_the_installed_cli_trains_as_the_trees_does(target, tmp_path):
    """One epoch of the small AlexNet on the CPU through the installed
    ``veles-tpu-torch`` and through the tree's ``python -m
    veles_tpu_torch``, from the same seed: the history and every
    parameter bit for bit; the run changed the weights."""
    runs = {}
    for name, argv, env in (
            ("installed", [os.path.join(target, "bin", "veles-tpu-torch")],
             _installed_env(target)),
            ("tree", [sys.executable, "-m", "veles_tpu_torch"],
             dict(os.environ, PYTHONPATH=REPO))):
        cwd = tmp_path / name
        cwd.mkdir()
        runs[name] = _cli_run(argv, env, str(cwd), str(cwd / "run"))
    (params, history), (want, want_history) = runs["installed"], runs["tree"]
    assert history == want_history and len(history) == 1
    assert sorted(params) == sorted(want)
    for key in want:
        assert params[key].tobytes() == want[key].tobytes(), key


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """build.py pointed at a copy of csrc/ in a package directory, its
    per-user cache under tmp_path, with stand-in compiler names: a
    library's place is computed, nothing is built."""
    package = tmp_path / "package" / "csrc"
    package.mkdir(parents=True)
    for name in build.sources() + build.headers():
        shutil.copy(os.path.join(CSRC, name), str(package))
    monkeypatch.setattr(build, "CSRC", str(package))
    monkeypatch.setattr(build, "BUILD_DIR", str(package / "build"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "cxx", lambda: "g++")
    return package


def test_the_cache_follows_xdg_cache_home(csrc_copy, tmp_path,
                                          monkeypatch):
    assert build.cache_dir() == str(tmp_path / "cache" / "veles_tpu_torch" /
                                    "kernels")
    monkeypatch.delenv("XDG_CACHE_HOME")
    assert build.cache_dir() == os.path.join(
        os.path.expanduser("~"), ".cache", "veles_tpu_torch", "kernels")


@pytest.mark.parametrize("writable", [True, False])
@pytest.mark.parametrize("source", ["gemm_bias_act.cu",
                                    "column_reduce_binding.cpp"])
def test_a_new_build_goes_beside_the_sources_or_to_the_cache(
        csrc_copy, monkeypatch, source, writable):
    """A package directory that can be written takes a new library in
    its csrc/build/; one that cannot (the probe says so) sends it to the
    per-user cache, under the same name."""
    monkeypatch.setattr(build, "_writable", lambda directory: writable)
    target = build._target(source)
    want = build.BUILD_DIR if writable else build.cache_dir()
    assert os.path.dirname(target) == want
    name = os.path.basename(target)
    assert name.startswith(source.rsplit(".", 1)[0] + "-")
    monkeypatch.setattr(build, "_writable", lambda directory: not writable)
    assert os.path.basename(build._target(source)) == name


@pytest.mark.parametrize("where", ["beside", "cache"])
def test_a_library_already_built_is_used_wherever_it_lies(
        csrc_copy, monkeypatch, where):
    """A library built before (beside the sources, in a directory that
    cannot be written now; or in the per-user cache) is what
    ``_built`` returns, and no compiler starts."""
    monkeypatch.setattr(build, "_writable", lambda directory: False)
    name = os.path.basename(build._target("lrn_fwd.cu"))
    directory = build.BUILD_DIR if where == "beside" else build.cache_dir()
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, name), "wb") as f:
        f.write(b"\0")

    def refused(*args):
        raise AssertionError("a compiler started")

    monkeypatch.setattr(build, "_start", refused)
    assert build._built("lrn_fwd.cu") == os.path.join(directory, name)


def test_the_writability_probe_writes_rather_than_reads_modes(tmp_path):
    """The probe creates the directory and a file in it; under a plain
    file no directory can be made, whoever runs it (root included)."""
    assert build._writable(str(tmp_path / "new" / "build"))
    assert os.listdir(str(tmp_path / "new" / "build")) == []
    blocker = tmp_path / "file"
    blocker.write_text("")
    assert not build._writable(str(blocker / "build"))


STAND_IN_COMPILER = """#!%s
import sys, time
time.sleep(0.2)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"library")
""" % sys.executable


@pytest.mark.parametrize("writable", [True, False])
def test_build_all_builds_each_source_once_where_it_may(
        csrc_copy, tmp_path, monkeypatch, capsys, writable):
    """``python -m veles_tpu_torch.ops.build``'s ``main()`` with a
    stand-in compiler: every source built once into the chosen
    directory, each with its own seconds, no temporary file left; a
    second run builds nothing (0.0 s each)."""
    compiler = tmp_path / "compiler"
    compiler.write_text(STAND_IN_COMPILER)
    compiler.chmod(compiler.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc", lambda: str(compiler))
    monkeypatch.setattr(build, "cxx", lambda: str(compiler))
    monkeypatch.setattr(build, "_writable", lambda directory: writable)
    assert build.main() == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    directory = build.BUILD_DIR if writable else build.cache_dir()
    assert sorted(report["seconds"]) == build.sources()
    assert all(s > 0.0 for s in report["seconds"].values())
    assert sorted(os.listdir(directory)) == sorted(
        os.path.basename(p) for p in report["libraries"].values())
    assert all(os.path.dirname(p) == directory
               for p in report["libraries"].values())
    assert build.build_all() == {name: 0.0 for name in build.sources()}


def test_a_failed_build_raises_and_leaves_no_library(csrc_copy, tmp_path,
                                                    monkeypatch):
    compiler = tmp_path / "failing"
    compiler.write_text("#!/bin/sh\necho refused; exit 3\n")
    compiler.chmod(compiler.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc", lambda: str(compiler))
    monkeypatch.setattr(build, "cxx", lambda: str(compiler))
    with pytest.raises(RuntimeError, match="refused"):
        build.build_all()
    assert not os.path.isdir(build.BUILD_DIR) or \
        os.listdir(build.BUILD_DIR) == []


CPU_CALLS = {
    "linear_act": (lambda: linear_act(_t(8, 16), _t(16, 4), _t(4)),
                   lambda: linear_act_plain(_t(8, 16), _t(16, 4), _t(4)),
                   linear_act),
    "lrn_forward": (lambda: lrn_forward(_t(2, 3, 3, 32)),
                    lambda: lrn_forward_plain(_t(2, 3, 3, 32)),
                    lrn_forward),
    "lrn_backward": (lambda: lrn_backward(_t(2, 3, 3, 32), _t(2, 3, 3, 32)),
                     lambda: lrn_backward_plain(_t(2, 3, 3, 32),
                                                _t(2, 3, 3, 32)),
                     lrn_backward),
    "column_sum": (lambda: column_sum(_t(64, 8)),
                   lambda: column_sum_plain(_t(64, 8)), column_sum),
    "uniform_fill": (lambda: uniform_fill((4, 8), 7, device="cpu"),
                     lambda: uniform_fill_plain((4, 8), 7), uniform_fill),
}


def _t(*shape):
    return torch.from_numpy(numpy.random.RandomState(
        sum(shape)).randn(*shape).astype(numpy.float32))


@pytest.mark.parametrize("wrapper", sorted(CPU_CALLS))
def test_a_missing_csrc_raises_and_cpu_tensors_take_the_plain_version(
        tmp_path, monkeypatch, wrapper):
    """An install without ``csrc/``: the build refuses with a
    ``RuntimeError`` that names the directory and says what the install
    lacks; a CPU tensor still takes the plain version, counting no
    launch."""
    missing = str(tmp_path / "site-packages" / "veles_tpu_torch" / "csrc")
    monkeypatch.setattr(build, "CSRC", missing)
    monkeypatch.setattr(build, "BUILD_DIR", os.path.join(missing, "build"))
    monkeypatch.setattr(build, "_libraries", {})
    for call in (build.sources, build.headers, build.build_all,
                 lambda: build.library("gemm_bias_act"),
                 lambda: build._target("uniform_fill_binding.cpp")):
        with pytest.raises(RuntimeError) as error:
            call()
        assert missing in str(error.value)
        assert "lacks the kernel sources" in str(error.value)
    run, plain, fn = CPU_CALLS[wrapper]
    before = fn.launches
    assert torch.equal(run(), plain())
    assert fn.launches == before
