"""Export packages and the ``serve`` command of the port, on the CPU.

* The writer against the JAX package's: for the same workflow and
  weights (``MnistWorkflow`` and a conv stack with LRN, pooling and
  dropout, ``-s 7`` on both sides), ``contents.json`` is equal and
  every array member holds the same bytes (``model.stablehlo``, which
  the port does not write, aside); tar and directory both.
* Readers across the packages: ``veles_tpu``'s ``ServeableModel.
  from_package`` reads a port package and the port reads a JAX package,
  with replies within 1e-6 of each other; a package with a unit the
  dense loader does not serve raises ``ModelLoadError`` in both.
* The C++ runtime under ``native/`` (built by the port's own driver
  into ``native/build-torch``) runs the port's packages of an eager-
  trained ``MnistWorkflow`` (also through the command-line runner), a
  conv stack, an attention model and a mixture of experts, matched to
  the port's forward (``tests/test_export.py``'s tolerances).
* Unsupported units are rejected at export (an unknown class, a
  ``sincos`` convolution).
* ``python -m veles_tpu_torch serve -a cpu`` over loopback, on a
  package and on a snapshot; each flag the port once refused takes
  effect, and without its value is refused by the parser naming it.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher  # noqa: E402
from veles_tpu.loader.fullbatch import \
    ProviderLoader as JaxProviderLoader  # noqa: E402
from veles_tpu.models.mnist import MnistWorkflow as JaxMnist  # noqa: E402
from veles_tpu.standard_workflow import \
    StandardWorkflow as JaxStandardWorkflow  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.dummy import DummyLauncher  # noqa: E402
from veles_tpu_torch.export.package import (export_workflow,  # noqa: E402
                                            load_package_info)
from veles_tpu_torch.loader.fullbatch import ProviderLoader  # noqa: E402
from veles_tpu_torch.models.mnist import MnistWorkflow  # noqa: E402
from veles_tpu_torch.models.samples import (SequenceProvider,  # noqa
                                            sequence_layers)
from veles_tpu_torch.serving.frontend import REFUSED_FLAGS, serve  # noqa
from veles_tpu_torch.serving.model_store import (ModelLoadError,  # noqa
                                                 ModelStore,
                                                 ServeableModel)
from veles_tpu_torch.snapshotter import dump_workflow  # noqa: E402
from veles_tpu_torch.standard_workflow import StandardWorkflow  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digits():
    rng = numpy.random.RandomState(0)
    return (rng.rand(40, 8, 8).astype(numpy.float32),
            rng.randint(0, 10, 40).astype(numpy.int32),
            rng.rand(10, 8, 8).astype(numpy.float32),
            rng.randint(0, 10, 10).astype(numpy.int32))


def _images():
    rng = numpy.random.RandomState(1)
    data = rng.rand(32, 8, 8, 3).astype(numpy.float32)
    labels = rng.randint(0, 4, 32).astype(numpy.int32)
    return data[8:], labels[8:], data[:8], labels[:8]


CONV_LAYERS = [
    {"type": "conv_relu", "n_kernels": 4, "kx": 3, "ky": 3, "padding": 1},
    {"type": "norm"},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_tanh", "output_sample_shape": 12},
    {"type": "dropout", "dropout_ratio": 0.3},
    {"type": "softmax", "output_sample_shape": 4},
]


def _seed_both(spec="7"):
    from veles_tpu.__main__ import Main as JaxMain
    from veles_tpu_torch.__main__ import Main
    jax_prng._generators.clear()
    prng._generators.clear()
    JaxMain()._seed_random(spec)
    Main()._seed_random(spec)


def _pair(kind):
    """(JAX workflow, port workflow) of ``kind``, initialized under the
    same seed: the same weights, bit for bit."""
    _seed_both()
    if kind == "mnist":
        jax_wf = JaxMnist(JaxDummyLauncher(), provider=_digits,
                          layers=(16,), minibatch_size=10, max_epochs=1)
        port_wf = MnistWorkflow(DummyLauncher(), provider=_digits,
                                layers=(16,), minibatch_size=10,
                                max_epochs=1)
    else:
        jax_wf = JaxStandardWorkflow(
            JaxDummyLauncher(), loader=lambda w: JaxProviderLoader(
                w, provider=_images, minibatch_size=8),
            layers=CONV_LAYERS, max_epochs=1)
        port_wf = StandardWorkflow(
            DummyLauncher(), loader=lambda w: ProviderLoader(
                workflow=w, provider=_images, minibatch_size=8),
            layers=CONV_LAYERS, max_epochs=1)
    jax_wf.initialize(device=Device(backend="cpu"))
    port_wf.initialize(device="cpu")
    return jax_wf, port_wf


def _members(path):
    """{member: bytes} of a package directory or tar."""
    import tarfile
    if os.path.isdir(path):
        return {n: open(os.path.join(path, n), "rb").read()
                for n in os.listdir(path)}
    with tarfile.open(path) as tar:
        return {n: tar.extractfile(n).read() for n in tar.getnames()}


@pytest.mark.parametrize("kind,suffix", [("mnist", ".tar"),
                                         ("conv", "")])
def test_contents_equal_the_jax_package(tmp_path, kind, suffix):
    from veles_tpu.export.package import export_workflow as jax_export
    jax_wf, port_wf = _pair(kind)
    want = _members(jax_export(jax_wf, str(tmp_path / ("jax" + suffix))))
    got = _members(export_workflow(port_wf,
                                   str(tmp_path / ("port" + suffix))))
    want.pop("model.stablehlo", None)
    assert sorted(got) == sorted(want)
    assert json.loads(got.pop("contents.json")) == \
        json.loads(want.pop("contents.json"))
    for name, blob in want.items():
        assert got[name] == blob, name  # the conv weights HWIO included
    contents, members = load_package_info(str(tmp_path /
                                              ("port" + suffix)))
    assert contents["format_version"] == 1
    assert "model.stablehlo" not in members


def _trained(kind):
    """A port workflow of ``kind`` after one eager epoch on the CPU."""
    if kind in ("mnist", "conv"):
        wf = _pair(kind)[1]
    else:
        prng._generators.clear()
        prng.get().seed(41)
        prng.get("loader").seed(42)
        provider = SequenceProvider(n_train=100, n_valid=20)
        layers = (sequence_layers(heads=4) if kind == "attention" else
                  [{"type": "moe", "n_experts": 4, "hidden": 32},
                   {"type": "softmax", "output_sample_shape": 8}])
        wf = StandardWorkflow(
            DummyLauncher(), loader=lambda w: ProviderLoader(
                workflow=w, provider=provider, minibatch_size=40,
                sequence=True), layers=layers, max_epochs=1)
        wf.initialize(device="cpu")
    wf.run()
    assert len(wf.decision.epoch_history) == 1
    return wf


@pytest.mark.parametrize("kind,units", [("mnist", 2), ("conv", 6),
                                        ("attention", 3), ("moe", 2)])
def test_native_runtime_matches_the_port(tmp_path, kind, units):
    from veles_tpu_torch.export.native import NativeWorkflow, runner_path
    wf = _trained(kind)
    path = wf.package_export(str(tmp_path / (
        "model.tar" if kind in ("mnist", "moe") else "model")))
    sample = tuple(wf.loader.minibatch_data.shape[1:])
    batch = numpy.random.RandomState(9).rand(
        *((6,) + sample)).astype(numpy.float32)
    want = ServeableModel.from_workflow(wf)(batch).reshape(6, -1)
    tol = (2e-5, 2e-6) if kind == "mnist" else (5e-5, 5e-6)
    with NativeWorkflow(path) as native:
        assert native.unit_count == units
        got = native.run(batch)
    numpy.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])
    if kind == "mnist":
        numpy.save(str(tmp_path / "input.npy"), batch)
        proc = subprocess.run(
            [runner_path(), path, str(tmp_path / "input.npy"),
             str(tmp_path / "output.npy")], capture_output=True,
            text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        numpy.testing.assert_allclose(
            numpy.load(str(tmp_path / "output.npy")), want, rtol=tol[0],
            atol=tol[1])


def test_packages_cross_between_the_readers(tmp_path):
    """JAX's loader serves the port's package and the port serves
    JAX's, with the same replies; each side's conv package raises
    ``ModelLoadError`` in both loaders."""
    from veles_tpu.serving.model_store import ModelLoadError as JaxError
    from veles_tpu.serving.model_store import ModelStore as JaxStore
    jax_wf, port_wf = _pair("mnist")
    jax_wf.run()
    port_wf.run()
    port_pkg = port_wf.package_export(str(tmp_path / "port.tar"))
    jax_pkg = jax_wf.package_export(str(tmp_path / "jax.tar"))
    batch = numpy.random.RandomState(5).rand(7, 8, 8).astype(
        numpy.float32)
    by_jax = JaxStore().load(port_pkg)(batch)
    by_port = ModelStore().load(port_pkg, device="cpu")(batch)
    numpy.testing.assert_allclose(by_port, by_jax, atol=1e-6, rtol=0)
    from_jax = ModelStore().load(jax_pkg, device="cpu")(batch)
    numpy.testing.assert_allclose(from_jax, JaxStore().load(jax_pkg)(
        batch), atol=1e-6, rtol=0)
    numpy.testing.assert_allclose(
        by_port, ServeableModel.from_workflow(port_wf)(batch), atol=1e-6,
        rtol=0)
    jax_conv, port_conv = _pair("conv")
    for path in (export_workflow(port_conv, str(tmp_path / "pc.tar")),
                 jax_conv.package_export(str(tmp_path / "jc.tar"))):
        with pytest.raises(ModelLoadError, match="ConvRELU"):
            ModelStore().load(path, device="cpu")
        with pytest.raises(JaxError, match="ConvRELU"):
            JaxStore().load(path)


def test_unsupported_units_rejected(tmp_path):
    class Odd(object):
        pass

    class FakeWorkflow(object):
        name = "fake"
        checksum = "x"
        forwards = [Odd()]
        loader = None

    with pytest.raises(NotImplementedError, match="not exportable"):
        export_workflow(FakeWorkflow(), str(tmp_path / "x.tar"))
    prng._generators.clear()
    wf = StandardWorkflow(
        DummyLauncher(), loader=lambda w: ProviderLoader(
            workflow=w, provider=_images, minibatch_size=8),
        layers=[{"type": "conv", "n_kernels": 2, "kx": 2, "ky": 2,
                 "activation": "sincos"},
                {"type": "softmax", "output_sample_shape": 4}])
    wf.initialize(device="cpu")
    with pytest.raises(NotImplementedError, match="sincos"):
        wf.package_export(str(tmp_path / "bad"))


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _served_reply(artifact, batch):
    """``python -m veles_tpu_torch serve -a cpu --model artifact`` in a
    process of its own: (healthz, single reply, batch replies)."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", "serve", "-a", "cpu",
         "--model", artifact, "--port", str(port), "--name", "digits",
         "--max-batch-size", "8", "--keep-last", "2"],
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        url = "http://127.0.0.1:%d" % port
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=5) as resp:
                    health = json.loads(resp.read())
                break
            except OSError:
                if time.time() > deadline or proc.poll() is not None:
                    raise AssertionError(proc.stdout.read().decode()
                                         if proc.poll() is not None
                                         else "serve did not come up")
                time.sleep(0.2)

        def post(path, body):
            req = urllib.request.Request(
                url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())

        single = post("/api", {"input": batch[0].tolist(),
                               "codec": "list"})["result"]
        rows = post("/api/batch", {"inputs": batch.tolist(),
                                   "codec": "list"})["results"]
        return health, single, rows
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_serve_command_on_a_package_and_a_snapshot(tmp_path):
    _, wf = _pair("mnist")
    wf.run()
    package = wf.package_export(str(tmp_path / "digits.tar"))
    snapshot = tmp_path / "digits.pickle"
    snapshot.write_bytes(dump_workflow(wf))
    batch = numpy.random.RandomState(6).rand(5, 8, 8).astype(numpy.float32)
    want = ServeableModel.from_workflow(wf)(batch)
    for artifact in (package, str(snapshot)):
        health, single, rows = _served_reply(artifact, batch)
        assert (health["model"], health["device"],
                health["sample_shape"]) == ("digits", "cpu", [64])
        numpy.testing.assert_allclose(single, want[0], atol=1e-6, rtol=0)
        numpy.testing.assert_allclose(rows, want, atol=1e-6, rtol=0)


#: the flags the port once refused, by argparse dest, and a second --model
ONCE_REFUSED = ("cache_mb", "cache_ttl_s", "max_replicas", "min_replicas",
                "model", "tenant", "trace_out", "web_status")


@pytest.fixture(scope="module")
def digits_package(tmp_path_factory):
    _, wf = _pair("mnist")
    return wf.package_export(str(tmp_path_factory.mktemp("pkg") /
                                 "digits.tar"))


@pytest.mark.parametrize("dest", ONCE_REFUSED)
def test_serve_refuses_by_name(tmp_path, dest, digits_package, capsys):
    """The port refuses none of the JAX command's flags
    (``REFUSED_FLAGS`` is empty): each flag it once refused now takes
    effect on a served package, and the same flag without its value is
    refused by the parser naming it."""
    from veles_tpu_torch.telemetry import tracing
    assert REFUSED_FLAGS == {}
    flag = "--" + dest.replace("_", "-")
    value = {"cache_mb": "2", "cache_ttl_s": "7", "max_replicas": "2",
             "min_replicas": "1", "tenant": "gold:3:interactive",
             "trace_out": str(tmp_path / "serve.trace.json"),
             "web_status": "127.0.0.1:%d" % _free_port(),
             "model": "second=" + digits_package}[dest]
    first = ("first=" if dest == "model" else "") + digits_package
    argv = ["--model", first, "-a", "cpu", "--port", "0",
            "--max-batch-size", "4"]
    if dest == "min_replicas":
        argv += ["--max-replicas", "2"]
    frontend = serve(argv + [flag, value])
    try:
        if dest == "cache_mb":
            assert frontend.cache.max_bytes == 2 << 20
        elif dest == "cache_ttl_s":
            assert frontend.cache.ttl_s == 7.0
        elif dest in ("max_replicas", "min_replicas"):
            assert (frontend.autoscaler.min_replicas,
                    frontend.autoscaler.max_replicas) == (1, 2)
        elif dest == "tenant":
            assert frontend.admission.stats()["tenants"]["gold"][
                "qos"] == "interactive"
        elif dest == "trace_out":
            assert tracing.enabled()
        elif dest == "web_status":
            assert frontend._reporter is not None
        else:
            assert sorted(frontend.entries) == ["first", "second"]
    finally:
        frontend.stop()
        tracing.disable()
    if dest == "trace_out":
        with open(value) as f:
            assert json.load(f)["traceEvents"] is not None
    with pytest.raises(SystemExit):
        serve(["--model", digits_package, "-a", "cpu", flag])
    assert flag in capsys.readouterr().err
