"""The forge model repository of the port (``veles_tpu_torch/forge``,
``veles_tpu_torch/scripts/update_forge.py``) against the JAX package's.

The first ten tests are ``tests/test_forge.py``'s on the port's server
and client. Then the two packages across each other: a package uploaded
through one package's client to the other's server comes down through
the other's client byte-equal, in both directions; both ``update_forge``
sweeps of the same tree report the same uploads and failures; and a
convolutional package (LRN, poolings, padded convolutions) trained here
goes through the forge and serves from ``ServeableModel.from_package(...,
full=True)`` with the trained workflow's replies (1e-6 absolute: the
same modules on the same weights, float32), while the default reader
still refuses it. Servers listen on loopback port 0; packages live in
``tmp_path``.
"""

import io
import json
import os
import tarfile
import urllib.error
import urllib.request

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu_torch.forge import ForgeClient, ForgeServer  # noqa: E402


def _make_package(tmp_path, name="mnist-fc", version="1.0", author="me"):
    pkg = tmp_path / ("pkg-%s-%s" % (name, version))
    pkg.mkdir(exist_ok=True)
    (pkg / "manifest.json").write_text(json.dumps({
        "name": name, "version": version, "author": author,
        "short_description": "a model", "workflow": "workflow.py",
        "config": "config.py"}))
    (pkg / "workflow.py").write_text("WORKFLOW = %r\n" % version)
    (pkg / "config.py").write_text("root = {}\n")
    (pkg / "weights.npy").write_bytes(b"\x93NUMPY fake")
    return str(pkg)


@pytest.fixture
def forge(tmp_path):
    server = ForgeServer(str(tmp_path / "storage"), port=0,
                         token="sekret").start()
    client = ForgeClient("127.0.0.1:%d" % server.port, token="sekret")
    try:
        yield server, client, tmp_path
    finally:
        server.stop()


def test_upload_list_details_fetch_delete(forge):
    server, client, tmp_path = forge
    client.upload(_make_package(tmp_path))
    client.upload(_make_package(tmp_path, version="1.1"))
    client.upload(_make_package(tmp_path, name="cifar", author="you"))

    models = client.list()
    assert [m["name"] for m in models] == ["cifar", "mnist-fc"]
    latest = next(m for m in models if m["name"] == "mnist-fc")
    assert latest["version"] == "1.1" and latest["author"] == "me"

    details = client.details("mnist-fc")
    assert details["manifest"]["workflow"] == "workflow.py"
    assert [v["version"] for v in details["versions"]] == ["1.0", "1.1"]

    dest = tmp_path / "fetched"
    assert client.fetch("mnist-fc", str(dest)) == "1.1"
    assert (dest / "workflow.py").read_text() == "WORKFLOW = '1.1'\n"
    assert (dest / "weights.npy").exists()

    dest_old = tmp_path / "fetched-1.0"
    assert client.fetch("mnist-fc", str(dest_old), version="1.0") == "1.0"
    assert (dest_old / "workflow.py").read_text() == "WORKFLOW = '1.0'\n"

    client.delete("mnist-fc", version="1.1")
    assert client.details("mnist-fc")["versions"][-1]["version"] == "1.0"
    client.delete("mnist-fc")
    assert [m["name"] for m in client.list()] == ["cifar"]


def test_browse_page_served_live(forge):
    server, client, tmp_path = forge
    client.upload(_make_package(tmp_path))
    for path in ("/", "/browse.html"):
        with urllib.request.urlopen(
                "http://127.0.0.1:%d%s" % (server.port, path),
                timeout=10) as resp:
            assert resp.headers["Content-Type"].startswith("text/html")
            page = resp.read().decode()
        assert "forge model repository" in page
        assert "query=list" in page and "query=details" in page
        assert "/fetch?name=" in page
        # uploader-controlled strings go through textContent only
        assert "innerHTML" not in page


def test_duplicate_version_rejected(forge):
    server, client, tmp_path = forge
    client.upload(_make_package(tmp_path))
    with pytest.raises(RuntimeError, match="already exists"):
        client.upload(_make_package(tmp_path))


def test_token_required_for_mutations(forge):
    server, client, tmp_path = forge
    client.upload(_make_package(tmp_path))
    anonymous = ForgeClient("127.0.0.1:%d" % server.port)
    assert anonymous.list()
    assert anonymous.details("mnist-fc")["name"] == "mnist-fc"
    with pytest.raises(RuntimeError, match="token"):
        anonymous.upload(_make_package(tmp_path, version="2.0"))
    with pytest.raises(RuntimeError, match="token"):
        anonymous.delete("mnist-fc")
    # nothing was stored or removed
    assert [v["version"] for v in client.details("mnist-fc")["versions"]] \
        == ["1.0"]


def test_missing_model_is_404(forge):
    server, client, tmp_path = forge
    with pytest.raises(RuntimeError, match="no such model"):
        client.details("nope")
    with pytest.raises(RuntimeError, match="no such model"):
        client.fetch("nope", str(tmp_path / "nowhere"))
    client.upload(_make_package(tmp_path))
    with pytest.raises(RuntimeError, match="no version"):
        client.fetch("mnist-fc", str(tmp_path / "nowhere"), version="9.9")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen("http://127.0.0.1:%d/fetch?name=nope"
                               % server.port, timeout=10)
    assert e.value.code == 404


def _tar(*members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for name, data in members:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def test_bad_packages_rejected(forge):
    from veles_tpu_torch.forge.server import validate_name
    server, client, tmp_path = forge
    with pytest.raises(ValueError):
        server.upload(b"not a tar at all", token="sekret")
    with pytest.raises(ValueError, match="manifest"):
        server.upload(_tar(("stuff.txt", b"{}")), token="sekret")
    manifest = json.dumps({"name": "evil", "version": "1"}).encode()
    with pytest.raises(ValueError, match="unsafe"):
        server.upload(_tar(("manifest.json", manifest),
                           ("../escape.txt", b"")), token="sekret")
    with pytest.raises(ValueError, match="unsafe"):
        server.upload(_tar(("manifest.json", manifest),
                           ("/abs.txt", b"")), token="sekret")
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        info = tarfile.TarInfo("manifest.json")
        info.size = len(manifest)
        tar.addfile(info, io.BytesIO(manifest))
        link = tarfile.TarInfo("link")
        link.type = tarfile.SYMTYPE
        link.linkname = "/etc/passwd"
        tar.addfile(link)
    with pytest.raises(ValueError, match="unsafe"):
        server.upload(buf.getvalue(), token="sekret")
    assert client.list() == []
    for bad in ("", "..", "a/b", "-x", "a b"):
        with pytest.raises(ValueError):
            validate_name(bad)


def test_exported_model_through_forge(forge, tmp_path):
    """Train, ``package_export``, upload, fetch: the package's members
    come back."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mnist import MnistWorkflow
    server, client, base = forge

    def provider():
        rng = numpy.random.RandomState(0)
        return (rng.rand(20, 6, 6).astype(numpy.float32),
                rng.randint(0, 10, 20).astype(numpy.int32),
                rng.rand(10, 6, 6).astype(numpy.float32),
                rng.randint(0, 10, 10).astype(numpy.int32))

    prng.get().seed(51)
    prng.get("loader").seed(52)
    wf = MnistWorkflow(DummyLauncher(), provider=provider, layers=(8,),
                       minibatch_size=10, max_epochs=1)
    wf.initialize(device="cpu")
    wf.run()
    pkg_dir = tmp_path / "package"
    wf.package_export(str(pkg_dir))
    with open(pkg_dir / "manifest.json", "w") as f:
        json.dump({"name": "trained-mnist", "version": "1.0",
                   "author": "ci", "export": "contents.json"}, f)
    client.upload(str(pkg_dir))
    dest = tmp_path / "roundtrip"
    client.fetch("trained-mnist", str(dest))
    assert (dest / "contents.json").exists()
    assert any(fn.startswith("@") for fn in os.listdir(dest))


def test_delete_via_get_is_refused(forge):
    server, client, tmp_path = forge
    client.upload(_make_package(tmp_path, name="getdel"))
    url = ("http://127.0.0.1:%d/forge?query=delete&name=getdel"
           "&token=sekret" % server.port)
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(url, timeout=10)
    assert any(m["name"] == "getdel" for m in client.list())
    client.delete("getdel")
    assert not any(m["name"] == "getdel" for m in client.list())
    with pytest.raises(RuntimeError, match="no such model"):
        client.fetch("getdel", str(tmp_path / "gone"))


def test_tokenless_non_loopback_bind_refused(tmp_path):
    with pytest.raises(ValueError, match="refusing"):
        ForgeServer(str(tmp_path), host="0.0.0.0", port=0, token=None)
    s = ForgeServer(str(tmp_path), host="0.0.0.0", port=0, token=None,
                    allow_insecure=True)
    s._server.server_close()


def _scan_tree(tmp_path):
    scan = tmp_path / "models"
    scan.mkdir()
    _make_package(scan, name="model-a", version="1.0")
    _make_package(scan, name="model-b", version="2.0")
    broken = scan / "broken"
    broken.mkdir()
    (broken / "manifest.json").write_text("{not json")
    return scan


def test_update_forge_bulk_sync(forge, capsys):
    from veles_tpu_torch.scripts.update_forge import main
    server, client, tmp_path = forge
    scan = _scan_tree(tmp_path)
    address = "127.0.0.1:%d" % server.port
    main([str(scan), "--server", address, "--token", "sekret",
          "--dry-run"])
    assert client.list() == []
    rc = main([str(scan), "--server", address, "--token", "sekret"])
    out = capsys.readouterr()
    assert {m["name"] for m in client.list()} == {"model-a", "model-b"}
    assert rc != 0
    assert "FAILED" in out.err
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main([str(empty), "--server", address]) == 1


# -- across the two packages ------------------------------------------------

def _files(directory):
    """{relative path: bytes} of every file under ``directory``."""
    out = {}
    for dirpath, _, filenames in os.walk(directory):
        for name in filenames:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, directory)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("up,down", [("jax", "port"), ("port", "jax")])
def test_packages_cross_the_packages(tmp_path, up, down):
    """A package goes up through one package's client to the other's
    server and comes down through the other's client, byte-equal; the
    server is the downloading side's, so each client meets the other's
    server."""
    from veles_tpu.forge import ForgeClient as JaxClient
    from veles_tpu.forge import ForgeServer as JaxServer
    clients = {"jax": JaxClient, "port": ForgeClient}
    servers = {"jax": JaxServer, "port": ForgeServer}
    server = servers[down](str(tmp_path / "storage"), port=0,
                           token="sekret").start()
    try:
        address = "127.0.0.1:%d" % server.port
        pkg = _make_package(tmp_path, name="cross", version="3.1")
        os.makedirs(os.path.join(pkg, "plots"))
        with open(os.path.join(pkg, "plots", "curve.bin"), "wb") as f:
            f.write(numpy.random.RandomState(3).bytes(4096))
        clients[up](address, token="sekret").upload(pkg)
        getter = clients[down](address)
        assert [m["name"] for m in getter.list()] == ["cross"]
        assert getter.details("cross")["manifest"]["version"] == "3.1"
        dest = tmp_path / "fetched"
        assert getter.fetch("cross", str(dest)) == "3.1"
        assert _files(str(dest)) == _files(pkg)
        with pytest.raises(RuntimeError, match="token"):
            clients[up](address).delete("cross")
    finally:
        server.stop()


def test_update_forge_sweeps_agree(tmp_path, capfd):
    """Both packages' ``update_forge`` over the same tree, each against a
    server of its own package: the same exit code, the same uploads (the
    servers' lists) and the same failures (stderr lines)."""
    from veles_tpu.forge import ForgeServer as JaxServer
    from veles_tpu.scripts.update_forge import main as jax_main
    from veles_tpu_torch.scripts.update_forge import main as port_main
    scan = _scan_tree(tmp_path)
    reports = {}
    for label, server_cls, main in (("jax", JaxServer, jax_main),
                                    ("port", ForgeServer, port_main)):
        server = server_cls(str(tmp_path / ("storage-" + label)), port=0,
                            token="sekret").start()
        try:
            rc = main([str(scan), "--server",
                       "127.0.0.1:%d" % server.port, "--token", "sekret"])
            out = capfd.readouterr()
            reports[label] = (
                rc, sorted((m["name"], m["version"])
                           for m in server.list_models()),
                sorted(line for line in out.out.splitlines()
                       if line.startswith("uploaded")),
                sorted(line for line in out.err.splitlines()
                       if line.startswith("FAILED")))
        finally:
            server.stop()
    assert reports["port"] == reports["jax"]
    assert reports["port"][0] == 1 and len(reports["port"][3]) == 1
    assert reports["port"][1] == [("model-a", "1.0"), ("model-b", "2.0")]


#: a small convolutional model with every unit kind the full reader
#: rebuilds: padded convolutions, LRN, max and average pooling, dense
FULL_LAYERS = [
    {"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3, "padding": 1},
    {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75},
    {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
    {"type": "conv_tanh", "n_kernels": 8, "kx": 3, "ky": 3,
     "sliding": (2, 2)},
    {"type": "avg_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_str", "output_sample_shape": 16},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 10},
]


def test_full_package_through_forge_serves(forge, tmp_path):
    """A trained convolutional workflow exported, uploaded, fetched and
    served with ``full=True``: its replies equal the workflow's own
    within 1e-6, and the default (dense) reader refuses the package."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,
                                                SyntheticImageLoader)
    from veles_tpu_torch.serving.model_store import (ModelLoadError,
                                                     ServeableModel)
    server, client, _ = forge
    prng.get().seed(61)
    prng.get("loader").seed(62)
    wf = AlexNetWorkflow(DummyLauncher(), layers=FULL_LAYERS, max_epochs=1,
                         loader_factory=lambda w: SyntheticImageLoader(
                             workflow=w, n_train=16, n_valid=8, side=19,
                             n_classes=10, minibatch_size=8))
    wf.initialize(device="cpu")
    wf.run()
    pkg = tmp_path / "alexnet-like"
    wf.package_export(str(pkg))
    (pkg / "manifest.json").write_text(json.dumps(
        {"name": "alexnet-like", "version": "1.0"}))
    client.upload(str(pkg))
    dest = tmp_path / "fetched"
    client.fetch("alexnet-like", str(dest), version="1.0")
    assert _files(str(dest)) == _files(str(pkg))
    model = ServeableModel.from_package(str(dest), device="cpu", full=True)
    assert model.sample_shape == (19, 19, 3)
    x = numpy.random.RandomState(7).uniform(-1, 1, (5, 19, 19, 3)).astype(
        numpy.float32)
    want = ServeableModel.from_workflow(wf)(x)
    numpy.testing.assert_allclose(model(x), want, atol=1e-6, rtol=0)
    with pytest.raises(ModelLoadError, match="ConvStrictRELU"):
        ServeableModel.from_package(str(dest), device="cpu")
