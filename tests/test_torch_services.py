"""The port's services against the JAX package's: ``interaction.py``
(``Shell``, ``Manhole``, the stack dumps), ``loader/hdfs.py``,
``downloader.py`` and ``avatar.py``, with the launcher's
``is_interactive`` seam and ``TriviallyDistributable``.

The twins of ``tests/test_services.py``'s Shell, Manhole, stacks and
HDFS tests and of ``tests/test_loaders.py``'s Downloader and Avatar
tests run on the port. Across the packages: the port's ``HDFSLoader``
dataset from a WebHDFS stub equals JAX's from the same stub bit for
bit; an archive served over HTTP unpacks to the same bytes under both
``Downloader``s; a JAX ``RemoteAvatar`` pulls the port's
``AvatarServer`` and the port's pulls JAX's, the values equal bit for
bit (both codecs are the same wire format). Every server listens on
loopback port 0 and every file lives in ``tmp_path``.
"""

import http.server
import io
import os
import pickle
import signal
import subprocess
import sys
import tarfile
import textwrap
import threading
import zipfile

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- interaction ------------------------------------------------------------

def test_shell_interact_uses_workflow_namespace():
    from veles_tpu_torch.interaction import Shell
    wf = DummyWorkflow()
    shell = Shell(wf)
    seen = {}

    class FakeEmbed(object):
        def __call__(self, local_ns=None):
            seen.update(local_ns or {})

    shell.shell_ = FakeEmbed()
    shell.interact(extra_locals={"extra": 42})
    assert seen["workflow"] is wf
    assert isinstance(seen["units"], list)
    assert seen["extra"] == 42
    assert shell.view_group == "SERVICE"


def test_shell_run_noop_without_tty(monkeypatch):
    from veles_tpu_torch.interaction import Shell
    shell = Shell(DummyWorkflow())
    shell.shell_ = object()
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))  # not a tty
    shell.run()  # must not raise or block


def test_shell_interact_next_run_flag():
    from veles_tpu_torch.interaction import Shell
    shell = Shell(DummyWorkflow())
    calls = []
    shell.interact = lambda *a, **k: calls.append(1)
    shell.interact_next_run = True
    shell.run()
    assert calls == [1]
    assert not shell.interact_next_run


def test_shell_follows_the_launchers_interactive_seam():
    """``-i`` reaches the launcher (``is_interactive``); a Shell under an
    interactive launcher never embeds a console, and without IPython it
    warns and stays disabled, as JAX's does."""
    from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
    from veles_tpu.launcher import Launcher as JaxLauncher
    from veles_tpu_torch.distributable import (Distributable,
                                               TriviallyDistributable)
    from veles_tpu_torch.interaction import Shell
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.workflow import Workflow
    assert issubclass(Shell, TriviallyDistributable)
    assert issubclass(TriviallyDistributable, Distributable)
    for interactive in (False, True):
        assert Launcher(interactive=interactive).is_interactive is \
            JaxLauncher(interactive=interactive).is_interactive is \
            interactive
    assert DummyLauncher().is_interactive is \
        JaxDummyLauncher().is_interactive is False
    shell = Shell(Workflow(Launcher(interactive=True)))
    assert shell.interactive
    shell.initialize()
    assert shell.shell_ is None
    shell = Shell(DummyWorkflow())
    assert not shell.interactive
    try:
        import IPython  # noqa: F401
    except ImportError:
        shell.initialize()
        assert shell.shell_ is None


def test_cli_passes_interactive_to_the_launcher():
    from veles_tpu_torch.__main__ import Main
    main = Main()
    main.args = main.init_parser().parse_args(["wf.py", "-i"])
    assert main._launcher_kwargs()["interactive"] is True
    main.args = main.init_parser().parse_args(["wf.py"])
    assert main._launcher_kwargs()["interactive"] is False


def test_print_thread_stacks_lists_main_thread():
    from veles_tpu_torch.interaction import print_thread_stacks
    buf = io.StringIO()
    print_thread_stacks(file=buf)
    assert "MainThread" in buf.getvalue()


def test_debug_deadlocks_flags_non_daemon_thread():
    from veles_tpu_torch.interaction import debug_deadlocks
    gate = threading.Event()
    thr = threading.Thread(target=gate.wait, name="suspicious-worker")
    thr.start()
    try:
        buf = io.StringIO()
        suspects = debug_deadlocks(file=buf)
        assert thr in suspects
        assert "suspicious-worker" in buf.getvalue()
    finally:
        gate.set()
        thr.join()
    assert debug_deadlocks(file=io.StringIO()) == []


def test_stack_dump_on_sigusr1():
    """``install_stack_dump_handler()`` then ``SIGUSR1`` to the process
    itself: the dump on stderr names the main thread, and the process
    goes on."""
    code = textwrap.dedent('''
        import os, signal, sys
        sys.path.insert(0, sys.argv[1])
        from veles_tpu_torch.interaction import install_stack_dump_handler
        previous = install_stack_dump_handler()
        os.kill(os.getpid(), signal.SIGUSR1)
        print("alive", previous == signal.SIG_DFL)
    ''')
    proc = subprocess.run([sys.executable, "-c", code, REPO],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "alive True" in proc.stdout
    assert "MainThread" in proc.stderr
    assert "in <module>" in proc.stderr


def test_manhole_eval_and_exec(tmp_path):
    import socket
    from veles_tpu_torch.interaction import Manhole
    wf = DummyWorkflow()
    manhole = Manhole(path=str(tmp_path / "mh.sock"),
                      locals={"workflow": wf, "x": 41}).start()
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
            sock.connect(manhole.path)
            f = sock.makefile("rw")
            assert "manhole" in f.readline()
            f.read(4)  # ">>> "
            f.write("x + 1\n")
            f.flush()
            assert f.readline().strip() == "42"
            f.read(4)
            f.write("y = x * 2\n")  # a statement: executed
            f.flush()
            f.read(4)
            f.write("y\n")
            f.flush()
            assert f.readline().strip() == "82"
            f.read(4)
            f.write("1/0\n")  # errors answered, the session goes on
            f.flush()
            assert "ZeroDivisionError" in f.readline()
            f.read(4)
            f.write("workflow.name\n")
            f.flush()
            assert "Dummy" in f.readline()
    finally:
        manhole.stop()
    assert not os.path.exists(manhole.path)


def test_manhole_private_socket():
    from veles_tpu_torch.interaction import Manhole
    manhole = Manhole(locals={}).start()
    try:
        directory = os.path.dirname(manhole.path)
        assert os.stat(directory).st_mode & 0o777 == 0o700
        assert os.stat(manhole.path).st_mode & 0o777 == 0o600
    finally:
        manhole.stop()
    assert not os.path.exists(directory)


# -- HDFS ---------------------------------------------------------------------

def test_hdfs_loader_gated_without_namenode():
    from veles_tpu_torch.loader import HDFSLoader
    loader = HDFSLoader(train_path="/data/train.pickle", minibatch_size=4)
    with pytest.raises(RuntimeError, match="namenode"):
        loader.load_dataset()


class _WebHDFS(object):
    """A WebHDFS stub on loopback: ``OPEN`` and ``GETFILESTATUS`` over
    ``blobs`` ({path: bytes})."""

    def __init__(self, blobs):
        class Stub(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                blob = blobs.get(path[len("/webhdfs/v1"):])
                if blob is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                if "op=GETFILESTATUS" in query:
                    blob = ('{"FileStatus": {"length": %d, "type": "FILE"}}'
                            % len(blob)).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

        self.server = http.server.HTTPServer(("127.0.0.1", 0), Stub)
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()
        self.namenode = "127.0.0.1:%d" % self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _hdfs_blobs():
    rng = numpy.random.RandomState(0)
    return {
        "/data/train.pickle": pickle.dumps(
            (rng.rand(8, 3).astype(numpy.float32),
             rng.randint(0, 2, 8).astype(numpy.int32))),
        "/data/valid.pickle": pickle.dumps(
            (rng.rand(4, 3).astype(numpy.float32),
             rng.randint(0, 2, 4).astype(numpy.int32))),
    }


def test_hdfs_loader_reads_webhdfs():
    from veles_tpu_torch.loader.hdfs import HDFSLoader, WebHDFSClient
    stub = _WebHDFS(_hdfs_blobs())
    try:
        loader = HDFSLoader(namenode=stub.namenode,
                            train_path="/data/train.pickle",
                            validation_path="/data/valid.pickle",
                            minibatch_size=4)
        loader.initialize()
        assert loader.class_lengths == [0, 4, 8]
        assert tuple(loader.original_data.shape) == (12, 3)
        status = WebHDFSClient(stub.namenode, user="me").status(
            "data/train.pickle")
        assert status["length"] == len(_hdfs_blobs()["/data/train.pickle"])
    finally:
        stub.close()


def test_hdfs_dataset_equals_jax_bit_for_bit():
    """The same stub read by both packages' loaders: data and labels
    equal bit for bit, classes alike; a changed training label changes
    the port's labels; an unreachable namenode raises the gated error in
    both."""
    from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
    from veles_tpu.loader.hdfs import HDFSLoader as JaxHDFSLoader
    from veles_tpu_torch.loader.hdfs import HDFSLoader
    blobs = _hdfs_blobs()
    stub = _WebHDFS(blobs)
    paths = dict(train_path="/data/train.pickle",
                 validation_path="/data/valid.pickle")
    try:
        jax = JaxHDFSLoader(JaxDummyWorkflow(), namenode=stub.namenode,
                            minibatch_size=4, **paths)
        jax.initialize()
        port = HDFSLoader(namenode=stub.namenode, minibatch_size=4, **paths)
        port.initialize()
        assert port.class_lengths == jax.class_lengths
        assert port.original_data.numpy().tobytes() == \
            numpy.asarray(jax.original_data.mem).tobytes()
        assert port.original_labels.numpy().tobytes() == \
            numpy.asarray(jax.original_labels.mem).tobytes()
        data, labels = pickle.loads(blobs["/data/train.pickle"])
        labels = labels.copy()
        labels[0] = 1 - labels[0]
        blobs["/data/train.pickle"] = pickle.dumps((data, labels))
        changed = HDFSLoader(namenode=stub.namenode, minibatch_size=4,
                             **paths)
        changed.initialize()
        assert int((changed.original_labels !=
                    port.original_labels).sum()) == 1
    finally:
        stub.close()
    for loader in (HDFSLoader(namenode=stub.namenode, minibatch_size=4,
                              **paths),
                   JaxHDFSLoader(JaxDummyWorkflow(), namenode=stub.namenode,
                                 minibatch_size=4, **paths)):
        with pytest.raises(RuntimeError, match="cannot fetch"):
            loader.load_dataset()


# -- downloader ----------------------------------------------------------------

def test_downloader_unpacks_zip(tmp_path):
    from veles_tpu_torch.downloader import Downloader
    archive = tmp_path / "data.zip"
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("dataset/a.txt", "hello")
    target = tmp_path / "out"
    unit = Downloader(DummyWorkflow(), url="file://" + str(archive),
                      directory=str(target), files=("dataset/a.txt",))
    assert unit.view_group == "SERVICE"
    unit.initialize()
    assert (target / "dataset" / "a.txt").read_text() == "hello"
    archive.unlink()  # present now: a second initialize fetches nothing
    unit.initialize()


def test_downloader_missing_file_raises(tmp_path):
    from veles_tpu_torch.downloader import Downloader
    archive = tmp_path / "data.zip"
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("other.txt", "x")
    unit = Downloader(DummyWorkflow(), url="file://" + str(archive),
                      directory=str(tmp_path / "out2"),
                      files=("missing.txt",))
    with pytest.raises(FileNotFoundError):
        unit.initialize()


@pytest.fixture
def archive_host(tmp_path):
    """An HTTP server on loopback over ``tmp_path / "www"``."""
    www = tmp_path / "www"
    www.mkdir()

    class Quiet(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **k):
            super(Quiet, self).__init__(*a, directory=str(www), **k)

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        yield www, "http://127.0.0.1:%d/" % server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()


def test_downloader_over_http_matches_jax(tmp_path, archive_host):
    """A ``.tar`` over ``http://`` and a plain ``file://``: both
    packages' Downloaders unpack the same bytes, remove the fetched
    archive, and raise ``FileNotFoundError`` for a promised file the tar
    lacks. A plain file over ``http://`` lands in the port's directory;
    the JAX unit copies it onto itself and fails (the port differs on
    purpose)."""
    import shutil
    from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
    from veles_tpu.downloader import Downloader as JaxDownloader
    from veles_tpu_torch.downloader import Downloader
    www, base = archive_host
    rng = numpy.random.RandomState(4)
    payload = {"set/train.pickle": rng.bytes(5000),
               "set/valid.pickle": rng.bytes(3000)}
    with tarfile.open(www / "set.tar", "w") as tar:
        for name, blob in sorted(payload.items()):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    (www / "plain.bin").write_bytes(b"plain bytes")
    for label, cls, wf in (("jax", JaxDownloader, JaxDummyWorkflow),
                           ("port", Downloader, DummyWorkflow)):
        target = tmp_path / label
        cls(wf(), url=base + "set.tar", directory=str(target),
            files=tuple(payload)).initialize()
        for name, blob in payload.items():
            assert (target / name).read_bytes() == blob
        assert not (target / "set.tar").exists()
        cls(wf(), url="file://" + str(www / "plain.bin"),
            directory=str(target / "p"), files=("plain.bin",)).initialize()
        assert (target / "p" / "plain.bin").read_bytes() == b"plain bytes"
        over_http = cls(wf(), url=base + "plain.bin",
                        directory=str(target / "h"), files=("plain.bin",))
        if label == "jax":
            with pytest.raises(shutil.SameFileError):
                over_http.initialize()
        else:
            over_http.initialize()
            assert (target / "h" / "plain.bin").read_bytes() == \
                b"plain bytes"
        with pytest.raises(FileNotFoundError):
            cls(wf(), url=base + "set.tar", directory=str(target / "x"),
                files=("set/test.pickle",)).initialize()


# -- avatar ----------------------------------------------------------------------

class _AvatarSource(object):
    """Module-level, so a workflow holding an avatar of it pickles."""


def test_avatar_mirrors_attrs():
    from veles_tpu_torch.avatar import Avatar
    src = _AvatarSource()
    src.values = torch.ones(4)
    src.table = numpy.ones(3, numpy.float32)
    src.count = 7
    avatar = Avatar(DummyWorkflow(), source=src,
                    attrs=("values", "table", "count"))
    avatar.initialize()
    assert avatar.count == 7
    src.count = 9
    src.values[...] = 2.0
    src.table[...] = 2.0
    assert torch.equal(avatar.values, torch.ones(4))  # a snapshot
    assert numpy.array_equal(avatar.table, numpy.ones(3))
    avatar.run()
    assert avatar.count == 9
    assert torch.equal(avatar.values, torch.full((4,), 2.0))
    assert numpy.array_equal(avatar.table, numpy.full(3, 2.0))


def test_avatar_copies_a_parameter_updated_in_place():
    """A parameter an optimizer updates in place after the clone: the
    mirror keeps the values of the clone, and holds no memory of the
    source."""
    from veles_tpu_torch.avatar import Avatar
    src = _AvatarSource()
    src.weights = torch.nn.Parameter(torch.arange(6.0).reshape(2, 3))
    avatar = Avatar(DummyWorkflow(), source=src, attrs=("weights",))
    avatar.initialize()
    before = avatar.weights.clone()
    opt = torch.optim.SGD([src.weights], lr=0.5)
    src.weights.grad = torch.ones(2, 3)
    opt.step()
    with torch.no_grad():
        src.weights.mul_(3.0)
    assert torch.equal(avatar.weights, before)
    assert not avatar.weights.requires_grad
    assert avatar.weights.data_ptr() != src.weights.data_ptr()
    avatar.run()
    assert torch.equal(avatar.weights, src.weights.detach())


def test_remote_avatar_mirrors_across_workflows():
    import pickle as _pickle
    from veles_tpu_torch.avatar import Avatar, AvatarServer, RemoteAvatar
    src = _AvatarSource()
    src.weights = torch.ones(3, 2)
    src.epoch = 4
    master_wf = DummyWorkflow()
    avatar = Avatar(master_wf, source=src, attrs=("weights", "epoch"))
    avatar.initialize()
    server = AvatarServer(avatar)
    try:
        remote = RemoteAvatar(DummyWorkflow(), address=server.address,
                              attrs=("weights", "epoch"))
        remote.initialize()
        assert remote.epoch == 4
        assert isinstance(remote.weights, torch.Tensor)
        assert torch.equal(remote.weights, torch.ones(3, 2))
        first_rev = remote.rev
        src.epoch = 5
        src.weights[...] = 3.0
        avatar.run()
        remote.run()
        assert remote.rev == first_rev + 1 == server.rev
        assert remote.epoch == 5
        assert torch.equal(remote.weights, torch.full((3, 2), 3.0))
        assert server.published_bytes > 0 and server.publish_ms >= 0
        remote2 = RemoteAvatar(DummyWorkflow(), address=server.address)
        remote2.initialize()
        assert remote2.epoch == 5 and remote2.rev == remote.rev
        # the publish hook of the live server never rides the pickle
        clone = _pickle.loads(_pickle.dumps(master_wf))
        assert clone["Avatar"].epoch == 5
        remote.close()
        remote2.close()
    finally:
        server.stop()


@pytest.mark.parametrize("direction", ["jax_pulls_port", "port_pulls_jax"])
def test_remote_avatar_across_the_packages(direction):
    """One package's RemoteAvatar pulls the other's AvatarServer: the
    codecs and the framing agree, the values arrive bit for bit (float32
    weights, an int, a dict)."""
    from veles_tpu.avatar import Avatar as JaxAvatar
    from veles_tpu.avatar import AvatarServer as JaxServer
    from veles_tpu.avatar import RemoteAvatar as JaxRemote
    from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
    from veles_tpu.memory import Array
    from veles_tpu_torch.avatar import Avatar, AvatarServer, RemoteAvatar
    weights = numpy.random.RandomState(9).randn(5, 4).astype(numpy.float32)
    src = _AvatarSource()
    src.epoch = 3
    src.info = {"name": "fc7", "shape": [5, 4]}
    if direction == "jax_pulls_port":
        src.weights = torch.from_numpy(weights.copy())
        avatar = Avatar(DummyWorkflow(), source=src,
                        attrs=("weights", "epoch", "info"))
        server_cls, remote = AvatarServer, JaxRemote(
            JaxDummyWorkflow(), address=None)
    else:
        src.weights = Array(weights.copy())
        avatar = JaxAvatar(JaxDummyWorkflow(), source=src,
                           attrs=("weights", "epoch", "info"))
        server_cls, remote = JaxServer, RemoteAvatar(DummyWorkflow(),
                                                     address=None)
    avatar.initialize()
    server = server_cls(avatar)
    try:
        remote.address = server.address
        remote.initialize()
        got = remote.weights
        got = got.numpy() if isinstance(got, torch.Tensor) else \
            numpy.asarray(got.mem)
        assert got.dtype == numpy.float32
        assert got.tobytes() == weights.tobytes()
        assert remote.epoch == 3 and remote.info == src.info
        assert remote.rev >= 1
        remote.close()
    finally:
        server.stop()


# -- the import guard -------------------------------------------------------------

def test_new_modules_import_no_jax():
    """Importing every module of this slice loads no ``jax`` and no
    ``veles_tpu`` module."""
    code = textwrap.dedent('''
        import sys
        sys.path.insert(0, sys.argv[1])
        import veles_tpu_torch.avatar, veles_tpu_torch.downloader
        import veles_tpu_torch.interaction, veles_tpu_torch.loader.hdfs
        import veles_tpu_torch.forge, veles_tpu_torch.forge.client
        import veles_tpu_torch.forge.server
        import veles_tpu_torch.scripts.update_forge
        import veles_tpu_torch.nn.kohonen, veles_tpu_torch.train.som
        import veles_tpu_torch.models.mnist_ae
        bad = sorted(m for m in sys.modules if m == "jax" or
                     m.startswith("jax.") or m.split(".")[0] == "veles_tpu")
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    ''')
    proc = subprocess.run([sys.executable, "-c", code, REPO],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_sigusr1_handler_is_python_level():
    """The handler is a Python callable (run under the interpreter lock),
    not ``faulthandler``'s C-level dump."""
    from veles_tpu_torch.interaction import install_stack_dump_handler
    previous = install_stack_dump_handler()
    try:
        handler = signal.getsignal(signal.SIGUSR1)
        assert callable(handler) and handler not in (signal.SIG_DFL,
                                                     signal.SIG_IGN)
    finally:
        signal.signal(signal.SIGUSR1, previous)
