"""Snapshots of the port's workflows, and the JAX snapshot reader, on
the CPU.

* Resume: 4 epochs of the small AlexNet (dropout through the Philox
  fill's plain version) uninterrupted equal 2 epochs, a snapshot, a
  restore in a cleared registry and 2 more, bit for bit (epoch history,
  evaluator loss, parameters, SGD velocity); the same restore with the
  registry dropped must differ (the control).
* The file format: raw, gz, bz2 and xz round-trip (read by magic
  bytes), the ``_current`` link names the newest, ``restore_latest``
  falls back past a corrupt newest file (``ModelStore.load`` of the
  directory too; an export package loads as one, an empty one raises
  ``ModelLoadError``), a pickle that is not a
  snapshot is refused, no tensor (and no torch class) is pickled, and a
  snapshot loads and serves with no card.
* The JAX reader: JAX's own mid-epoch case (``tests/test_fused_runner.
  py``: an eager JAX run stopped after 17 minibatches, offset 300),
  finished by the port's ``FusedRunner``, against the JAX ``FusedRunner``
  finishing the same bytes (epoch history within that test's 0.02 on
  the normalized metrics, read: equal; parameters within 1e-6, read:
  3e-8); a
  finished ``MnistWorkflow`` (weights, velocity and history equal); a
  small ``AlexNetWorkflow`` after one epoch, continued one more epoch by
  both sides (JAX's dropout uniforms handed over; history equal,
  parameters within 1e-6); a JAX snapshot written by its own
  ``SnapshotterToFile`` (gz) comes over with its snapshotter; a sharded
  generation and a workflow class the port does not read both raise.
* A subprocess guard: a CLI run, the load of a port and of a JAX
  snapshot and a served forward import neither ``jax`` nor any
  ``veles_tpu`` module.
"""

import os
import pickle
import pickletools
import subprocess
import sys

import numpy
import pytest

torch = pytest.importorskip("torch")

from test_mnist_e2e import synthetic_digits  # noqa: E402
from test_torch_workflow import (JaxUniforms, MNIST_FILE,  # noqa: E402
                                 SMALL_LOADER, _jax_weights, _port_weights,
                                 _small_mnist, workflow_file)

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.convert import solver_state_to_jax  # noqa: E402
from veles_tpu_torch.dummy import DummyLauncher  # noqa: E402
from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,  # noqa: E402
                                            SyntheticImageLoader,
                                            small_alexnet_layers)
from veles_tpu_torch.snapshotter import (SnapshotterToFile,  # noqa: E402
                                         dump_workflow, load_workflow,
                                         restore_latest, save_snapshot,
                                         snapshot_candidates)
from veles_tpu_torch.standard_workflow import TrainableWorkflow  # noqa
from veles_tpu_torch.train.runner import (FusedRunner,  # noqa: E402
                                          fused_compatible)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _alexnet(directory=None, max_epochs=4):
    prng._generators.clear()
    prng.get().seed(7)
    prng.get("loader").seed(8)
    wf = AlexNetWorkflow(
        DummyLauncher(), layers=small_alexnet_layers(10),
        loader_factory=lambda w: SyntheticImageLoader(
            workflow=w, **SMALL_LOADER), max_epochs=max_epochs)
    if directory is not None:
        snap = SnapshotterToFile(wf, directory=str(directory),
                                 compression="", time_interval=0,
                                 name="snapshotter")
        snap.link_from(wf.decision)
        snap.gate_skip = ~wf.loader.epoch_ended
    return wf


def _velocities(wf):
    return [solver_state_to_jax([gd.opt_state])[0]["velocity"]
            for gd in wf.gds if gd.opt_state]


def _assert_same(a, b):
    assert a.decision.epoch_history == b.decision.epoch_history
    assert a.evaluator.loss == b.evaluator.loss
    for got, want in ((_port_weights(a), _port_weights(b)),
                      (_velocities(a), _velocities(b))):
        for g, w in zip(got, want):
            for k in w:
                numpy.testing.assert_array_equal(g[k], w[k])


def _resumed(directory, out, keep_random=True):
    path = os.path.join(str(directory), "wf.1.pickle")
    prng._generators.clear()
    wf = load_workflow(path)
    if not keep_random:
        prng._generators.clear()
    for unit in wf:
        if isinstance(unit, SnapshotterToFile):
            unit.directory = str(out)
    wf.workflow = DummyLauncher()
    wf.initialize(device="cpu")
    wf.runner = FusedRunner(wf)
    wf.runner.run()
    return wf


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    directory = tmp_path_factory.mktemp("snaps")
    wf = _alexnet(directory)
    wf.initialize(device="cpu")
    runner = FusedRunner(wf)
    runner.run()
    wf.epoch_losses = [t["loss"] for t in runner.epoch_times]
    return wf, directory


def test_resume_equals_uninterrupted_bitwise(uninterrupted, tmp_path):
    full, directory = uninterrupted
    resumed = _resumed(directory, tmp_path)
    assert len(resumed.decision.epoch_history) == 4
    assert [t["loss"] for t in resumed.runner.epoch_times] == \
        full.epoch_losses[2:]
    _assert_same(resumed, full)
    assert sorted(os.listdir(str(tmp_path))) == [
        "wf.2.pickle", "wf.3.pickle", "wf_current.pickle"]


def test_resume_without_the_registry_differs(uninterrupted, tmp_path):
    """The control: the same snapshot with its random streams dropped
    (the loader's shuffles and the dropout masks restart) does not give
    the uninterrupted run."""
    full, directory = uninterrupted
    resumed = _resumed(directory, tmp_path, keep_random=False)
    with pytest.raises(AssertionError):
        _assert_same(resumed, full)


def test_every_epoch_snapshotted_and_linked(uninterrupted):
    full, directory = uninterrupted
    names = sorted(os.listdir(str(directory)))
    assert names == ["wf.%d.pickle" % e for e in range(4)] + \
        ["wf_current.pickle"]
    link = os.path.join(str(directory), "wf_current.pickle")
    assert os.readlink(link) == "wf.3.pickle"
    assert snapshot_candidates(str(directory))[0] == \
        os.path.realpath(os.path.join(str(directory), "wf.3.pickle"))
    snap = [u for u in full if isinstance(u, SnapshotterToFile)][0]
    assert len(snap.exports) == 4 and snap.destination.endswith(
        "wf.3.pickle")


@pytest.mark.parametrize("codec,magic", [("", b"\x80"), ("gz", b"\x1f\x8b"),
                                         ("bz2", b"BZh"),
                                         ("xz", b"\xfd7zXZ\x00")])
def test_codecs_round_trip(tmp_path, uninterrupted, codec, magic):
    full, _ = uninterrupted
    path, nbytes = save_snapshot(full, str(tmp_path), compression=codec)
    assert path.endswith(".pickle" + ("." + codec if codec else ""))
    with open(path, "rb") as f:
        assert f.read(len(magic)) == magic
    # the codec is read from the bytes, not the name
    renamed = str(tmp_path / "renamed")
    os.rename(path, renamed)
    wf = load_workflow(renamed)
    wf.initialize(device="cpu")
    _assert_same(wf, full)


def test_no_tensor_in_a_snapshot(uninterrupted):
    full, _ = uninterrupted
    modules = set()
    strings = []
    for opcode, arg, _ in pickletools.genops(dump_workflow(full)):
        if isinstance(arg, str):
            strings.append(arg)
        if opcode.name == "STACK_GLOBAL":
            modules.add(strings[-2])
    assert modules and not any(m.split(".")[0] == "torch" for m in modules)


def test_restore_latest_falls_back_past_a_corrupt_file(tmp_path,
                                                       uninterrupted):
    full, directory = uninterrupted
    for name in ("wf.2.pickle", "wf.3.pickle"):
        with open(os.path.join(str(directory), name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    os.symlink("wf.3.pickle", str(tmp_path / "wf_current.pickle"))
    blob = (tmp_path / "wf.3.pickle").read_bytes()
    (tmp_path / "wf.3.pickle").write_bytes(blob[:len(blob) // 2])
    wf, path = restore_latest(str(tmp_path))
    assert path.endswith("wf.2.pickle")
    assert len(wf.decision.epoch_history) == 3


def test_a_pickle_that_is_not_a_snapshot_is_refused(tmp_path):
    path = tmp_path / "other.pickle"
    path.write_bytes(pickle.dumps({"weights": [1, 2, 3]}))
    with pytest.raises(pickle.UnpicklingError):
        load_workflow(str(path))
    with pytest.raises(FileNotFoundError):
        restore_latest(str(tmp_path))


def test_a_snapshot_loads_and_serves_without_a_card(uninterrupted,
                                                    monkeypatch):
    from veles_tpu_torch.serving.model_store import (ModelLoadError,
                                                     ModelStore,
                                                     ServeableModel)
    full, directory = uninterrupted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wf = load_workflow(os.path.join(str(directory), "wf.3.pickle"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wf.initialize()
    store = ModelStore()
    model = store.load(str(directory), device="cpu")
    x = numpy.random.RandomState(0).uniform(
        -1, 1, (3, 32, 32, 3)).astype(numpy.float32)
    with torch.no_grad():
        want = full.model.eval()(torch.from_numpy(x)).numpy()
    numpy.testing.assert_array_equal(model(x), want)


# -- the JAX reader ----------------------------------------------------------

def _jax_mid_epoch_blob():
    """JAX's own mid-epoch snapshot (``tests/test_fused_runner.py``)."""
    from veles_tpu.launcher import Launcher
    from veles_tpu.models.mnist import MnistWorkflow as JaxMnist
    from veles_tpu.nn.decision import DecisionGD
    from veles_tpu.snapshotter import dump_workflow as jax_dump
    jax_prng.get().seed(42)
    jax_prng.get("loader").seed(43)
    launcher = Launcher(graphics=False, eager=True)
    wf = JaxMnist(launcher, provider=synthetic_digits(), layers=(32,),
                  minibatch_size=60, learning_rate=0.08, max_epochs=3)
    calls = [0]
    orig_run = DecisionGD.run

    def counting_run(self):
        orig_run(self)
        calls[0] += 1
        if calls[0] == 17:
            self.workflow.stop()

    DecisionGD.run = counting_run
    try:
        launcher.initialize()
        launcher.run()
    finally:
        DecisionGD.run = orig_run
    assert wf.loader._global_offset == 300
    assert wf.decision.epoch_stats[2]["samples"] == 180
    return jax_dump(wf)


def _jax_finish(blob):
    from veles_tpu.snapshotter import load_workflow as jax_load
    from veles_tpu.train import FusedRunner as JaxFusedRunner
    jax_prng._generators.clear()
    wf = jax_load(blob)
    wf.workflow = JaxDummyLauncher()
    wf.initialize(device=Device(backend="cpu"))
    JaxFusedRunner(wf).run()
    return wf


def _port_finish(blob):
    prng._generators.clear()
    wf = load_workflow(blob)
    wf.workflow = DummyLauncher()
    wf.initialize(device="cpu")
    assert fused_compatible(wf) is None
    FusedRunner(wf).run()
    return wf


def test_jax_mid_epoch_snapshot_finishes_under_the_port():
    blob = _jax_mid_epoch_blob()
    want = _jax_finish(blob)
    got = _port_finish(blob)
    hist, expected = got.decision.epoch_history, \
        want.decision.epoch_history
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in expected]
    resumed = next(h for h in hist if h["epoch"] == 1)
    assert resumed["train"]["samples"] == 600
    assert resumed["validation"]["samples"] == 120
    for g, w in zip(hist, expected):
        for klass in ("validation", "train"):
            assert g[klass]["samples"] == w[klass]["samples"]
            numpy.testing.assert_allclose(
                g[klass]["normalized"], w[klass]["normalized"], atol=0.02)
    assert bool(got.decision.complete)
    assert got.loader.epoch_number == want.loader.epoch_number
    for g, w in zip(_port_weights(got), _jax_weights(want)):
        for k in w:
            numpy.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0)


def test_jax_finished_mnist_snapshot(tmp_path):
    from veles_tpu.__main__ import Main as JaxMain
    from veles_tpu.snapshotter import dump_workflow as jax_dump
    main = JaxMain()
    assert main.run([workflow_file(tmp_path, MNIST_FILE, "veles_tpu", 2,
                                   "done"), "-s", "7"]) == 0
    jax_wf = main.workflow
    prng._generators.clear()
    wf = load_workflow(jax_dump(jax_wf))
    wf.workflow = DummyLauncher()
    wf.initialize(device="cpu")
    assert wf.decision.epoch_history == jax_wf.decision.epoch_history
    assert bool(wf.decision.complete)
    assert wf.decision.best_epoch == jax_wf.decision.best_epoch
    for g, w in zip(_port_weights(wf), _jax_weights(jax_wf)):
        for k in w:
            numpy.testing.assert_array_equal(g[k], w[k])
    jax_gds = {gd.name: gd for gd in jax_wf.gds}
    for gd in wf.gds:
        got = solver_state_to_jax([gd.opt_state])[0]
        for k, v in jax_gds[gd.name].opt_state["velocity"].items():
            numpy.testing.assert_array_equal(got["velocity"][k],
                                             numpy.asarray(v))
    assert prng.get("loader").save_state()[0][2] == \
        jax_prng.get("loader").save_state()[0][2]
    FusedRunner(wf).run()  # a finished run resumes to nothing
    assert len(wf.decision.epoch_history) == 2


def test_jax_standard_workflow_snapshot_continues(monkeypatch):
    """A small AlexNet after one JAX epoch; both sides train one more."""
    from veles_tpu.models.alexnet import AlexNetWorkflow as JaxAlexNet
    from veles_tpu.models.alexnet import \
        SyntheticImageLoader as JaxSyntheticImageLoader
    from veles_tpu.snapshotter import dump_workflow as jax_dump
    from veles_tpu.train import FusedRunner as JaxFusedRunner
    jax_prng.get().seed(7)
    jax_prng.get("loader").seed(8)
    jax_wf = JaxAlexNet(JaxDummyLauncher(), layers=small_alexnet_layers(10),
                        loader_factory=lambda w: JaxSyntheticImageLoader(
                            w, **SMALL_LOADER), max_epochs=1)
    jax_wf.initialize(device=Device(backend="cpu"))
    JaxFusedRunner(jax_wf).run()
    jax_wf.decision.max_epochs = 2
    jax_wf.decision.complete.value = False
    blob = jax_dump(jax_wf)
    dropout = jax_prng.get("default").save_state()
    monkeypatch.setattr(TrainableWorkflow, "uniform_source",
                        JaxUniforms(dropout[2], dropout[1]))
    got = _port_finish(blob)
    want = _jax_finish(blob)
    assert [type(f).__name__ for f in got.forwards] == \
        [type(f).__name__ for f in want.forwards]
    assert got.decision.epoch_history == want.decision.epoch_history
    for g, w in zip(_port_weights(got), _jax_weights(want)):
        for k in w:
            numpy.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0)


def test_jax_sharded_generation_raises(tmp_path):
    """A JAX sharded generation is read (its part 0's workflow through
    ``jax_snapshot``): one of a workflow never initialized holds no
    dataset, so its load raises and ``restore_latest`` finds nothing
    loadable; the generation of the initialized workflow loads
    (``tests/test_torch_elastic.py`` holds its leaves bit for bit)."""
    from veles_tpu.snapshotter import save_snapshot_sharded
    jax_prng.get().seed(1)
    from veles_tpu.models.mnist import MnistWorkflow as JaxMnist
    wf = JaxMnist(JaxDummyLauncher(), provider=synthetic_digits(),
                  layers=(8,), minibatch_size=60, max_epochs=1)
    bare = str(tmp_path / "bare")
    gen_dir, _ = save_snapshot_sharded(wf, bare, [])
    with pytest.raises(ValueError, match="no dataset"):
        load_workflow(gen_dir)
    with pytest.raises(FileNotFoundError):
        restore_latest(bare)
    wf.initialize(device=Device(backend="cpu"))
    gen_dir, _ = save_snapshot_sharded(wf, str(tmp_path / "ready"), [])
    got = load_workflow(gen_dir)
    assert [f.name for f in got.forwards] == [f.name for f in wf.forwards]


def _jax_graph(kind):
    from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow
    from veles_tpu.models.mnist import MnistWorkflow as JaxMnist
    from veles_tpu.units import TrivialUnit as JaxTrivialUnit
    if kind == "another_workflow":
        return JaxDummyWorkflow()
    wf = JaxMnist(JaxDummyLauncher(), provider=synthetic_digits(),
                  layers=(8,), minibatch_size=60, max_epochs=1)
    JaxTrivialUnit(wf, name="extra").link_from(wf.decision)
    return wf


@pytest.mark.parametrize("kind,needle", [
    ("another_workflow", "eager compute units"),
    ("an_extra_unit", "extra")])
def test_jax_snapshot_the_port_cannot_carry_raises(kind, needle):
    from veles_tpu.snapshotter import dump_workflow as jax_dump
    with pytest.raises(NotImplementedError, match=needle):
        load_workflow(jax_dump(_jax_graph(kind)))


# -- no JAX on the port's paths -----------------------------------------------

GUARD = r'''
import sys
import numpy
from veles_tpu_torch.__main__ import main
from veles_tpu_torch.serving.model_store import ModelStore
from veles_tpu_torch.snapshotter import load_workflow

workflow, snaps, jax_snapshot = sys.argv[1:4]
assert main([workflow, "-s", "7", "-a", "cpu"]) == 0
store = ModelStore()
model = store.load(snaps, device="cpu")
out = model(numpy.zeros((2, 36), numpy.float32))
assert out.shape == (2, 10)
jax_wf = load_workflow(jax_snapshot)
jax_wf.initialize(device="cpu")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "veles_tpu" or m.startswith("veles_tpu."))
print("LOADED", bad)
assert not bad, bad
'''

#: MNIST_FILE with a snapshotter into ``SNAPS`` (a global the test sets)
SNAPSHOTTING_FILE = MNIST_FILE.replace(
    "    load(MnistWorkflow", "    wf, restored = load(MnistWorkflow"
).replace("    main()", '''
    from {package}.snapshotter import SnapshotterToFile
    snap = SnapshotterToFile(wf, directory=SNAPS, time_interval=0,
                             name="snapshotter")
    snap.link_from(wf.decision)
    snap.gate_skip = ~wf.loader.epoch_ended
    main()''')


def test_no_jax_on_the_cli_snapshot_and_serving_paths(tmp_path):
    from veles_tpu.__main__ import Main as JaxMain
    from veles_tpu.snapshotter import dump_workflow as jax_dump
    main = JaxMain()
    assert main.run([workflow_file(tmp_path, MNIST_FILE, "veles_tpu", 1,
                                   "guard"), "-s", "7"]) == 0
    jax_snapshot = tmp_path / "jax.pickle"
    jax_snapshot.write_bytes(jax_dump(main.workflow))
    snaps = tmp_path / "snaps"
    path = tmp_path / "guarded.py"
    path.write_text("SNAPS = %r\n" % str(snaps) + SNAPSHOTTING_FILE.format(
        package="veles_tpu_torch", epochs=2))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", GUARD, str(path), str(snaps),
         str(jax_snapshot)], env=env, cwd=str(tmp_path),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
    assert sorted(os.listdir(str(snaps)))[-1] == "wf_current.pickle.gz"


def _mnist_trained():
    """A tiny ``MnistWorkflow`` after one fused epoch on the CPU."""
    wf = _small_mnist(max_epochs=1)
    wf.initialize(device="cpu")
    FusedRunner(wf).run()
    return wf


def test_model_store_skips_a_corrupt_newest_snapshot(tmp_path,
                                                     uninterrupted):
    """``ModelStore.load`` of a snapshot directory serves the newest
    snapshot that loads; a directory holding ``contents.json`` is read
    as an export package instead: one without units raises
    ``ModelLoadError``, the snapshot's own package loads and serves."""
    from veles_tpu_torch.serving.model_store import (ModelLoadError,
                                                     ModelStore,
                                                     ServeableModel)
    full, directory = uninterrupted
    for name in ("wf.2.pickle", "wf.3.pickle"):
        with open(os.path.join(str(directory), name), "rb") as f:
            (tmp_path / name).write_bytes(f.read())
    blob = (tmp_path / "wf.3.pickle").read_bytes()
    (tmp_path / "wf.3.pickle").write_bytes(blob[:len(blob) // 3])
    os.utime(str(tmp_path / "wf.3.pickle"))
    model = ModelStore().load(str(tmp_path), device="cpu")
    assert model.source.endswith("wf.2.pickle")
    package = tmp_path / "package"
    package.mkdir()
    (package / "contents.json").write_text("{}")
    with pytest.raises(ModelLoadError, match="no units"):
        ModelStore().load(str(package), device="cpu")
    dense = tmp_path / "dense.tar"
    mnist = _mnist_trained()
    mnist.package_export(str(dense))
    served = ModelStore().load(str(dense), device="cpu")
    batch = numpy.random.RandomState(3).rand(5, 6, 6).astype(numpy.float32)
    numpy.testing.assert_array_equal(
        served(batch), ServeableModel.from_workflow(mnist)(batch))


def test_jax_snapshot_written_by_its_snapshotter(tmp_path):
    """A JAX run snapshots itself through ``SnapshotterToFile`` (gz by
    default, the unit inside its own snapshot): the port reads the file,
    its snapshotter comes over with the same settings, and the port's
    run goes on snapshotting where it is pointed."""
    from veles_tpu.models.mnist import MnistWorkflow as JaxMnist
    from veles_tpu.snapshotter import SnapshotterToFile as JaxSnapshotter
    from veles_tpu.train import FusedRunner as JaxFusedRunner
    jax_prng.get().seed(5)
    jax_prng.get("loader").seed(6)
    jax_wf = JaxMnist(JaxDummyLauncher(), provider=synthetic_digits(),
                      layers=(8,), minibatch_size=60, max_epochs=2)
    snap = JaxSnapshotter(jax_wf, directory=str(tmp_path / "jax"),
                          prefix="mnist", time_interval=0.0,
                          name="snapshotter")
    snap.link_from(jax_wf.decision)
    snap.gate_skip = ~jax_wf.loader.epoch_ended
    jax_wf.initialize(device=Device(backend="cpu"))
    JaxFusedRunner(jax_wf).run()
    path = str(tmp_path / "jax" / "mnist.0.pickle.gz")
    prng._generators.clear()
    wf = load_workflow(path)
    (port_snap,) = [u for u in wf if isinstance(u, SnapshotterToFile)]
    assert (port_snap.prefix, port_snap.compression, port_snap.directory) \
        == ("mnist", "gz", str(tmp_path / "jax"))
    port_snap.directory = str(tmp_path / "port")
    wf.workflow = DummyLauncher()
    wf.initialize(device="cpu")
    FusedRunner(wf).run()
    assert [h["epoch"] for h in wf.decision.epoch_history] == [0, 1]
    assert wf.decision.epoch_history[1] == \
        jax_wf.decision.epoch_history[1]
    assert sorted(os.listdir(str(tmp_path / "port"))) == [
        "mnist.1.pickle.gz", "mnist_current.pickle.gz"]
