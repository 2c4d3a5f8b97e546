"""The run's observers on the CPU: the train-class confusion sweep, the
runner's ``confusion_from_train``, an observed CLI run, the snapshot
diff, the frontend catalog and the import guard.

* ``FusedTrainer.confusion_segment`` resident, streamed (shards of two
  minibatches) and offloaded (one group a layer or two) against the JAX
  trainer's ``confusion_segment`` on the same weights and index matrix
  (``tests/test_torch_train.py``'s tiny net): 0 cells differ. The data
  are drawn so that every row's top-two logit gap exceeds 1e-4 of the
  row's spread (checked): an argmax there cannot flip between two
  float32 forwards. The port's matrix also equals the one numpy builds
  from the argmax of the same forward's logits, and that matrix with the
  truth shifted by one row (each label + 1: the control) differs.
* Two CLI epochs of the small AlexNet with no validation class and the
  standard plot set (``--no-graphics``, ``root.common.disable.plotting=
  False``), JAX's dropout uniforms handed to the port: the evaluator's
  confusion matrix (from the TRAIN sweep), the confusion plotter's
  matrix and the epoch curves equal the JAX run's; without a
  ``MatrixPlotter`` no sweep runs (the control).
* The observed run as ``chip_smoke.py`` phase 19 drives it on the card,
  small and on the CPU: ``--web-status`` to a dashboard in this process,
  the graphics server subscribed, a publisher; each curve on the wire
  equals the run's history, the last confusion sums to the train set and
  equals the one recomputed from the last snapshot, and the dashboard
  lists the run, its publisher's record and its events.
* ``scripts.compare_snapshots``: 0 for a snapshot against itself,
  nonzero for every trained layer between epochs, a JAX snapshot's rows
  equal to the JAX package's own script's.
* ``scripts.generate_frontend``: the port's catalog, the JAX package's
  units but those the next slice ports.
* Importing the new modules and running an observed CPU epoch loads
  neither ``jax`` nor any ``veles_tpu`` module, with ``matplotlib`` and
  ``jinja2`` made unimportable.
"""

import io
import json
import os
import pickle
import subprocess
import sys
import textwrap
import zlib
from contextlib import redirect_stdout

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.config import root as jax_root  # noqa: E402
from veles_tpu.train import FusedTrainer as JaxFusedTrainer  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.loader.base import TRAIN  # noqa: E402
from veles_tpu_torch.train import offload  # noqa: E402

from test_torch_train import _jax_trainer, _port_trainer  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _pallas_lrn(monkeypatch):
    monkeypatch.setenv("VELES_LRN", "pallas")


def test_config_defaults_equal_jax():
    for key in ("plotting", "publishing", "snapshotting"):
        assert root.common.disable.get(key) == \
            jax_root.common.disable.get(key)
    assert root.common.web.to_dict() == jax_root.common.web.to_dict()


# -- the confusion sweep ------------------------------------------------------

def _logits(trainer, idx):
    """(logits, truth, valid) of every row of ``idx`` through the
    trainer's forward (no dropout)."""
    out = []
    with torch.no_grad():
        for row in idx:
            x, truth, valid = trainer._gather(torch.from_numpy(row))
            out.append((trainer._forward(x, False).reshape(len(row), -1),
                        truth, valid))
    logits = torch.cat([o[0] for o in out]).numpy()
    truth = torch.cat([o[1] for o in out]).numpy()
    valid = torch.cat([o[2] for o in out]).numpy().astype(bool)
    return logits[valid], truth[valid]


def _argmax_matrix(logits, truth, n_classes):
    matrix = numpy.zeros((n_classes, n_classes), numpy.int32)
    numpy.add.at(matrix, (truth, logits.argmax(axis=1)), 1)
    return matrix


@pytest.mark.parametrize("mode,env", [
    ({}, {}), ({"stream": True}, {"VELES_SHARD_MB": "0.2"}),
    ({"offload": True}, {"VELES_OFFLOAD_GROUP_MB": "0.01"})],
    ids=["resident", "streamed", "offloaded"])
def test_confusion_segment_equals_jax(monkeypatch, mode, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jt = _jax_trainer(stage_s2d=False)
    if mode:
        jt = JaxFusedTrainer(jt.workflow, **mode)
    pt = _port_trainer(jt, **mode)
    try:
        assert pt.streaming == jt.streaming == bool(mode.get("stream"))
        assert pt.offloaded == jt.offloaded == bool(mode.get("offload"))
        idx = pt._segment_indices(TRAIN)
        numpy.testing.assert_array_equal(idx, jt._segment_indices(TRAIN))
        want = numpy.asarray(jt.confusion_segment(jt.pull_params()[0],
                                                  idx))
        got = pt.confusion_segment(None, idx)
        assert got.dtype == torch.int32
        got = got.numpy()
        assert int(got.sum()) == pt.loader.class_lengths[TRAIN] == 40
        assert int((got != want).sum()) == 0
    finally:
        jt.shutdown()
        pt.shutdown()
        offload.shutdown_all()
    # the argmaxes are stable: every row's top-two gap is well above the
    # float32 noise of two forwards
    resident = _port_trainer(_jax_trainer(stage_s2d=False))
    logits, truth = _logits(resident, idx)
    top2 = numpy.sort(logits, axis=1)[:, -2:]
    spread = logits.max(axis=1) - logits.min(axis=1)
    assert ((top2[:, 1] - top2[:, 0]) > 1e-4 * spread).all()
    # the scatter-add against numpy's, and the control
    assert int((_argmax_matrix(logits, truth, 10) != got).sum()) == 0
    shifted = _argmax_matrix(logits, (truth + 1) % 10, 10)
    assert int((shifted != want).sum()) > 0


def test_confusion_segment_loads_given_params():
    jt = _jax_trainer(stage_s2d=False)
    pt = _port_trainer(jt)
    idx = pt._segment_indices(TRAIN)
    params, _ = pt.pull_params()
    live = pt.confusion_segment(None, idx)
    zeroed = [{k: torch.zeros_like(v) for k, v in layer.items()}
              for layer in params]
    flat = pt.confusion_segment(zeroed, idx)
    # zero weights: every logit 0, argmax 0 for every sample
    assert int(flat[:, 0].sum()) == 40 and int(flat[:, 1:].sum()) == 0
    back = pt.confusion_segment(params, idx)
    assert torch.equal(back, live)


def test_confusion_segment_needs_softmax():
    jt = _jax_trainer(stage_s2d=False)
    pt = _port_trainer(jt)
    pt.loss_kind = "mse"
    with pytest.raises(TypeError, match="softmax"):
        pt.confusion_segment(None, pt._segment_indices(TRAIN))


# -- the runner's confusion_from_train ---------------------------------------

#: the small AlexNet, no validation class, the standard plot set
PLOTTED_FILE = '''
from {package}.models.alexnet import (AlexNetWorkflow,
                                      SyntheticImageLoader,
                                      small_alexnet_layers)


def run(load, main):
    wf, _ = load(AlexNetWorkflow,
                 loader_factory=lambda wf: SyntheticImageLoader(
                     {workflow_kw}, n_train=40, n_valid=0, side=32,
                     n_classes=10, minibatch_size=16),
                 layers=small_alexnet_layers(10), max_epochs={epochs})
    if {plotters}:
        wf.add_plotters()
    main()
'''


def _plotted_pair(tmp_path, plotters=True):
    from test_torch_workflow import _cli_pair
    template = PLOTTED_FILE.replace("{plotters}", str(plotters))
    return _cli_pair(tmp_path, template, "plotted", epochs=2, extra=())


@pytest.fixture
def _plotting_on(monkeypatch):
    from test_torch_workflow import JaxUniforms
    from veles_tpu_torch.standard_workflow import TrainableWorkflow
    monkeypatch.setattr(TrainableWorkflow, "uniform_source",
                        JaxUniforms(7, 0))
    saved = (root.common.disable.get("plotting"),
             jax_root.common.disable.get("plotting"))
    root.common.disable.update({"plotting": False})
    jax_root.common.disable.update({"plotting": False})
    # no graphics server: the plotters fill and keep their data
    from veles_tpu.launcher import Launcher as JaxLauncher
    from veles_tpu_torch.launcher import Launcher
    monkeypatch.setattr(JaxLauncher, "_launch_graphics", lambda self: None)
    monkeypatch.setattr(Launcher, "_launch_graphics", lambda self: None)
    yield
    root.common.disable.update({"plotting": saved[0]})
    jax_root.common.disable.update({"plotting": saved[1]})


def test_runner_confusion_from_train_equals_jax(tmp_path, _plotting_on):
    jax_wf, port_wf = _plotted_pair(tmp_path)
    want = numpy.asarray(jax_wf.evaluator.confusion_matrix)
    got = numpy.asarray(port_wf.evaluator.confusion_matrix)
    assert got.shape == (10, 10) and int(got.sum()) == 40
    assert int((got != want).sum()) == 0
    plots = {p.name: p for p in port_wf.plotters}
    jax_plots = {p.name: p for p in jax_wf.plotters}
    assert sorted(plots) == sorted(jax_plots) == [
        "confusion", "train n_err_pt", "validation n_err_pt"]
    numpy.testing.assert_array_equal(plots["confusion"].matrix,
                                     jax_plots["confusion"].matrix)
    numpy.testing.assert_array_equal(plots["confusion"].matrix, got)
    history = port_wf.decision.epoch_history
    assert plots["train n_err_pt"].values == [
        h["train"]["normalized"] for h in history]
    assert plots["train n_err_pt"].values == \
        jax_plots["train n_err_pt"].values
    assert plots["validation n_err_pt"].values == []
    assert port_wf.launcher.runner.epoch_times[-1]["confusion_s"] > 0


def test_runner_runs_no_confusion_sweep_without_a_plotter(tmp_path,
                                                         _plotting_on):
    _, port_wf = _plotted_pair(tmp_path, plotters=False)
    assert port_wf.evaluator.confusion_matrix is None
    assert all("confusion_s" not in t
               for t in port_wf.launcher.runner.epoch_times)


def test_runner_runs_no_confusion_sweep_for_disabled_plotters(tmp_path,
                                                             monkeypatch):
    """A headless run (plotting disabled, no graphics server) holds a
    MatrixPlotter that nothing reads: no train-class sweep runs."""
    from test_torch_workflow import workflow_file
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.launcher import Launcher
    monkeypatch.setattr(Launcher, "_launch_graphics", lambda self: None)
    saved = root.common.disable.get("plotting")
    root.common.disable.update({"plotting": True})
    try:
        template = PLOTTED_FILE.replace("{plotters}", "True")
        main = Main()
        assert main.run([workflow_file(tmp_path, template,
                                       "veles_tpu_torch", 2, "headless"),
                         "-s", "7", "-a", "cpu"]) == 0
    finally:
        root.common.disable.update({"plotting": saved})
    wf = main.workflow
    assert [p.name for p in wf.plotters if not p.enabled] == [
        p.name for p in wf.plotters] and wf.plotters
    assert wf.evaluator.confusion_matrix is None
    assert len(wf.launcher.runner.epoch_times) == 2
    assert all("confusion_s" not in t
               for t in wf.launcher.runner.epoch_times)


# -- the observed run ---------------------------------------------------------

#: phase 19's workflow file at the CPU's size: no validation class, a
#: snapshot every epoch, the plot set, a publisher after the decision,
#: and a unit that writes the graphics endpoint and waits for N
#: subscribers before the run starts
OBSERVED_FILE = '''
import json
import os

from veles_tpu_torch.config import root
from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,
                                            SyntheticImageLoader,
                                            small_alexnet_layers)
from veles_tpu_torch.publishing import Publisher
from veles_tpu_torch.result_provider import IResultProvider
from veles_tpu_torch.snapshotter import SnapshotterToFile
from veles_tpu_torch.units import Unit


class Observed(Unit, IResultProvider):
    view_group = "SERVICE"

    def initialize(self, **kwargs):
        server = getattr(self.launcher, "_graphics_server", None)
        # written whole, then renamed: a reader sees all of it or nothing
        path = os.path.join(root.obs.dir, "endpoint.json")
        with open(path + ".tmp", "w") as f:
            json.dump(server.endpoints if server else None, f)
        os.replace(path + ".tmp", path)
        if server is not None:
            assert server.wait_for_subscribers(root.obs.subscribers, 120)

    def run(self):
        pass

    def get_metric_values(self):
        return {"epoch_history": [
            {k: v["normalized"] for k, v in h.items()
             if isinstance(v, dict) and "normalized" in v}
            for h in self.workflow.decision.epoch_history]}


def run(load, main):
    wf, restored = load(
        AlexNetWorkflow,
        loader_factory=lambda wf: SyntheticImageLoader(
            workflow=wf, n_train=48, n_valid=0, side=32, n_classes=10,
            minibatch_size=16),
        layers=small_alexnet_layers(10), max_epochs=2)
    snap = SnapshotterToFile(wf, compression="", time_interval=0,
                             name="snapshotter")
    snap.link_from(wf.decision)
    snap.gate_skip = ~wf.loader.epoch_ended
    snap.directory = root.obs.dir
    wf.add_plotters()
    pub = Publisher(wf, backends={"markdown": {
        "file": os.path.join(root.obs.dir, "report.md")}})
    pub.link_from(wf.plotters[-1])
    pub.gate_block = ~wf.decision.complete
    Observed(wf, name="observed")
    main()
'''


def test_observed_cli_run(tmp_path):
    import threading
    import time
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.graphics_server import TOPIC_END, Subscription
    from veles_tpu_torch.scripts.compare_snapshots import compare
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    from veles_tpu_torch.train.runner import trainer_for
    from veles_tpu_torch.web_status import WebStatusServer
    from test_torch_serving_full import _fresh_telemetry

    _fresh_telemetry()
    saved = root.common.disable.get("plotting"), root.common.web.to_dict()
    dashboard = WebStatusServer(host="127.0.0.1", port=0).start()
    path = tmp_path / "observed.py"
    path.write_text(OBSERVED_FILE)
    main, snapshots = Main(), []
    argv = [str(path), "-s", "7", "-a", "cpu", "--web-status",
            "--result-file", str(tmp_path / "r.json"),
            "root.obs.dir=%r" % str(tmp_path), "root.obs.subscribers=1",
            "root.common.disable.plotting=False",
            "root.common.web.host='127.0.0.1'",
            "root.common.web.port=%d" % dashboard.port,
            "root.common.web.notification_interval=0.05"]
    codes = []
    cli = threading.Thread(target=lambda: codes.append(main.run(argv)))
    try:
        cli.start()
        endpoint = tmp_path / "endpoint.json"
        deadline = time.time() + 120
        while not endpoint.exists() and time.time() < deadline:
            time.sleep(0.05)
        sub = Subscription(json.loads(endpoint.read_text())["tcp"])
        while True:
            topic, payload = sub.get(120)
            if topic == TOPIC_END:
                break
            snapshots.append(pickle.loads(zlib.decompress(payload)))
        sub.close()
        cli.join(120)
        assert codes == [0]
        # the dashboard: the run, its publisher's record, its events
        launcher = main.launcher
        workflows = dashboard.receive_request({
            "request": "workflows", "args": ["mode", "units", "name"]})
        assert workflows["result"][launcher.id] == {
            "mode": "standalone", "units": len(main.workflow),
            "name": "AlexNetWorkflow"}
        logs = dashboard.receive_request({
            "request": "logs", "find": {"session": launcher.log_id}})
        assert any(r["message"].startswith("publishing the results")
                   for r in logs["result"])
        events = dashboard.receive_request({
            "request": "events", "find": {"session": launcher.log_id,
                                          "name": "run"}})["result"]
        wf_events = [e["type"] for e in events
                     if e["instance"].startswith("AlexNetWorkflow@")]
        assert wf_events == ["begin", "end"]
    finally:
        dashboard.stop()
        root.common.disable.update({"plotting": saved[0]})
        root.common.web.update(saved[1])
        _fresh_telemetry()
    # (a) every curve snapshot holds the history the result file holds
    results = json.loads((tmp_path / "r.json").read_text())
    history = results["epoch_history"]
    curves = [s for s in snapshots if s.name == "train n_err_pt"]
    assert len(curves) == 2
    for i, curve in enumerate(curves):
        assert curve.values == [h["train"] for h in history[:i + 1]]
    # (b) the last confusion: the train set's, and the one recomputed
    # from the last snapshot through the same sweep
    matrix = [s for s in snapshots if s.name == "confusion"][-1].matrix
    assert int(matrix.sum()) == 48
    wf = SnapshotterToFile.import_(str(tmp_path / "wf.1.pickle"))
    from veles_tpu_torch.dummy import DummyLauncher
    wf.workflow = DummyLauncher()
    wf.initialize(device="cpu")
    trainer = trainer_for(wf)
    idx = trainer._segment_indices(TRAIN)
    again = trainer.confusion_segment(None, idx).numpy()
    assert int((again != matrix).sum()) == 0
    wf.loader.original_labels = torch.remainder(
        wf.loader.original_labels + 1, 10).to(torch.int32)
    wf.loader.release_staged()
    shifted = trainer_for(wf).confusion_segment(None, idx).numpy()
    assert int((shifted != matrix).sum()) > 0
    # the report holds the results; the snapshots diff as they should
    report = (tmp_path / "report.md").read_text()
    assert "| epochs | 2 |" in report
    same = compare(str(tmp_path / "wf.1.pickle"),
                   str(tmp_path / "wf.1.pickle"))
    assert same and all(row[5] == 0 for row in same)


# -- the snapshot diff --------------------------------------------------------

SNAPSHOT_FILE = '''
from {package}.models.mnist import MnistWorkflow
from {package}.snapshotter import SnapshotterToFile
import numpy


def provider():
    rng = numpy.random.RandomState(2)
    return (rng.rand(30, 6, 6).astype(numpy.float32),
            rng.randint(0, 10, 30).astype(numpy.int32),
            rng.rand(10, 6, 6).astype(numpy.float32),
            rng.randint(0, 10, 10).astype(numpy.int32))


def run(load, main):
    wf, _ = load(MnistWorkflow, provider=provider, layers=(8,),
                 minibatch_size=10, max_epochs={epochs})
    snap = SnapshotterToFile(wf, compression="", time_interval=0,
                             name="snapshotter")
    snap.link_from(wf.decision)
    snap.gate_skip = ~wf.loader.epoch_ended
    snap.directory = {directory!r}
    main()
'''


def _table(argv):
    from veles_tpu_torch.scripts.compare_snapshots import main
    out = io.StringIO()
    with redirect_stdout(out):
        assert main(argv) == 0
    rows = {}
    for line in out.getvalue().splitlines()[3:-1]:
        cells = [c.strip() for c in line.strip("|").split("|")]
        rows[(cells[0], cells[1])] = [float(c) for c in cells[2:]]
    return rows


def _snapshots(tmp_path, package, cli_args):
    directory = tmp_path / package
    directory.mkdir()
    # not named after the package: the file's directory is on sys.path
    path = tmp_path / ("%s_snapshots.py" % package)
    path.write_text(SNAPSHOT_FILE.format(package=package, epochs=2,
                                         directory=str(directory)))
    if package == "veles_tpu":
        from veles_tpu.__main__ import Main
    else:
        from veles_tpu_torch.__main__ import Main
    assert Main().run([str(path), "-s", "7"] + cli_args) == 0
    return str(directory / "wf.0.pickle"), str(directory / "wf.1.pickle")


def test_compare_snapshots(tmp_path):
    first, last = _snapshots(tmp_path, "veles_tpu_torch", ["-a", "cpu"])
    same = _table(["-q", last, last])
    assert same and all(v[2] == 0.0 for v in same.values())
    moved = _table(["-q", first, last, "-s", "unit", "attr"])
    trained = {k: v for k, v in moved.items()
               if k[1] in ("weights", "bias")}
    assert sorted({k[0] for k in trained}) == ["fc0", "softmax"]
    assert all(v[2] > 0 for v in trained.values())


def test_compare_snapshots_of_jax_equals_jax_script(tmp_path):
    from veles_tpu.scripts import compare_snapshots as jax_script
    from veles_tpu_torch.scripts import compare_snapshots
    first, last = _snapshots(tmp_path, "veles_tpu", [])
    want = {(name, attr): (rel, avg, mx) for _, name, attr, rel, avg, mx
            in jax_script.compare(first, last)
            if attr in ("weights", "bias")}
    got = {(name, attr): (rel, avg, mx) for _, name, attr, rel, avg, mx
           in compare_snapshots.compare(first, last)
           if attr in ("weights", "bias")}
    assert want and got == want
    with pytest.raises(ValueError, match="different workflows"):
        other = _snapshots(tmp_path, "veles_tpu_torch", ["-a", "cpu"])[1]
        alexnet = tmp_path / "alexnet"
        alexnet.mkdir()
        compare_snapshots.compare(other, _alexnet_snapshot(alexnet))


def _alexnet_snapshot(directory):
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,
                                                SyntheticImageLoader,
                                                small_alexnet_layers)
    from veles_tpu_torch.snapshotter import save_snapshot
    wf = AlexNetWorkflow(DummyLauncher(), layers=small_alexnet_layers(10),
                         loader_factory=lambda w: SyntheticImageLoader(
                             workflow=w, n_train=16, n_valid=16, side=32,
                             n_classes=10, minibatch_size=16),
                         max_epochs=1)
    wf.initialize(device="cpu")
    return save_snapshot(wf, str(directory))[0]


# -- the catalog --------------------------------------------------------------

#: the JAX package's units the catalog leaves out: none
NOT_YET = set()


CATALOGS = textwrap.dedent('''
    import json
    import sys
    sys.path.insert(0, sys.argv[1])
    from veles_tpu.scripts.generate_frontend import describe_units
    from veles_tpu_torch.scripts.generate_frontend import generate
    print(json.dumps({"jax": describe_units(), "port": generate()}))
''')


def test_frontend_catalog():
    """Both catalogs, each built in a fresh process: the unit registries
    are process-wide, and a test process holds whatever units the tests
    run before in it defined or imported."""
    out = subprocess.run(
        [sys.executable, "-c", CATALOGS, REPO], capture_output=True,
        text=True, timeout=240, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    both = json.loads(out.stdout.strip().splitlines()[-1])
    doc = both["port"]
    jax_only = set(both["jax"]) - set(doc["units"])
    assert jax_only == NOT_YET
    assert not [u for u in doc["units"].values()
                if u["module"].split(".")[0] == "veles_tpu"]
    assert doc["units"]["MatrixPlotter"]["view_group"] == "PLOTTER"


# -- the import guard ---------------------------------------------------------

GUARD = textwrap.dedent('''
    import importlib.abc
    import json
    import sys
    import threading

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in ("matplotlib", "jinja2"):
                raise ImportError("refused: " + name)
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, sys.argv[1])
    import veles_tpu_torch.graphics_client
    import veles_tpu_torch.graphics_server
    import veles_tpu_torch.plotter
    import veles_tpu_torch.plotting_units
    import veles_tpu_torch.publishing
    import veles_tpu_torch.scripts.compare_snapshots
    import veles_tpu_torch.scripts.generate_frontend
    import veles_tpu_torch.web_status
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.web_status import WebStatusServer

    dashboard = WebStatusServer(host="127.0.0.1", port=0).start()
    code = Main().run([sys.argv[2], "-s", "7", "-a", "cpu", "--web-status",
                       "root.obs.dir=%r" % sys.argv[3],
                       "root.obs.subscribers=0",
                       "root.common.disable.plotting=False",
                       "root.common.web.host='127.0.0.1'",
                       "root.common.web.port=%d" % dashboard.port])
    dashboard.stop()
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "veles_tpu", "matplotlib",
                                        "jinja2") and sys.modules[m])
    print(json.dumps({"code": code, "bad": bad}))
''')


def test_observers_import_neither_jax_nor_the_renderers(tmp_path):
    path = tmp_path / "observed.py"
    path.write_text(OBSERVED_FILE.replace("max_epochs=2", "max_epochs=1"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", GUARD, REPO, str(path), str(tmp_path)],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"code": 0, "bad": []}
    # jinja2 refused: the markdown backend warned, the run went on
    assert "backend markdown failed" in proc.stderr
    assert not (tmp_path / "report.md").exists()
    assert (tmp_path / "wf.0.pickle").exists()
