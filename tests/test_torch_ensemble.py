"""The port's ensembles against the JAX package's (``veles_tpu/ensemble/``,
``veles_tpu/loader/ensemble.py`` and the ensemble hooks of the config,
the loader and the snapshotter), on the CPU.

* Each member's argv (seed ``1234 + 1000 i``, the ensemble overrides)
  equals JAX's, for the trainer and the tester; the results files, the
  aggregate and the task farming with a dropped slave equal JAX's on the
  same in-process runners.
* ``train_ratio`` (``root.common.ensemble.train_ratio`` or the loader's
  keyword): the class lengths and every minibatch's indices over three
  epochs equal JAX's loader's; a restored loader cuts the original
  length again, not its cut one.
* A member's snapshots carry its ``_m<i>`` tag (and a ``_current`` link
  of its own), the JAX package's names.
* ``EnsembleLoader`` stacks what JAX's stacks from the same JSON, to
  the bit, and refuses what JAX's refuses.
* ``--ensemble-train 2:0.8`` then ``--ensemble-test`` through the port's
  CLI (``-a cpu``): two members trained on ``int(0.8 n)`` samples into
  two snapshots of one directory, their test runs' ``Output``
  (``publish_output``, recorded by the eager path) stacked by
  ``EnsembleLoader`` (the members' loaders never reshuffle: their test
  passes serve the samples in one order, which the loader checks), and
  the aggregate ``aggregate_metrics`` of the members.
"""

import json
import os
import subprocess
import sys

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu import ensemble as jax_ensemble  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.config import root as jax_root  # noqa: E402
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow  # noqa: E402
from veles_tpu.loader.ensemble import \
    EnsembleLoader as JaxEnsembleLoader  # noqa: E402
from veles_tpu.models.alexnet import \
    SyntheticImageLoader as JaxSyntheticImageLoader  # noqa: E402
from veles_tpu_torch import ensemble, prng  # noqa: E402
from veles_tpu_torch.config import root  # noqa: E402
from veles_tpu_torch.dummy import DummyWorkflow  # noqa: E402
from veles_tpu_torch.loader.ensemble import EnsembleLoader  # noqa: E402
from veles_tpu_torch.models.alexnet import SyntheticImageLoader  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROC_S = 240
LOADER = dict(n_train=40, n_valid=16, side=16, n_classes=10,
              minibatch_size=16)


@pytest.fixture(autouse=True)
def _ensemble_config():
    saved = [dict(tree.common.ensemble.items()) for tree in (root,
                                                             jax_root)]
    yield
    for tree, values in zip((root, jax_root), saved):
        tree.common.ensemble.update(values)


# -- the managers -------------------------------------------------------------


@pytest.mark.parametrize("index", [0, 2])
def test_member_argv_equals_jax(index):
    got = ensemble.EnsembleTrainer("wf.py", config_file="cfg.py", size=3,
                                   train_ratio=0.5)
    want = jax_ensemble.EnsembleTrainer("wf.py", config_file="cfg.py",
                                        size=3, train_ratio=0.5)
    argv = got.model_argv(index, "/tmp/r.json")
    assert argv == want.model_argv(index, "/tmp/r.json")
    assert argv[argv.index("-s") + 1] == str(1234 + 1000 * index)
    assert "root.common.ensemble.model_index=%d" % index in argv
    assert "root.common.ensemble.train_ratio=0.5" in argv
    results = {"models": [{"Snapshot": "/s/a.pickle"},
                          {"snapshot": "/s/b.pickle"},
                          {"snapshot_file": "/s/c.pickle"}]}
    got = ensemble.EnsembleTester("wf.py", results_file=results)
    want = jax_ensemble.EnsembleTester("wf.py", results_file=results)
    assert got.model_argv(index, "/tmp/t.json") == \
        want.model_argv(index, "/tmp/t.json")


def test_trainer_results_file_equals_jax(tmp_path):
    files = {}
    for name, module in (("port", ensemble), ("jax", jax_ensemble)):
        path = str(tmp_path / ("%s.json" % name))
        module.EnsembleTrainer(
            "wf.py", size=4, train_ratio=0.75, result_file=path,
            runner=lambda i: {"fitness": 0.9 - 0.1 * i,
                              "Snapshot": "/tmp/m%d.pickle" % i}).run()
        with open(path) as f:
            files[name] = json.load(f)
    got, want = files["port"], files["jax"]
    # the port adds the process runs' records (none in process)
    assert got.pop("evaluations") == []
    assert got == want


def test_tester_aggregate_equals_jax(tmp_path):
    train = {"models": [{"fitness": 0.9, "Snapshot": "/tmp/a.pickle"},
                        {"fitness": 0.8, "Snapshot": "/tmp/b.pickle"},
                        {"fitness": 0.7, "Snapshot": "/tmp/c.pickle"}],
             "size": 3}
    files = {}
    for name, module in (("port", ensemble), ("jax", jax_ensemble)):
        path = str(tmp_path / ("%s.json" % name))
        module.EnsembleTester(
            "wf.py", results_file=train, result_file=path,
            runner=lambda i: {"n_err": 10 + i, "loss": 0.5 / (i + 1),
                              "flag": True, "name": "m"}).run()
        with open(path) as f:
            files[name] = json.load(f)
    files["port"].pop("evaluations")
    assert files["port"] == files["jax"]
    assert files["port"]["aggregate"]["n_err"]["mean"] == 11.0


@pytest.mark.parametrize("members", [
    [{"a": 1.0, "flag": True, "s": "x"}, {"a": 3.0}],
    [{"n_err": 4, "loss": 0.25}, None, {"n_err": 6, "loss": 0.75}],
    []])
def test_aggregate_metrics_equals_jax(members):
    assert ensemble.aggregate_metrics(members) == \
        jax_ensemble.aggregate_metrics(members)


def test_manager_refusals_equal_jax():
    for module in (ensemble, jax_ensemble):
        with pytest.raises(ValueError):
            module.EnsembleTrainer("wf.py", size=0)
        with pytest.raises(ValueError):
            module.EnsembleTrainer("wf.py", size=2, train_ratio=1.5)
        with pytest.raises(ValueError):
            module.EnsembleTester("wf.py", results_file={"models": []})
        with pytest.raises(ValueError):
            module.EnsembleTester("wf.py", results_file={
                "models": [{"fitness": 1.0}]}).model_argv(0, "r.json")


def test_task_farming_with_a_dropped_slave_equals_jax():
    trace = {}
    for name, module in (("port", ensemble), ("jax", jax_ensemble)):
        trainer = module.EnsembleTrainer(
            "wf.py", size=3, runner=lambda i: {"fitness": float(i)})
        jobs = [trainer.generate_data_for_slave("s1"),
                trainer.generate_data_for_slave("s2")]
        trainer.drop_slave("s1")
        jobs.append(trainer.generate_data_for_slave("s2"))
        for idx in jobs[1:]:
            trainer.apply_data_from_master(idx)
            trainer.apply_data_from_slave(
                trainer.generate_data_for_master(), "s2")
        trace[name] = (jobs, trainer.results, trainer.processed,
                       trainer.has_data_for_slave, trainer.pending_indices)
    assert trace["port"] == trace["jax"]
    assert trace["port"][0][2] == trace["port"][0][0]


def test_a_dead_evaluator_loses_one_member():
    trainer = ensemble.EnsembleTrainer("wf.py", size=2, warm=True)

    class DeadPool(object):
        def run(self, argv, result_file=None):
            raise RuntimeError("warm evaluator died (rc=-9)")

    trainer._pool_ = DeadPool()
    assert trainer.process_model(0) is None


# -- the hooks ----------------------------------------------------------------


def test_config_defaults_equal_jax():
    assert dict(root.common.ensemble.items()) == \
        dict(jax_root.common.ensemble.items()) == {
            "model_index": 0, "size": 0, "train_ratio": 1.0}


def _serve(loader, n, jax):
    out = []
    for _ in range(n):
        loader.run()
        size = loader.minibatch_size
        idx = loader.minibatch_indices.mem if jax \
            else loader.minibatch_indices
        out.append((int(loader.minibatch_class),
                    numpy.asarray(idx[:size]).tolist()))
    return out


@pytest.mark.parametrize("ratio,how", [(0.8, "config"), (0.5, "keyword"),
                                       (1.0, "config")])
def test_train_ratio_lengths_and_minibatches_equal_jax(ratio, how):
    """Three epochs served minibatch by minibatch: the classes and the
    indices of each are the JAX loader's under the same ratio."""
    kw = dict(LOADER)
    if how == "config":
        root.common.ensemble.train_ratio = ratio
        jax_root.common.ensemble.train_ratio = ratio
    else:
        kw["train_ratio"] = ratio
    prng.get("loader").seed(4)
    jax_prng.get("loader").seed(4)
    ours = SyntheticImageLoader(workflow=DummyWorkflow(), **kw)
    ours.initialize(device="cpu")
    theirs = JaxSyntheticImageLoader(JaxDummyWorkflow(), **kw)
    theirs.initialize(device=Device(backend="cpu"))
    assert ours.class_lengths == list(theirs.class_lengths) == [
        0, 16, max(1, int(40 * ratio))]
    n = 3 * (1 + -(-ours.class_lengths[2] // 16))
    assert _serve(ours, n, False) == _serve(theirs, n, True)


def test_train_ratio_flag_cuts_a_plain_run(tmp_path):
    """``--train-ratio`` sets ``root.common.ensemble.train_ratio``, which
    the workflow's loader reads."""
    from veles_tpu_torch.__main__ import Main
    wf = tmp_path / "ens.py"
    wf.write_text(ENSEMBLE_WORKFLOW)
    cfg = tmp_path / "ens_config.py"
    cfg.write_text("root.ens.snapshots = %r\n" % str(tmp_path / "s"))
    main = Main()
    assert main.run([str(wf), str(cfg), "-a", "cpu", "--train-ratio",
                     "0.5", "--dry-run", "init", "-v", "warning"]) == 0
    assert main.workflow.loader.class_lengths == [0, 20, 35]


def test_train_ratio_is_not_applied_twice():
    """A loader initialized again (as a restored one is) cuts the
    original train length, not the cut one."""
    ours = SyntheticImageLoader(workflow=DummyWorkflow(), train_ratio=0.5,
                                **LOADER)
    ours.initialize(device="cpu")
    assert ours.class_lengths[2] == 20
    ours.initialize(device="cpu")
    assert ours.class_lengths[2] == 20
    assert ours._full_train_length == 40


def test_snapshots_carry_the_member_tag(tmp_path):
    """Two members of one ensemble snapshot into one directory without
    overwriting each other: ``<prefix>_m<i>.<epoch>.pickle`` and a
    ``<prefix>_m<i>_current.pickle`` link each, the JAX package's
    names; outside an ensemble no tag."""
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    names = []
    for size, index in ((2, 0), (2, 1), (0, 0)):
        root.common.ensemble.size = size
        root.common.ensemble.model_index = index
        wf = DummyWorkflow()
        snap = SnapshotterToFile(wf, directory=str(tmp_path),
                                 compression="", time_interval=0)
        snap.export()
        names.append(os.path.basename(snap.destination))
    assert names == ["wf_m0.0.pickle", "wf_m1.0.pickle", "wf.0.pickle"]
    links = sorted(n for n in os.listdir(tmp_path) if "current" in n)
    assert links == ["wf_current.pickle", "wf_m0_current.pickle",
                     "wf_m1_current.pickle"]
    assert os.readlink(str(tmp_path / "wf_m1_current.pickle")) == \
        "wf_m1.0.pickle"


# -- the ensemble loader ------------------------------------------------------


def _ensemble_json(n=12, members=3, classes=4):
    rng = numpy.random.RandomState(0)
    labels = rng.randint(0, classes, n).tolist()
    return {"models": [
        {"Output": rng.rand(n, classes).astype(numpy.float32).tolist(),
         "Labels": labels} for _ in range(members)]}


def test_ensemble_loader_stacks_as_jax_s():
    data = _ensemble_json()
    ours = EnsembleLoader(workflow=DummyWorkflow(), data=data,
                          minibatch_size=4)
    ours.initialize(device="cpu")
    theirs = JaxEnsembleLoader(JaxDummyWorkflow(), data=data,
                               minibatch_size=4)
    theirs.initialize(device=Device(backend="cpu"))
    assert tuple(ours.original_data.shape) == (12, 3, 4)
    numpy.testing.assert_array_equal(ours.original_data.numpy(),
                                     numpy.asarray(theirs.original_data.mem))
    numpy.testing.assert_array_equal(
        ours.original_labels.numpy(),
        numpy.asarray(theirs.original_labels.mem))
    assert ours.class_lengths == list(theirs.class_lengths) == [0, 0, 12]
    assert ours.original_data.dtype == torch.float32


def _refusal(case):
    data = _ensemble_json()
    if case == "no members":
        data = {"models": [None]}
    elif case == "no Output":
        data["models"][1] = {"fitness": 1.0}
    elif case == "empty Output":
        data["models"][0]["Output"] = []
    elif case == "shape":
        data["models"][1]["Output"] = data["models"][1]["Output"][:5]
    elif case == "label order":
        data["models"][2]["Labels"] = list(reversed(
            data["models"][2]["Labels"]))
    return data


@pytest.mark.parametrize("case", ["no members", "no Output", "empty Output",
                                  "shape", "label order"])
def test_ensemble_loader_refuses_what_jax_s_refuses(case):
    data = _refusal(case)
    with pytest.raises(ValueError) as ours:
        EnsembleLoader(workflow=DummyWorkflow(), data=data).load_dataset()
    with pytest.raises(ValueError) as theirs:
        JaxEnsembleLoader(JaxDummyWorkflow(), data=data).load_dataset()
    assert str(ours.value).split()[:2] == str(theirs.value).split()[:2]


def test_ensemble_loader_needs_a_file_or_data():
    with pytest.raises(ValueError, match="file= or data="):
        EnsembleLoader(workflow=DummyWorkflow()).load_dataset()


# -- the CLI round trip -------------------------------------------------------

ENSEMBLE_WORKFLOW = '''
import numpy
from veles_tpu_torch.config import root
from veles_tpu_torch.models.mnist import MnistWorkflow
from veles_tpu_torch.snapshotter import SnapshotterToFile


class TinyProvider(object):
    def __call__(self):
        rng = numpy.random.RandomState(0)
        x = rng.rand(90, 6, 6).astype(numpy.float32)
        y = (x.reshape(90, -1).sum(1) > 18).astype(numpy.int32)
        return x[:70], y[:70], x[70:], y[70:]


def run(load, main):
    wf, restored = load(MnistWorkflow, provider=TinyProvider(),
                        layers=(8,), minibatch_size=20, max_epochs=2)
    if not restored:
        snap = SnapshotterToFile(wf, directory=root.ens.snapshots,
                                 compression="", time_interval=0)
        snap.link_from(wf.decision)
        snap.gate_skip = ~wf.loader.epoch_ended
        # every member's test pass serves the samples in one order
        wf.loader.shuffle_limit = 0
    wf.evaluator.publish_output = True
    main()
'''


def test_ensemble_cli_train_then_test(tmp_path):
    wf = tmp_path / "ens.py"
    wf.write_text(ENSEMBLE_WORKFLOW)
    snaps = tmp_path / "snaps"
    cfg = tmp_path / "ens_config.py"
    cfg.write_text("root.ens.snapshots = %r\n" % str(snaps))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO
    train, test = str(tmp_path / "train.json"), str(tmp_path / "test.json")
    for argv in (["--ensemble-train", "2:0.8", "--result-file", train],
                 ["--ensemble-test", train, "--result-file", test]):
        proc = subprocess.run(
            [sys.executable, "-m", "veles_tpu_torch", str(wf), str(cfg),
             "-a", "cpu", "-v", "warning"] + argv, env=env, cwd=tmp_path,
            capture_output=True, timeout=PROC_S)
        assert proc.returncode == 0, proc.stderr.decode()[-3000:]
    with open(train) as f:
        trained = json.load(f)
    with open(test) as f:
        tested = json.load(f)
    members = trained["models"]
    assert trained["size"] == 2 and trained["train_ratio"] == 0.8
    assert [os.path.basename(m["Snapshot"]) for m in members] == [
        "wf_m0.1.pickle", "wf_m1.1.pickle"]
    assert len({e["pid"] for e in trained["evaluations"]}) == 1
    assert members[0] != members[1]   # seeds 1234 and 2234
    outputs = [numpy.asarray(m["Output"]) for m in tested["models"]]
    # one forward pass over validation (20) and int(0.8 * 70) training
    # samples
    assert [o.shape for o in outputs] == [(20 + 56, 10)] * 2
    stacked = EnsembleLoader(workflow=DummyWorkflow(), file=test)
    stacked.initialize(device="cpu")
    assert tuple(stacked.original_data.shape) == (76, 2, 10)
    for i, output in enumerate(outputs):
        numpy.testing.assert_array_equal(
            stacked.original_data[:, i].numpy(),
            output.astype(numpy.float32))
    assert tested["aggregate"] == ensemble.aggregate_metrics(
        tested["models"])
