"""The port's SPMD training tier against its single-process trainer and
the JAX package's, on the CPU.

Ranks are processes of their own (``tests/torch_world.py``
``run_world``: gloo over a file store under the test's temporary
directory, so concurrent xdist workers never share a port, and one wall
limit of ``WORLD_S`` seconds for a whole world). One world of two ranks
per module runs every case (``tests/torch_spmd_ranks.py``); the test
process holds the JAX runs and the port's single-process references.

The net is ``tests/test_torch_train.py``'s tiny AlexNet (space-to-depth
conv -> LRN -> max-pool -> fc -> dropout -> softmax, 40 + 16 samples,
minibatch 16 with a short tail of 8), plus ``TP_NET`` for the tensor
parallel forms LRN does not reach (a dense row layer after a split
convolution, a column dense layer and dropout on its split output).
Dropout: every run replays JAX's own uniforms of the whole minibatch
(``RecordedUniforms``), so the port's ranks, its single process and the
JAX trainers draw the same masks.

Tolerances (float32; the ranks sum their partial gradients in another
order than one process does): one batch's gradients within
``GRAD_SHARE`` of each tensor's norm (read: ~1e-8), each batch loss of
two epochs within ``LOSS_REL`` (read: 0 to 1e-7), every parameter
within ``CHANGE_SHARE`` of its tensor's largest change over the two
epochs (read: ~1e-6). The control that skips the gradient all_reduce
must break the loss or the parameter bound. A world of one rank is the
single-process trainer bit for bit.
"""

import json
import os
import subprocess
import sys

import jax
import numpy
import pytest

torch = pytest.importorskip("torch")

import torch_spmd_ranks as ranks  # noqa: E402
from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher  # noqa: E402
from veles_tpu.models.alexnet import AlexNetWorkflow  # noqa: E402
from veles_tpu.models.alexnet import \
    SyntheticImageLoader as JaxSyntheticImageLoader  # noqa: E402
from veles_tpu.parallel import DataParallelTrainer as JaxDP  # noqa: E402
from veles_tpu.parallel import gspmd as jax_gspmd  # noqa: E402
from veles_tpu.parallel.mesh import build_mesh as jax_build_mesh  # noqa
from veles_tpu.parallel.tp import shard_map_linear as jax_linear  # noqa
from veles_tpu.parallel.tp import tp_param_shardings as jax_tp  # noqa
from veles_tpu.train import FusedTrainer as JaxFusedTrainer  # noqa: E402
from veles_tpu_torch.convert import params_to_jax  # noqa: E402
from veles_tpu_torch.models.alexnet import small_alexnet_layers  # noqa
from veles_tpu_torch.models.build import build_model  # noqa: E402
from veles_tpu_torch.parallel import mesh  # noqa: E402
from veles_tpu_torch.parallel.gspmd import (GSPMDTrainer,  # noqa: E402
                                            gspmd_mesh, parse_mesh_spec)
from veles_tpu_torch.parallel.tp import tp_roles  # noqa: E402
from torch_world import run_world  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_S = 120.0
GRAD_SHARE = 1e-5
LOSS_REL = 1e-5
CHANGE_SHARE = 1e-5

TINY = [
    {"type": "conv_str", "n_kernels": 8, "kx": 5, "ky": 5,
     "sliding": (4, 4), "padding": 2, "space_to_depth": True},
    {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_str", "output_sample_shape": 32},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 10},
]
TP_NET = [
    {"type": "conv_str", "n_kernels": 8, "kx": 5, "ky": 5,
     "sliding": (4, 4), "padding": 2},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_str", "output_sample_shape": 32},
    {"type": "all2all_str", "output_sample_shape": 16},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 10},
]
EPOCHS = 2
N_BATCHES = 3   # 40 training samples in minibatches of 16


def _jax_workflow():
    jax_prng.get().seed(ranks.WEIGHT_SEED)
    jax_prng.get("loader").seed(ranks.LOADER_SEED)
    wf = AlexNetWorkflow(
        DummyLauncher(),
        loader_factory=lambda w: JaxSyntheticImageLoader(w,
                                                         **ranks.LOADER),
        layers=TINY, max_epochs=EPOCHS)
    wf.initialize(device=Device(backend="cpu"))
    return wf


def _jax_run(make_trainer):
    wf = _jax_workflow()
    trainer = make_trainer(wf)
    history = trainer.train()
    params, _ = trainer.pull_params()
    return {"means": [[h[k]["loss"] for k in ("train", "validation")]
                      for h in history],
            "params": [{k: numpy.asarray(v) for k, v in p.items()}
                       for p in params]}


def _recorded_uniforms(stream_seed, counter):
    """JAX's dropout uniforms of every (epoch, batch) of the runs, the
    whole minibatch's (16, 32) at TINY's dropout (layer 4)."""
    table = {}
    for epoch in range(EPOCHS):
        base = jax.random.fold_in(jax.random.PRNGKey(stream_seed),
                                  counter + epoch)
        for batch in range(N_BATCHES):
            key = jax.random.fold_in(jax.random.fold_in(base, batch), 4)
            table[(epoch, batch, 4)] = numpy.array(
                jax.random.uniform(key, (16, 32)))
    return table


@pytest.fixture(scope="module")
def setup():
    """JAX's initial weights and uniforms, JAX's 2-epoch runs (fused,
    data parallel on 2 devices, GSPMD 2x1 and 1x2) and TP_NET's."""
    jt = JaxFusedTrainer(_jax_workflow())
    stream = jax_prng.get("default")
    table = _recorded_uniforms(stream.seed_value, stream.save_state()[1])
    params, _ = jt.pull_params()
    params = [{k: numpy.asarray(v) for k, v in p.items()} for p in params]
    devices = jax.devices()[:2]
    out = {"params": params, "table": table, "jax": {
        "fused": _jax_run(JaxFusedTrainer),
        "dp": _jax_run(lambda w: JaxDP(
            w, mesh=jax_build_mesh({"data": 2}, devices=devices))),
        "2x1": _jax_run(lambda w: jax_gspmd.GSPMDTrainer(
            w, mesh=jax_gspmd.gspmd_mesh(2, 1, devices=devices))),
        "1x2": _jax_run(lambda w: jax_gspmd.GSPMDTrainer(
            w, mesh=jax_gspmd.gspmd_mesh(1, 2, devices=devices)))}}
    rng = numpy.random.RandomState(5)
    out["net_params"] = params_to_jax(build_model(TP_NET, ranks.SAMPLE,
                                                  seed=3, device="cpu"))
    out["net_table"] = {(e, b, 4): rng.rand(16, 16).astype(numpy.float32)
                        for e in range(EPOCHS + 1)
                        for b in range(N_BATCHES)}
    return out


def _reference(layers, params, table):
    """The port's single-process run: one batch's gradients, then two
    epochs."""
    from veles_tpu_torch.loader.base import TRAIN
    t = ranks.trainer(layers, params, table)
    idx = torch.from_numpy(t._segment_indices(TRAIN)[0])
    t.gradients(idx, 0, 0)
    grads = ranks.whole_grads(t)
    t.uniform_source.epochs.clear()
    state = ranks.run_state(t, t.train(max_epochs=EPOCHS))
    state["grads"] = grads
    return state


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    """The one 2-rank world of the module: every trainer case, the
    reshard, placer, multihost and linear cases."""
    p, t = setup["params"], setup["table"]
    np_, nt = setup["net_params"], setup["net_table"]
    specs = [("dp", (TINY, p, t, 2, 1), {"axis": "data"}),
             ("2x1", (TINY, p, t, 2, 1), {}),
             ("1x2", (TINY, p, t, 1, 2), {}),
             ("1x2 tp_net", (TP_NET, np_, nt, 1, 2), {}),
             ("2x1 streamed", (TINY, p, t, 2, 1), {"stream": True}),
             ("2x1 control", (TINY, p, t, 2, 1), {"reduce": False}),
             ("1x2 control", (TINY, p, t, 1, 2), {"reduce": False}),
             ("dp control", (TINY, p, t, 2, 1),
              {"axis": "data", "reduce": False})]
    rng = numpy.random.RandomState(11)
    linear = [rng.randn(4, 16).astype(numpy.float32) for _ in range(1)] + [
        rng.randn(16, 32).astype(numpy.float32),
        rng.randn(32, 8).astype(numpy.float32)]
    reports = run_world(ranks.world_cases, 2, (specs, linear), timeout=WORLD_S,
                        workdir=str(tmp_path_factory.mktemp("world")))
    return {"reports": reports, "linear": linear}


@pytest.fixture(scope="module")
def references(setup):
    return {"tiny": _reference(TINY, setup["params"], setup["table"]),
            "tp_net": _reference(TP_NET, setup["net_params"],
                                 setup["net_table"])}


def _grad_share(got, want):
    return max(float(numpy.linalg.norm(g[k] - w[k]) /
                     max(numpy.linalg.norm(w[k]), 1e-30))
               for g, w in zip(got, want) for k in w)


def _loss_rel(got, want):
    return max(float(numpy.max(numpy.abs(numpy.asarray(g) -
                                          numpy.asarray(w)) /
                               numpy.abs(numpy.asarray(w))))
               for g, w in zip(got, want))


def _change_share(got, want, start):
    return max(float(numpy.abs(g[k] - w[k]).max() /
                     max(numpy.abs(w[k] - s[k]).max(), 1e-30))
               for g, w, s in zip(got, want, start) for k in w)


# -- the grid ------------------------------------------------------------------


@pytest.mark.parametrize("axes,n,sizes", [
    ({"data": -1}, 4, [4]), ({"batch": -1, "model": 2}, 4, [2, 2]),
    ({"pipe": 2, "seq": -1}, 8, [2, 4]), ({"a": 1, "b": 1}, 1, [1, 1])])
def test_infer_sizes_matches_jax_mesh(axes, n, sizes):
    """The grid's axis sizes, one -1 inferred, as JAX's ``build_mesh``
    lays them over n devices."""
    names, got = mesh.infer_sizes(axes, n)
    assert got == sizes
    jmesh = jax_build_mesh(dict(axes), devices=jax.devices()[:n])
    assert [jmesh.shape[k] for k in names] == got


@pytest.mark.parametrize("axes,n,message", [
    ({"a": -1, "b": -1}, 4, "at most one inferred"),
    ({"a": 3, "b": -1}, 4, "cannot infer axis"),
    ({"a": 2, "b": 3}, 4, "needs 6 devices, have 4")])
def test_infer_sizes_errors_are_jax_s(axes, n, message):
    with pytest.raises(ValueError, match=message):
        mesh.infer_sizes(axes, n)
    with pytest.raises(ValueError, match=message):
        jax_build_mesh(dict(axes), devices=jax.devices()[:n])


def test_standalone_grid_is_one_rank():
    grid = mesh.build_mesh({"batch": -1, "model": 1})
    assert grid.shape == {"batch": 1, "model": 1} and grid.size == 1
    assert grid.axis("model").group is None
    with pytest.raises(ValueError, match="has no 'seq' axis"):
        grid.axis("seq")


@pytest.mark.parametrize("spec,n", [
    ("auto", 2), ("2x1", 2), ("1x2", 2), ("batch=2,model=1", 2),
    ("model=2", 4), ("4x2", 8), ("batch=-1,model=4", 8)])
def test_parse_mesh_spec_matches_jax(spec, n):
    got = parse_mesh_spec(spec, n=n)
    jmesh = jax_gspmd.parse_mesh_spec(spec, devices=jax.devices()[:n])
    assert got == {"batch": jmesh.shape["batch"],
                   "model": jmesh.shape["model"]}


@pytest.mark.parametrize("spec,message", [
    ("2x2x2", "BATCHxMODEL"), ("pipe=2", "unknown GSPMD mesh axis"),
    ("3x1", "needs 3 devices, have 2")])
def test_parse_mesh_spec_errors(spec, message):
    with pytest.raises(ValueError, match=message):
        parse_mesh_spec(spec, n=2)


def test_a_dead_peer_fails_the_run_instead_of_hanging_it(tmp_path):
    """A rank that dies leaves its peer's next collective failing with
    the transport's error well inside the world's wall limit."""
    import pickle
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 left no report"):
        run_world(ranks.dead_peer_case, 2, timeout=WORLD_S,
                  workdir=str(tmp_path))
    assert time.monotonic() - t0 < WORLD_S / 2
    with open(tmp_path / "rank0.pickle", "rb") as fin:
        assert "Traceback" in pickle.load(fin)["error"]


def test_ranks_stay_off_the_cpu_unless_asked(tmp_path):
    """Without a card a rank of ``auto`` raises before any process group
    exists; only ``cpu`` puts it on the CPU."""
    import torch.distributed as dist
    store = dist.FileStore(str(tmp_path / "store"), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.init_world(store, 1, 0, "auto")
    assert not dist.is_initialized()


def test_backend_rule():
    assert mesh.choose_backend("cpu", 4)[0] == "gloo"
    assert mesh.choose_backend("cuda:0", 1)[0] == "nccl"
    backend, reason = mesh.choose_backend("cuda:0", 2)
    assert backend == "gloo" and "NCCL refuses" in reason


# -- the world's cases ---------------------------------------------------------


def _case(world, name, rank=0):
    return world["reports"][rank]["value"]["trainers"][name]


@pytest.mark.parametrize("name,ref", [("dp", "tiny"), ("2x1", "tiny"),
                                      ("1x2", "tiny"),
                                      ("1x2 tp_net", "tp_net"),
                                      ("2x1 streamed", "tiny")])
def test_trainer_matches_the_single_process_trainer(world, references,
                                                     setup, name, ref):
    """One batch's gradients, two epochs of losses and parameters, on
    both ranks, against the port's ``FusedTrainer``; ``2x1 streamed``
    streams each rank's columns of every shard from the host instead
    of holding the row-sharded dataset."""
    want = references[ref]
    start = setup["params"] if ref == "tiny" else setup["net_params"]
    for rank in (0, 1):
        got = _case(world, name, rank)
        assert _grad_share(got["grads"], want["grads"]) <= GRAD_SHARE
        assert _loss_rel(got["train"], want["train"]) <= LOSS_REL
        assert _loss_rel(got["validation"], want["validation"]) <= LOSS_REL
        assert _change_share(got["params"], want["params"],
                             start) <= CHANGE_SHARE


@pytest.mark.parametrize("name", ["dp control", "2x1 control",
                                  "1x2 control"])
def test_control_without_the_gradient_all_reduce_fails(world, references,
                                                        setup, name):
    got = _case(world, name)
    want = references["tiny"]
    assert (_loss_rel(got["train"], want["train"]) > LOSS_REL or
            _change_share(got["params"], want["params"],
                          setup["params"]) > CHANGE_SHARE)


@pytest.mark.parametrize("name", ["dp", "2x1", "1x2"])
def test_trainer_matches_the_jax_trainer(world, setup, name):
    """Two epochs against JAX's ``DataParallelTrainer`` (``dp``) or
    ``GSPMDTrainer`` on a 2-device mesh: each epoch's mean training and
    validation loss, and the parameters."""
    got, want = _case(world, name), setup["jax"][name]
    assert _loss_rel(got["means"], want["means"]) <= LOSS_REL
    assert _change_share(got["params"], want["params"],
                         setup["params"]) <= CHANGE_SHARE


def test_dataset_rows_are_sharded(world):
    """Each rank holds ceil(56 / 2) rows over the batch axis, all 56
    over the model axis; a streamed run holds none."""
    for rank in (0, 1):
        assert _case(world, "2x1 streamed", rank)["streaming"]
        assert _case(world, "2x1 streamed", rank)["rows_on_device"] is None
        assert _case(world, "2x1", rank)["rows_on_device"] == 28
        assert _case(world, "dp", rank)["rows_on_device"] == 28
        assert _case(world, "1x2", rank)["rows_on_device"] == 56


def test_minibatch_must_divide_the_axis(world):
    message = world["reports"][0]["value"]["indivisible"]
    assert "minibatch size 15 does not divide over the 'data' mesh axis " \
           "(2 shards)" in message


def test_reshard_round_trip_and_labels(world):
    for rank, report in enumerate(world["reports"]):
        case = report["value"]["reshard"]
        numpy.testing.assert_array_equal(case["back"], case["whole"])
        numpy.testing.assert_array_equal(case["host"], case["whole"])
        numpy.testing.assert_array_equal(
            case["block"], case["whole"][..., rank * 4:(rank + 1) * 4])
        assert case["label_of"] == ["replicated", "P(_,_,model)",
                                    "P(batch)", "P(_,model)", "host"]
        assert {"host>P(_,_,model)", "P(_,_,model)>replicated",
                "host>P(batch)", "P(_,_,model)>host"} <= set(case["labels"])


def test_sharded_placer_pads_and_splits(world):
    """7 rows over 2 ranks: 4 a rank, the last one padded with zeros."""
    rows = numpy.arange(21, dtype=numpy.float32).reshape(7, 3)
    numpy.testing.assert_array_equal(
        world["reports"][0]["value"]["reshard"]["placed"], rows[:4])
    want = numpy.concatenate([rows[4:], numpy.zeros((1, 3), "f")])
    numpy.testing.assert_array_equal(
        world["reports"][1]["value"]["reshard"]["placed"], want)


def test_multihost_same_spec_twice_is_a_no_op(world):
    for report in world["reports"]:
        assert report["value"]["multihost"] == [True, "RuntimeError"]


def test_shard_map_linear_matches_jax(world):
    x, wc, wr = world["linear"]
    jmesh = jax_build_mesh({"model": 2}, devices=jax.devices()[:2])
    want = numpy.asarray(jax_linear(x, wc, wr, jmesh,
                                    activation=jax.nn.relu))
    for report in world["reports"]:
        numpy.testing.assert_allclose(report["value"]["linear"], want,
                                      rtol=1e-5, atol=1e-5)


def test_ranks_load_neither_jax_nor_the_jax_package(world):
    for report in world["reports"]:
        assert report["bad_modules"] == []


# -- in the test process -------------------------------------------------------


def test_one_rank_equals_the_fused_trainer_bit_for_bit(setup):
    """A 1x1 grid: the GSPMD trainer's two epochs are the single-process
    trainer's, every loss and parameter bitwise."""
    p, t = setup["params"], setup["table"]
    fused = ranks.trainer(TINY, p, t)
    want = ranks.run_state(fused, fused.train(max_epochs=EPOCHS))
    gspmd = ranks.trainer(TINY, p, t, GSPMDTrainer, grid=gspmd_mesh(1, 1))
    got = ranks.run_state(gspmd, gspmd.train(max_epochs=EPOCHS))
    for g, w in zip(got["train"] + got["validation"],
                    want["train"] + want["validation"]):
        numpy.testing.assert_array_equal(g, w)
    for g, w in zip(got["params"], want["params"]):
        for k in w:
            numpy.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("kind", ["dp", "gspmd"])
def test_default_grid_is_on_the_trainer_s_device(setup, monkeypatch, kind):
    """Built without a grid, a trainer lays its grid, and with it the
    row-sharded dataset, on the trainer's own device: the grid is asked
    for that device, not left to the standalone default.
    ``tests/test_torch_cuda.py`` holds the same on the card."""
    from veles_tpu_torch.parallel import dp, gspmd
    asked = []
    build = mesh.build_mesh

    def spy(axes=None, device=None):
        asked.append(device)
        return build(axes, device)

    monkeypatch.setattr(dp, "build_mesh", spy)
    monkeypatch.setattr(gspmd, "build_mesh", spy)
    cls = dp.DataParallelTrainer if kind == "dp" else GSPMDTrainer
    t = ranks.trainer(TINY, setup["params"], setup["table"], cls)
    assert asked == [t.device]
    assert t.grid.device == t.device
    assert t._data_args[0].device == t.device


#: offloaded against resident data parallelism: every loss and parameter
#: bit for bit (the bound ``tests/test_torch_offload.py`` holds an
#: offloaded run to against the resident one); groups of 0.02 MB cut the
#: small net into several
DP_OFFLOAD_GROUP_MB = 0.02


@pytest.mark.parametrize("n", [1, 2])
def test_offloaded_data_parallel_equals_resident(setup, tmp_path, n):
    """The ``DataParallelTrainer`` with the model state offloaded in
    layer groups (each group's gradients summed over the axis before its
    update) trains as the resident one does, at one and two ranks: every
    loss and every parameter bit for bit."""
    reports = run_world(
        ranks.dp_offload_case, n,
        (TINY, setup["params"], setup["table"], DP_OFFLOAD_GROUP_MB),
        timeout=WORLD_S, workdir=str(tmp_path))
    for report in reports:
        assert report["bad_modules"] == []
        got = report["value"]["offloaded"]
        want = report["value"]["resident"]
        assert got["offloaded"] and got["groups"] > 1
        assert not want["offloaded"]
        for g, w in zip(got["train"] + got["validation"],
                        want["train"] + want["validation"]):
            numpy.testing.assert_array_equal(g, w)
        for g, w in zip(got["params"], want["params"]):
            for k in w:
                numpy.testing.assert_array_equal(g[k], w[k])


def test_gspmd_refuses_an_offloaded_model():
    with pytest.raises(ValueError, match="in-core"):
        GSPMDTrainer(None, None, None, offload=True)


def test_tp_plan_matches_jax():
    """The column/row roles of the small AlexNet and of AlexNet-227's
    layer list at model=2 against JAX's ``tp_param_shardings``."""
    from veles_tpu.models.alexnet import AlexNetWorkflow as JaxAlexNet
    layers = small_alexnet_layers(10)
    model = build_model(layers, (32, 32, 3), seed=0, device="cpu")
    roles = tp_roles(list(model), 2)
    jax_prng.get().seed(1)
    jax_prng.get("loader").seed(1)
    wf = JaxAlexNet(DummyLauncher(),
                    loader_factory=lambda w: JaxSyntheticImageLoader(
                        w, n_train=8, n_valid=4, side=32, n_classes=10,
                        minibatch_size=4), layers=layers)
    wf.initialize(device=Device(backend="cpu"))
    specs = jax_tp(wf.forwards, jax_build_mesh(
        {"model": 2}, devices=jax.devices()[:2]))
    want = []
    for spec in specs:
        w = spec.get("weights")
        parts = tuple(w.spec) if w is not None else ()
        want.append("column" if parts[-1:] == ("model",) else
                    "row" if "model" in parts else None)
    assert roles == want
    assert roles.count("column") == 2 and roles.count("row") == 1


def _workflow_file(tmp_path):
    path = tmp_path / "wf.py"
    path.write_text(
        "from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,\n"
        "    SyntheticImageLoader, small_alexnet_layers)\n\n\n"
        "def run(load, main):\n"
        "    load(AlexNetWorkflow, layers=small_alexnet_layers(10),\n"
        "         max_epochs=2, loader_factory=lambda wf: "
        "SyntheticImageLoader(\n"
        "             workflow=wf, n_train=32, n_valid=16, side=32,\n"
        "             n_classes=10, minibatch_size=16))\n"
        "    main()\n")
    return str(path)


def _cli(args, tmp_path, timeout=WORLD_S):
    env = dict(os.environ, PYTHONPATH=REPO, VELES_DATASET_CACHE="0")
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-m", "veles_tpu_torch"] + args,
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_cli_gspmd_spawns_its_ranks_and_writes_one_result(tmp_path):
    """``python -m veles_tpu_torch -a cpu --gspmd 2x1 <wf>``: rank 0
    starts rank 1, both train, rank 0 alone writes the result file;
    its losses are the single-process run's within ``LOSS_REL``."""
    wf = _workflow_file(tmp_path)
    one = _cli([wf, "-a", "cpu", "-s", "7", "--result-file", "one.json"],
               tmp_path)
    assert one.returncode == 0, one.stderr[-3000:]
    run = _cli([wf, "-a", "cpu", "-s", "7", "--gspmd", "2x1",
                "--result-file", "r.json"], tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "backend gloo" in run.stderr
    assert run.stderr.count("running the GSPMD path over mesh "
                            "{'batch': 2, 'model': 1}") == 2
    assert sorted(f.name for f in tmp_path.glob("*.json")) == [
        "one.json", "r.json"]
    got, want = (json.loads((tmp_path / n).read_text())
                 for n in ("r.json", "one.json"))
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])


def test_cli_multi_process_flags_join_one_world_at_a_file_store(tmp_path):
    """One process a rank, each given ``--jax-coordinator file://PATH
    --jax-processes 2 --jax-process-id K``: both join one gloo world,
    train, and rank 0 alone writes the result file."""
    wf = _workflow_file(tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO, VELES_DATASET_CACHE="0")
    env.pop("JAX_PLATFORMS", None)
    store = "file://" + str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "veles_tpu_torch", wf, "-a", "cpu", "-s", "7",
         "--gspmd", "2x1", "--result-file", "r%d.json" % k,
         "--jax-coordinator", store, "--jax-processes", "2",
         "--jax-process-id", str(k)], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(2)]
    try:
        outs = [proc.communicate(timeout=WORLD_S) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, (_, err) in zip(procs, outs):
        assert proc.returncode == 0, err[-3000:]
        assert "backend gloo" in err
    assert sorted(f.name for f in tmp_path.glob("*.json")) == ["r0.json"]


SNAPSHOT_FILE = """
from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,
                                            SyntheticImageLoader,
                                            small_alexnet_layers)
from veles_tpu_torch.snapshotter import SnapshotterToFile


def run(load, main):
    wf, _ = load(AlexNetWorkflow, layers=small_alexnet_layers(10),
                 max_epochs=2, loader_factory=lambda wf: SyntheticImageLoader(
                     workflow=wf, n_train=32, n_valid=16, side=32,
                     n_classes=10, minibatch_size=16))
    snap = SnapshotterToFile(wf, compression="", time_interval=0,
                             name="snapshotter")
    snap.link_from(wf.decision)
    snap.gate_skip = ~wf.loader.epoch_ended
    snap.directory = "snaps"
    main()
"""


def test_cli_gspmd_1x2_snapshots_whole_weights_on_rank_0(tmp_path):
    """Under ``--gspmd 1x2`` rank 0 alone snapshots, and the snapshot
    holds every layer's weights whole (the sharded ones gathered at the
    epoch's end), within ``CHANGE_SHARE`` of the single process's."""
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    path = tmp_path / "wf.py"
    path.write_text(SNAPSHOT_FILE)
    got = {}
    for mode, extra in (("one", []), ("tp", ["--gspmd", "1x2"])):
        run_dir = tmp_path / mode
        run_dir.mkdir()
        run = _cli([str(path), "-a", "cpu", "-s", "7"] + extra, run_dir)
        assert run.returncode == 0, run.stderr[-3000:]
        assert sorted(p.name for p in (run_dir / "snaps").iterdir()) == [
            "wf.0.pickle", "wf.1.pickle", "wf_current.pickle"]
        wf = SnapshotterToFile.import_(str(run_dir / "snaps/wf.1.pickle"))
        # a snapshot keeps each unit's parameters in the JAX layout until
        # the unit is initialized
        got[mode] = [getattr(f, "_params", {}) for f in wf.forwards]
    assert got["tp"][0]["weights"].shape == (5, 5, 3, 16)
    for g, w in zip(got["tp"], got["one"]):
        for k in w:
            assert g[k].shape == w[k].shape
            numpy.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=0)


def test_cli_coordinator_without_processes_exits(tmp_path):
    run = _cli([_workflow_file(tmp_path), "-a", "cpu",
                "--jax-coordinator", "127.0.0.1:1"], tmp_path)
    assert run.returncode != 0
    assert "--jax-coordinator requires --jax-processes" in run.stderr


def test_gspmd_refuses_eager(tmp_path):
    from veles_tpu_torch.__main__ import main
    with pytest.raises(RuntimeError, match="mutually exclusive"):
        main([_workflow_file(tmp_path), "-a", "cpu", "--gspmd", "1x1",
              "--eager"])
    assert not mesh.multihost_initialized()
