"""The port's elastic tier against the JAX package's, on the CPU.

* Sharded generations: a generation the JAX package writes at world 2
  (two part files of a leaf split over 8 virtual devices, the layout of
  ``tests/test_elastic.py``'s ``test_checkpoint_written_at_world_2_
  restores_at_world_1``, here with the workflow's real leaves) loads in
  the port with every parameter and solver-state leaf equal to the bit;
  the port's own trainers (standalone, ``2x1`` and ``1x2`` worlds of
  processes over gloo) round-trip through ``checkpoint_records`` ->
  ``save_snapshot_sharded`` -> ``restore_latest`` bit for bit, the
  tensor-parallel one restored at ``1x1``; a torn generation (no
  manifest, a truncated part, a leaf not covered) is never restored.
* The rendezvous protocol across the packages: the JAX client against
  the port's server and the port's client against the JAX server (and
  the port's against its own): join, form, heartbeat, break, re-form,
  complete; a closed connection breaks the generation; a lost member
  raises the port's ``spmd_participant_lost`` alert.
* The supervisor's cycle with stub workers, as the JAX test runs it.
* ``worker-demo``: the port's bare run against JAX's bare run (the same
  seeds and data), each epoch's validation error within 2 samples of
  128; the supervised two-process kill at ``1:1`` (rank 1 SIGKILLs
  itself at the first epoch boundary) re-forms at world 1 from the
  generation-initial checkpoint written at world 2 and equals the
  uninterrupted one-rank run in every value (curve, losses,
  parameters), as ``test_spmd_kill_mid_epoch_restarts_at_world_1_with_
  loss_parity`` holds the JAX tier; a worker made to fail leaves a
  flight record with its generation, rank, job and trace id; the worker
  loads neither ``jax`` nor any ``veles_tpu`` module.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy
import pytest

torch = pytest.importorskip("torch")

import torch_elastic_ranks as ranks  # noqa: E402
from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu import snapshotter as jax_snapshotter  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher  # noqa: E402
from veles_tpu.models.mnist import MnistWorkflow as JaxMnist  # noqa: E402
from veles_tpu.parallel import DataParallelTrainer as JaxDP  # noqa: E402
from veles_tpu.parallel import build_mesh as jax_build_mesh  # noqa: E402
from veles_tpu.parallel import elastic as jax_elastic  # noqa: E402
from veles_tpu.parallel.mesh import named_sharding, put_global  # noqa
from veles_tpu_torch import snapshotter  # noqa: E402
from veles_tpu_torch.convert import (params_to_jax,  # noqa: E402
                                     solver_state_to_jax, to_jax_layout)
from veles_tpu_torch.dummy import DummyLauncher  # noqa: E402
from veles_tpu_torch.parallel import elastic  # noqa: E402
from veles_tpu_torch.parallel.gspmd import GSPMDTrainer  # noqa: E402
from veles_tpu_torch.telemetry import alerts, flight  # noqa: E402
from veles_tpu_torch.train.runner import trainer_for  # noqa: E402
from veles_tpu_torch.train.step import FusedTrainer  # noqa: E402
from torch_world import run_world  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the demo curves of the two packages: each epoch's validation error
#: (a share of 128 samples) within two samples
DEMO_CURVE_TOL = 2.0 / 128
#: seconds any one subprocess of these tests may take
PROC_S = 240


def _equal_trees(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _equal_trees(got[k], want[k], "%s/%s" % (where, k))
        return
    if isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _equal_trees(g, w, "%s/%d" % (where, i))
        return
    got, want = numpy.asarray(got), numpy.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, where
    assert (got == want).all(), where


def _restored(path):
    """The port's workflow restored from ``path`` and initialized on the
    CPU."""
    wf, where = snapshotter.restore_latest(path)
    wf.workflow = DummyLauncher()
    wf.initialize(device="cpu")
    return wf, where


def _unit_state(wf):
    """(params, solver states) the units hold, JAX layout."""
    gd_for = {id(gd.forward): gd for gd in wf.gds}
    params = params_to_jax([f.module for f in wf.forwards])
    states = solver_state_to_jax([
        gd_for[id(f)].opt_state if id(f) in gd_for and
        gd_for[id(f)].opt_state else {} for f in wf.forwards])
    return params, states


# -- sharded generations ------------------------------------------------------


def _jax_tiny(seed=42):
    jax_prng.get().seed(seed)
    jax_prng.get("loader").seed(seed + 1)
    wf = JaxMnist(JaxDummyLauncher(),
                  provider=jax_elastic._DemoProvider(64, 32), layers=(8,),
                  minibatch_size=16, learning_rate=0.1, momentum=0.9,
                  max_epochs=1)
    wf.initialize(device=Device(backend="cpu"))
    return wf


def test_jax_generation_written_at_world_2_loads_bitwise(tmp_path):
    """Every leaf of a JAX workflow's checkpoint records, moved off its
    initial values (so the part files, not the workflow's pickle, carry
    them), split over an 8-device data axis where its first dimension
    divides, written as two part files (world 2) by the JAX package:
    the port's restore has each one bit for bit."""
    wf = _jax_tiny()
    trainer = JaxDP(wf, mesh=jax_build_mesh({"data": 8}))
    params, states = trainer.pull_params()
    records = trainer.checkpoint_records(params, states)
    trainer.shutdown()
    mesh8 = jax_build_mesh({"data": 8})
    parts = ([], [])
    want = {}
    for k, (spec, leaf) in enumerate(records):
        host = numpy.asarray(leaf) + numpy.float32(0.25 + k)
        want[json.dumps(spec, sort_keys=True)] = host
        split = host.ndim and host.shape[0] % 8 == 0
        arr = put_global(host, named_sharding(mesh8, "data") if split
                         else named_sharding(mesh8))
        meta, entries = jax_snapshotter.shard_records(arr)
        for p, chunk in enumerate((entries[:4], entries[4:])):
            parts[p].append({"spec": spec, "shape": meta["shape"],
                             "dtype": meta["dtype"], "shards": chunk})
    assert any(len(r["shards"]) for r in parts[1])
    gen = tmp_path / "wf_g0.0.shards"
    gen.mkdir()
    jax_snapshotter._write_part_file(str(gen), 0, {
        "format": 1, "part": 0, "records": parts[0],
        "workflow": jax_snapshotter.dump_workflow(wf)})
    jax_snapshotter._write_part_file(str(gen), 1, {
        "format": 1, "part": 1, "records": parts[1]})
    jax_snapshotter._write_manifest(str(gen), 2, 0)
    got, path = _restored(str(tmp_path))
    assert path == str(gen)
    params, states = _unit_state(got)
    for spec_key, host in want.items():
        spec = json.loads(spec_key)
        if spec["kind"] == "param":
            value = params[spec["forward"]][spec["name"]]
        else:
            value = states[spec["forward"]]
            for key in spec["path"]:
                value = value[key]
        _equal_trees(value, host, spec_key)


def _standalone_generations(tmp_path, epochs=2):
    """A standalone run of the demo workflow with a generation cut at
    each closed epoch (and before the first): the trainer's whole state
    after each."""
    wf = ranks.demo_workflow(epochs=epochs)
    trainer = trainer_for(wf, FusedTrainer)
    trainer.epoch_history = wf.decision.epoch_history
    ctx = elastic.ElasticContext(0, 1, 0, snapshot_dir=str(tmp_path))
    seen = []

    def cut(tr, params, states):
        elastic.save_elastic_checkpoint(tr, ctx, params, states, wf,
                                        compression="")
        seen.append(tr.pull_params())

    cut(trainer, trainer.params, trainer.states)
    trainer.train(max_epochs=epochs, epoch_callback=cut,
                  initial_state=trainer.pull_params())
    return seen


def test_standalone_generation_round_trips_bitwise(tmp_path):
    seen = _standalone_generations(tmp_path)
    wf, path = _restored(str(tmp_path))
    assert path.endswith("wf_g0.2.shards")
    assert len(wf.decision.epoch_history) == 2
    params, states = _unit_state(wf)
    want_params, want_states = seen[-1]
    _equal_trees(params, [to_jax_layout(p) for p in want_params])
    _equal_trees(states, solver_state_to_jax(want_states))


@pytest.mark.parametrize("grid", ["2x1", "1x2"])
def test_world_generation_restores_at_1x1_bitwise(tmp_path, grid):
    """A 2-rank world (data or tensor parallel) trains an epoch and cuts
    a generation, each rank its part; restored at ``1x1`` in this
    process (the sharded leaves assembled whole, the trainer placing
    them through the reshard seam), every parameter and solver state
    leaf equals the world's gathered whole to the bit."""
    batch, model = (int(n) for n in grid.split("x"))
    snaps = str(tmp_path / "snaps")
    reports = run_world(ranks.generation_rank, 2, (snaps, batch, model, 1),
                        timeout=PROC_S, workdir=str(tmp_path))
    assert all(not r["bad_modules"] for r in reports)
    world = reports[0]["value"]
    if model > 1:
        assert world["roles"][:2] == ["column", "row"]
    gens = [d for d in os.listdir(snaps) if d.endswith(".shards")]
    assert gens == ["wf_g0.1.shards"]
    gen = os.path.join(snaps, gens[0])
    assert sorted(os.listdir(gen)) == ["MANIFEST.json", "part0.pickle",
                                       "part1.pickle"]
    manifest = snapshotter.generation_manifest(gen)
    assert manifest["mesh_axes"] == {"batch": batch, "model": model}
    wf, _ = _restored(snaps)
    params, states = _unit_state(wf)
    _equal_trees(params, world["params"])
    _equal_trees(states, world["states"])
    trainer = trainer_for(wf, GSPMDTrainer)
    got_params, got_states = trainer.pull_params()
    _equal_trees([to_jax_layout(p) for p in got_params], world["params"])
    _equal_trees(solver_state_to_jax(got_states), world["states"])
    trainer.shutdown()


def _newest_two(tmp_path):
    _standalone_generations(tmp_path)
    gens = sorted(d for d in os.listdir(tmp_path) if d.endswith(".shards"))
    return [str(tmp_path / d) for d in gens[-2:]]


def test_generation_without_its_manifest_is_no_candidate(tmp_path):
    older, newest = _newest_two(tmp_path)
    os.unlink(os.path.join(newest, snapshotter.MANIFEST_NAME))
    assert newest not in snapshotter.snapshot_candidates(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        snapshotter.load_sharded_generation(newest)
    _, path = _restored(str(tmp_path))
    assert path == older


def test_truncated_part_falls_back_to_the_previous_generation(tmp_path):
    older, newest = _newest_two(tmp_path)
    part = os.path.join(newest, "part0.pickle")
    with open(part, "r+b") as f:
        f.truncate(os.path.getsize(part) // 2)
    with pytest.raises(Exception):
        snapshotter.load_sharded_generation(newest)
    wf, path = _restored(str(tmp_path))
    assert path == older
    assert len(wf.decision.epoch_history) == 1


def test_uncovered_leaf_raises(tmp_path):
    older, newest = _newest_two(tmp_path)
    part_path = os.path.join(newest, "part0.pickle")
    part = snapshotter._read_part_file(part_path)
    part["records"][0]["shards"] = []
    snapshotter._write_part_file(newest, 0, part, compression="")
    with pytest.raises(ValueError, match="incomplete generation"):
        snapshotter.load_sharded_generation(newest)
    assert _restored(str(tmp_path))[1] == older


def test_prune_keeps_the_newest_complete_generations(tmp_path):
    _standalone_generations(tmp_path)
    gens = sorted(d for d in os.listdir(tmp_path) if d.endswith(".shards"))
    assert gens == ["wf_g0.0.shards", "wf_g0.1.shards", "wf_g0.2.shards"]
    removed = snapshotter.prune_sharded_generations(str(tmp_path), 1)
    # the link protects its target, the newest
    assert sorted(os.path.basename(p) for p in removed) == [
        "wf_g0.0.shards", "wf_g0.1.shards"]


def test_part_file_refuses_other_classes(tmp_path):
    import pickle
    path = str(tmp_path / "part0.pickle")
    with open(path, "wb") as f:
        pickle.dump({"records": [], "x": DummyLauncher}, f)
    with pytest.raises(pickle.UnpicklingError, match="names"):
        snapshotter._read_part_file(path)


# -- the rendezvous protocol across the packages ------------------------------


@pytest.mark.parametrize("server_mod,client_mod", [
    (elastic, jax_elastic), (jax_elastic, elastic), (elastic, elastic)],
    ids=["jax-client-port-server", "port-client-jax-server", "port-port"])
def test_rendezvous_forms_breaks_and_reforms(server_mod, client_mod):
    server = server_mod.RendezvousServer(
        expected=2, min_workers=1, settle_s=0.2,
        heartbeat_timeout_s=5.0).start()
    addr = "%s:%d" % server.address
    a = client_mod.RendezvousClient(addr, "a")
    b = client_mod.RendezvousClient(addr, "b")
    try:
        assert a._request({"cmd": "join"})["status"] == "wait"
        ra = b.join_wait(timeout_s=5)
        rb = a.join_wait(timeout_s=5)
        assert ra["gen"] == rb["gen"] == 0
        assert ra["world"] == rb["world"] == 2
        assert {ra["rank"], rb["rank"]} == {0, 1}
        a.set_coord(0, "127.0.0.1:5555")
        assert b.get_coord_wait(0) == "127.0.0.1:5555"
        assert a.heartbeat(0) == "ok"
        reply = b.worker_exit(0, 137)
        assert reply["status"] == "restart" and not reply.get("stale")
        assert a.worker_exit(0, 1).get("stale") is True
        assert a.heartbeat(0) == "restart"
        b.leave()
        b.close()
        r = a.join_wait(timeout_s=10)
        assert r["gen"] >= 1 and r["world"] == 1 and r["rank"] == 0
        assert server.lost_total >= 1
        assert server.last_recovery_s is not None
        assert a.worker_exit(r["gen"], 0)["status"] == "done"
        assert a.heartbeat(r["gen"]) == "done"
    finally:
        a.close()
        b.close()
        server.stop()


def test_crashed_member_is_formed_only_after_its_next_join():
    """The port's server keeps a member whose worker crashed out of the
    next generation until its supervisor joins again: the survivor
    re-forms at world 1 and the crashed member's leave breaks nothing
    (the JAX server can form both again at once, and break at the
    leave)."""
    server = elastic.RendezvousServer(expected=2, min_workers=1,
                                      settle_s=0.2,
                                      heartbeat_timeout_s=5.0).start()
    addr = "%s:%d" % server.address
    a = elastic.RendezvousClient(addr, "a")
    b = elastic.RendezvousClient(addr, "b")
    try:
        a._request({"cmd": "join"})
        b.join_wait(timeout_s=5)
        a.join_wait(timeout_s=5)
        assert b.worker_exit(0, -9)["status"] == "restart"
        r = a.join_wait(timeout_s=10)
        assert (r["gen"], r["world"]) == (1, 1)
        b.leave()
        assert a.heartbeat(1) == "ok"
        assert server.generation == 1 and server.lost_total == 1
    finally:
        a.close()
        b.close()
        server.stop()


def test_closed_connection_breaks_the_generation_and_alerts():
    """A killed supervisor never says goodbye: its closed connection
    breaks the generation, counts a lost participant and raises the
    port's ``spmd_participant_lost`` rule."""
    engine = alerts.AlertEngine(rules=[
        r for r in alerts.DEFAULT_RULES
        if r["name"] == "spmd_participant_lost"], min_eval_interval_s=0)
    # the rule reads the counter's increase over its 300 s window: a
    # sample that old first (the engine takes its clock from the caller)
    now = time.time()
    engine.evaluate(now=now - 301.0, force=True)
    assert "spmd_participant_lost" not in engine.active()
    server = elastic.RendezvousServer(expected=2, min_workers=1,
                                      settle_s=0.2,
                                      heartbeat_timeout_s=30.0).start()
    addr = "%s:%d" % server.address
    a = elastic.RendezvousClient(addr, "a")
    b = elastic.RendezvousClient(addr, "b")
    try:
        a._request({"cmd": "join"})
        b.join_wait(timeout_s=5)
        a.join_wait(timeout_s=5)
        b._teardown()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and server.phase == "running":
            time.sleep(0.05)
        assert server.generation >= 1
        assert a.heartbeat(0) == "restart"
        engine.evaluate(now=now, force=True)
        assert "spmd_participant_lost" in engine.active()
    finally:
        a.close()
        server.stop()


def test_supervisor_cycle_with_stub_workers():
    """Two supervised stub workers (no torch); one is SIGKILLed: its
    supervisor (crash budget 0) leaves, the survivor's wedged worker is
    killed and started again at world 1, and the run completes."""
    server = elastic.RendezvousServer(expected=2, min_workers=1,
                                      settle_s=0.3,
                                      heartbeat_timeout_s=3.0).start()
    addr = "%s:%d" % server.address
    stub = ("import os, time\n"
            "if os.environ.get('VELES_ELASTIC_GEN') == '0':\n"
            "    time.sleep(120)\n")
    sups = [elastic.ElasticSupervisor(addr, [sys.executable, "-c", stub],
                                      member="h%d" % i, max_restarts=0,
                                      poll_s=0.1)
            for i in range(2)]
    rcs = [None, None]

    def run(i):
        rcs[i] = sups[i].run()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                server.phase == "running" and
                all(s.worker is not None for s in sups)):
            time.sleep(0.05)
        assert server.phase == "running" and server.world_size == 2
        time.sleep(0.2)
        os.kill(sups[1].worker.pid, signal.SIGKILL)
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert rcs == [0, 1]
        assert server.phase == "done"
        assert server.generation >= 1 and server.world_size == 1
        assert 0 < server.last_recovery_s < 10
    finally:
        for sup in sups:
            sup._kill_worker()
        server.stop()


# -- the demo worker ----------------------------------------------------------

#: the port's demo worker in a process of its own, reporting the modules
#: it loaded of jax and the JAX package
DEMO = """
import sys
from veles_tpu_torch.parallel import elastic
code = elastic.main(["worker-demo"] + sys.argv[1:])
bad = sorted(m for m in sys.modules if m in ("jax", "veles_tpu") or
             m.startswith(("jax.", "veles_tpu.")))
print("LOADED", bad)
sys.exit(code or (1 if bad else 0))
"""


def _env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.update(extra or {})
    return env


def _port_demo(tmp, name):
    out = os.path.join(tmp, name + ".json")
    state = os.path.join(tmp, name + ".npz")
    return [sys.executable, "-c", DEMO, "--out", out, "-a", "cpu",
            "--state-out", state], out, state


@pytest.fixture(scope="module")
def port_baseline(tmp_path_factory):
    """The port's bare demo run: (curve, {losses, parameters}), the
    modules it loaded."""
    tmp = str(tmp_path_factory.mktemp("elastic_base"))
    cmd, out, state = _port_demo(tmp, "base")
    proc = subprocess.run(cmd, env=_env({"VELES_FLIGHT_DIR": tmp}),
                          capture_output=True, timeout=PROC_S, cwd=tmp)
    log = proc.stdout.decode(errors="replace")
    assert proc.returncode == 0, log[-3000:] + proc.stderr.decode(
        errors="replace")[-3000:]
    with numpy.load(state) as data:
        arrays = {k: data[k] for k in data.files}
    with open(out) as f:
        curve = json.load(f)
    return curve, arrays, log


def test_worker_demo_loads_no_jax(port_baseline):
    assert "LOADED []" in port_baseline[2]


def test_bare_worker_demo_matches_jax(port_baseline, tmp_path):
    out = str(tmp_path / "jax.json")
    proc = subprocess.run(
        [sys.executable, "-m", "veles_tpu.parallel.elastic", "worker-demo",
         "--out", out], env=_env({"JAX_PLATFORMS": "cpu"}),
        capture_output=True, timeout=PROC_S, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr.decode(errors="replace")[-3000:]
    with open(out) as f:
        want = json.load(f)
    got = port_baseline[0]
    assert len(got) == len(want) == 3
    assert max(abs(g - w) for g, w in zip(got, want)) <= DEMO_CURVE_TOL, (
        got, want)


def test_supervised_kill_equals_the_uninterrupted_run(port_baseline,
                                                      tmp_path):
    """Rank 1 of a 2-rank world SIGKILLs itself at the first epoch
    boundary, before that epoch's generation commits; its supervisor
    (crash budget 0) leaves, the survivor re-forms at world 1 from the
    generation-initial checkpoint written at world 2, and the run equals
    the uninterrupted one-rank run in every value."""
    tmp = str(tmp_path)
    snaps = os.path.join(tmp, "snaps")
    server = elastic.RendezvousServer(expected=2, min_workers=1,
                                      settle_s=0.5,
                                      heartbeat_timeout_s=3.0).start()
    addr = "%s:%d" % server.address
    procs, outs, logs = [], [], []
    try:
        for i in range(2):
            worker, out, state = _port_demo(tmp, "h%d" % i)
            outs.append((out, state))
            cmd = [sys.executable, "-m", "veles_tpu_torch.parallel.elastic",
                   "supervise", "--rdzv", addr, "--member", "h%d" % i,
                   "--snapshots", snaps, "--max-restarts",
                   "3" if i == 0 else "0", "--"] + worker
            extra = {"VELES_FLIGHT_DIR": tmp}
            if i == 1:
                extra[elastic.ENV_TEST_DIE] = "1:1"
            procs.append(subprocess.Popen(
                cmd, env=_env(extra), cwd=tmp, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
        for proc in procs:
            logs.append(proc.communicate(timeout=PROC_S)[0].decode(
                errors="replace"))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        server.stop()
    assert procs[0].returncode == 0, logs[0][-4000:]
    assert procs[1].returncode == 1, logs[1][-4000:]
    assert server.generation >= 1 and server.world_size == 1
    assert server.lost_total >= 1 and server.phase == "done"
    with open(outs[0][0]) as f:
        assert json.load(f) == port_baseline[0]
    with numpy.load(outs[0][1]) as data:
        got = {k: data[k] for k in data.files}
    want = port_baseline[1]
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k] == want[k]).all(), k
    g0 = os.path.join(snaps, "wf_g0.0.shards")
    assert sorted(os.listdir(g0)) == ["MANIFEST.json", "part0.pickle.gz",
                                      "part1.pickle.gz"]
    # the first epoch's generation of world 2 never committed
    assert not os.path.exists(os.path.join(
        snaps, "wf_g0.1.shards", snapshotter.MANIFEST_NAME))
    assert any(d.startswith("wf_g1.") for d in os.listdir(snaps))


def test_failed_worker_leaves_a_flight_record(tmp_path, monkeypatch):
    for key, value in ((elastic.ENV_WORLD, "1"), (elastic.ENV_GEN, "3"),
                       (elastic.ENV_RANK, "0"),
                       (elastic.ENV_SNAPSHOTS, str(tmp_path / "snaps")),
                       (elastic.ENV_TEST_FAIL, "0:1"),
                       (elastic.ENV_JOB, "job-7"),
                       (elastic.ENV_TRACE, "trace-7"),
                       ("VELES_FLIGHT_DIR", str(tmp_path / "flight"))):
        monkeypatch.setenv(key, value)
    flight.reset_recorder()
    try:
        with pytest.raises(RuntimeError, match="induced worker failure"):
            elastic.run_elastic_training(
                lambda device: ranks.demo_workflow(device), backend="cpu",
                compression="")
    finally:
        flight.reset_recorder()
        from veles_tpu_torch.telemetry import tracing
        tracing.set_default_trace_id(None)
    records = [f for f in os.listdir(tmp_path / "flight")
               if "elastic_worker_failed" in f and f.endswith(".json")]
    assert len(records) == 1
    with open(tmp_path / "flight" / records[0]) as f:
        record = json.load(f)
    context = record.get("context", record)
    assert (context["generation"], context["rank"], context["job"],
            context["trace_id"]) == (3, 0, "job-7", "trace-7")
