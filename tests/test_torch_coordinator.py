"""The port's control plane (``veles_tpu_torch/parallel/coordinator.py``,
``telemetry/health.py``, ``telemetry/federation.py``, ``parallel/
nodes.py``): the cases of ``tests/test_coordinator.py``,
``tests/test_control_plane_security.py`` (the handshake's HMAC and the
frame caps), ``tests/test_federation.py`` and ``tests/test_nodes.py``
on the port's modules, in process (slaves as threads), plus a JAX
client served by the port's server and the reverse (the protocol is
one).

* checksum rejection, job farming, two slaves sharing the queue, a
  chaos death requeued, the same-host shared-memory path and
  ``wire.Chunks`` through it, segment growth slack, in-order epoch
  closing on the port's ``DecisionGD``;
* the mutual HMAC handshake (both refusals), forged proofs, the
  heartbeat channel's own challenge, frame and message caps;
* health scoring with hysteresis, the federation's delta merge over the
  heartbeat, a two-slave fleet's ``cluster_report`` with a silenced
  slave flagged straggler and ``slave_straggler`` firing;
* ``nodes`` against ``localhost`` only.

Every join and wait has its own timeout (60 s at most).
"""

import socket as socket_mod
import sys
import threading
import time

import numpy
import pytest

from veles_tpu_torch import prng
from veles_tpu_torch.parallel import coordinator as coord
from veles_tpu_torch.parallel import wire
from veles_tpu_torch.parallel.coordinator import (CoordinatorClient,
                                                  CoordinatorServer,
                                                  Protocol)
from veles_tpu_torch.telemetry import alerts, federation, health
from veles_tpu_torch.telemetry.registry import MetricsRegistry, get_registry


@pytest.fixture
def singletons():
    """Fresh port federation / health / alert singletons (the
    coordinator wires itself onto them), reset afterwards."""
    federation.reset_federation()
    health.reset_scorer()
    alerts.reset_engine()
    try:
        yield
    finally:
        federation.reset_federation()
        health.reset_scorer()
        alerts.reset_engine()


def _pair():
    a, b = socket_mod.socketpair()
    return Protocol(a), Protocol(b)


def _until(predicate, timeout=10.0, what="condition"):
    deadline = time.time() + timeout
    while not predicate():
        assert time.time() < deadline, what
        time.sleep(0.02)


# -- jobs --------------------------------------------------------------------

def test_handshake_checksum_mismatch_rejected_and_not_echoed():
    server = CoordinatorServer(checksum="top-secret-topology")
    try:
        with pytest.raises(ConnectionError, match="checksum"):
            CoordinatorClient(server.address, checksum="WRONG").connect()
        proto = Protocol(socket_mod.create_connection(server.address, 5.0))
        proto.send({"cmd": "handshake", "checksum": "WRONG", "nonce": "c"})
        reply = proto.recv()
        assert "error" in reply and "top-secret" not in str(reply)
        proto.close()
    finally:
        server.stop()


def test_job_farming_roundtrip():
    server = CoordinatorServer(checksum="c")
    try:
        server.submit(*[{"x": i} for i in range(10)])
        client = CoordinatorClient(server.address, checksum="c").connect()
        assert client.serve_forever(lambda job: job["x"] * 2,
                                    max_idle=3) == 10
        assert sorted(server.wait(10, timeout=10)) == list(range(0, 20, 2))
        assert len(client.job_log) == 10
        assert all(entry["wait_ms"] >= 0 and entry["result_ms"] >= 0
                   for entry in client.job_log)
    finally:
        server.stop()


@pytest.mark.parametrize("pipeline", [True, False])
def test_two_slaves_share_queue(pipeline):
    server = CoordinatorServer(checksum="c")
    try:
        server.submit(*list(range(20)))
        counts = {}

        def run(name):
            c = CoordinatorClient(server.address, checksum="c",
                                  pipeline=pipeline).connect()
            counts[name] = c.serve_forever(lambda j: j + 1, max_idle=5)

        threads = [threading.Thread(target=run, args=("s%d" % i,),
                                    daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert sorted(server.wait(20, timeout=10)) == list(range(1, 21))
        assert sum(counts.values()) == 20
    finally:
        server.stop()


def test_chaos_death_requeues_job():
    prng.get("chaos").seed(123)
    requeued = get_registry().counter(
        "veles_jobs_requeued_total",
        "In-flight jobs requeued after a slave was dropped",
        labels=("reason",))
    before = requeued.labels(reason="dead").value
    server = CoordinatorServer(checksum="c", heartbeat_timeout=0.5)
    try:
        server.submit(*list(range(5)))
        suicidal = CoordinatorClient(server.address, checksum="c",
                                     death_probability=1.0).connect()
        with pytest.raises(RuntimeError, match="chaos"):
            suicidal.serve_forever(lambda j: j, max_idle=3)
        healthy = CoordinatorClient(server.address, checksum="c").connect()
        healthy.serve_forever(lambda j: j, max_idle=30)
        assert sorted(server.wait(5, timeout=10)) == list(range(5))
        assert requeued.labels(reason="dead").value > before
    finally:
        server.stop()


def test_slave_registry_and_power():
    server = CoordinatorServer(checksum="c")
    try:
        client = CoordinatorClient(server.address, checksum="c",
                                   power=123.0).connect()
        client.heartbeat()
        slave = list(server.slaves.values())[0]
        assert slave.power == 123.0 and slave.id == client.id
        assert client.trace_id == server.trace_id
    finally:
        server.stop()


@pytest.mark.parametrize("direction", ["jax client", "jax server"])
def test_port_and_jax_coordinators_interoperate(direction, monkeypatch):
    """The protocol is one: a JAX client farms the port's server's
    jobs, and a port client the JAX server's, with array payloads (on
    socket frames: each package keeps its own record of the shared
    memory segments it owns)."""
    from veles_tpu.parallel import coordinator as jax_coord
    from veles_tpu.parallel import wire as jax_wire
    for module in (coord, jax_coord):
        monkeypatch.setattr(module, "_answer_same_host",
                            lambda proto, challenge:
                            {"cmd": "shm_proof", "proof": None})
    server_cls, client_cls, client_wire = (
        (CoordinatorServer, jax_coord.CoordinatorClient, jax_wire)
        if direction == "jax client" else
        (jax_coord.CoordinatorServer, CoordinatorClient, wire))
    server = server_cls(checksum="x")
    try:
        w = numpy.arange(40000, dtype=numpy.float32)
        server.submit({"blob": wire.encode({"w": w}, compress=False)})
        client = client_cls(server.address, checksum="x").connect()
        client.serve_forever(lambda job: {"blob": client_wire.encode_chunks(
            {"w": client_wire.decode(job["blob"])["w"] * 2})}, max_idle=3)
        out = wire.decode(server.wait(1, timeout=10)[0]["blob"])
        numpy.testing.assert_array_equal(out["w"], w * 2)
    finally:
        server.stop()


# -- the same-host path -------------------------------------------------------

def test_sharedio_fast_path_same_host():
    big = "x" * (256 * 1024)
    server = CoordinatorServer(checksum="c")
    try:
        server.submit({"blob": big}, {"blob": big + big})  # regrow path
        client = CoordinatorClient(server.address, checksum="c").connect()
        assert client.proto._shm_tx
        client.serve_forever(lambda job: {"blob": job["blob"] + "y"},
                             max_idle=3)
        results = server.wait(2, timeout=10)
        assert sorted(len(r["blob"]) for r in results) == \
            [256 * 1024 + 1, 512 * 1024 + 1]
        assert client.proto.shm_reads >= 1 and client.proto.shm_sends >= 1
        assert client.proto.shm_ms > 0
        assert all("shm_ms" in entry for entry in client.job_log)
    finally:
        server.stop()


def test_machine_id_is_the_hosts():
    """The same-host nomination reads one id in every process of the
    host, network card or not (``uuid.getnode()`` is random per process
    without one, which left every slave on socket frames)."""
    import subprocess
    other = subprocess.run(
        [sys.executable, "-c", "from veles_tpu_torch.parallel import "
         "coordinator; print(coordinator._machine_id())"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    assert other == coord._machine_id() and other


def test_spoofed_mid_does_not_enable_sharedio(monkeypatch):
    monkeypatch.setattr(coord, "_answer_same_host",
                        lambda proto, challenge:
                        {"cmd": "shm_proof", "proof": None})
    server = CoordinatorServer(checksum="c")
    try:
        client = CoordinatorClient(server.address, checksum="c").connect()
        assert not client.proto._shm_tx and not client.proto._shm_rx
        server.submit({"blob": "x" * (256 * 1024)})
        client.serve_forever(lambda job: {"n": len(job["blob"])},
                             max_idle=3)
        assert server.wait(1, timeout=10) == [{"n": 256 * 1024}]
        assert client.proto.shm_sends == 0
    finally:
        server.stop()


@pytest.mark.parametrize("sharedio", [True, False])
def test_chunks_ride_the_protocol(sharedio):
    tx, rx = _pair()
    if sharedio:
        tx.enable_sharedio()
        rx.enable_sharedio()
    # frames go through the socket pair's buffer, read after the send
    # returns: keep them under it
    shape = (300, 300) if sharedio else (32, 64)
    tree = {"w": numpy.random.RandomState(3).randn(*shape).astype("f4"),
            "meta": {"epoch": 1}}
    try:
        for _ in range(5):
            tx.send({"blob": wire.encode_chunks(tree)})
            out = wire.decode(rx.recv()["blob"])
            numpy.testing.assert_array_equal(out["w"], tree["w"])
        assert tx.shm_sends == (5 if sharedio else 0)
        assert tx.shm_regrows == 0
    finally:
        tx.close()
        rx.close()


def test_segment_growth_slack_and_inert_refs():
    tx, rx = _pair()
    tx.enable_sharedio()
    rx.enable_sharedio()
    small, bigger, too_big = (b"s" * (100 * 1024), b"b" * (110 * 1024),
                              b"B" * (200 * 1024))
    try:
        for blob in (small, small, bigger, bigger, small, small):
            tx.send({"payload": blob})
            assert rx.recv()["payload"] == blob
        assert tx.shm_regrows == 0
        for blob in (too_big, too_big):
            tx.send({"payload": blob})
            assert rx.recv()["payload"] == blob
        assert tx.shm_regrows == 2
        # a user dict shaped like a ref is escaped, never attached
        payload = {"__shm__": "psm_evil", "size": 1 << 40}
        tx.send({"p": payload})
        assert rx.recv() == {"p": payload} and rx.shm_reads == 8
    finally:
        tx.close()
        rx.close()
    tx, rx = _pair()   # sharedio never enabled on rx: refs are data
    try:
        tx.send({"payload": {"__shm__": "psm_evil", "size": 4}})
        assert rx.recv()["payload"] == {"__shm__": "psm_evil", "size": 4}
    finally:
        tx.close()
        rx.close()


def test_restore_rejects_out_of_bounds_refs():
    from multiprocessing import shared_memory
    seg = shared_memory.SharedMemory(create=True, size=64)
    try:
        for off, size in ((0, 65), (-1, 4), (60, 8), (0, -1)):
            with pytest.raises(ConnectionError, match="bounds"):
                Protocol._read_shm_ref({"__shm__": seg.name, "off": off,
                                        "size": size})
    finally:
        seg.close()
        seg.unlink()


def test_large_initial_data_survives_sharedio_handshake():
    blob = b"w" * (Protocol.SHM_THRESHOLD * 2)
    server = CoordinatorServer(checksum="c",
                               initial_data_source=lambda slave: blob)
    try:
        client = CoordinatorClient(server.address, checksum="c").connect()
        assert client.initial_data == blob and client.proto._shm_tx
    finally:
        server.stop()


# -- authentication and caps --------------------------------------------------

def test_authenticated_job_farming_roundtrip():
    server = CoordinatorServer(checksum="c", secret="hunter2")
    try:
        server.submit(*[{"x": i} for i in range(4)])
        client = CoordinatorClient(server.address, checksum="c",
                                   secret="hunter2").connect()
        assert client.serve_forever(lambda job: job["x"] + 1,
                                    max_idle=3) == 4
        assert sorted(server.wait(4, timeout=10)) == [1, 2, 3, 4]
    finally:
        server.stop()


@pytest.mark.parametrize("server_secret,client_secret,needle", [
    ("hunter2", None, "secret"), ("hunter2", "wrong", "mutual"),
    (None, "hunter2", "did not authenticate")])
def test_handshake_refusals(server_secret, client_secret, needle):
    server = CoordinatorServer(checksum="c", secret=server_secret)
    try:
        with pytest.raises(ConnectionError, match=needle):
            CoordinatorClient(server.address, checksum="c",
                              secret=client_secret).connect()
        if server_secret:   # a secretless master admits, then is refused
            assert not server.slaves
    finally:
        server.stop()


@pytest.mark.parametrize("hello", [
    {"cmd": "handshake", "checksum": "c", "nonce": "aa"},
    {"cmd": "hb_attach", "id": "whatever", "nonce": "bb"}])
def test_forged_proof_never_reaches_the_queue(hello):
    server = CoordinatorServer(checksum="c", secret="hunter2")
    try:
        proto = Protocol(socket_mod.create_connection(server.address, 5.0))
        proto.send(hello)
        assert "auth" in proto.recv()
        proto.send({"cmd": "auth", "proof": "f" * 64})
        assert proto.recv() == {"error": "authentication failed"}
        proto.close()
        assert not server.slaves
    finally:
        server.stop()


def test_max_frame_plumbed_per_connection(monkeypatch):
    monkeypatch.setattr(coord, "_answer_same_host",
                        lambda proto, challenge:
                        {"cmd": "shm_proof", "proof": None})
    server = CoordinatorServer(checksum="c", max_frame=1024 * 1024)
    try:
        client = CoordinatorClient(server.address, checksum="c",
                                   max_frame=4 * 1024 * 1024).connect()
        assert client.proto.MAX_FRAME == 4 * 1024 * 1024
        with pytest.raises((ConnectionError, OSError)):
            client.proto.send({"cmd": "result",
                               "data": {"b": b"z" * (2 * 1024 * 1024)}})
            client.proto.recv()
    finally:
        server.stop()


def test_frame_message_and_line_caps():
    tx, rx = _pair()
    try:
        tx._file.write(b'{"p": {"__bin__": 0}}\n')
        tx._file.write((Protocol.MAX_FRAME + 1).to_bytes(8, "big"))
        tx._file.flush()
        with pytest.raises(ConnectionError, match="oversized"):
            rx.recv()
    finally:
        tx.close()
        rx.close()
    tx, rx = _pair()
    rx.MAX_FRAME, rx.MAX_MESSAGE = 1024, 2048
    try:
        refs = ", ".join('"b%d": {"__bin__": %d}' % (i, i) for i in range(3))
        tx._file.write(("{%s}\n" % refs).encode())
        for _ in range(3):
            tx._file.write((1024).to_bytes(8, "big") + b"z" * 1024)
        tx._file.flush()
        with pytest.raises(ConnectionError, match="exceeds"):
            rx.recv()
    finally:
        tx.close()
        rx.close()
    tx, rx = _pair()
    rx.MAX_LINE = 4096
    try:
        tx._file.write(b"x" * 8192)
        tx._file.flush()
        with pytest.raises(ConnectionError, match="line exceeds"):
            rx.recv()
    finally:
        tx.close()
        rx.close()


def test_marker_shaped_user_dicts_roundtrip():
    tx, rx = _pair()
    try:
        for payload in ({"__bin__": 3}, {"__esc__": {"__bin__": 0}},
                        {"outer": {"__bin__": 1}, "real": b"bytes-too"}):
            tx.send({"p": payload})
            assert rx.recv() == {"p": payload}
    finally:
        tx.close()
        rx.close()


def test_nagle_off_on_tcp_sockets():
    server = CoordinatorServer(checksum="c")
    try:
        client = CoordinatorClient(server.address, checksum="c").connect()
        assert client.proto.sock.getsockopt(
            socket_mod.IPPROTO_TCP, socket_mod.TCP_NODELAY)
    finally:
        server.stop()


# -- the master's epoch accounting --------------------------------------------

def _decision(max_epochs=3):
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.nn.decision import DecisionGD
    d = DecisionGD(DummyWorkflow(), max_epochs=max_epochs)
    d.class_lengths = [0, 10, 20]
    d.epoch_number = 0
    return d


def _updates(epoch, loss=None):
    from veles_tpu_torch.loader.base import TRAIN, VALIDATION
    extra = {} if loss is None else {"loss": loss}
    return ([dict(klass=TRAIN, samples=10, metric=1.0, epoch=epoch,
                  last=False, epoch_ended=False, **extra)
             for _ in range(2)] +
            [dict(klass=VALIDATION, samples=10, metric=2.0, epoch=epoch,
                  last=True, epoch_ended=True, **extra)])


def test_epochs_close_in_order_despite_runahead_completion():
    d = _decision(max_epochs=3)
    d.apply_data_from_slave(_updates(0), slave=None)
    assert [h["epoch"] for h in d.epoch_history] == [0]
    d.epoch_number = 3
    d.apply_data_from_slave(_updates(2), slave=None)
    assert [h["epoch"] for h in d.epoch_history] == [0]
    assert not bool(d.complete) and not d.has_data_for_slave
    d.apply_data_from_slave(_updates(1), slave=None)
    assert [h["epoch"] for h in d.epoch_history] == [0, 1, 2]
    assert bool(d.complete)


def test_stop_epoch_cancels_parked_runahead_and_losses_average():
    d = _decision(max_epochs=2)
    d.apply_data_from_slave(_updates(0, loss=0.5), slave=None)
    d.epoch_number = 2
    d.apply_data_from_slave(_updates(2, loss=0.25), slave=None)
    d.apply_data_from_slave(_updates(1, loss=0.75), slave=None)
    assert [h["epoch"] for h in d.epoch_history] == [0, 1]
    assert bool(d.complete)
    assert d.epoch_history[0]["train"]["loss"] == 0.5
    assert d.epoch_history[1]["validation"]["loss"] == 0.75
    assert d.epoch_history[1]["train"]["normalized"] == 0.1
    # epochs past the stop never reopen a bucket
    d.apply_data_from_slave(_updates(3), slave=None)
    assert len(d.epoch_history) == 2


# -- health and federation ---------------------------------------------------

def test_health_scorer_hysteresis_against_jax():
    """Fed the same job times on the same clock, the port's scorer and
    the JAX package's flag the slow slave at the same evaluation (after
    ``job_streak`` slow jobs and ``enter_evals`` evaluations) and clear
    it the same way."""
    from veles_tpu.telemetry import health as jax_health
    from veles_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
    trails = []
    for scorer in (health.HealthScorer(registry=MetricsRegistry()),
                   jax_health.HealthScorer(registry=JaxRegistry())):
        states = []
        for step in range(16):
            slow = 10.0 if 3 <= step < 8 else 1.0
            for sid, ms in (("a", 1.0), ("b", 1.2), ("c", slow)):
                scorer.observe(sid, job_ms=ms * 100)
            scorer.evaluate(now=100.0 + step, force=True)
            states.append(scorer.table()["c"]["state"])
        trails.append(states)
    assert trails[0] == trails[1]
    assert "straggler" in trails[0] and trails[0][-1] == "healthy"


def test_federation_merge_resync_and_gc():
    slave_reg = MetricsRegistry()
    slave_reg.counter("veles_jobs_done_total", "jobs").inc(4)
    fed = federation.FederatedRegistry(registry=MetricsRegistry())
    enc = federation.SnapshotEncoder(registry=slave_reg)
    assert fed.apply("ab12", enc.encode()) in (None, {})
    snap = fed.merged_snapshot(MetricsRegistry())
    row = snap["counters"]["veles_jobs_done_total"]["series"][0]
    assert row["labels"] == {"slave": "ab12"} and row["value"] == 4.0
    counter = slave_reg.counter("veles_jobs_done_total", "jobs")
    counter.inc(1)
    enc.encode()                      # a lost delta: the next is a gap
    counter.inc(1)
    assert fed.apply("ab12", enc.encode()) == {"resync": True}
    enc.mark_resync()
    assert fed.apply("ab12", enc.encode()) == {}
    snap = fed.merged_snapshot(MetricsRegistry())
    assert snap["counters"]["veles_jobs_done_total"]["series"][0][
        "value"] == 6.0
    fed.remove_slave("ab12")
    assert not fed.slaves()


def test_heartbeat_piggyback_over_socket(singletons):
    get_registry().counter("veles_torch_fedtest_marker_total").inc(11)
    server = CoordinatorServer(checksum="f")
    client = None
    try:
        client = CoordinatorClient(server.address, checksum="f",
                                   heartbeat_interval=0.05).connect()
        sid = client.id

        def federated():
            snap = server.federation.merged_snapshot()
            series = snap["counters"].get(
                "veles_torch_fedtest_marker_total", {}).get("series", [])
            return any(s.get("labels", {}).get("slave") == sid and
                       s["value"] >= 11.0 for s in series)

        _until(federated, what="marker never federated")
        assert server.health.table()[sid]["state"] == "healthy"
    finally:
        if client is not None:
            client.close()
        server.stop()
    _until(lambda: not server.federation.slaves(),
           what="feed survived disconnect")


def _tiny_mnist(launcher, **kwargs):
    sys.path.insert(0, "tests")
    from test_mnist_e2e import synthetic_digits
    from veles_tpu_torch.models.mnist import MnistWorkflow
    prng.get().seed(42)
    prng.get("loader").seed(43)
    return MnistWorkflow(launcher, provider=synthetic_digits(), layers=(8,),
                         minibatch_size=60, max_epochs=1, **kwargs)


def test_two_slave_cluster_report_and_straggler(singletons):
    """A two-slave fleet: both in ``cluster_report`` with federated
    telemetry; silencing one's heartbeats flags it straggler within a
    few intervals and ``slave_straggler`` fires."""
    from veles_tpu_torch.launcher import Launcher
    master = Launcher(listen_address="127.0.0.1:0", heartbeat_timeout=30.0)
    _tiny_mnist(master)
    master.initialize()
    slaves = []
    try:
        port = master._server.address[1]
        for _ in range(2):
            slave = Launcher(master_address="127.0.0.1:%d" % port,
                             backend="cpu", heartbeat_interval=0.1)
            _tiny_mnist(slave)
            slave.initialize()
            slaves.append(slave)
        sids = sorted(s._client.id for s in slaves)

        def ready():
            report = federation.cluster_report()
            return sorted(report["slaves"]) == sids and all(
                e["state"] == "healthy" and e["telemetry"]
                for e in report["slaves"].values())

        _until(ready, timeout=20, what=federation.cluster_report())
        assert federation.cluster_report()["run"]["trace_id"] == \
            master._server.trace_id
        victim = slaves[1]._client
        victim._hb_stop.set()
        victim._hb_wake.set()
        _until(lambda: federation.cluster_report()["slaves"][victim.id][
            "state"] == "straggler", what="victim never flagged")

        def firing():
            gauge = get_registry().get("veles_alerts_active")
            return gauge is not None and {
                labels["rule"]: child.value
                for labels, child in gauge.series()}.get(
                "slave_straggler") == 1.0

        _until(firing, what="slave_straggler never fired")
    finally:
        for slave in slaves:
            slave.stop()
        master.stop()


# -- nodes, against localhost only --------------------------------------------

def test_parse_nodes_and_slave_command():
    from veles_tpu_torch.parallel.nodes import (parse_nodes,
                                                slave_command_from_argv)
    assert parse_nodes("a,b*3, c") == [("a", 1), ("b", 3), ("c", 1)]
    assert parse_nodes("") == []
    cmd = slave_command_from_argv(
        ["workflow.py", "-l", "0.0.0.0:5000", "--nodes", "localhost*2",
         "--respawn", "--exchange-dtype", "bfloat16", "--job-timeout",
         "30", "-a", "cpu"], ("master-host", 5000))
    parts = cmd.split()
    assert parts[:3] == [sys.executable, "-m", "veles_tpu_torch"]
    assert "-l" not in parts and "--nodes" not in parts
    assert "--respawn" not in parts and "--exchange-dtype" not in parts
    assert "-m master-host:5000" in cmd and "--job-timeout 30" in cmd
    assert "-a cpu" in cmd


def test_localhost_spawn_stop_and_respawn(tmp_path):
    from veles_tpu_torch.parallel.nodes import NodeLauncher
    launcher = NodeLauncher("localhost*3", "touch %s && sleep 30"
                            % (tmp_path / "ran_{index}"))
    launcher.start()
    try:
        _until(lambda: len(list(tmp_path.glob("ran_*"))) == 3)
        assert launcher.alive == 3
    finally:
        launcher.stop()
    assert launcher.alive == 0
    counter = tmp_path / "count"
    launcher = NodeLauncher("localhost", "echo run >> %s" % counter,
                            respawn=True, max_respawns=2)
    launcher.start()
    try:
        _until(lambda: counter.exists() and
               len(counter.read_text().splitlines()) >= 3, timeout=15)
        time.sleep(0.5)
        assert len(counter.read_text().splitlines()) == 3
    finally:
        launcher.stop()


def test_master_advertises_loopback_to_localhost_nodes(monkeypatch):
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.parallel import nodes as nodes_mod
    captured = {}

    class FakeNodeLauncher(object):
        def __init__(self, nodes, command, master_address=None,
                     respawn=False):
            captured.update(advertise=master_address, command=command,
                            respawn=respawn)

        def start(self):
            return self

        def stop(self):
            pass

    monkeypatch.setattr(nodes_mod, "NodeLauncher", FakeNodeLauncher)
    launcher = Launcher(listen_address="127.0.0.1:0", nodes="localhost",
                        respawn=True)
    _tiny_mnist(launcher)
    try:
        launcher.initialize()
        assert captured["advertise"][0] == "127.0.0.1"
        assert captured["respawn"]
        assert "-m 127.0.0.1:%d" % launcher._server.address[1] in \
            captured["command"]
    finally:
        launcher.stop()
