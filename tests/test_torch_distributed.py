"""Master/slave training on the port (``veles_tpu_torch/launcher.py``
``-l``/``-m``, ``train/segment.py``, the units' distribution hooks),
on the CPU (``-a cpu``), slaves as threads, held to the JAX package's.

``MnistWorkflow`` over the synthetic digits of ``tests/
test_mnist_e2e.py`` (``layers=(32,)``, 600 + 120 samples, minibatch 60,
lr 0.08), seeds 42/43, as ``tests/test_segment.py`` builds it.

* The port's master and one non-pipelined slave (``--segment-size 8``)
  against the JAX package's master and slave on the same seeds:
  ``epoch_history`` (samples and metric sums equal, normalized within
  1e-12) and the master's final weights within 6e-8 (the parameter
  reading of the CLI parity of ``tests/test_torch_workflow.py``; read:
  4.5e-8);
  against the port's own standalone run: the history equal, the
  weights within 6e-8 (a delta ``new - base`` added back to ``base``
  may round by an ulp), with a control that must fail -- the master
  drops the first layer's deltas.
* ``--eager`` slaves, ``--segment-size 1``, and the float32 and bf16
  delta exchange (``--exchange-dtype``): every epoch closes with exact
  sample counts, the eager and the one-minibatch runs within 6e-8 of
  the standalone run, float32 deltas within 6e-8, bf16 deltas within
  1e-4 (one bf16 rounding of each push's delta). Read: 3e-8 for the
  fused, eager and float32-delta fleets, 0 for one-minibatch jobs,
  4.3e-6 for bf16 deltas.
* Two pipelined slaves: exact per-epoch sample counts, both did jobs.
* A slave killed mid-epoch (``--segment-size 1 --no-pipeline``, the
  chaos stream's death on job 8): the per-epoch curve equal to the
  unfaulted run's bit for bit, ``veles_jobs_requeued_total{reason=
  "dead"}`` risen (``tests/test_fault_tolerance.py``).
* Straggler drop, a mid-run join (its first job's update equal to a
  resident slave's, bit for bit; an elastic join over sockets closing
  every epoch once), the master restarted with ``--auto-resume`` and a
  slave riding ``--reconnect-s``.
* A master initializes on the host, builds no kernel and creates no
  CUDA tensor (the card's functions made to raise); a slave without a
  card refuses unless given ``-a cpu``.
* In subprocesses through the CLI: a master and a slave train to the
  end, and neither loads ``jax``, ``ml_dtypes`` or any ``veles_tpu``
  module.

Every join has its own timeout (at most 60 s).
"""

import copy
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy
import pytest

from test_mnist_e2e import synthetic_digits

from veles_tpu import prng as jax_prng
from veles_tpu.launcher import Launcher as JaxLauncher
from veles_tpu.models.mnist import MnistWorkflow as JaxMnist
from veles_tpu_torch import prng
from veles_tpu_torch.convert import layer_params, to_jax_layout
from veles_tpu_torch.launcher import Launcher
from veles_tpu_torch.models.mnist import MnistWorkflow
from veles_tpu_torch.parallel.coordinator import (CoordinatorClient,
                                                  CoordinatorServer)
from veles_tpu_torch.telemetry import health
from veles_tpu_torch.telemetry.registry import get_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: parameters: the reading of the CLI parity (tests/test_torch_workflow)
WEIGHTS_ATOL = 6e-8
#: one bf16 rounding of each push's delta (read: 4.3e-6)
BF16_ATOL = 1e-4
JOIN_S = 60


def _port_wf(launcher, max_epochs=3, seed=42, **kwargs):
    prng.get().seed(seed)
    prng.get("loader").seed(seed + 1)
    return MnistWorkflow(launcher, provider=kwargs.pop(
        "provider", synthetic_digits()), layers=(32,), minibatch_size=60,
        learning_rate=0.08, max_epochs=max_epochs, **kwargs)


def _jax_wf(launcher, max_epochs=3, seed=42):
    jax_prng.get().seed(seed)
    jax_prng.get("loader").seed(seed + 1)
    return JaxMnist(launcher, provider=synthetic_digits(), layers=(32,),
                    minibatch_size=60, learning_rate=0.08,
                    max_epochs=max_epochs)


def _weights(wf):
    return [to_jax_layout(layer_params(fwd.module)) for fwd in wf.forwards]


def _jax_weights(wf):
    return [{k: numpy.asarray(a.map_read()) for k, a in
             fwd.param_arrays().items()} for fwd in wf.forwards]


def _assert_weights(got, want, atol):
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            numpy.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0)


def _assert_history(got, want):
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    for g, w in zip(got, want):
        for klass in ("validation", "train"):
            assert g[klass]["samples"] == w[klass]["samples"]
            assert g[klass]["metric"] == w[klass]["metric"]
            assert abs(g[klass]["normalized"] -
                       w[klass]["normalized"]) <= 1e-12


def _assert_counts(wf):
    lengths = wf.loader.class_lengths
    for h in wf.decision.epoch_history:
        assert h["validation"]["samples"] == lengths[1], h
        assert h["train"]["samples"] == lengths[2], h


def _run_threads(slaves):
    threads = [threading.Thread(target=s.run, daemon=True) for s in slaves]
    for t in threads:
        t.start()
    return threads


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "a slave outlived its join timeout"


def _fleet(n_slaves=1, segment_size=8, pipeline=False, eager=False,
           exchange_dtype=None, max_epochs=3, master_kw=None, patch=None):
    """The port's master and ``n_slaves`` CPU slaves in threads; returns
    (master workflow, master launcher, slave launchers)."""
    master = Launcher(listen_address="127.0.0.1:0",
                      segment_size=segment_size,
                      exchange_dtype=exchange_dtype, **(master_kw or {}))
    wf = _port_wf(master, max_epochs=max_epochs)
    master.initialize()
    if patch is not None:
        patch(wf)
    port = master._server.address[1]
    slaves = []
    for _ in range(n_slaves):
        slave = Launcher(master_address="127.0.0.1:%d" % port,
                         backend="cpu", pipeline=pipeline, eager=eager)
        _port_wf(slave, max_epochs=max_epochs)
        slave.initialize()
        slaves.append(slave)
    threads = _run_threads(slaves)
    master.run()
    _join(threads)
    return wf, master, slaves


def _standalone(max_epochs=3):
    launcher = Launcher(backend="cpu")
    wf = _port_wf(launcher, max_epochs=max_epochs)
    launcher.initialize()
    launcher.run()
    return wf, launcher


def _jax_fleet(segment_size=8):
    master = JaxLauncher(listen_address="127.0.0.1:0", graphics=False,
                         segment_size=segment_size)
    wf = _jax_wf(master)
    master.initialize()
    slave = JaxLauncher(master_address="127.0.0.1:%d" %
                        master._server.address[1], graphics=False,
                        pipeline=False)
    _jax_wf(slave)
    slave.initialize()
    threads = _run_threads([slave])
    master.run()
    _join(threads)
    return wf


@pytest.fixture(scope="module")
def standalone():
    return _standalone()


# -- parity ------------------------------------------------------------------

def test_port_fleet_matches_jax_fleet():
    """The same workflow under the JAX package's master and one
    non-pipelined slave, and under the port's: the same epochs and the
    same master weights."""
    jax_wf = _jax_fleet()
    wf, master, slaves = _fleet()
    _assert_history(wf.decision.epoch_history, jax_wf.decision.epoch_history)
    _assert_weights(_weights(wf), _jax_weights(jax_wf), WEIGHTS_ATOL)
    assert master.run_mode_used == "master"
    assert slaves[0].run_mode_used == "slave"
    assert slaves[0]._executor is not None and not slaves[0]._executor.eager


def test_port_fleet_matches_port_standalone(standalone):
    wf_alone, launcher = standalone
    wf, master, slaves = _fleet()
    _assert_history(wf.decision.epoch_history,
                    wf_alone.decision.epoch_history)
    _assert_weights(_weights(wf), _weights(wf_alone), WEIGHTS_ATOL)
    # each epoch's mean minibatch loss, from the slaves' stats, is the
    # runner's (summed in float64 here, float32 there)
    for h, times in zip(wf.decision.epoch_history,
                        launcher.runner.epoch_times):
        for klass in ("validation", "train"):
            assert abs(h[klass]["loss"] - times["loss"][klass]) <= \
                1e-6 * abs(times["loss"][klass])
    # the slave logged each job's exchange beside its compute
    log = slaves[0].job_log
    assert log and sum(e["batches"] for e in log) == 3 * 12
    for entry in log:
        assert entry["compute_ms"] > 0 and entry["bytes_in"] > 0
        assert {"decode_ms", "encode_ms", "wait_ms", "result_ms",
                "shm_ms"} <= set(entry)


def test_control_master_dropping_a_layers_delta_fails(standalone):
    """The control: a master that never adds the first layer's deltas
    keeps that layer at its initial weights, and the comparison above
    catches it."""
    wf_alone, _ = standalone

    def drop_first_delta(wf):
        gd = next(gd for gd in wf.gds if gd.forward is wf.forwards[0])
        gd.apply_data_from_slave = lambda data, slave=None: None

    wf, _, _ = _fleet(patch=drop_first_delta, max_epochs=1)
    with pytest.raises(AssertionError):
        _assert_weights(_weights(wf)[:1], _weights(wf_alone)[:1], 1e-3)


@pytest.mark.parametrize("mode", ["eager", "segment1", "float32",
                                  "bfloat16"])
def test_fleet_modes_against_standalone(standalone, mode):
    """``--eager`` slaves, one-minibatch jobs, and the delta exchange:
    exact sample counts, the same curve, weights within the mode's
    tolerance of the standalone run."""
    wf_alone, _ = standalone
    wf, master, _ = _fleet(
        eager=mode == "eager",
        segment_size=1 if mode == "segment1" else 8,
        exchange_dtype=mode if mode in ("float32", "bfloat16") else None)
    _assert_counts(wf)
    atol = BF16_ATOL if mode == "bfloat16" else WEIGHTS_ATOL
    _assert_weights(_weights(wf), _weights(wf_alone), atol)
    if mode != "bfloat16":
        _assert_history(wf.decision.epoch_history,
                        wf_alone.decision.epoch_history)
    sent = get_registry().get("veles_exchange_bytes_total")
    assert sum(child.value for labels, child in sent.series()
               if labels["direction"] == "to_slave") > 0


def _alexnet_wf(launcher, momentum=0.9):
    from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,
                                                SyntheticImageLoader,
                                                small_alexnet_layers)
    prng.get().seed(7)
    prng.get("loader").seed(8)
    return AlexNetWorkflow(
        launcher, layers=small_alexnet_layers(10), max_epochs=2,
        loader_factory=lambda wf: SyntheticImageLoader(
            workflow=wf, n_train=64, n_valid=16, side=32, n_classes=10,
            minibatch_size=16),
        learning_rate=0.01, momentum=momentum, weights_decay=5e-4)


@pytest.fixture(scope="module")
def alexnet_standalone():
    launcher = Launcher(backend="cpu")
    wf = _alexnet_wf(launcher)
    launcher.initialize()
    launcher.run()
    return wf


@pytest.mark.parametrize("segment_size", [8, 2, 1])
def test_dropout_masks_follow_the_epoch_not_the_segment(
        alexnet_standalone, segment_size):
    """The small AlexNet (dropout, momentum 0.9) under one non-pipelined
    slave: the standalone run's curve and weights within 6e-8 (read:
    4e-9, 2e-10 and 0) whether an epoch's 4 training minibatches come
    as one segment, two, or one job each: the slave addresses each
    epoch's dropout seed by its number and each minibatch's masks by its
    place in the epoch."""
    master = Launcher(listen_address="127.0.0.1:0",
                      segment_size=segment_size)
    wf = _alexnet_wf(master)
    master.initialize()
    slave = Launcher(master_address="127.0.0.1:%d" %
                     master._server.address[1], backend="cpu",
                     pipeline=False)
    _alexnet_wf(slave)
    slave.initialize()
    threads = _run_threads([slave])
    master.run()
    _join(threads)
    _assert_history(wf.decision.epoch_history,
                    alexnet_standalone.decision.epoch_history)
    _assert_weights(_weights(wf), _weights(alexnet_standalone),
                    WEIGHTS_ATOL)
    assert sum(e["train_batches"] for e in slave.job_log) == 2 * 4


def test_exchange_spans_counters_and_trace_id():
    """With tracing on: the master's ``exchange:encode`` /
    ``exchange:decode`` / ``exchange:merge`` / ``exchange:result`` and
    the slave's ``exchange:job`` / ``step:segment`` spans, every one
    under the run's trace id, and the exchange counters and histograms
    by slave."""
    from veles_tpu_torch.telemetry import tracing
    tracing.enable()
    tracing.get_buffer().clear()
    try:
        wf, master, slaves = _fleet(max_epochs=1)
        events = tracing.get_buffer().events()
    finally:
        tracing.disable()
        tracing.set_default_trace_id(None)
    names = {e["name"] for e in events}
    assert {"exchange:encode", "exchange:decode", "exchange:merge",
            "exchange:result", "exchange:job", "step:segment"} <= names
    trace_id = master._server.trace_id
    assert all(e["args"].get("trace_id") == trace_id for e in events
               if e["name"].startswith(("exchange:", "step:segment")))
    sid = slaves[0]._client.id
    registry = get_registry()
    bytes_by = {labels["direction"]: child.value for labels, child in
                registry.get("veles_exchange_bytes_total").series()
                if labels["slave"] == sid}
    assert bytes_by["to_slave"] > 0 and bytes_by["from_slave"] > 0
    for name in ("veles_exchange_encode_ms", "veles_exchange_decode_ms"):
        assert [child.count for labels, child in
                registry.get(name).series() if labels["slave"] == sid] \
            == [len(slaves[0].job_log)]


def test_two_pipelined_slaves_exact_counts():
    wf, master, slaves = _fleet(n_slaves=2, segment_size=2, pipeline=True,
                                max_epochs=4)
    assert [h["epoch"] for h in wf.decision.epoch_history] == [0, 1, 2, 3]
    _assert_counts(wf)
    assert all(s._client.jobs_done > 0 for s in slaves)
    train = [h["train"]["normalized"] for h in wf.decision.epoch_history]
    assert train[-1] < train[0]


def test_slave_without_a_card_refuses_unless_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    slave = Launcher(master_address="127.0.0.1:9")
    _port_wf(slave)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        slave.initialize()


# -- faults ------------------------------------------------------------------

def _kill_leg(fault, max_epochs=2):
    """300 + 60 samples at minibatch 60: 6 one-minibatch jobs an epoch,
    strictly sequential; with ``fault`` the chaos stream (seed 7) kills
    the slave on its 8th job, holding epoch 1's first train minibatch,
    and a fresh slave finishes the run."""
    provider = synthetic_digits(n_train=300, n_valid=60)
    prng.get("chaos").seed(7)
    master = Launcher(listen_address="127.0.0.1:0", segment_size=1,
                      heartbeat_timeout=1.0)
    wf = _port_wf(master, max_epochs=max_epochs, provider=provider)
    master.initialize()
    port = master._server.address[1]
    if fault:
        suicidal = Launcher(master_address="127.0.0.1:%d" % port,
                            backend="cpu", pipeline=False,
                            slave_death_probability=0.073)
        _port_wf(suicidal, max_epochs=max_epochs, provider=provider)
        suicidal.initialize()
        died = []

        def run_until_death():
            try:
                suicidal.run()
            except RuntimeError as e:
                assert "chaos death" in str(e)
                died.append(True)

        thread = threading.Thread(target=run_until_death, daemon=True)
        thread.start()
        _join([thread])
        assert died and suicidal._client.jobs_done == 7
    healthy = Launcher(master_address="127.0.0.1:%d" % port,
                       backend="cpu", pipeline=False)
    _port_wf(healthy, max_epochs=max_epochs, provider=provider)
    healthy.initialize()
    threads = _run_threads([healthy])
    master.run()
    _join(threads)
    return wf.decision.epoch_history, _weights(wf)


def test_kill_mid_epoch_curve_equals_unfaulted():
    requeued = get_registry().counter(
        "veles_jobs_requeued_total",
        "In-flight jobs requeued after a slave was dropped",
        labels=("reason",))
    before = requeued.labels(reason="dead").value
    reference, ref_weights = _kill_leg(fault=False)
    faulted, weights = _kill_leg(fault=True)
    assert [h["epoch"] for h in reference] == [0, 1]
    curve = [(h["epoch"], h["validation"]["normalized"],
              h["train"]["normalized"]) for h in faulted]
    assert curve == [(h["epoch"], h["validation"]["normalized"],
                      h["train"]["normalized"]) for h in reference]
    _assert_weights(weights, ref_weights, 0.0)
    assert requeued.labels(reason="dead").value > before


def test_straggler_drop_requeues_jobs():
    health.reset_scorer()
    requeued = get_registry().counter(
        "veles_jobs_requeued_total",
        "In-flight jobs requeued after a slave was dropped",
        labels=("reason",))
    before = requeued.labels(reason="straggler").value
    server = CoordinatorServer(checksum="s", straggler_drop_s=0.0,
                               heartbeat_timeout=30.0)
    try:
        server.submit({"x": 1})
        victim = CoordinatorClient(server.address, checksum="s").connect()
        victim.proto.send({"cmd": "job"})
        assert victim.proto.recv()["job"] == {"x": 1}
        scorer = server.health
        scorer.observe(victim.id, beat=True)
        with scorer._lock:
            st = scorer._slaves[victim.id]
            st.state = "straggler"
            st.since = time.monotonic() - 10.0
        deadline = time.time() + 10
        while victim.id in server.slaves and time.time() < deadline:
            time.sleep(0.05)
        assert victim.id not in server.slaves
        assert requeued.labels(reason="straggler").value == before + 1
        healthy = CoordinatorClient(server.address, checksum="s").connect()
        healthy.serve_forever(lambda job: job["x"] * 10, max_idle=10)
        assert server.wait(1, timeout=10) == [10]
        victim.close()
        healthy.close()
    finally:
        server.stop()
        health.reset_scorer()


def test_prng_dump_restore_continues_streams():
    gen = prng.get("ft-test")
    gen.seed(123)
    gen.rand()
    states = prng.dump_states()
    expect = [gen.rand() for _ in range(3)] + [gen.philox_seed()]
    prng.restore_states(states)
    gen = prng.get("ft-test")
    assert [gen.rand() for _ in range(3)] + [gen.philox_seed()] == expect


def test_mid_run_join_first_job_bit_consistent():
    """A slave joining mid-run gets the full-push resync (weights,
    cursors, random streams) in its handshake: its first job's update
    equals a resident slave's, bit for bit, though it was built from
    other seeds."""
    master = Launcher(listen_address="127.0.0.1:0")
    wf_master = _port_wf(master, max_epochs=4)
    wf_master.initialize(device="cpu")
    wf_master.stopped = False
    resident = _port_wf(Launcher(master_address="127.0.0.1:1"), 4)
    resident.initialize(device="cpu")
    for _ in range(5):
        job = wf_master.generate_data_for_slave("resident")
        wf_master.apply_data_from_slave(resident.do_job(
            copy.deepcopy(job)), "resident")
    joiner = _port_wf(Launcher(master_address="127.0.0.1:1"), 4, seed=777)
    joiner.initialize(device="cpu")
    joiner.apply_initial_data_from_master({
        "units": wf_master.generate_initial_data_for_slave("joiner"),
        "resync": wf_master.generate_resync_for_slave("joiner")})
    assert joiner.loader.epoch_number == wf_master.loader.epoch_number
    job = wf_master.generate_data_for_slave("joiner")
    got = joiner.do_job(copy.deepcopy(job))
    want = resident.do_job(copy.deepcopy(job))
    compared = 0
    for (name_w, pay_w), (name_g, pay_g) in zip(want, got):
        assert name_w == name_g
        if name_w == wf_master.loader.name:
            continue
        if isinstance(pay_w, dict) and any(
                isinstance(v, numpy.ndarray) for v in pay_w.values()):
            for key in pay_w:
                assert pay_w[key].tobytes() == pay_g[key].tobytes()
                compared += 1
        else:
            assert pay_w == pay_g, name_w
            compared += 1
    assert compared >= 5


def test_elastic_join_counts_and_completes():
    joins = get_registry().counter("veles_slave_joins_total",
                                   "Successful slave handshakes",
                                   labels=("kind",))
    mid_before = joins.labels(kind="mid_run").value
    master = Launcher(listen_address="127.0.0.1:0", segment_size=2)
    wf = _port_wf(master, max_epochs=3)
    master.initialize()
    port = master._server.address[1]
    first = Launcher(master_address="127.0.0.1:%d" % port, backend="cpu")
    _port_wf(first, max_epochs=3)
    first.initialize()
    threads = _run_threads([first])
    deadline = time.time() + JOIN_S
    while not master._server._jobs_handed and time.time() < deadline:
        time.sleep(0.02)
    assert master._server._jobs_handed
    late = Launcher(master_address="127.0.0.1:%d" % port, backend="cpu")
    _port_wf(late, max_epochs=3)
    late.initialize()
    threads += _run_threads([late])
    master.run()
    _join(threads)
    assert [h["epoch"] for h in wf.decision.epoch_history] == [0, 1, 2]
    _assert_counts(wf)
    assert joins.labels(kind="mid_run").value > mid_before


def test_master_restart_auto_resume(tmp_path):
    """The master snapshots each closed epoch into ``--auto-resume``'s
    directory, dies, and a master restarted on the same port restores
    the newest snapshot; the slave re-handshakes within
    ``--reconnect-s`` and every epoch closes exactly once."""
    snapdir = str(tmp_path / "snaps")
    master1 = Launcher(listen_address="127.0.0.1:0", auto_resume=snapdir,
                       heartbeat_timeout=2.0, segment_size=2)
    _port_wf(master1, max_epochs=4)
    master1.initialize()
    port = master1._server.address[1]
    slave = Launcher(master_address="127.0.0.1:%d" % port, backend="cpu",
                     reconnect_s=60.0)
    _port_wf(slave, max_epochs=4)
    slave.initialize()
    threads = _run_threads([slave])
    deadline = time.time() + JOIN_S
    while master1._last_snap_epochs < 1 and time.time() < deadline:
        time.sleep(0.05)
    assert master1._last_snap_epochs >= 1
    master1._server.stop()     # the crash: no drain, no goodbye
    master2 = Launcher(listen_address="127.0.0.1:%d" % port,
                       auto_resume=snapdir, heartbeat_timeout=2.0,
                       segment_size=2)
    _port_wf(master2, max_epochs=4)
    master2.initialize()
    assert master2._resumed_from
    wf2 = master2.workflow
    master2.run()
    _join(threads)
    assert slave._client.reconnects >= 1
    assert [h["epoch"] for h in wf2.decision.epoch_history] == [0, 1, 2, 3]
    _assert_counts(wf2)
    assert get_registry().get("veles_recovery_ms").labels(
        event="restore").count >= 1


# -- the master has no device -------------------------------------------------

def test_master_builds_no_kernel_and_creates_no_cuda_tensor(monkeypatch):
    """With the card reported present and every kernel build and CUDA
    initialization made to raise, a master (``-a`` left at ``auto``)
    initializes on the host and serves a whole run to a CPU slave."""
    import torch
    from veles_tpu_torch.ops import build

    def refuse(*args, **kwargs):
        raise AssertionError("the master touched the card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    for name in ("library", "function", "binding", "launch"):
        monkeypatch.setattr(build, name, refuse)
    master = Launcher(listen_address="127.0.0.1:0", segment_size=4)
    wf = _port_wf(master, max_epochs=2)
    master.initialize()
    assert master.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for fwd in wf.forwards
               for p in layer_params(fwd.module).values())
    slave = Launcher(master_address="127.0.0.1:%d" %
                     master._server.address[1], backend="cpu")
    _port_wf(slave, max_epochs=2)
    slave.initialize()
    threads = _run_threads([slave])
    master.run()
    _join(threads)
    assert [h["epoch"] for h in wf.decision.epoch_history] == [0, 1]
    assert getattr(wf.loader, "_staged_", None) is None


# -- through the CLI, in processes of their own -------------------------------

WORKFLOW_FILE = '''
import numpy

from veles_tpu_torch.models.mnist import MnistWorkflow


class Digits(object):
    def __call__(self):
        rng = numpy.random.RandomState(3)
        protos = rng.rand(10, 144) * 2 - 1

        def make(n):
            y = rng.randint(0, 10, n).astype(numpy.int32)
            x = (protos[y] + rng.normal(0, 0.35, (n, 144))).astype(
                numpy.float32)
            return x.reshape(n, 12, 12), y

        tx, ty = make(240)
        vx, vy = make(60)
        return tx, ty, vx, vy


def run(load, main):
    load(MnistWorkflow, provider=Digits(), layers=(16,), minibatch_size=60,
         learning_rate=0.08, max_epochs=2)
    main()
'''

DRIVER = '''
import json, sys
from veles_tpu_torch.__main__ import main
rc = main(sys.argv[1:])
bad = sorted(m for m in sys.modules if m in ("jax", "ml_dtypes", "veles_tpu")
             or m.startswith(("jax.", "ml_dtypes.", "veles_tpu.")))
print("RESULT " + json.dumps({"rc": rc, "bad": bad}))
'''


def _free_port():
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def test_cli_master_and_slave_processes_load_no_jax(tmp_path):
    path = tmp_path / "digits.py"
    path.write_text(WORKFLOW_FILE)
    result = tmp_path / "result.json"
    address = "127.0.0.1:%d" % _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, VELES_CONNECT_RETRY_S="60",
               CUDA_VISIBLE_DEVICES="", VELES_DATASET_CACHE="0")
    common = [sys.executable, "-c", DRIVER, str(path), "-s", "7"]
    master = subprocess.Popen(
        common + ["-l", address, "--segment-size", "2", "--result-file",
                  str(result)], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    slave = subprocess.Popen(
        common + ["-m", address, "-a", "cpu", "--no-pipeline"], env=env,
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    outs = []
    try:
        for proc in (slave, master):
            out, err = proc.communicate(timeout=JOIN_S)
            outs.append((proc.returncode, out.decode(), err.decode()))
    finally:
        for proc in (slave, master):
            if proc.poll() is None:
                proc.kill()
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
        report = json.loads(line[len("RESULT "):])
        assert report == {"rc": 0, "bad": []}, (report, err[-2000:])
    assert json.load(open(result))["epochs"] == 2
