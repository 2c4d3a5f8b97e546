"""The port's input pipeline and streamed training, on the CPU.

* ``PrefetchPipeline``: the unit cases of ``tests/test_prefetch.py``,
  each run on the JAX package's pipeline and on the port's (ordered and
  bounded, the depth bound under a slow consumer, a worker's exception
  at its index, ``close`` joining every thread, depth 0 inline, the
  ``VELES_PREFETCH`` depth, ``shutdown_all``).
* The planning functions equal the JAX package's on the same inputs and
  knobs: ``gather_rows`` (its -1 padding contract), ``local_indices``,
  ``plan_residency``, ``shard_batches``; ``take_rows`` (the pinned
  gather, numpy's take on one thread) bit for bit ``index_select``.
* ``StagingRing`` and ``HostRing`` on the CPU: slots reused in place, a
  short shard a view of a slot, placements refused after ``clear``.
* Streamed training of the small AlexNet: bit for bit the resident run
  (losses, confusion, parameters, velocity, gradient norms) over two
  epochs at depth 2 and 0, with one and several workers, a short tail;
  a worker's exception reaching the step loop; ``FusedRunner`` end to
  end with the epoch's input wait and starvation; and two epochs
  against JAX's streamed ``FusedTrainer`` (JAX's dropout uniforms handed
  over as ``tests/test_torch_train.py`` does; its tolerances: 1e-5 on
  each loss, 1e-6 on parameters and velocity).
"""

import threading
import time

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.loader import prefetch as jax_prefetch  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.loader import prefetch  # noqa: E402
from veles_tpu_torch.models.alexnet import (ALEXNET_TRAINING,  # noqa: E402
                                            SyntheticImageLoader,
                                            small_alexnet_layers)
from veles_tpu_torch.models.build import build_training  # noqa: E402

PACKAGES = {"jax": jax_prefetch, "port": prefetch}


def _threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("veles-prefetch")]


@pytest.fixture(autouse=True)
def _no_threads_left():
    yield
    prefetch.shutdown_all()
    jax_prefetch.shutdown_all()
    assert not _threads()


@pytest.fixture(params=sorted(PACKAGES))
def module(request):
    return PACKAGES[request.param]


# -- the pipeline -------------------------------------------------------------


def test_pipeline_ordered_and_bounded(module):
    in_flight, peak = [], [0]
    lock = threading.Lock()

    def produce(i):
        with lock:
            in_flight.append(i)
            peak[0] = max(peak[0], len(in_flight))
        time.sleep(0.002)
        with lock:
            in_flight.remove(i)
        return i * 10

    pipe = module.PrefetchPipeline(produce, 12, depth=2, workers=1,
                                   name="t").start()
    got = [pipe.get()[0] for _ in range(12)]
    pipe.close()
    assert got == [i * 10 for i in range(12)]
    assert peak[0] <= 2
    assert not _threads()


def test_pipeline_depth_bound_with_a_slow_consumer(module):
    produced = []
    pipe = module.PrefetchPipeline(lambda i: produced.append(i) or i, 10,
                                   depth=3, workers=2, name="t").start()
    time.sleep(0.1)
    assert len(produced) <= 3
    assert [pipe.get()[0] for _ in range(10)] == list(range(10))
    pipe.close()


def test_pipeline_worker_exception_at_its_index(module):
    def produce(i):
        if i == 2:
            raise ValueError("etl broke on shard 2")
        return i

    pipe = module.PrefetchPipeline(produce, 6, depth=2, workers=1,
                                   name="t").start()
    assert [pipe.get()[0] for _ in range(2)] == [0, 1]
    with pytest.raises(ValueError, match="shard 2"):
        pipe.get()
    assert not _threads()


def test_pipeline_close_joins_every_thread(module):
    release = threading.Event()

    def produce(i):
        release.wait(5)
        return i

    pipe = module.PrefetchPipeline(produce, 50, depth=4, workers=3,
                                   name="t").start()
    assert _threads()
    release.set()
    pipe.close()
    assert not _threads()


def test_pipeline_depth_zero_runs_inline(module):
    consumer = threading.current_thread()
    calls = []

    def produce(i):
        calls.append((i, threading.current_thread() is consumer))
        return i

    pipe = module.PrefetchPipeline(produce, 4, depth=0, name="t").start()
    assert not _threads()
    assert [pipe.get()[0] for _ in range(4)] == [0, 1, 2, 3]
    assert calls == [(i, True) for i in range(4)]
    pipe.close()


def test_pipeline_env_depth_and_workers(module, monkeypatch):
    for value, want in (("5", 5), ("0", 0), ("junk", 2), ("", 2)):
        monkeypatch.setenv("VELES_PREFETCH", value)
        assert module.default_depth() == want
    monkeypatch.setenv("VELES_PREFETCH_WORKERS", "3")
    assert module.default_workers() == 3
    monkeypatch.setenv("VELES_ETL_THROTTLE_MS", "7")
    assert module.etl_throttle_s() == pytest.approx(0.007)


def test_shutdown_all_closes_leaked_pipelines(module):
    pipe = module.PrefetchPipeline(lambda i: i, 100, depth=1, workers=1,
                                   name="leak").start()
    pipe.get()
    assert _threads()
    module.shutdown_all()
    assert not _threads()


# -- planning -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_gather_rows_and_local_indices_equal_jax(dtype):
    rng = numpy.random.RandomState(0)
    data = (rng.rand(9, 3, 2) * 100).astype(dtype)
    truth = numpy.arange(9, dtype=numpy.int32) * 100
    idx = numpy.array([[4, -1, 8], [0, 5, -1]], numpy.int32)
    want_rows, want_truth = jax_prefetch.gather_rows(data, truth, idx)
    rows, picked = prefetch.gather_rows(torch.from_numpy(data),
                                        torch.from_numpy(truth), idx)
    numpy.testing.assert_array_equal(rows.numpy(), want_rows)
    numpy.testing.assert_array_equal(picked.numpy(), want_truth)
    out = (torch.full((6, 3, 2), 7, dtype=getattr(torch, dtype)),
           torch.full((6,), 7, dtype=torch.int32))
    prefetch.gather_rows(data, truth, idx, out=out)
    numpy.testing.assert_array_equal(out[0].numpy(), want_rows)
    numpy.testing.assert_array_equal(out[1].numpy(), want_truth)
    numpy.testing.assert_array_equal(prefetch.local_indices(idx),
                                     jax_prefetch.local_indices(idx))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32",
                                   "int32", "uint8"])
@pytest.mark.parametrize("strided", [False, True])
def test_take_rows_equals_index_select(dtype, strided):
    rng = numpy.random.RandomState(1)
    bits = torch.from_numpy(rng.randint(0, 256, (40, 6, 5, 4), numpy.uint8))
    src = bits.view(getattr(torch, dtype))
    if strided:
        src = src[::2, :, 1:]
    index = torch.from_numpy(rng.randint(0, src.shape[0], 23)).long()
    want = torch.index_select(src, 0, index)
    out = torch.full((30,) + tuple(src.shape[1:]), 7, dtype=src.dtype)
    prefetch.take_rows(src, index, out[:23])
    assert torch.equal(out[:23].flatten().view(torch.uint8),
                       want.flatten().view(torch.uint8))
    assert torch.equal(out[23:], torch.full_like(out[23:], 7))


@pytest.mark.parametrize("env", [
    {}, {"VELES_DEVICE_BUDGET_MB": "1"}, {"VELES_DEVICE_BUDGET_MB": "0"},
    {"VELES_DEVICE_BUDGET_MB": "1", "VELES_STREAM": "0"},
    {"VELES_STREAM": "1"}, {"VELES_STREAM": "force"},
    {"VELES_STREAM": "maybe", "VELES_DEVICE_BUDGET_MB": "1"},
    {"VELES_SHARD_MB": "10"}, {"VELES_SHARD_MB": "0.5",
                               "VELES_PREFETCH": "4"},
])
def test_residency_planning_equals_jax(monkeypatch, env):
    for name in ("VELES_STREAM", "VELES_DEVICE_BUDGET_MB", "VELES_SHARD_MB",
                 "VELES_PREFETCH"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    # the CPU reports no budget in either package
    assert prefetch.device_budget_bytes("cpu") == \
        jax_prefetch.device_budget_bytes()
    for nbytes in (10.0, 0.5e6, 2e6, 1e15):
        for force in (None, True, False):
            assert prefetch.plan_residency(nbytes, "cpu", force) == \
                jax_prefetch.plan_residency(nbytes, force=force)
    for batch, depth, budget in ((1e6, 2, None), (1e6, 2, 8e6),
                                 (3e5, None, None), (5e7, 0, 4e8)):
        assert prefetch.shard_batches(batch, depth, budget) == \
            jax_prefetch.shard_batches(batch, depth, budget)


# -- the rings on the CPU -----------------------------------------------------


def test_staging_ring_reuses_slots_and_views_a_short_shard():
    ring = prefetch.StagingRing(2, "cpu")
    placed = []
    for n in (4, 4, 3):
        host = (torch.arange(n * 2.0).reshape(n, 2), torch.arange(n))
        staged = ring.place(host)
        tree = staged.wait()
        assert staged.ready is None and staged.started is None
        assert torch.equal(tree[0], host[0]) and torch.equal(tree[1], host[1])
        placed.append(tree[0])
        ring.release(staged)
    # the third placement refilled slot 0: a view of its first rows
    assert placed[2].data_ptr() == placed[0].data_ptr()
    assert ring.resident_bytes() == 2 * (4 * 2 * 4 + 4 * 8)
    ring.clear()
    assert ring.resident_bytes() == 0
    with pytest.raises(RuntimeError, match="closed"):
        ring.place((torch.zeros(1),))
    ring.reopen()
    ring.release(ring.place((torch.zeros(1),)))


def test_host_ring_reuses_buffers_unpinned_on_the_cpu():
    host = prefetch.HostRing(2, pin=False)
    a = host.buffers(0, [((4, 3), torch.float32), ((4,), torch.int32)])
    b = host.buffers(2, [((3, 3), torch.float32), ((3,), torch.int32)])
    assert b[0].data_ptr() == a[0].data_ptr() and b[0].shape == (3, 3)
    assert not a[0].is_pinned()
    c = host.buffers(4, [((8, 3), torch.float32), ((8,), torch.int32)])
    assert c[0].shape == (8, 3)


# -- streamed training --------------------------------------------------------


LOADER = dict(n_train=72, n_valid=24, side=32, n_classes=10,
              minibatch_size=16)


def _trainer(n_train=72, **residency):
    prng.get().seed(3)
    prng.get("loader").seed(4)
    loader = SyntheticImageLoader(**dict(LOADER, n_train=n_train))
    return build_training(small_alexnet_layers(10), (32, 32, 3), loader,
                          seed=1, device="cpu", **dict(ALEXNET_TRAINING,
                                                       **residency))


def _run(trainer, epochs=2):
    history = [trainer.run_epoch(e) for e in range(epochs)]
    trainer.shutdown()
    return history


def _assert_bitwise(a, b, history_a, history_b):
    for x, y in zip(history_a, history_b):
        for klass in ("validation", "train"):
            numpy.testing.assert_array_equal(x[klass]["losses"],
                                             y[klass]["losses"])
            assert x[klass]["metric"] == y[klass]["metric"]
        numpy.testing.assert_array_equal(x["validation"]["confusion"],
                                         y["validation"]["confusion"])
    for pa, pb in zip(a.params, b.params):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    for sa, sb in zip(a.states, b.states):
        if sa:
            for k in sa["velocity"]:
                assert torch.equal(sa["velocity"][k], sb["velocity"][k])
    assert torch.equal(a.last_grad_norms, b.last_grad_norms)


@pytest.mark.parametrize("depth,workers,n_train", [
    (2, 1, 72), (0, 1, 72), (3, 3, 72), (2, 1, 70)],
    ids=["depth2", "depth0", "three_workers", "short_tail"])
def test_streamed_equals_resident_bitwise(monkeypatch, depth, workers,
                                          n_train):
    monkeypatch.setenv("VELES_SHARD_MB", "0.05")
    resident = _trainer(n_train)
    want = _run(resident)
    streamed = _trainer(n_train, stream=True, prefetch_depth=depth,
                        prefetch_workers=workers)
    assert streamed.streaming and streamed.loader._staged_ is None
    assert streamed._batches_per_shard == 1
    assert len(streamed._shard_bounds(5)) == 5
    got = _run(streamed)
    _assert_bitwise(streamed, resident, got, want)
    assert streamed.input_wait_s > 0 and streamed.first_wait_s is not None
    assert len(streamed.shard_etl_ms) == 5


def test_budget_streams_and_the_planner_stays_resident_without_one(
        monkeypatch):
    monkeypatch.delenv("VELES_STREAM", raising=False)
    assert not _trainer().streaming
    monkeypatch.setenv("VELES_DEVICE_BUDGET_MB", "1")
    trainer = _trainer(n_train=304)
    # the 4.0 MB dataset streams; one minibatch a shard fits the budget's
    # four slots; the model state (over the budget too) stays in-core: a
    # streamed dataset wins over offload
    assert trainer.streaming and not trainer.offloaded
    assert trainer._batches_per_shard == 1e6 // 4 // (16 * (32 * 32 * 3 *
                                                            4 + 4)) == 1
    trainer.shutdown()


def test_streamed_worker_exception_reaches_the_step_loop(monkeypatch):
    monkeypatch.setenv("VELES_SHARD_MB", "0.05")
    trainer = _trainer(stream=True)
    calls = [0]
    real = prefetch.gather_rows

    def broken(data, truth, indices, out=None):
        calls[0] += 1
        if calls[0] >= 3:
            raise RuntimeError("disk fell over")
        return real(data, truth, indices, out)

    monkeypatch.setattr(
        "veles_tpu_torch.loader.fullbatch.gather_rows", broken)
    with pytest.raises(RuntimeError, match="disk fell over"):
        trainer.train_class()
    assert not _threads()
    trainer.shutdown()


def test_streamed_runner_end_to_end(monkeypatch):
    """``FusedRunner`` drives a streamed workflow: the decision's history
    equals the resident run's, each epoch's times carry the input wait
    and the starvation fraction, and no pipeline thread is left."""
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.alexnet import AlexNetWorkflow
    from veles_tpu_torch.train.runner import FusedRunner

    def run():
        prng.get().seed(3)
        prng.get("loader").seed(4)
        wf = AlexNetWorkflow(
            DummyLauncher(), layers=small_alexnet_layers(10),
            loader_factory=lambda w: SyntheticImageLoader(workflow=w,
                                                          **LOADER),
            max_epochs=2)
        wf.initialize(device="cpu")
        runner = FusedRunner(wf)
        runner.run()
        return wf, runner

    resident, _ = run()
    monkeypatch.setenv("VELES_STREAM", "1")
    monkeypatch.setenv("VELES_SHARD_MB", "0.1")
    streamed, runner = run()
    assert runner.trainer.streaming
    assert streamed.decision.epoch_history == \
        resident.decision.epoch_history
    for times in runner.epoch_times:
        assert times["input_wait_s"] > 0
        assert 0 < times["starvation"] <= 1
    assert not _threads()


def test_streamed_matches_jax_streamed_trainer(monkeypatch):
    """Two epochs of the port's streamed trainer against JAX's streamed
    ``FusedTrainer`` (shards of two minibatches in both)."""
    from veles_tpu.train import FusedTrainer as JaxFusedTrainer
    from test_torch_train import (_assert_runs_match, _jax_trainer,
                                  _port_trainer, _run_both)
    monkeypatch.setenv("VELES_SHARD_MB", "0.2")
    jt = _jax_trainer(stage_s2d=False)
    jt = JaxFusedTrainer(jt.workflow, stream=True)
    assert jt.streaming and jt._batches_per_shard == 2
    pt = _port_trainer(jt, stream=True)
    assert pt.streaming and pt._batches_per_shard == 2
    _assert_runs_match(*_run_both(jt, pt), pt)
    jt.shutdown()
    pt.shutdown()


def test_switch_interval_lowered_while_workers_run():
    import sys
    before = sys.getswitchinterval()
    first = prefetch.PrefetchPipeline(lambda i: i, 4, depth=1,
                                      name="s").start()
    second = prefetch.PrefetchPipeline(lambda i: i, 4, depth=1,
                                       name="s").start()
    assert sys.getswitchinterval() == min(before,
                                          prefetch.SWITCH_INTERVAL_S)
    first.close()
    assert sys.getswitchinterval() == min(before,
                                          prefetch.SWITCH_INTERVAL_S)
    second.close()
    second.close()
    assert sys.getswitchinterval() == before
    inline = prefetch.PrefetchPipeline(lambda i: i, 2, depth=0).start()
    assert sys.getswitchinterval() == before
    inline.close()
