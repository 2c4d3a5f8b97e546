"""The port's telemetry plane (``veles_tpu_torch/telemetry``) against the
JAX package's (``veles_tpu/telemetry``), on the CPU.

Each test feeds both packages the same calls, made from a seed, and
compares what comes out:

* the registry: snapshot JSON and Prometheus text byte for byte, for a
  random sequence of counter, gauge and histogram calls with labels
  that need escaping and reservoirs that overflow; the registry's own
  semantics (label conflicts, ``remove``) on both;
* tracing: Chrome export, nesting, the dump's merge, trace ids from a
  request, the shared no-op of a disabled span;
* history: ``SeriesStore`` points after same-bucket overwrites,
  downsampling, retention and the series cap;
* alerts: ``AlertEngine.evaluate(now=...)`` transitions and the
  ``/alerts.json`` rules for each rule kind and for ``DEFAULT_RULES``;
* the profiler: ``CostBook.report()`` and the step MFU for the same noted
  costs and times with and without ``VELES_PEAK_TFLOPS`` /
  ``VELES_HBM_GBPS``, the phases, the CPU memory sample, and AlexNet-227's
  analytic FLOPs a training sample against ``bench.py``'s accounting of
  the JAX workflow (6.835 GFLOP);
* the flight recorder: the same trips (epoch, batch, reason) for the same
  loss and gradient-norm vectors, and the stall watchdog under a fake
  clock;
* the CLI: ``--trace-out`` on a small MnistWorkflow, fused and eager,
  beside the JAX CLI's trace of the same file.

Tolerances: none -- every comparison is exact (the same float64
arithmetic in the same order), apart from wall-clock fields, which are
left out.
"""

import json
import os
import time
import types

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu.telemetry import alerts as jax_alerts  # noqa: E402
from veles_tpu.telemetry import flight as jax_flight  # noqa: E402
from veles_tpu.telemetry import profiler as jax_profiler  # noqa: E402
from veles_tpu.telemetry import registry as jax_registry  # noqa: E402
from veles_tpu.telemetry import timeseries as jax_timeseries  # noqa: E402
from veles_tpu.telemetry import tracing as jax_tracing  # noqa: E402
from veles_tpu_torch.telemetry import alerts, flight, profiler  # noqa
from veles_tpu_torch.telemetry import registry, timeseries  # noqa: E402
from veles_tpu_torch.telemetry import tracing  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (JAX module, port module) per telemetry module
PAIRS = {"registry": (jax_registry, registry),
         "tracing": (jax_tracing, tracing),
         "timeseries": (jax_timeseries, timeseries),
         "alerts": (jax_alerts, alerts),
         "flight": (jax_flight, flight),
         "profiler": (jax_profiler, profiler)}

#: the one DEFAULT_RULES rule whose text the port cuts short: JAX's ends
#: with a pointer into the JAX package's history
CUT_RULE = "spmd_participant_lost"


def _jax_rules_as_ported(rules):
    """JAX's rule dicts with ``CUT_RULE``'s description the port's, once
    that is shown to be JAX's cut short."""
    ported = {r["name"]: r for r in alerts.DEFAULT_RULES}[CUT_RULE]
    out = []
    for rule in rules:
        rule = dict(rule)
        if rule["name"] == CUT_RULE:
            assert rule["description"].startswith(ported["description"])
            assert len(rule["description"]) < len(ported["description"]) + 20
            rule["description"] = ported["description"]
        out.append(rule)
    return out


@pytest.fixture(autouse=True, scope="module")
def _stop_port_threads():
    yield
    alerts.reset_engine()
    flight.reset_recorder()
    profiler.stop_memory_sampler()
    timeseries.reset_history()
    tracing.disable()


# -- the registry -------------------------------------------------------------

def _drive_registry(module, seed):
    """A seeded sequence of registry calls; returns the registry."""
    rng = numpy.random.RandomState(seed)
    reg = module.MetricsRegistry()
    labels = ['/a"b\\c', "line\nbreak", "plain", "x" * 3]
    c = reg.counter("veles_t_requests_total", "total\nrequests",
                    labels=("route", "code"))
    g = reg.gauge("veles_t_depth", "queue depth")
    lg = reg.gauge("veles_t_load", "", labels=("replica",))
    h = reg.histogram("veles_t_lat_ms", "latency", labels=("u",),
                      reservoir_size=int(rng.randint(3, 40)))
    plain = reg.histogram("veles_t_plain_ms", "unlabeled")
    for _ in range(int(rng.randint(50, 200))):
        op = rng.randint(7)
        if op == 0:
            c.labels(route=labels[rng.randint(4)],
                     code=int(rng.choice([200, 503]))).inc(
                int(rng.randint(1, 4)))
        elif op == 1:
            g.set(float(rng.randn()))
        elif op == 2:
            g.inc(float(rng.rand()))
        elif op == 3:
            lg.labels(replica=int(rng.randint(3))).dec(float(rng.rand()))
        elif op == 4:
            h.labels(u=labels[rng.randint(4)]).observe(
                float(rng.exponential(10.0)))
        elif op == 5:
            plain.observe(float(rng.rand() * 1e3))
        else:
            lg.remove(replica=int(rng.randint(3)))
    return reg


@pytest.mark.parametrize("seed", range(4))
def test_registry_renderings_byte_equal(seed):
    want = _drive_registry(jax_registry, seed)
    got = _drive_registry(registry, seed)
    assert json.dumps(got.snapshot()) == json.dumps(want.snapshot())
    assert got.render_prometheus() == want.render_prometheus()
    assert registry.render_snapshot(want.snapshot()) == \
        jax_registry.render_snapshot(want.snapshot())


@pytest.mark.parametrize("package", ["jax", "port"])
def test_registry_semantics(package):
    module = PAIRS["registry"][package == "port"]
    assert module.percentile([], 50) == 0.0
    assert module.percentile(sorted(float(i) for i in range(1, 101)),
                             50) == 51.0
    reg = module.MetricsRegistry()
    c = reg.counter("thing_total", labels=("a", "b"))
    assert reg.counter("thing_total", labels=("a", "b")) is c
    with pytest.raises(ValueError):
        reg.gauge("thing_total")
    with pytest.raises(ValueError):
        reg.counter("thing_total", labels=("b",))
    with pytest.raises(ValueError):
        reg.counter("bad name")
    with pytest.raises(ValueError):
        c.labels(a=1)
    with pytest.raises(ValueError):
        c.inc()
    for a in range(3):
        for b in range(2):
            c.labels(a=a, b=b).inc()
    assert c.remove(a=1) == 2
    with pytest.raises(ValueError):
        c.remove(z=1)
    assert sorted((lab["a"], lab["b"]) for lab, _ in c.series()) == [
        ("0", "0"), ("0", "1"), ("2", "0"), ("2", "1")]


# -- tracing ------------------------------------------------------------------

@pytest.fixture
def buffers():
    """A fresh enabled buffer in each package; both disabled after."""
    bufs = (jax_tracing.TraceBuffer(), tracing.TraceBuffer())
    jax_tracing.enable(buffer=bufs[0])
    tracing.enable(buffer=bufs[1])
    try:
        yield bufs
    finally:
        for module in (jax_tracing, tracing):
            module.disable()
            module.set_default_trace_id(None)


def _trace_calls(module):
    with module.span("outer", kind="test"):
        time.sleep(0.002)
        with module.span("inner"):
            time.sleep(0.001)
    with module.request_span("http:/api", trace_id="req-123"):
        with module.span("nested"):
            pass
    with module.span("after"):
        pass
    module.set_default_trace_id("run-7")
    module.add_complete("done", time.perf_counter(), 0.001, step=3)
    module.set_default_trace_id(None)


def _shape(events):
    """The events without their clocks, pids and thread ids."""
    return [(e["name"], e["ph"], e["args"]) for e in events]


def test_tracing_events_follow_jax(buffers, tmp_path):
    for module in (jax_tracing, tracing):
        _trace_calls(module)
    want, got = (b.events() for b in buffers)
    assert _shape(got) == _shape(want)
    spans = {e["name"]: e for e in got}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1
    assert abs(outer["ts"] / 1e6 - time.time()) < 60  # wall-clock µs
    chrome = buffers[1].to_chrome(process_name="pytest")
    assert chrome["traceEvents"][0] == {
        "name": "process_name", "ph": "M", "pid": os.getpid(), "tid": 0,
        "args": {"name": "pytest"}}
    assert chrome["displayTimeUnit"] == "ms"


def test_trace_dump_merges_an_existing_file(buffers, tmp_path):
    """A second writer merges into the file (JAX's writer first, then
    the port's), and the result loads."""
    path = str(tmp_path / "trace.json")
    with jax_tracing.span("first"):
        pass
    buffers[0].dump(path)
    with tracing.span("second"):
        pass
    n = buffers[1].dump(path, process_name="port")
    events = json.load(open(path))["traceEvents"]
    assert n == len(events) == 3
    assert {e["name"] for e in events} == {"first", "second",
                                          "process_name"}


def test_trace_ids_from_requests():
    for module in (jax_tracing, tracing):
        assert module.trace_id_from_request({"X-Request-Id": "a"}, 5) == "a"
        assert module.trace_id_from_request({}, 5) == "5"
        assert module.trace_id_from_request(None, None) is None


def test_disabled_span_is_the_shared_noop():
    assert not tracing.enabled()
    assert tracing.span("idle") is tracing.span("other", x=1)
    with tracing.request_span("http:/api", trace_id="x"):
        pass
    assert len(tracing.get_buffer()) == 0 or \
        "http:/api" not in {e["name"] for e in tracing.get_buffer().events()}
    # the least of many short batches: on a loaded machine a batch a
    # few milliseconds long is likelier to run unpreempted than a long
    # one, and the bound is on the span's own cost
    best = float("inf")
    for _ in range(30):
        start = time.perf_counter()
        for _ in range(1000):
            with tracing.span("idle"):
                pass
        best = min(best, (time.perf_counter() - start) / 1000)
    assert best < 5e-6, "disabled span costs %.2f us" % (best * 1e6)


# -- history ------------------------------------------------------------------

def _drive_history(module, seed):
    rng = numpy.random.RandomState(seed)
    reg = (jax_registry if module is jax_timeseries else
           registry).MetricsRegistry()
    store = module.SeriesStore(resolution_s=0.5, max_points=8,
                               retention_s=30.0, max_series=5,
                               registry=reg)
    now = 1000.0
    for _ in range(150):
        now += float(rng.choice([0.1, 0.4, 0.9, 2.5]))
        name = "veles_t_%d" % rng.randint(4)
        labels = {"model": "m%d" % rng.randint(3)}
        t = now - (5.0 if rng.rand() < 0.05 else 0.0)  # out of order
        store.record(name, labels, float(rng.randn()), now=t)
    snap = reg.snapshot()
    src = (jax_registry if module is jax_timeseries else
           registry).MetricsRegistry()
    src.gauge("veles_t_depth", labels=("model",)).labels(
        model="a").set(3.0)
    src.counter("veles_sched_job_x_total").inc()
    store.ingest(src.snapshot(), now=now + 1.0)
    return store, reg, snap, now


@pytest.mark.parametrize("seed", range(3))
def test_series_store_gives_jax_points(seed):
    want, want_reg, want_snap, now = _drive_history(jax_timeseries, seed)
    got, got_reg, got_snap, _ = _drive_history(timeseries, seed)
    for query in ({}, {"series": "veles_t_1"}, {"since": now - 10.0},
                  {"series": "veles_t", "since": now - 3.0}):
        assert got.query(now=now, **query) == want.query(now=now, **query)
    assert got_snap == want_snap
    assert got_reg.snapshot() == want_reg.snapshot()
    assert got.series_count() == want.series_count()


# -- alerts -------------------------------------------------------------------

KIND_RULES = {
    "threshold": [{"name": "p95", "metric": "veles_t_lat_ms",
                   "field": "p95", "agg": "max", "op": ">",
                   "threshold": 50.0, "for_s": 2.0, "clear_for_s": 3.0}],
    "increase": [{"name": "trips", "kind": "increase",
                  "metric": "veles_t_trips_total",
                  "labels": {"detector": "nan"}, "window_s": 5.0,
                  "threshold": 1.0, "clear_for_s": 4.0}],
    "burn_rate": [{"name": "burn", "kind": "burn_rate",
                   "numerator": "veles_t_bad_total",
                   "denominator": "veles_t_all_total", "objective": 0.05,
                   "windows": [[4.0, 2.0], [8.0, 1.5]]}],
}


def _feed(reg, t, rng):
    """One tick of series values, from ``rng``."""
    burst = 20 <= t % 60 < 35
    h = reg.histogram("veles_t_lat_ms", labels=("endpoint",),
                      reservoir_size=8)
    for _ in range(3):
        h.labels(endpoint="/api").observe(
            float(rng.exponential(80.0 if burst else 10.0)))
    if rng.rand() < (0.6 if burst else 0.02):
        reg.counter("veles_t_trips_total", labels=("detector",)).labels(
            detector="nan").inc()
    reg.counter("veles_t_all_total").inc(10)
    reg.counter("veles_t_bad_total").inc(int(rng.binomial(
        10, 0.5 if burst else 0.01)))
    # the default rules' series
    lat = reg.histogram("veles_serving_latency_ms", labels=("endpoint",))
    lat.labels(endpoint="/api").observe(
        float(rng.exponential(900.0 if burst else 20.0)))
    reg.gauge("veles_serving_queue_depth", labels=("model",)).labels(
        model="m").set(100.0 if burst else float(rng.randint(5)))
    reg.counter("veles_serving_requests_total", labels=("endpoint",
                                                        "status")).labels(
        endpoint="/api", status="200").inc(10)
    reg.counter("veles_serving_rejected_total", labels=("model",)).labels(
        model="m").inc(int(rng.binomial(10, 0.6 if burst else 0.0)))
    reg.gauge("veles_serving_cache_hit_ratio", labels=("model",)).labels(
        model="m").set(0.01 if burst else 0.8)
    if burst and rng.rand() < 0.5:
        reg.counter("veles_autoscale_transitions_total",
                    labels=("model", "direction")).labels(
            model="m", direction="up").inc()
    reg.gauge("veles_input_starvation_fraction", labels=("phase",)).labels(
        phase="epoch").set(0.9 if burst else 0.1)
    if burst and rng.rand() < 0.2:
        reg.counter("veles_flight_detector_trips_total",
                    labels=("detector",)).labels(
            detector="non_finite_loss").inc()


def _alert_run(package, rules, seed):
    rng = numpy.random.RandomState(seed)
    module = PAIRS["alerts"][package == "port"]
    reg = PAIRS["registry"][package == "port"].MetricsRegistry()
    engine = module.AlertEngine(registry=reg, rules=rules)
    for tick in range(120):
        now = 5000.0 + tick * 0.5
        _feed(reg, now - 5000.0, rng)
        engine.evaluate(now=now, force=True)
    report = engine.report(evaluate=False)
    del report["generated_t"]
    for record in report["transitions"]:
        del record["t"]
    return report, engine.active(), reg.snapshot()["gauges"].get(
        "veles_alerts_active")


@pytest.mark.parametrize("kind", sorted(KIND_RULES) + ["defaults"])
def test_alert_transitions_follow_jax(kind):
    rules = KIND_RULES.get(kind)        # None: DEFAULT_RULES
    want = _alert_run("jax", rules, 11)
    got = _alert_run("port", rules, 11)
    if kind == "defaults":
        want[0]["rules"] = _jax_rules_as_ported(want[0]["rules"])
    assert got == want
    assert got[0]["transitions"], "the timeline fired nothing"
    assert {t["to"] for t in got[0]["transitions"]} == {"firing", "clear"}


def test_default_rules_are_the_jax_rules():
    want = _jax_rules_as_ported(jax_alerts.DEFAULT_RULES)
    assert [dict(r) for r in alerts.DEFAULT_RULES] == want


def test_alert_log_lines_are_json(caplog):
    reg = registry.MetricsRegistry()
    engine = alerts.AlertEngine(registry=reg, rules=KIND_RULES["threshold"])
    h = reg.histogram("veles_t_lat_ms", labels=("endpoint",))
    h.labels(endpoint="/api").observe(100.0)
    with caplog.at_level("INFO", logger="veles.alerts"):
        for t in (0.0, 1.0, 2.5):
            engine.evaluate(now=t, force=True)
    lines = [r.getMessage() for r in caplog.records
             if r.name == "veles.alerts"]
    assert len(lines) == 1 and lines[0].startswith("ALERT ")
    record = json.loads(lines[0][len("ALERT "):])
    assert (record["rule"], record["to"], record["severity"]) == (
        "p95", "firing", "warning")


# -- the profiler -------------------------------------------------------------

def _book_report(package, seed):
    rng = numpy.random.RandomState(seed)
    module = PAIRS["profiler"][package == "port"]
    reg = PAIRS["registry"][package == "port"].MetricsRegistry()
    book = module.CostBook(registry=reg)
    for k in range(5):
        op = "op%d" % k
        if rng.rand() < 0.8:
            book.note_cost(op, float(rng.randint(1, 10**12)),
                           float(rng.randint(1, 10**9)))
        for _ in range(int(rng.randint(0, 5))):
            book.observe_ms(op, float(rng.rand() * 0.1))
    book.note_cost("train_segment", 6.835e9 * 512, 3.1e9)
    book.observe_ms("train_segment", 0.0125)
    mfu = book.record_step_mfu("train_segment", 0.0125)
    return book.report(), mfu


@pytest.mark.parametrize("peaks", [None, ("100", "1000"), ("989", "3350")])
@pytest.mark.parametrize("seed", range(2))
def test_cost_book_report_follows_jax(monkeypatch, peaks, seed):
    if peaks is None:
        monkeypatch.delenv("VELES_PEAK_TFLOPS", raising=False)
        monkeypatch.delenv("VELES_HBM_GBPS", raising=False)
    else:
        monkeypatch.setenv("VELES_PEAK_TFLOPS", peaks[0])
        monkeypatch.setenv("VELES_HBM_GBPS", peaks[1])
    want, want_mfu = _book_report("jax", seed)
    got, got_mfu = _book_report("port", seed)
    assert got == want and got_mfu == want_mfu
    if peaks is None:
        # never set: the unlabeled gauge reads its fresh 0.0, as in JAX
        assert got_mfu is None and got["step_mfu"] == 0.0
    else:
        assert got_mfu == 6.835e9 * 512 / 0.0125 / (float(peaks[0]) * 1e12)
        assert got["step_mfu"] == got_mfu
        assert {row["op"]: row.get("bound") for row in got["ops"]}[
            "train_segment"] == "compute"


def test_card_specs_are_nvidia_rows(monkeypatch):
    monkeypatch.delenv("VELES_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("VELES_HBM_GBPS", raising=False)
    assert [kind for kind, _ in profiler.DEVICE_SPECS] == [
        "NVIDIA H100 80GB HBM3"]
    assert profiler.device_spec() == (None, None)     # no card here
    monkeypatch.setattr(profiler, "_device_kind",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert profiler.device_spec() == (989e12, 3350e9)


def test_phases_and_memory_sample():
    for module in (jax_profiler, profiler):
        module.reset_phases()
        for name, s in (("first_step", 0.5), ("zeta", 0.01),
                        ("replica_warmup", 0.25), ("replica_warmup", 0.25),
                        ("alpha", 0.02)):
            module.record_phase(name, s)
    assert profiler.phase_report() == jax_profiler.phase_report() == {
        "replica_warmup": 500.0, "first_step": 500.0, "alpha": 20.0,
        "zeta": 10.0}
    tracing.enable(buffer=tracing.TraceBuffer())
    try:
        with profiler.phase("warmup"):
            pass
        names = [e["name"] for e in tracing.get_buffer().events()]
    finally:
        tracing.disable()
        profiler.reset_phases()
        jax_profiler.reset_phases()
    assert names == ["phase:warmup"]
    sample = profiler.sample_memory(registry.MetricsRegistry())
    assert sample["devices"] == {} and sample["host_rss_bytes"] > 0
    assert not profiler.dump_memory_profile("unused.memprof")
    assert not os.path.exists("unused.memprof")


def test_alexnet_flops_equal_bench_accounting():
    """6.835 GFLOP a training sample: the port's ``model_cost`` of
    AlexNet-227 against ``bench.py``'s count over the initialized JAX
    ``AlexNetWorkflow`` (four samples: only shapes matter)."""
    import logging
    disabled = logging.root.manager.disable
    import bench                # its import disables logging below ERROR
    logging.disable(disabled)
    from veles_tpu import prng as jax_prng
    from veles_tpu.backends import Device
    from veles_tpu.dummy import DummyLauncher
    from veles_tpu.models.alexnet import (AlexNetWorkflow,
                                          SyntheticImageLoader)
    from veles_tpu_torch.models.alexnet import (ALEXNET_LAYERS,
                                                ALEXNET_SAMPLE_SHAPE)
    from veles_tpu_torch.models.build import build_model, model_cost
    jax_prng.get().seed(1)
    jax_prng.get("loader").seed(2)
    wf = AlexNetWorkflow(DummyLauncher(), loader_factory=lambda w:
                         SyntheticImageLoader(w, n_train=2, n_valid=2,
                                              side=227, n_classes=1000,
                                              minibatch_size=2),
                         max_epochs=1)
    wf.initialize(device=Device(backend="cpu"))
    want = bench.model_train_flops_per_sample(wf)
    del wf
    cost = model_cost(build_model(ALEXNET_LAYERS, ALEXNET_SAMPLE_SHAPE,
                                  seed=1, device="cpu"))
    assert cost["train_flops"] == want == 6834745344.0
    assert cost["train_flops"] == 3 * cost["forward_flops"]


# -- the flight recorder ------------------------------------------------------

def _recorder(package, tmp_path, **kw):
    module = PAIRS["flight"][package == "port"]
    return module.FlightRecorder(out_dir=str(tmp_path / package),
                                 min_dump_interval_s=0.0, **kw)


def _trips(package, tmp_path, losses, norms):
    """[(kind, reason, context)] of each trip over the epochs."""
    rec = _recorder(package, tmp_path)
    module = PAIRS["flight"][package == "port"]
    out = []
    try:
        for epoch, (loss, norm) in enumerate(zip(losses, norms)):
            for kind, path in (
                    ("loss", rec.check_losses(loss, epoch=epoch)),
                    ("norm", rec.observe_grad_norms(norm, epoch=epoch))):
                if path is not None:
                    record = module.load_record(path)
                    out.append((kind, record["reason"],
                                record["context"]))
    finally:
        rec.stop()
    return out


def _vectors(case):
    rng = numpy.random.RandomState(3)
    losses = [rng.rand(8) + 1.0 for _ in range(4)]
    norms = [rng.rand(16) + 0.5 for _ in range(4)]
    if case == "nan_loss":
        losses[1][5] = numpy.nan
        losses[2][:] = numpy.nan
    elif case == "inf_loss":
        losses[3][0] = numpy.inf
    elif case == "norm_spike":
        norms[3][7] = 1e4
    elif case == "norm_nan":
        norms[2][11] = numpy.nan
    return losses, norms


@pytest.mark.parametrize("case", ["clean", "nan_loss", "inf_loss",
                                  "norm_spike", "norm_nan"])
def test_flight_trips_follow_jax(tmp_path, case):
    losses, norms = _vectors(case)
    want = _trips("jax", tmp_path, losses, norms)
    got = _trips("port", tmp_path, losses, norms)
    assert got == want
    assert bool(got) == (case != "clean")
    if case == "nan_loss":
        assert got[0][2]["epoch"] == 1 and got[0][2]["batch"] == 5


def test_flight_record_holds_log_tail_and_spans(tmp_path):
    import logging
    tracing.enable(buffer=tracing.TraceBuffer())
    rec = _recorder("port", tmp_path)
    try:
        with tracing.span("step:train"):
            pass
        logging.getLogger("veles.test").warning("before the trip")
        path = rec.check_losses([1.0, float("nan")], epoch=4)
    finally:
        rec.stop()
        tracing.disable()
    record = flight.load_record(path)
    assert record["context"]["step"] == "epoch 4 batch 1 of train sweep"
    assert any(e["message"] == "before the trip" for e in record["log_tail"])
    assert [s["name"] for s in record["spans"]] == ["step:train"]
    assert record["metrics"]["counters"][
        "veles_flight_detector_trips_total"]["series"]


@pytest.mark.parametrize("package", ["jax", "port"])
def test_stall_watchdog_fires_under_a_fake_clock(tmp_path, monkeypatch,
                                                 package):
    """Three sweeps of 1 s set the rolling p95; an armed sweep whose fake
    clock passes factor x p95 dumps a ``stall`` record with the stacks."""
    module = PAIRS["flight"][package == "port"]
    clock = [100.0]
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        perf_counter=lambda: clock[0], time=time.time,
        strftime=time.strftime, gmtime=time.gmtime))
    rec = _recorder(package, tmp_path, poll_s=0.01, stall_factor=2.0,
                    stall_min_s=0.5)
    try:
        for _ in range(3):
            rec.observe_step("train", 1.0)
        rec.step_begin("train sweep epoch 3")
        time.sleep(0.1)
        assert rec.last_record_path() is None   # the clock stood still
        clock[0] += 2.5
        deadline = time.time() + 10
        while rec.last_record_path() is None and time.time() < deadline:
            time.sleep(0.01)
        path = rec.last_record_path()
    finally:
        rec.stop()
    record = module.load_record(path)
    assert record["reason"] == "stall"
    assert record["context"]["budget_s"] == 2.0
    assert os.path.exists(record["stacks_file"])


# -- the CLI ------------------------------------------------------------------

MNIST_FILE = '''
import numpy
from {package}.models.mnist import MnistWorkflow


class TinyProvider(object):
    def __call__(self):
        rng = numpy.random.RandomState(0)
        x = rng.rand(80, 6, 6).astype(numpy.float32)
        y = (x.reshape(80, -1).sum(1) > 18).astype(numpy.int32)
        return x[:60], y[:60], x[60:], y[60:]


def run(load, main):
    load(MnistWorkflow, provider=TinyProvider(), layers=(8,),
         minibatch_size=20, max_epochs=2)
    main()
'''


def _span_names(path):
    with open(path) as f:
        return [e["name"] for e in json.load(f)["traceEvents"]]


@pytest.mark.parametrize("eager", [False, True])
def test_cli_trace_out_writes_a_loadable_trace(tmp_path, monkeypatch,
                                               eager):
    """``--trace-out`` on the port's CLI (and the JAX CLI on the same
    file): the fused run's trace has the ``step:eval`` / ``step:train`` /
    ``epoch`` spans and no ``unit:*`` span, the eager run's ``unit:*``
    spans; ``veles_step_ms{phase="train"}`` and the step MFU agree with
    the runner's own ``train_s``."""
    from veles_tpu.__main__ import Main as JaxMain
    from veles_tpu_torch.__main__ import Main
    monkeypatch.setenv("VELES_PEAK_TFLOPS", "1")
    monkeypatch.setenv("VELES_HBM_GBPS", "100")
    monkeypatch.setenv("VELES_MEMORY_SAMPLE_S", "0")
    flags = ["--eager"] if eager else []
    names = {}
    for package, main in (("veles_tpu", JaxMain), ("veles_tpu_torch",
                                                   Main)):
        path = tmp_path / ("wf_%s.py" % package)
        path.write_text(MNIST_FILE.format(package=package))
        trace = str(tmp_path / ("%s.trace.json" % package))
        with open(trace, "w") as f:
            f.write("stale")           # removed, not merged into
        argv = [str(path), "-s", "3", "--trace-out", trace] + flags
        if package == "veles_tpu_torch":
            argv += ["-a", "cpu"]
        cli = main()
        try:
            assert cli.run(argv) == 0
        finally:
            jax_tracing.disable()
            tracing.disable()
        names[package] = _span_names(trace)
    got = names["veles_tpu_torch"]
    units = {n for n in got if n.startswith("unit:")}
    if eager:
        assert units and "workflow:MnistWorkflow" in got
        assert units == {n for n in names["veles_tpu"]
                         if n.startswith("unit:")}
        return
    assert not units
    for name in ("step:eval", "step:train", "epoch"):
        assert got.count(name) == names["veles_tpu"].count(name) > 0, name
    assert not os.path.exists(str(tmp_path / "veles_tpu_torch.trace.json")
                              + ".memprof")     # no card here
    train_s = [t["train_s"] for t in cli.launcher.runner.epoch_times]
    reg = registry.get_registry()
    step = reg.get("veles_step_ms").labels(phase="train")
    assert step.count >= 2 and step.reservoir._values[-1] == \
        train_s[-1] * 1e3
    trainer = cli.launcher.runner.trainer
    flops = trainer.sweep_cost(60, True)[0]
    assert reg.get("veles_step_mfu").value == flops / train_s[-1] / 1e12
