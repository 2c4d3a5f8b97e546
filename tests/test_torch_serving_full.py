"""The port's full serving engine against the JAX package's, on the CPU:
the result cache, tenants, the autoscaler, multi-model routing, the
metrics and observability endpoints, the status reporter and the
``serve`` command with every flag.

* ``ResultCache``: the keys of the same inputs and model identities are
  JAX's, and a seeded sequence of gets, puts, invalidations and clock
  steps gives the same hits, evictions, fenced puts and registry series;
* ``AdmissionController``: a seeded sequence of admits, settles and
  ``configure`` calls gives the same buckets, sheds, ``Retry-After``,
  stats and Prometheus text, the tenant cap's overflow alias and the
  eviction of idle auto-created tenants included;
* ``Autoscaler.tick(now=...)``: the same decisions and transitions on the
  same signal timelines as ``tests/test_serving_elastic.py``'s;
* both packages' ``ServingFrontend`` serve a tiny AlexNet under two
  routes: every request answers the same status and body (results
  within 1e-5, the float32 tolerance of ``tests/test_torch_serving.py``),
  ``/healthz``, ``/metrics`` (Prometheus family names),
  ``/metrics.json``, ``/profile.json``, ``/alerts.json`` and
  ``/history.json`` answer with the same keys, ``X-Request-Id`` reaches
  the ``http:*`` span, the reporter posts the same payload keys to a
  local stub;
* a cache hit returns the first reply bit for bit with no forward, a
  swap invalidates, and a cache keyed without the model version (the
  control) serves a stale row after the swap;
* ``serve`` with every flag and a traced epoch, in a process of their
  own, load neither ``jax`` nor any ``veles_tpu`` module and write
  loadable traces.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher  # noqa: E402
from veles_tpu.models.alexnet import (AlexNetWorkflow,  # noqa: E402
                                      SyntheticImageLoader)
from veles_tpu.serving import admission as jax_admission  # noqa: E402
from veles_tpu.serving import autoscale as jax_autoscale  # noqa: E402
from veles_tpu.serving import cache as jax_cache  # noqa: E402
from veles_tpu.serving import frontend as jax_frontend  # noqa: E402
from veles_tpu.serving.model_store import \
    ServeableModel as JaxServeableModel  # noqa: E402
from veles_tpu.telemetry import alerts as jax_alerts  # noqa: E402
from veles_tpu.telemetry import profiler as jax_profiler  # noqa: E402
from veles_tpu.telemetry import registry as jax_registry  # noqa: E402
from veles_tpu.telemetry import timeseries as jax_timeseries  # noqa: E402
from veles_tpu.telemetry import tracing as jax_tracing  # noqa: E402
from veles_tpu_torch.serving import admission, autoscale, cache  # noqa
from veles_tpu_torch.serving import frontend  # noqa: E402
from veles_tpu_torch.serving.model_store import ServeableModel  # noqa
from veles_tpu_torch.telemetry import alerts, flight, profiler  # noqa
from veles_tpu_torch.telemetry import registry, timeseries  # noqa: E402
from veles_tpu_torch.telemetry import tracing  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=0)

TINY_ALEXNET = [
    {"type": "conv_str", "n_kernels": 8, "kx": 5, "ky": 5,
     "sliding": (2, 2), "padding": 1},
    {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75},
    {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
    {"type": "all2all_str", "output_sample_shape": 24},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 10},
]

#: (JAX module, port module)
PAIRS = {"cache": (jax_cache, cache),
         "admission": (jax_admission, admission),
         "autoscale": (jax_autoscale, autoscale),
         "registry": (jax_registry, registry)}


@pytest.fixture(autouse=True, scope="module")
def _stop_port_threads():
    yield
    alerts.reset_engine()
    flight.reset_recorder()
    profiler.stop_memory_sampler()
    timeseries.reset_history()
    tracing.disable()


# -- the result cache ---------------------------------------------------------

@pytest.mark.parametrize("dtype,shape", [("float32", (4,)),
                                         ("float32", (2, 3, 3)),
                                         ("float64", (5,))])
def test_cache_keys_equal_jax(dtype, shape):
    rng = numpy.random.RandomState(1)
    sample = rng.rand(*shape).astype(dtype)
    for name, version in (("mnist", 1), ("mnist", 2), ("alexnet", 1)):
        assert cache.ResultCache.key_for(sample, name, version) == \
            jax_cache.ResultCache.key_for(sample, name, version)
    assert cache.ResultCache.key_for(sample, "m", 1) != \
        cache.ResultCache.key_for(sample, "m", 2)


def _cache_run(package, seed):
    rng = numpy.random.RandomState(seed)
    module = PAIRS["cache"][package == "port"]
    reg = PAIRS["registry"][package == "port"].MetricsRegistry()
    c = module.ResultCache(max_bytes=700, max_entries=6, ttl_s=5.0,
                           model="m", registry=reg, ratio_window=8)
    keys = [module.ResultCache.key_for(numpy.full(4, i, numpy.float32),
                                       "m", 1) for i in range(10)]
    now = 100.0
    out = []
    tokens = [c.token()]
    for _ in range(300):
        now += float(rng.choice([0.0, 0.5, 2.0]))
        op = rng.randint(10)
        key = keys[rng.randint(10)]
        if op < 5:
            hit = c.get(key, now=now)
            out.append(None if hit is None else hit.tolist())
        elif op < 9:
            value = numpy.full(int(rng.randint(1, 40)),
                               float(rng.rand()), numpy.float32)
            out.append(c.put(key, value, tokens[rng.randint(
                len(tokens))], now=now))
        else:
            out.append(c.invalidate())
            tokens.append(c.token())
    return out, c.stats(), c.hit_ratio(), reg.render_prometheus()


@pytest.mark.parametrize("seed", range(3))
def test_cache_lru_bytes_ttl_and_fence_follow_jax(seed):
    want = _cache_run("jax", seed)
    got = _cache_run("port", seed)
    assert got == want
    stats = got[1]
    assert stats["hits"] and stats["misses"] and stats["evictions"]
    assert "veles_serving_cache_stale_puts_total" in got[3]


# -- admission ----------------------------------------------------------------

def _admission_run(package, seed):
    rng = numpy.random.RandomState(seed)
    module = PAIRS["admission"][package == "port"]
    reg = PAIRS["registry"][package == "port"].MetricsRegistry()
    ctl = module.AdmissionController(
        capacity=12, tenants={"vip": {"weight": 2.0,
                                      "qos": "interactive"},
                              "bulk": 1.0},
        activity_window_s=3.0, drain_window_s=2.0, registry=reg,
        model="m", max_tenants=5)
    ctl.configure("bulk", weight=0.5, qos="best_effort", pin_qos=True)
    with pytest.raises(ValueError):
        ctl.configure("vip", qos="gold")
    names = ["vip", "bulk", None, "a", "b", "c", "d", "e"]
    held = []
    out = []
    now = 1000.0
    for _ in range(400):
        now += float(rng.choice([0.0, 0.1, 1.0, 4.0]))
        if held and rng.rand() < 0.45:
            name = held.pop(rng.randint(len(held)))
            ctl.settle(name, now=now)
            out.append(("settle", name))
            continue
        name = names[rng.randint(len(names))]
        qos = [None, "interactive", "batch",
               "best_effort"][rng.randint(4)]
        try:
            bucket = ctl.admit(name, qos=qos, now=now)
            held.append(bucket)
            out.append(("admit", bucket))
        except module.TenantOverloaded as e:
            out.append(("shed", e.tenant, e.retry_after))
    return out, ctl.stats(now=now), reg.render_prometheus()


@pytest.mark.parametrize("seed", range(3))
def test_admission_follows_jax(seed):
    want = _admission_run("jax", seed)
    got = _admission_run("port", seed)
    assert got == want
    kinds = {entry[0] for entry in got[0]}
    assert kinds == {"admit", "settle", "shed"}
    assert "overflow" in {entry[1] for entry in got[0]}
    assert got[1]["tenants"]["bulk"]["qos"] == "best_effort"  # pinned


@pytest.mark.parametrize("package", ["jax", "port"])
def test_tenant_cap_and_idle_eviction(package):
    module = PAIRS["admission"][package == "port"]
    reg = PAIRS["registry"][package == "port"].MetricsRegistry()
    ctl = module.AdmissionController(capacity=100, max_tenants=2,
                                     tenants={"vip": {"weight": 2.0}},
                                     activity_window_s=5.0, registry=reg)
    now = 1000.0
    for name in ("vip", "x"):
        ctl.admit(name, now=now)
        ctl.settle(name, now=now)
    assert ctl.admit("y", now=now + 10.0) == "y"
    assert set(ctl.stats(now=now + 10.0)["tenants"]) == {"vip", "y"}
    text = reg.render_prometheus()
    assert 'tenant="x"' not in text and 'tenant="y"' in text


# -- the autoscaler -----------------------------------------------------------

class FakePool(object):
    def __init__(self, n=1):
        self.n = n
        self.busy = 0

    def size(self):
        return self.n

    def stats(self):
        return [{"load": 1 if i < self.busy else 0} for i in range(self.n)]

    def add_replica(self):
        self.n += 1

    def remove_replica(self, timeout=60.0):
        if self.n <= 1:
            return None
        self.n -= 1
        return object()


class FakeBatcher(object):
    def __init__(self):
        self.depth = 0
        self.admission = self
        self.shed = 0

    def queue_depth(self):
        return self.depth

    def stats(self):
        return {"tenants": {"t": {"shed": self.shed}}}


#: signal timelines: [(now, depth, shed, busy)] from a start size
TIMELINES = {
    "sustained_depth": (1, [(100.0, 20, 0, 0), (100.5, 20, 0, 0),
                            (101.1, 20, 0, 0), (101.2, 20, 0, 0),
                            (103.5, 40, 0, 0), (110.0, 100, 0, 0),
                            (111.5, 100, 0, 0)]),
    "shed_burst": (1, [(99.0, 0, 0, 0), (100.0, 0, 5, 0),
                       (100.6, 0, 9, 0), (101.0, 0, 9, 0)]),
    "slow_down": (2, [(100.0, 0, 0, 0), (105.0, 0, 0, 0),
                      (110.5, 0, 0, 0), (130.0, 0, 0, 0),
                      (141.0, 0, 0, 1), (150.0, 3, 0, 0),
                      (160.9, 0, 0, 0), (171.0, 0, 0, 0)]),
    "no_flap": (1, [(100.0, 50, 0, 0), (101.1, 50, 0, 0)] +
                [(float(t), 0, 0, 0) for t in numpy.arange(101.2, 125.0,
                                                           1.0)]),
}


def _scale_run(package, start, timeline):
    module = PAIRS["autoscale"][package == "port"]
    reg = PAIRS["registry"][package == "port"].MetricsRegistry()
    pool, batcher = FakePool(start), FakeBatcher()
    scaler = module.Autoscaler(pool, batcher, min_replicas=1,
                               max_replicas=3, up_queue_per_replica=8.0,
                               up_for_s=0.5, up_cooldown_s=2.0,
                               down_idle_for_s=10.0, down_cooldown_s=10.0,
                               registry=reg, model="m")
    decisions = []
    for now, depth, shed, busy in timeline:
        batcher.depth, batcher.shed, pool.busy = depth, shed, busy
        decisions.append(scaler.tick(now=now))
    moves = [(direction, size) for _, direction, size in scaler.transitions]
    reaction = reg.get("veles_autoscale_reaction_s")
    counts = sorted((tuple(sorted(lab.items())), child.count)
                    for lab, child in reaction.series())
    return decisions, moves, pool.n, counts


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_autoscaler_decisions_follow_jax(name):
    start, timeline = TIMELINES[name]
    want = _scale_run("jax", start, timeline)
    got = _scale_run("port", start, timeline)
    assert got == want
    assert any(got[0])


def test_autoscaler_drives_a_real_pool(port_model):
    """Through the real ``ReplicaPool``: up to two warm replicas (the
    ``replica_warmup`` phase recorded), then drained back to one."""
    from veles_tpu_torch.serving.engine import DynamicBatcher
    from veles_tpu_torch.serving.replica import ReplicaPool
    pool = ReplicaPool(port_model, n_replicas=1, max_batch_size=4)
    engine = DynamicBatcher(pool, batch_timeout_ms=1)
    scaler = autoscale.Autoscaler(pool, engine, min_replicas=1,
                                  max_replicas=2, up_for_s=0.0,
                                  down_idle_for_s=0.0, down_cooldown_s=0.0,
                                  registry=registry.MetricsRegistry())
    try:
        profiler.reset_phases()
        assert scaler.tick(now=0.0) == 0
        engine.admission.capacity = 1000
        engine.admission._total = 20        # a deep queue, as seen
        assert scaler.tick(now=1.0) == 1
        engine.admission._total = 0
        assert pool.size() == 2 and len(pool.replicas[1].warmed_buckets)
        assert profiler.phase_report()["replica_warmup"] > 0
        assert scaler.tick(now=2.0) == -1 and pool.size() == 1
        x = numpy.zeros((1, 32, 32, 3), numpy.float32)
        numpy.testing.assert_array_equal(
            engine.submit(x[0]).result(timeout=30), port_model(x)[0])
    finally:
        engine.stop()
        pool.stop()


# -- the frontends ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model():
    prng.get().seed(42)
    prng.get("loader").seed(43)
    wf = AlexNetWorkflow(
        DummyLauncher(),
        loader_factory=lambda wf_: SyntheticImageLoader(
            wf_, n_train=8, n_valid=4, side=32, n_classes=10,
            minibatch_size=4),
        layers=TINY_ALEXNET, max_epochs=1)
    wf.initialize(device=Device(backend="cpu"))
    return JaxServeableModel.from_workflow(wf, name="tiny")


def _port_twin(jax_model, delta=0.0, version=1):
    return ServeableModel.from_layers(
        TINY_ALEXNET, jax_model.sample_shape,
        params=[{k: v + delta for k, v in p.items()}
                for _, p in jax_model.layers],
        device="cpu", name=jax_model.name, version=version)


def _jax_twin(jax_model, delta, version=1):
    return JaxServeableModel(
        [(fn, {k: v + delta for k, v in params.items()})
         for fn, params in jax_model.layers],
        jax_model.sample_shape, name=jax_model.name, version=version)


@pytest.fixture(scope="module")
def port_model(jax_model):
    return _port_twin(jax_model)


FRONTEND_KW = dict(port=0, replicas=1, max_batch_size=4,
                   batch_timeout_ms=1, max_queue=64, cache_mb=1,
                   warm=False, tenants={"gold": {"weight": 2.0,
                                                 "qos": "interactive"}})


def _fresh_telemetry():
    """Both packages' process-wide telemetry state made anew: the cost
    book, the startup phases, the alert engine and the history. A test
    file that ran earlier in the same worker process (a JAX serving
    test's XLA-costed ``serve_forward:b1`` row, say) must not leave state
    in one package's singletons that the other's lacks."""
    for module in (jax_profiler, profiler):
        module.reset_cost_book()
        module.reset_phases()
    for module in (jax_alerts, alerts):
        module.reset_engine()
    for module in (jax_timeseries, timeseries):
        module.reset_history()


@pytest.fixture(scope="module")
def frontends(jax_model, port_model):
    """(JAX frontend, port frontend), each with routes alpha and beta,
    over telemetry state of their own (:func:`_fresh_telemetry`)."""
    _fresh_telemetry()
    jfe = jax_frontend.ServingFrontend(
        {"alpha": jax_model, "beta": _jax_twin(jax_model, 0.05)},
        **FRONTEND_KW).start()
    pfe = frontend.ServingFrontend(
        {"alpha": port_model, "beta": _port_twin(jax_model, 0.05)},
        **FRONTEND_KW).start()
    try:
        yield jfe, pfe
    finally:
        pfe.stop()
        jfe.stop()
        _fresh_telemetry()


def _call(port, path, body=None, headers=None, raw=None):
    """(status, headers, parsed body) of one request."""
    url = "http://127.0.0.1:%d%s" % (port, path)
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    req = urllib.request.Request(url, data=data, headers=hdrs,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            status, got_headers, text = (resp.status, dict(resp.headers),
                                         resp.read())
    except urllib.error.HTTPError as e:
        status, got_headers, text = e.code, dict(e.headers), e.read()
    if path.startswith("/metrics") and not path.startswith(
            "/metrics.json"):
        return status, got_headers, text.decode()
    return status, got_headers, json.loads(text)


def _x(n, seed):
    return numpy.random.RandomState(seed).uniform(
        -1, 1, (n, 32, 32, 3)).astype(numpy.float32)


def _requests():
    x = _x(3, 5)
    single = {"input": x[0].tolist(), "codec": "list", "id": 7}
    b64 = {"input": __import__("base64").b64encode(x[1].tobytes()).decode(),
           "codec": "base64", "shape": [32, 32, 3], "type": "float32"}
    batch = {"inputs": x.tolist(), "codec": "list"}
    return [
        ("/api", single, None), ("/api/alpha", single, None),
        ("/api/beta", single, None), ("/api/batch", batch, None),
        ("/api/beta/batch", batch, None), ("/api/alpha", b64, None),
        ("/api/alpha", single, {"X-Tenant": "gold"}),
        ("/api/alpha", single, {"X-QoS": "platinum"}),
        ("/api/alpha", single, {"X-Deadline-Ms": "-5"}),
        ("/api/alpha", {"codec": "list"}, None),
        ("/api/alpha", {"input": [1, 2], "codec": "list"}, None),
        ("/api/beta/batch", {"inputs": [], "codec": "list"}, None),
        ("/api/gamma", single, None), ("/apialpha", single, None),
        ("/api/alpha/batch/x", single, None),
        ("/api/alpha", single, {"Content-Type": "text/plain"}),
        ("/api/alpha", None, None),
    ]


def test_frontends_answer_alike(frontends):
    """Every route answers both packages' frontends with the same status
    and body: results within 1e-5, error texts equal, ids echoed."""
    jfe, pfe = frontends
    for path, body, headers in _requests():
        raw = b"{not json" if body is None else None
        want = _call(jfe.port, path, body, headers, raw)
        got = _call(pfe.port, path, body, headers, raw)
        assert got[0] == want[0], (path, got[2], want[2])
        assert sorted(got[2]) == sorted(want[2]), path
        for key in ("result", "results"):
            if key in want[2]:
                numpy.testing.assert_allclose(got[2][key], want[2][key],
                                              **TOL)
        if "error" in want[2]:
            assert got[2]["error"] == want[2]["error"]
        assert got[2].get("id") == want[2].get("id")
    alpha = _call(pfe.port, "/api/alpha", _requests()[0][1])[2]["result"]
    beta = _call(pfe.port, "/api/beta", _requests()[0][1])[2]["result"]
    assert not numpy.allclose(alpha, beta, atol=1e-7)


def _keys(tree, depth=2):
    if not isinstance(tree, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


def _families(text):
    prefixes = ("veles_serving_", "veles_op_", "veles_alerts_",
                "veles_history_", "veles_hbm_", "veles_host_rss")
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ") and
            line.split()[2].startswith(prefixes)}


def test_endpoints_answer_alike(frontends):
    jfe, pfe = frontends
    for fe in (jfe, pfe):
        _call(fe.port, "/api/alpha", _requests()[0][1])
        _call(fe.port, "/profile.json")       # samples the memory
    for path in ("/healthz", "/metrics.json", "/profile.json",
                 "/alerts.json", "/history.json",
                 "/history.json?series=veles_serving&since=0",
                 "/history.json?since=nope", "/nowhere"):
        want = _call(jfe.port, path)
        got = _call(pfe.port, path)
        assert got[0] == want[0], path
        if path == "/healthz":
            assert set(want[2]) <= set(got[2])
            assert got[2]["models"] == want[2]["models"]
            assert got[2]["device"] == "cpu"
        elif path == "/metrics.json":
            assert _keys(got[2], 1) == _keys(want[2], 1)
            for name in ("alpha", "beta"):
                g, w = got[2]["models"][name], want[2]["models"][name]
                assert _keys(g) == _keys(w), name
                assert sorted(g["endpoints"]) == sorted(w["endpoints"])
                assert [sorted(r) for r in g["replicas"]] == \
                    [sorted(r) for r in w["replicas"]]
                assert sorted(g["tenants"]) == sorted(w["tenants"])
        elif path == "/profile.json":
            assert sorted(got[2]) == sorted(want[2])
            # the cost book is the process's: its rows may carry costs
            # noted by earlier tests, so the port's row holds JAX's keys
            # and only keys of JAX's row schema
            schema = {"op", "flops", "bytes", "calls", "p50_ms", "p95_ms",
                      "arithmetic_intensity", "bound", "achieved_tflops",
                      "utilization", "achieved_gbps"}
            row = {r["op"]: set(r) for r in got[2]["ops"]}[
                "serve_forward:b1"]
            assert {r["op"]: set(r) for r in want[2]["ops"]}[
                "serve_forward:b1"] <= row <= schema
        elif path == "/alerts.json":
            assert sorted(got[2]) == sorted(want[2])
            assert [r["name"] for r in got[2]["rules"]] == \
                [r["name"] for r in want[2]["rules"]]
        else:
            assert sorted(got[2]) == sorted(want[2]), path
    metrics = [_call(fe.port, "/metrics") for fe in (jfe, pfe)]
    assert metrics[1][1]["Content-Type"] == "text/plain; version=0.0.4"
    assert _families(metrics[1][2]) == _families(metrics[0][2])
    assert "veles_serving_cache_hits_total" in _families(metrics[1][2])


def test_request_ids_reach_the_http_spans(frontends):
    jfe, pfe = frontends
    spans = {}
    for module, fe in ((jax_tracing, jfe), (tracing, pfe)):
        buf = module.TraceBuffer()
        module.enable(buffer=buf)
        try:
            _call(fe.port, "/api/alpha", _requests()[0][1],
                  {"X-Request-Id": "client-42"})
            _call(fe.port, "/api/beta/batch",
                  {"inputs": _x(2, 9).tolist(), "codec": "list",
                   "id": "body-7"})
            # a span is recorded as its handler returns, after the reply
            # reached the client
            deadline = time.time() + 10
            while sum(e["name"].startswith("http:") for e in
                      buf.events()) < 2 and time.time() < deadline:
                time.sleep(0.01)
        finally:
            module.disable()
        spans[module] = sorted(
            (e["name"], e["args"].get("trace_id")) for e in buf.events()
            if e["name"].startswith("http:"))
    assert spans[tracing] == spans[jax_tracing] == [
        ("http:/api", "client-42"),             # alpha is the default
        ("http:/api/beta/batch", "body-7")]


class _Stub(BaseHTTPRequestHandler):
    posts = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        _Stub.posts.append((self.path, json.loads(body)))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


def test_reporter_posts_jax_payload_keys(frontends):
    jfe, pfe = frontends
    stub = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
    thread = threading.Thread(target=stub.serve_forever, daemon=True)
    thread.start()
    try:
        payloads = []
        for fe in (jfe, pfe):
            _Stub.posts = []
            reporter = fe.report_to("127.0.0.1:%d" % stub.server_address[1],
                                    interval=0.05)
            deadline = time.time() + 20
            while not _Stub.posts and time.time() < deadline:
                time.sleep(0.02)
            reporter.stop()
            fe._reporter = None
            payloads.append(_Stub.posts[0])
    finally:
        stub.shutdown()
        stub.server_close()
    (jpath, want), (ppath, got) = payloads
    assert ppath == jpath == "/update"
    assert sorted(got) == sorted(want)
    assert sorted(got["serving"]) == sorted(want["serving"])
    assert got["mode"] == "serve"


def test_routes_refused_alike(jax_model, port_model):
    for module, model in ((jax_frontend, jax_model),
                          (frontend, port_model)):
        for spec in ({"batch": model}, {"a/b": model}):
            with pytest.raises(ValueError, match="collides"):
                module.ServingFrontend(spec, port=0, warm=False)
        with pytest.raises(ValueError, match="duplicate model route"):
            module._parse_models(["a=1.tar", "a=2.tar"])
        with pytest.raises(ValueError, match="name= prefix"):
            module._parse_models(["1.tar", "2.tar"])
        with pytest.raises(ValueError, match="unknown QoS"):
            module._parse_tenants(["x:1:gold"])
        assert module._parse_tenants(["x:2:batch", "y"]) == {
            "x": {"weight": 2.0, "qos": "batch"}, "y": {"weight": 1.0}}


# -- cache hits on the served path --------------------------------------------

class VersionBlindCache(cache.ResultCache):
    """The control: a key without the model version."""

    @staticmethod
    def key_for(sample, name, version):
        return cache.ResultCache.key_for(sample, name, 0)

    def invalidate(self):
        return 0


@pytest.mark.parametrize("blind", [False, True])
def test_cache_hits_skip_the_forward_and_swaps_invalidate(jax_model,
                                                          port_model,
                                                          blind):
    fe = frontend.ServingFrontend(port_model, port=0, replicas=1,
                                  max_batch_size=4, batch_timeout_ms=1,
                                  cache_mb=1).start()
    if blind:
        entry = fe.default_entry
        entry.engine.cache = entry.cache = VersionBlindCache(
            max_bytes=1 << 20, model="blind",
            registry=registry.MetricsRegistry())
    try:
        bodies = [{"input": row.tolist(), "codec": "list"}
                  for row in _x(4, 11)]
        first = [_call(fe.port, "/api", b)[2]["result"] for b in bodies]
        rows = fe.pool.replicas[0].rows_done
        second = [_call(fe.port, "/api", b)[2]["result"] for b in bodies]
        assert second == first                  # bit for bit
        assert fe.pool.replicas[0].rows_done == rows
        assert fe.cache.stats()["hits"] == 4
        assert fe.metrics.snapshot()["cached_total"] == 4
        fe.swap_model(_port_twin(jax_model, 0.1, version=2))
        after = _call(fe.port, "/api", bodies[0])[2]["result"]
        fresh = _port_twin(jax_model, 0.1)(_x(4, 11)[:1])[0]
        stale = numpy.abs(numpy.asarray(after) - fresh).max() > 1e-5
        assert stale == blind
    finally:
        fe.stop()


class SlowKeyCache(cache.ResultCache):
    """Hashing a row takes longer than the batch window."""

    @staticmethod
    def key_for(sample, name, version):
        time.sleep(0.003)
        return cache.ResultCache.key_for(sample, name, version)


@pytest.mark.parametrize("together", [True, False])
def test_batch_request_rows_reach_one_forward(port_model, together):
    """A batch request's rows enter the queue together (``submit_many``):
    one forward however long they take to key. Submitted one by one (the
    control), the 1 ms window closes between rows."""
    from veles_tpu_torch.serving.engine import DynamicBatcher
    from veles_tpu_torch.serving.replica import ReplicaPool
    pool = ReplicaPool(port_model, n_replicas=1, max_batch_size=8)
    engine = DynamicBatcher(pool, batch_timeout_ms=1, cache=SlowKeyCache(
        max_bytes=1 << 20, model="slow", registry=registry.MetricsRegistry()))
    x = _x(8, 12)
    try:
        if together:
            futures = engine.submit_many(list(x))
        else:
            futures = [engine.submit(row) for row in x]
        rows = numpy.stack([f.result(timeout=30) for f in futures])
        numpy.testing.assert_allclose(rows, port_model(x), rtol=1e-5,
                                      atol=1e-6)
        assert (pool.replicas[0].batches_done == 1) == together
    finally:
        engine.stop()
        pool.stop()


# -- the command, in processes of their own -----------------------------------

SERVE_AND_TRAIN = r'''
import json, socket, sys, threading, urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
import numpy
from veles_tpu_torch.__main__ import Main
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.mnist import MnistWorkflow
from veles_tpu_torch.serving.frontend import serve

out = sys.argv[1]
posts = []

class Stub(BaseHTTPRequestHandler):
    def do_POST(self):
        posts.append(self.rfile.read(int(self.headers["Content-Length"])))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()
    def log_message(self, *a):
        pass

stub = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
threading.Thread(target=stub.serve_forever, daemon=True).start()

class Digits(object):
    def __call__(self):
        rng = numpy.random.RandomState(0)
        x = rng.rand(80, 6, 6).astype(numpy.float32)
        y = (x.reshape(80, -1).sum(1) > 18).astype(numpy.int32)
        return x[:60], y[:60], x[60:], y[60:]

wf = MnistWorkflow(DummyLauncher(), provider=Digits(), layers=(8,),
                   minibatch_size=20, max_epochs=1)
wf.initialize(device="cpu")
wf.run()
package = wf.package_export(out + "/digits.tar")
fe = serve(["--model", "a=" + package, "--model", "b=" + package,
            "-a", "cpu", "--port", "0", "--cache-mb", "1",
            "--cache-ttl-s", "30", "--tenant", "gold:2:interactive",
            "--tenant", "bulk:1:batch", "--min-replicas", "1",
            "--max-replicas", "2", "--max-batch-size", "4",
            "--web-status", "127.0.0.1:%d" % stub.server_address[1],
            "--trace-out", out + "/serve.json"])
req = urllib.request.Request(
    "http://127.0.0.1:%d/api/b" % fe.port,
    data=json.dumps({"input": [0.5] * 36, "codec": "list"}).encode(),
    headers={"Content-Type": "application/json", "X-Tenant": "gold"})
assert numpy.isfinite(json.loads(urllib.request.urlopen(req).read())[
    "result"]).all()
import time
deadline = time.time() + 20
while not posts and time.time() < deadline:
    time.sleep(0.05)
fe.stop()
stub.shutdown()
with open(out + "/wf.py", "w") as f:
    f.write("""
import numpy
from veles_tpu_torch.models.mnist import MnistWorkflow

class Digits(object):
    def __call__(self):
        rng = numpy.random.RandomState(0)
        x = rng.rand(80, 6, 6).astype(numpy.float32)
        y = (x.reshape(80, -1).sum(1) > 18).astype(numpy.int32)
        return x[:60], y[:60], x[60:], y[60:]

def run(load, main):
    load(MnistWorkflow, provider=Digits(), layers=(8,), minibatch_size=20,
         max_epochs=1)
    main()
""")
assert Main().run([out + "/wf.py", "-a", "cpu", "--trace-out",
                   out + "/train.json"]) == 0
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "veles_tpu" or k.startswith("veles_tpu."))
print("POSTS", len(posts))
print("LOADED", bad)
'''


def test_serve_every_flag_and_a_traced_epoch_load_no_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, VELES_MEMORY_SAMPLE_S="0",
               VELES_FLIGHT_DIR=str(tmp_path / "flight"))
    proc = subprocess.run([sys.executable, "-c", SERVE_AND_TRAIN,
                           str(tmp_path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    assert "POSTS 0" not in proc.stdout
    served = [e["name"] for e in json.load(
        open(str(tmp_path / "serve.json")))["traceEvents"]]
    trained = [e["name"] for e in json.load(
        open(str(tmp_path / "train.json")))["traceEvents"]]
    # route b is the second: its rows are serve_forward:b:b<n>
    assert "http:/api/b" in served and "op:serve_forward:b:b1" in served
    assert {"step:train", "step:eval", "epoch"} <= set(trained)
