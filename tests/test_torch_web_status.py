"""The port's web_status dashboard, on the CPU.

Every test of ``tests/test_web_status.py`` on the port's
``veles_tpu_torch.web_status``: the ``/service`` protocol and the
garbage collection of silent runs, logs and events, malformed requests,
the pages and their escaping, the catalog, the log handler and the event
sink, the launcher's notifier, ``graph_description()`` and
``/profile.json``.

Held to the JAX package's dashboard: the replies to the same
``/update``, ``/service``, ``/logs`` and ``/events`` requests, and the
bodies of ``/jobs.json`` and ``/history.json`` after the same pushes,
equal once times and ids are masked; ``graph_description()`` of the same
workflow (names, types, groups, links). Both packages' cost book, alert
engine, startup phases and history are made anew before and after
(``tests/test_torch_serving_full.py``'s ``_fresh_telemetry``): they are
process-wide.

Beside them: the port's pushers land on it unchanged (the serving
frontend's ``_StatusReporter`` and ``sched serve``'s jobs blob), the
log handler drops what its own POSTs log (the dashboard in the same
process, every logger at DEBUG), and ``Launcher.status()``.
"""

import json
import logging
import time
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

from veles_tpu import web_status as jax_web_status  # noqa: E402
from veles_tpu_torch import web_status  # noqa: E402
from veles_tpu_torch.web_status import (GARBAGE_TIMEOUT,  # noqa: E402
                                        WebStatusLogHandler,
                                        WebStatusServer)

from test_torch_serving_full import _fresh_telemetry  # noqa: E402


def _post(address, path, payload):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (address[1], path),
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(address, path):
    with urllib.request.urlopen(
            "http://127.0.0.1:%d%s" % (address[1], path), timeout=10) as r:
        return r.status, r.read().decode()


@pytest.fixture(scope="module", autouse=True)
def _telemetry():
    _fresh_telemetry()
    yield
    _fresh_telemetry()


@pytest.fixture
def server():
    srv = WebStatusServer(host="127.0.0.1", port=0).start()
    try:
        yield srv
    finally:
        srv.stop()


def _wait_for(predicate, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


def test_update_then_workflows_query(server):
    status, reply = _post(server.address, "/update", {
        "id": "master-1", "name": "mnist", "mode": "master",
        "master": "host:5000", "time": 12.5, "slaves": {"s1": {}},
        "units": 9, "stopped": False})
    assert status == 200
    status, reply = _post(server.address, "/service", {
        "request": "workflows", "args": ["name", "slaves", "units"]})
    assert status == 200
    wf = reply["result"]["master-1"]
    assert wf == {"name": "mnist", "slaves": {"s1": {}}, "units": 9}


def test_silent_masters_are_garbage_collected(server):
    _post(server.address, "/update", {"id": "old", "name": "x"})
    server.masters["old"]["last_update"] = time.time() - GARBAGE_TIMEOUT - 1
    _post(server.address, "/update", {"id": "live", "name": "y"})
    status, reply = _post(server.address, "/service",
                          {"request": "workflows", "args": ["name"]})
    assert set(reply["result"]) == {"live"}
    assert "old" not in server.masters


def test_logs_and_events_queries(server):
    _post(server.address, "/logs", {"logs": [
        {"session": "s1", "levelname": "INFO", "message": "hello",
         "created": 100.0},
        {"session": "s1", "levelname": "ERROR", "message": "boom",
         "created": 200.0},
        {"session": "s2", "levelname": "ERROR", "message": "other",
         "created": 300.0}]})
    _post(server.address, "/events", {"events": [
        {"session": "s1", "name": "run", "type": "begin", "time": 1.0},
        {"session": "s1", "name": "run", "type": "end", "time": 2.0}]})
    status, reply = _post(server.address, "/service", {
        "request": "logs", "find": {"session": "s1", "levelname": "ERROR"}})
    assert [r["message"] for r in reply["result"]] == ["boom"]
    status, reply = _post(server.address, "/service", {
        "request": "logs", "find": {"created": {"$gte": 150.0,
                                                "$lte": 250.0}}})
    assert [r["message"] for r in reply["result"]] == ["boom"]
    status, reply = _post(server.address, "/service", {
        "request": "events", "find": {"type": "end"}})
    assert len(reply["result"]) == 1
    # an unknown request type: result None, as in the JAX package
    status, reply = _post(server.address, "/service", {"request": "nope"})
    assert status == 200 and reply["result"] is None


def test_malformed_requests(server):
    status, reply = _post(server.address, "/service", {"no_request": 1})
    assert status == 400 and "error" in reply
    status, reply = _post(server.address, "/service",
                          {"request": "logs"})  # no find
    assert status == 400
    status, reply = _post(server.address, "/nope", {})
    assert status == 404
    status, reply = _post(server.address, "/logs", {"logs": [1, 2]})
    assert status == 400


def test_html_pages(server):
    status, page = _get(server.address, "/status.html")
    assert status == 200 and "veles_tpu_torch workflows" in page
    status, page = _get(server.address, "/")
    assert status == 200 and "veles_tpu_torch workflows" in page
    status, page = _get(server.address, "/logs.html")
    assert status == 200 and "logs" in page
    status, page = _get(server.address, "/frontend.html")
    assert status == 200 and "command composer" in page
    assert 'let cmd = "python -m veles_tpu_torch";' in page
    status, page = _get(server.address, "/slaves.html")
    assert status == 200 and "jobs done" in page


def test_frontend_composer_renders_choices_and_help(server):
    """The composer page renders real registry flags: enumerated
    options become <select> dropdowns and each flag shows its help."""
    status, page = _get(server.address, "/frontend.html")
    assert status == 200
    assert "createElement(\"select\")" in page
    assert "arg.choices" in page
    assert "arg.help" in page


def test_catalog_endpoint(server):
    status, body = _get(server.address, "/catalog")
    assert status == 200
    catalog = json.loads(body)
    assert {"RESTfulAPI", "Publisher", "MatrixPlotter",
            "SnapshotterToFile"} <= set(catalog["units"])
    assert not [u for u in catalog["units"].values()
                if u["module"].split(".")[0] == "veles_tpu"]
    flags = {f for arg in catalog["arguments"] for f in arg["flags"]}
    assert {"--test", "--web-status", "--no-graphics"} <= flags


def test_log_handler_forwards_records(server):
    handler = WebStatusLogHandler(
        address=("127.0.0.1", server.port), session="sess-1", node="here",
        flush_interval=0.05)
    logger = logging.getLogger("test-web-status-forward")
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        logger.info("forwarded %d", 42)
        logger.error("bad thing")
        reply = {}

        def arrived():
            reply.update(_post(server.address, "/service", {
                "request": "logs", "find": {"session": "sess-1"}})[1])
            return len(reply["result"]) >= 2

        assert _wait_for(arrived)
        msgs = {r["message"] for r in reply["result"]}
        assert "forwarded 42" in msgs and "bad thing" in msgs
        levels = {r["levelname"] for r in reply["result"]}
        assert levels == {"INFO", "ERROR"}
        assert all(r["node"] == "here" for r in reply["result"])
    finally:
        logger.removeHandler(handler)
        handler.close()


def test_log_handler_does_not_feed_back(server):
    """On the root logger with everything at DEBUG, the dashboard in the
    same process: the server logs each POST and the flusher's HTTP
    client may log too, and none of that returns to the dashboard -- two
    records logged give two records stored, however long it runs."""
    root_logger = logging.getLogger()
    saved = root_logger.level, logging.getLogger("WebStatusServer").level
    handler = WebStatusLogHandler(
        address=("127.0.0.1", server.port), session="loop", node="here",
        flush_interval=0.02)
    root_logger.addHandler(handler)
    root_logger.setLevel(logging.DEBUG)
    logging.getLogger("WebStatusServer").setLevel(logging.DEBUG)
    try:
        logging.getLogger("test-feedback").info("one")
        logging.getLogger("test-feedback").info("two")
        assert _wait_for(lambda: len([r for r in server.logs
                                      if r["session"] == "loop"]) >= 2)
        time.sleep(0.5)      # 25 flush intervals
    finally:
        root_logger.removeHandler(handler)
        root_logger.setLevel(saved[0])
        logging.getLogger("WebStatusServer").setLevel(saved[1])
        handler.close()
    stored = [r["message"] for r in server.logs if r["session"] == "loop"]
    assert stored == ["one", "two"]


def test_launcher_notifier_posts_to_dashboard(server):
    """The launcher's --web-status loop lands in ``masters``, and its
    thread ends with the run."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import Launcher
    saved = (root.common.web.host, root.common.web.port,
             root.common.web.notification_interval)
    root.common.web.update({"host": "127.0.0.1", "port": server.port,
                            "notification_interval": 0.05})
    launcher = Launcher(web_status=True)

    class _FakeWorkflow(object):
        name = "fake"

        def __len__(self):
            return 3

        def graph_description(self):
            return {"nodes": [], "edges": []}

    launcher.workflow = _FakeWorkflow()
    launcher.start_time = time.time()
    launcher._start_status_notifier()
    try:
        assert _wait_for(lambda: launcher.id in server.masters)
        master = server.masters[launcher.id]
        assert master["name"] == "fake" and master["units"] == 3
        assert master["mode"] == "standalone"
        assert master["graph"] == {"nodes": [], "edges": []}
    finally:
        launcher._finished.set()
        launcher._status_thread.join(timeout=5)
        root.common.web.update({"host": saved[0], "port": saved[1],
                                "notification_interval": saved[2]})
    assert not launcher._status_thread.is_alive()


def test_workflow_and_timeline_pages_served(server):
    for page, marker in (("/workflow.html", "workflow graph"),
                         ("/timeline.html", "event timeline")):
        status, body = _get(server.address, page)
        assert marker in body


def test_pages_escape_untrusted_strings():
    """Unit and event names arrive from unauthenticated POSTs and are
    interpolated into innerHTML SVG: both pages route every such string
    through the shared esc() helper."""
    for page in (web_status._WORKFLOW_PAGE, web_status._TIMELINE_PAGE):
        assert "function esc(" in page
        assert "//__ESC__" not in page
    assert "${esc(n.type)}" in web_status._WORKFLOW_PAGE
    assert "${esc(n.name)}" in web_status._WORKFLOW_PAGE
    assert "${esc(b.name)}" in web_status._TIMELINE_PAGE
    assert "${esc(s.name)}" in web_status._TIMELINE_PAGE


def test_pages_equal_jax_but_the_package_name():
    for name in ("_STATUS_PAGE", "_LOGS_PAGE", "_SLAVES_PAGE",
                 "_FRONTEND_PAGE", "_WORKFLOW_PAGE", "_TIMELINE_PAGE"):
        assert getattr(web_status, name) == getattr(
            jax_web_status, name).replace("veles_tpu", "veles_tpu_torch")


def _mnist_pair():
    import numpy
    from veles_tpu import prng as jax_prng
    from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
    from veles_tpu.models.mnist import MnistWorkflow as JaxMnist
    from veles_tpu_torch import prng
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mnist import MnistWorkflow

    def provider():
        rng = numpy.random.RandomState(2)
        return (rng.rand(60, 6, 6).astype(numpy.float32),
                rng.randint(0, 10, 60).astype(numpy.int32),
                rng.rand(20, 6, 6).astype(numpy.float32),
                rng.randint(0, 10, 20).astype(numpy.int32))

    for p in (prng, jax_prng):
        p.get().seed(1)
        p.get("loader").seed(2)
    jax_wf = JaxMnist(JaxDummyLauncher(), provider=provider, layers=(8,),
                      minibatch_size=20, max_epochs=1)
    port_wf = MnistWorkflow(DummyLauncher(), provider=provider,
                            layers=(8,), minibatch_size=20, max_epochs=1)
    return jax_wf, port_wf


def test_graph_description_shape():
    _, wf = _mnist_pair()
    graph = wf.graph_description()
    names = {n["name"] for n in graph["nodes"]}
    assert {"MnistLoader", "evaluator", "decision"} <= names
    ids = {n["id"] for n in graph["nodes"]}
    assert all(s in ids and d in ids for s, d in graph["edges"])
    assert graph["edges"]  # the control loop is wired
    json.dumps(graph)  # JSON-able for the status POST


@pytest.mark.parametrize("plotters", [False, True],
                         ids=["bare", "with_plotters"])
def test_graph_description_equals_jax(plotters):
    """The same workflow built by both packages: the same nodes (name,
    type, view group) and links; with the standard plot set too."""
    from veles_tpu.backends import Device
    jax_wf, port_wf = _mnist_pair()
    if plotters:
        jax_wf.initialize(device=Device(backend="cpu"))
        port_wf.initialize(device="cpu")
        jax_wf.add_plotters()
        port_wf.add_plotters()
    got, want = port_wf.graph_description(), jax_wf.graph_description()
    assert got == want
    assert len(got["nodes"]) == len(port_wf) + 2 - (
        port_wf.start_point in port_wf.units) - (
        port_wf.end_point in port_wf.units)


def test_event_sink_feeds_timeline(server):
    from veles_tpu_torch import logger as logger_mod
    from veles_tpu_torch.web_status import WebStatusEventSink

    sink = logger_mod.add_event_sink(WebStatusEventSink(
        address=("127.0.0.1", server.port), session_id="tl-test",
        flush_interval=0.1))
    try:
        class Thing(logger_mod.Logger):
            pass

        thing = Thing()
        thing.event("step", "begin")
        thing.event("step", "end")
        thing.event("mark", "single")
        result = []

        def arrived():
            result[:] = _post(server.address, "/service", {
                "request": "events",
                "find": {"session": "tl-test"}})[1].get("result", [])
            return len(result) >= 3

        assert _wait_for(arrived)
        assert {r["type"] for r in result} == {"begin", "end", "single"}
        assert all(r["instance"].startswith("Thing@") for r in result)
    finally:
        logger_mod.remove_event_sink(sink)
        sink.close()


def test_profile_json_endpoint(server):
    """/profile.json: the attribution report, live."""
    from veles_tpu_torch.telemetry import profiler

    profiler.reset_phases()
    profiler.record_phase("compile", 1.25)
    try:
        status, body = _get(server.address, "/profile.json")
        assert status == 200
        report = json.loads(body)
        for key in ("ops", "device", "step_mfu", "phases_ms",
                    "memory", "flight_record"):
            assert key in report
        assert report["phases_ms"]["compile"] == pytest.approx(1250.0)
        # the status page links it and renders the perf panel
        _, page = _get(server.address, "/status.html")
        assert "/profile.json" in page and "renderPerf" in page
    finally:
        profiler.reset_phases()


# -- held to the JAX package's dashboard ----------------------------------

#: the same requests to both dashboards, in order: (method, path, body)
SCRIPT = [
    ("POST", "/update", {"id": "m1", "name": "mnist", "mode": "master",
                         "master": "h:5000", "time": 1.5,
                         "slaves": {"s1": {"power": 1.0}}, "units": 9,
                         "stopped": False, "graph": {"nodes": [],
                                                     "edges": []}}),
    ("POST", "/update", {"id": "sched-h-1", "name": "scheduler",
                         "mode": "sched", "master": "h",
                         "jobs": [{"id": "j1", "tenant": "a",
                                   "state": "running",
                                   "metrics": {"loss": 0.5, "mfu": 0.25,
                                               "samples_per_s": 100.0}},
                                  {"id": "j2", "tenant": "b",
                                   "state": "queued", "metrics": {}}],
                         "sched": {"queued": 1}}),
    ("POST", "/logs", {"logs": [
        {"session": "s1", "levelname": "INFO", "message": "a",
         "created": 10.0},
        {"session": "s1", "levelname": "ERROR", "message": "b",
         "created": 20.0},
        {"session": "s2", "levelname": "WARNING", "message": "c",
         "created": 30.0}]}),
    ("POST", "/logs", [{"session": "s3", "levelname": "INFO",
                        "message": "bare list", "created": 40.0}]),
    ("POST", "/events", {"events": [
        {"session": "s1", "name": "run", "type": "begin", "time": 1.0},
        {"session": "s1", "name": "run", "type": "end", "time": 2.0},
        {"session": "s2", "name": "step", "type": "single", "time": 3.0}]}),
    ("POST", "/service", {"request": "workflows",
                          "args": ["name", "mode", "units", "slaves",
                                   "graph", "missing"]}),
    ("POST", "/service", {"request": "logs",
                          "find": {"session": "s1"}}),
    ("POST", "/service", {"request": "logs",
                          "find": {"levelname": {"$in": ["ERROR",
                                                         "WARNING"]}}}),
    ("POST", "/service", {"request": "logs",
                          "find": {"created": {"$gte": 15, "$lte": 35}}}),
    ("POST", "/service", {"request": "events",
                          "find": {"session": "s1", "type": "end"}}),
    ("POST", "/service", {"request": "nope"}),
    ("POST", "/service", {"no_request": 1}),
    ("POST", "/service", {"request": "events"}),
    ("POST", "/events", {"events": {"not": "a list"}}),
    ("POST", "/nope", {}),
    ("GET", "/jobs.json", None),
    ("GET", "/history.json?series=veles_sched_job_loss", None),
    ("GET", "/nope", None),
]


def _mask(value):
    """Times and cursors replaced: the dashboard stamps both."""
    if isinstance(value, dict):
        return {k: ("<t>" if k in ("last_update", "t", "ts", "time",
                                   "since", "now", "cursor")
                    and isinstance(v, (int, float)) else
                    [["<t>", p[1]] for p in v] if k == "points"
                    else _mask(v))
                for k, v in value.items()}
    if isinstance(value, list):
        return [_mask(v) for v in value]
    return value


def _replay(server):
    replies = []
    for method, path, body in SCRIPT:
        url = "http://127.0.0.1:%d%s" % (server.port, path)
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                status, text = resp.status, resp.read()
        except urllib.error.HTTPError as e:
            status, text = e.code, e.read()
        replies.append((path, status, _mask(json.loads(text))))
    return replies


def test_replies_equal_jax():
    got, want = [], []
    for module, out in ((web_status, got), (jax_web_status, want)):
        _fresh_telemetry()
        srv = module.WebStatusServer(host="127.0.0.1", port=0).start()
        try:
            out.extend(_replay(srv))
            out.append(("masters", 200, _mask(srv.masters)))
        finally:
            srv.stop()
    _fresh_telemetry()
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    jobs = dict((r[0], r[2]) for r in got)["/jobs.json"]
    assert [j["id"] for j in jobs["jobs"]] == ["j1", "j2"]


# -- the port's pushers ----------------------------------------------------

def test_serving_reporter_lands_on_the_port_dashboard(server):
    """The serving frontend's ``_StatusReporter`` POSTs its payload; the
    dashboard lists the frontend with its serving block."""
    from veles_tpu_torch.serving.frontend import _StatusReporter

    class _Metrics(object):
        def dashboard_block(self):
            return {"qps": 0.8, "queue_depth": 0, "p95_ms": 1.0,
                    "rejected_total": 0, "batch_mean_size": 1.0,
                    "model": {"name": "m"}}

    class _Frontend(object):
        address = ("127.0.0.1", 1)
        entries = {}
        metrics = _Metrics()

    reporter = _StatusReporter(_Frontend(), ("127.0.0.1", server.port),
                               interval=0.05, name="serving-test").start()
    try:
        assert _wait_for(lambda: reporter.id in server.masters)
    finally:
        reporter.stop()
    _, reply = _post(server.address, "/service", {
        "request": "workflows", "args": ["name", "mode", "serving"]})
    entry = reply["result"][reporter.id]
    assert entry["name"] == "serving-test" and entry["mode"] == "serve"
    assert entry["serving"]["qps"] == 0.8


def test_sched_push_lands_in_jobs_json(server):
    from veles_tpu_torch.sched.cli import _push_status

    class _Scheduler(object):
        def jobs_report(self):
            return {"jobs": [{"id": "j1", "tenant": "t",
                              "state": "running",
                              "metrics": {"loss": 1.5}}]}

        def stats(self):
            return {"running": 1}

    _push_status("http://127.0.0.1:%d" % server.port, _Scheduler())
    _, body = _get(server.address, "/jobs.json")
    jobs = json.loads(body)["jobs"]
    assert [(j["id"], j["state"]) for j in jobs] == [("j1", "running")]
    assert jobs[0]["scheduler"].startswith("sched-")


def test_launcher_status_and_sinks(tmp_path):
    """``status()`` of a standalone launcher over a built workflow: the
    JAX payload's keys, the graph, the unit count; ``stop()`` detaches
    the sinks and ends the notifier."""
    from veles_tpu.launcher import Launcher as JaxLauncher
    from veles_tpu_torch import logger as logger_mod
    from veles_tpu_torch.launcher import Launcher
    _, wf = _mnist_pair()
    launcher = Launcher(web_status=True, graphics=False)
    wf.workflow = launcher
    launcher.workflow = wf
    launcher.start_time = time.time()
    status = launcher.status()
    jax_launcher = JaxLauncher(graphics=False)
    jax_launcher.start_time = time.time()
    assert sorted(status) == sorted(jax_launcher.status())
    assert status["units"] == len(wf)
    assert status["graph"] == wf.graph_description()
    assert status["mode"] == "standalone" and status["slaves"] == {}
    json.dumps(status)
    launcher._start_status_notifier()
    launcher._attach_dashboard_sinks()
    assert launcher._web_log_handler in logging.getLogger().handlers
    launcher.stop()
    assert launcher._web_log_handler is None
    assert launcher._web_event_sink not in logger_mod._event_sinks
    assert not launcher._status_thread.is_alive()
