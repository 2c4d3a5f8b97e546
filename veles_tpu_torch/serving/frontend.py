"""HTTP frontend of the serving engine (the port of
``veles_tpu/serving/frontend.py``), with the request contract of
:mod:`veles_tpu_torch.restful_api` (``parse_payload``,
``respond_json``, imported from there):

* ``POST <path>`` with ``{"input": ..., "codec": "list"|"base64"[,
  "shape", "type", "id"]}`` -> ``{"result": [...][, "id"]}``;
* ``POST <path>/batch`` with ``{"inputs": [...], "codec": ...}`` (or
  base64 ``"input"`` with a leading batch axis in ``"shape"``) ->
  ``{"results": [...]}`` in order;
* **multi-model routing**: one process hosts N models of one
  :class:`ModelStore` -- ``POST <path>/<model>`` (and
  ``<path>/<model>/batch``) routes by name, each model with its own
  replica pool, result cache, tenant buckets, metrics and autoscaler;
  the bare ``<path>`` serves the first model (``/apialpha`` routes
  nowhere: a route is a whole path segment);
* ``GET /metrics`` -- the Prometheus text of the process registry
  (serving, training and telemetry series);
* ``GET /metrics.json`` -- the default model's
  :class:`~veles_tpu_torch.serving.metrics.ServingMetrics` snapshot with
  its tenants' admission stats (and every model's under ``"models"``);
* ``GET /profile.json`` -- the cost book's attribution report
  (:func:`veles_tpu_torch.telemetry.profiler.profile_report`): each
  bucket's ``serve_forward:b<n>`` row with FLOPs, bytes, times,
  roofline verdict and utilization (a second route's rows are
  ``serve_forward:<route>:b<n>``), the memory sample, startup phases;
* ``GET /alerts.json`` -- the alert engine's report (started with the
  frontend);
* ``GET /history.json?series=&since=`` -- retained metric history
  (:class:`~veles_tpu_torch.telemetry.timeseries.SeriesStore`, fed from
  :meth:`ServingFrontend.start`);
* ``GET /healthz`` -- liveness, the default model's name, version,
  shape and device, and every hosted model under ``"models"``.

Malformed requests answer 400 with ``{"error": ...}``. Overload answers
503 with ``Retry-After`` (computed from the tenant's own drain rate);
a request whose ``X-Deadline-Ms`` budget passed while it queued answers
504. ``X-Tenant`` / ``X-QoS`` (or the body's ``"tenant"`` / ``"qos"``)
pick the admission bucket. A client's ``X-Request-Id`` (or the body's
``"id"``) becomes the trace id of the request's ``http:<endpoint>``
span, so a request is found in a ``--trace-out`` dump by the id the
client logs. Every route, endpoint, metric and JSON key is the JAX
package's.

:func:`main` is ``python -m veles_tpu_torch serve --model [name=]<snapshot
file or directory | snapshot URI | export package> ...`` (a URI:
``http(s)://...`` or ``sqlite://<db>[#key]``) with every flag of the JAX
command -- ``--model`` repeated with ``name=`` prefixes, ``--name``,
``--host``, ``--port``, ``--path``, ``--replicas``, ``--min-replicas``,
``--max-replicas`` (the autoscaler), ``--max-batch-size``,
``--batch-timeout-ms``, ``--max-queue``, ``--cache-mb`` (default 64; 0
turns the cache off), ``--cache-ttl-s``, ``--tenant name:weight[:qos]``
(repeated), ``--keep-last``, ``--response-timeout``, ``--web-status
host:port`` (a status POST every 2 s), ``--trace-out FILE`` and ``-v``
-- and the training command's ``-a/--backend`` and ``-d/--device`` (the
card unless ``-a cpu``). :data:`REFUSED_FLAGS` is empty: the port
refuses none of the JAX command's flags. :func:`serve` parses the same
arguments and returns the started frontend; its ``stop()`` writes the
``--trace-out`` file (Chrome trace-event JSON, open it in Perfetto) and,
on the card, the caching allocator's snapshot beside it
(``<file>.memprof``).
"""

import argparse
import concurrent.futures
import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy

from veles_tpu_torch.restful_api import (_NumpyJSONEncoder, parse_payload,
                                         respond_json)
from veles_tpu_torch.serving.admission import (QOS_MULTIPLIER,
                                               AdmissionController)
from veles_tpu_torch.serving.autoscale import Autoscaler
from veles_tpu_torch.serving.cache import ResultCache
from veles_tpu_torch.serving.engine import (DeadlineExceeded,
                                            DynamicBatcher,
                                            EngineOverloaded)
from veles_tpu_torch.serving.metrics import ServingMetrics
from veles_tpu_torch.serving.model_store import ModelStore
from veles_tpu_torch.serving.replica import ReplicaPool
from veles_tpu_torch.telemetry import alerts, profiler, tracing
from veles_tpu_torch.telemetry.registry import get_registry
from veles_tpu_torch.telemetry.timeseries import get_history

_log = logging.getLogger(__name__)




# -- the server --------------------------------------------------------------

class _FrontendHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        _log.debug("http: " + fmt, *args)

    def do_POST(self):
        self.server.frontend.handle_post(self)

    def do_GET(self):
        self.server.frontend.handle_get(self)


class _FrontendServer(ThreadingHTTPServer):
    daemon_threads = True
    # the default accept backlog of 5 would stall bursts of concurrent
    # clients in kernel retransmits
    request_queue_size = 128


class _ModelEntry(object):
    """Everything one hosted model owns: pool, batcher, cache,
    admission buckets, metrics, optional autoscaler."""

    def __init__(self, name, model, replicas, max_batch_size,
                 batch_timeout_ms, max_queue, warm, cache_mb,
                 cache_ttl_s, tenants, min_replicas, max_replicas,
                 autoscale_interval_s, op_name=None):
        self.name = name
        self.metrics = ServingMetrics(model_label=name)
        self.metrics.set_model(model.name, model.version)
        self.pool = ReplicaPool(model, n_replicas=replicas,
                                max_batch_size=max_batch_size,
                                warm=warm, op_name=op_name)
        self.cache = ResultCache(max_bytes=int(cache_mb * (1 << 20)),
                                 ttl_s=cache_ttl_s,
                                 model=name) if cache_mb else None
        self.admission = AdmissionController(capacity=max_queue,
                                             tenants=tenants,
                                             model=name)
        self.engine = DynamicBatcher(
            self.pool, max_batch_size=max_batch_size,
            batch_timeout_ms=batch_timeout_ms, max_queue=max_queue,
            metrics=self.metrics, cache=self.cache,
            admission=self.admission)
        self.autoscaler = None
        if max_replicas is not None and max_replicas > 0:
            self.autoscaler = Autoscaler(
                self.pool, self.engine,
                min_replicas=min_replicas or replicas,
                max_replicas=max_replicas,
                interval_s=autoscale_interval_s, model=name)

    @property
    def model(self):
        return self.pool.model

    def snapshot(self):
        snap = self.metrics.snapshot()
        snap["tenants"] = self.admission.stats()["tenants"]
        if self.autoscaler is not None:
            snap["autoscale"] = {
                "replicas": self.pool.size(),
                "min": self.autoscaler.min_replicas,
                "max": self.autoscaler.max_replicas,
            }
        return snap

    def stop(self):
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.engine.stop()
        self.pool.stop()


class ServingFrontend(object):
    """The serving process: model store + N model entries + HTTP.

    ``model`` is one :class:`ServeableModel` or artifact path, or a
    list or dict of them -- a dict's keys name the routes, otherwise
    each model's own name does. String sources load onto ``device``
    (the card by default). ``swap_model(source, name=...)`` hot-swaps
    one entry onto a new version (drain each replica in turn, promote,
    re-warm), then invalidates that model's result cache.
    ``trace_out``: :meth:`stop` dumps the trace buffer there (and, on
    the card, the allocator snapshot to ``<trace_out>.memprof``)."""

    def __init__(self, model, host="", port=8180, path="/api",
                 replicas=1, max_batch_size=64, batch_timeout_ms=5.0,
                 max_queue=256, response_timeout=30.0, warm=True,
                 cache_mb=64, cache_ttl_s=300.0, tenants=None,
                 tenant_header="X-Tenant", qos_header="X-QoS",
                 deadline_header="X-Deadline-Ms",
                 min_replicas=None, max_replicas=None,
                 autoscale_interval_s=0.5, store=None,
                 keep_last=None, device=None, trace_out=None):
        self.store = store or ModelStore(keep_last=keep_last)
        self.path = path
        self.response_timeout = float(response_timeout)
        self.tenant_header = tenant_header
        self.qos_header = qos_header
        self.deadline_header = deadline_header
        self.device = device
        self.trace_out = trace_out
        self.entries = {}
        if isinstance(model, dict):
            specs = list(model.items())
        elif isinstance(model, (list, tuple)):
            specs = [(None, m) for m in model]
        else:
            specs = [(None, model)]
        try:
            for name, source in specs:
                if isinstance(source, str):
                    served = self.store.load(source, name=name,
                                             device=device)
                else:
                    # keyed by the route: two routes serving variants
                    # that share a model name keep separate versions
                    served = self.store.add(source,
                                            version=source.version,
                                            name=name)
                route = name or served.name
                if route == "batch" or "/" in route:
                    raise ValueError(
                        "model route %r collides with the request "
                        "paths (rename it)" % route)
                if route in self.entries:
                    raise ValueError("duplicate model route %r"
                                     % route)
                # the first route's forwards are the cost book's
                # serve_forward:b<n> rows, a later route's its own
                self.entries[route] = _ModelEntry(
                    route, served, replicas, max_batch_size,
                    batch_timeout_ms, max_queue, warm, cache_mb,
                    cache_ttl_s, tenants, min_replicas, max_replicas,
                    autoscale_interval_s,
                    op_name=route if self.entries else None)
            self.default_route = next(iter(self.entries))
            self._server = _FrontendServer((host, port),
                                           _FrontendHandler)
        except Exception:
            # a later entry (or the bind) failing must not leak the
            # earlier entries' running pools and batcher threads
            for entry in self.entries.values():
                try:
                    entry.stop()
                except Exception:
                    _log.exception("entry %r cleanup failed", entry.name)
            raise
        self._server.frontend = self
        self.address = self._server.server_address
        self._thread = None
        self._reporter = None
        # continuous SLO evaluation (telemetry/alerts.py's rules)
        alerts.get_engine().start()

    @property
    def port(self):
        return self.address[1]

    # the default entry's accessors: with one model, it IS the frontend

    @property
    def default_entry(self):
        return self.entries[self.default_route]

    @property
    def model(self):
        return self.default_entry.model

    @property
    def metrics(self):
        return self.default_entry.metrics

    @property
    def pool(self):
        return self.default_entry.pool

    @property
    def engine(self):
        return self.default_entry.engine

    @property
    def cache(self):
        return self.default_entry.cache

    @property
    def admission(self):
        return self.default_entry.admission

    @property
    def autoscaler(self):
        return self.default_entry.autoscaler

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        for entry in self.entries.values():
            if entry.autoscaler is not None:
                entry.autoscaler.start()
        # retained metric history behind GET /history.json
        get_history().start()
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="serving-http")
        self._thread.start()
        for entry in self.entries.values():
            _log.info(
                "serving %s v%d on %s:%d%s (%s replica(s), max batch "
                "%d%s%s)", entry.model.name, entry.model.version,
                self.address[0] or "0.0.0.0", self.port,
                self._route_path(entry.name), entry.pool.size(),
                entry.pool.max_batch_size,
                ", cache %dMB" % (entry.cache.max_bytes >> 20)
                if entry.cache else "",
                ", autoscale [%d,%d]" % (
                    entry.autoscaler.min_replicas,
                    entry.autoscaler.max_replicas)
                if entry.autoscaler else "")
        return self

    def _route_path(self, route):
        return self.path if route == self.default_route \
            else "%s/%s" % (self.path, route)

    def stop(self):
        if self._reporter is not None:
            self._reporter.stop()
            self._reporter = None
        if self._thread is not None:
            # shutdown() waits for serve_forever: only after start()
            self._server.shutdown()
        self._server.server_close()
        for entry in self.entries.values():
            entry.stop()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self.trace_out:
            trace_out, self.trace_out = self.trace_out, None
            profiler.dump_trace(trace_out, "serve")

    def swap_model(self, source, name=None, version=None):
        """Register a new version of the ``name`` route's model (the
        default route's without one), promote its pool to it, then
        invalidate its result cache: no request is answered from a
        stale cached row after this returns."""
        entry = self._entry_for(name)
        if isinstance(source, str):
            model = self.store.load(source, name=entry.name,
                                    version=version, device=self.device)
        else:
            model = self.store.add(source, version=version,
                                   name=entry.name)
        if tuple(model.sample_shape) != tuple(entry.model.sample_shape):
            raise ValueError(
                "refusing hot-swap: new sample shape %s != serving %s"
                % (model.sample_shape, entry.model.sample_shape))
        entry.pool.swap(model)
        if entry.cache is not None:
            # after the promotion: the old version's keys can no longer
            # be looked up, and the epoch fences in-flight inserts
            entry.cache.invalidate()
        entry.metrics.set_model(model.name, model.version)
        return model

    def _entry_for(self, name):
        if name is None:
            return self.default_entry
        entry = self.entries.get(name)
        if entry is None:
            raise KeyError("no model route %r (have %s)"
                           % (name, sorted(self.entries)))
        return entry

    def report_to(self, web_status_address, interval=2.0, name=None):
        """POST the metrics block to a status dashboard every
        ``interval`` seconds."""
        self._reporter = _StatusReporter(
            self, web_status_address, interval=interval,
            name=name or self.model.name)
        self._reporter.start()
        return self._reporter

    # -- HTTP plumbing -----------------------------------------------------

    def _fail(self, handler, endpoint, message, code=400, rid=None,
              headers=None, t0=None, entry=None):
        if code == 503:
            _log.debug(message)         # expected shedding under overload
        else:
            _log.warning(message)
        payload = {"error": message}
        if rid is not None:
            payload["id"] = rid
        respond_json(handler, code, payload, headers=headers)
        (entry or self.default_entry).metrics.record_request(
            endpoint, code,
            (time.time() - t0) * 1000.0 if t0 else None)

    def handle_get(self, handler):
        if handler.path.startswith("/profile.json"):
            respond_json(handler, 200, profiler.profile_report())
        elif handler.path.startswith("/alerts.json"):
            respond_json(handler, 200, alerts.get_engine().report())
        elif handler.path.startswith("/history.json"):
            query = parse_qs(urlsplit(handler.path).query)
            try:
                respond_json(handler, 200, get_history().query(
                    series=(query.get("series") or [None])[0],
                    since=(query.get("since") or [None])[0]))
            except (TypeError, ValueError):
                respond_json(handler, 400, {"error": "bad since cursor"})
        elif handler.path.startswith("/metrics.json"):
            out = self.default_entry.snapshot()
            if len(self.entries) > 1:
                out["models"] = {name: entry.snapshot()
                                 for name, entry in self.entries.items()}
            respond_json(handler, 200, out)
        elif handler.path.startswith("/metrics"):
            body = get_registry().render_prometheus().encode("utf-8")
            handler.send_response(200)
            handler.send_header("Content-Type",
                                "text/plain; version=0.0.4")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        elif handler.path.startswith("/healthz"):
            respond_json(handler, 200, {
                "status": "ok", "model": self.model.name,
                "version": self.model.version,
                "sample_shape": list(self.model.sample_shape),
                "device": str(self.model.device),
                "replicas": self.pool.size(),
                "models": {
                    name: {"name": entry.model.name,
                           "version": entry.model.version,
                           "replicas": entry.pool.size(),
                           "path": self._route_path(name)}
                    for name, entry in self.entries.items()}})
        else:
            respond_json(handler, 404, {"error": "not found"})

    def _route(self, path):
        """``(entry, endpoint, batched)`` for a POST path, or None."""
        if not path.startswith(self.path):
            return None
        rest = path[len(self.path):]
        if rest in ("", "/"):
            return self.default_entry, self.path, False
        if rest == "/batch":
            return self.default_entry, self.path + "/batch", True
        if not rest.startswith("/"):
            return None         # /apialpha must not route to "alpha"
        parts = rest.lstrip("/").split("/")
        entry = self.entries.get(parts[0])
        if entry is None:
            return None
        if len(parts) == 1:
            return entry, self._route_path(parts[0]), False
        if len(parts) == 2 and parts[1] == "batch":
            return entry, self._route_path(parts[0]) + "/batch", True
        return None

    def handle_post(self, handler):
        t0 = time.time()
        # unread bytes on a keep-alive connection corrupt the next request
        if handler.headers.get("Transfer-Encoding"):
            handler.close_connection = True
            self._fail(handler, handler.path, "Content-Length required "
                       "(Transfer-Encoding is not supported)", code=411,
                       t0=t0)
            return
        try:
            length = int(handler.headers.get("Content-Length", 0))
            raw = handler.rfile.read(length)
        except (TypeError, ValueError):
            handler.close_connection = True
            self._fail(handler, handler.path, "Invalid Content-Length",
                       t0=t0)
            return
        routed = self._route(handler.path)
        if routed is None:
            self._fail(handler, handler.path,
                       "API path %s is not supported" % handler.path,
                       code=404, t0=t0)
            return
        entry, endpoint, batched = routed
        ctype = (handler.headers.get("Content-Type") or "").split(";")[0]
        if ctype.strip() != "application/json":
            self._fail(handler, endpoint, "Unsupported Content-Type "
                       "(must be \"application/json\")", t0=t0,
                       entry=entry)
            return
        try:
            request = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            self._fail(handler, endpoint, "Failed to parse JSON", t0=t0,
                       entry=entry)
            return
        body = request if isinstance(request, dict) else {}
        rid = body.get("id")
        tenant = handler.headers.get(self.tenant_header) or \
            body.get("tenant")
        qos = handler.headers.get(self.qos_header) or body.get("qos")
        if qos is not None and qos not in QOS_MULTIPLIER:
            self._fail(handler, endpoint,
                       "Unknown QoS class %r (one of %s)"
                       % (qos, sorted(QOS_MULTIPLIER)), rid=rid, t0=t0,
                       entry=entry)
            return
        deadline_ms = handler.headers.get(self.deadline_header) or \
            body.get("deadline_ms")
        deadline = None
        if deadline_ms is not None:
            try:
                deadline_ms = float(deadline_ms)
                if deadline_ms <= 0:
                    raise ValueError(deadline_ms)
            except (TypeError, ValueError):
                self._fail(handler, endpoint,
                           "Invalid %s value %r (positive "
                           "milliseconds)" % (self.deadline_header,
                                              deadline_ms),
                           rid=rid, t0=t0, entry=entry)
                return
            # relative budget -> absolute deadline at arrival
            deadline = t0 + deadline_ms / 1000.0
        # the request's span (and every span under it on this thread)
        # carries the client's X-Request-Id / "id"
        trace_id = tracing.trace_id_from_request(handler.headers, rid)
        try:
            with tracing.request_span("http:%s" % endpoint,
                                      trace_id=trace_id):
                if batched:
                    self._serve_batch(handler, entry, endpoint, request,
                                      rid, t0, tenant, qos, deadline)
                else:
                    self._serve_one(handler, entry, endpoint, request,
                                    rid, t0, tenant, qos, deadline)
        except EngineOverloaded as e:
            self._fail(handler, endpoint, str(e), code=503, rid=rid,
                       headers={"Retry-After": str(e.retry_after)},
                       t0=t0, entry=entry)

    def _serve_one(self, handler, entry, endpoint, request, rid, t0,
                   tenant, qos, deadline=None):
        data, error = parse_payload(request)
        if error is not None:
            self._fail(handler, endpoint, error, rid=rid, t0=t0,
                       entry=entry)
            return
        try:
            future = entry.engine.submit(data, tenant=tenant, qos=qos,
                                         deadline=deadline)
        except ValueError as e:
            self._fail(handler, endpoint, "Invalid input value: %s" % e,
                       rid=rid, t0=t0, entry=entry)
            return
        self._await_and_reply(handler, entry, endpoint, [future], rid,
                              t0, single=True)

    def _serve_batch(self, handler, entry, endpoint, request, rid, t0,
                     tenant, qos, deadline=None):
        if not isinstance(request, dict) or "codec" not in request or \
                ("inputs" not in request and "input" not in request):
            self._fail(handler, endpoint, "Invalid input format: there "
                       "must be \"inputs\" and \"codec\" attributes",
                       rid=rid, t0=t0, entry=entry)
            return
        if "inputs" in request:
            rows_spec = request["inputs"]
            if not isinstance(rows_spec, list) or not rows_spec:
                self._fail(handler, endpoint,
                           "\"inputs\" must be a non-empty array",
                           rid=rid, t0=t0, entry=entry)
                return
            if request["codec"] == "list":
                try:
                    rows = [numpy.array(r, numpy.float32)
                            for r in rows_spec]
                except (TypeError, ValueError):
                    self._fail(handler, endpoint,
                               "Invalid input array format", rid=rid,
                               t0=t0, entry=entry)
                    return
            else:
                rows = []
                for r in rows_spec:
                    data, error = parse_payload(
                        dict(request, input=r, inputs=None))
                    if error is not None:
                        self._fail(handler, endpoint, error, rid=rid,
                                   t0=t0, entry=entry)
                        return
                    rows.append(data)
        else:
            # base64 with a leading batch axis in "shape"
            data, error = parse_payload(request)
            if error is not None:
                self._fail(handler, endpoint, error, rid=rid, t0=t0,
                           entry=entry)
                return
            rows = list(data)
        try:
            futures = entry.engine.submit_many(
                rows, tenant=tenant, qos=qos, deadline=deadline)
        except ValueError as e:
            # rows already admitted still complete; their results are
            # dropped with the failed request
            self._fail(handler, endpoint, "Invalid input value: %s" % e,
                       rid=rid, t0=t0, entry=entry)
            return
        self._await_and_reply(handler, entry, endpoint, futures, rid,
                              t0, single=False)

    def _await_and_reply(self, handler, entry, endpoint, futures, rid,
                         t0, single):
        try:
            deadline = t0 + self.response_timeout
            results = [f.result(timeout=max(deadline - time.time(),
                                            0.001))
                       for f in futures]
        except concurrent.futures.TimeoutError:
            self._fail(handler, endpoint,
                       "The model did not respond in time", code=500,
                       rid=rid, t0=t0, entry=entry)
            return
        except DeadlineExceeded as e:
            self._fail(handler, endpoint, str(e), code=504, rid=rid,
                       t0=t0, entry=entry)
            return
        except EngineOverloaded:
            raise
        except Exception as e:
            self._fail(handler, endpoint, "inference failed: %s"
                       % (str(e) or type(e).__name__), code=500,
                       rid=rid, t0=t0, entry=entry)
            return
        payload = {"result": results[0]} if single else {"results": results}
        if rid is not None:
            payload["id"] = rid
        respond_json(handler, 200, payload)
        entry.metrics.record_request(endpoint, 200,
                                     (time.time() - t0) * 1000.0)


class _StatusReporter(object):
    """POSTs the serving block to a status dashboard's ``/update``
    every ``interval`` seconds (the JAX package's ``_payload``)."""

    def __init__(self, frontend, address, interval=2.0, name="serving"):
        if isinstance(address, str):
            host, _, port = address.partition(":")
            address = (host or "127.0.0.1", int(port or 8090))
        self.url = "http://%s:%d/update" % tuple(address)
        self.frontend = frontend
        self.interval = interval
        self.name = name
        self.id = str(uuid.uuid4())
        self._started = time.time()
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serving-status")
        self._thread.start()
        return self

    def _payload(self):
        return {
            "id": self.id,
            "name": self.name,
            "mode": "serve",
            "master": self.frontend.address[0] or "localhost",
            "time": time.time() - self._started,
            "units": sum(e.pool.size()
                         for e in self.frontend.entries.values()),
            "stopped": False,
            "serving": self.frontend.metrics.dashboard_block(),
        }

    def _post_once(self):
        import urllib.request
        try:
            req = urllib.request.Request(
                self.url,
                data=json.dumps(self._payload(),
                                cls=_NumpyJSONEncoder).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=2.0).close()
        except Exception as e:
            _log.debug("web_status push failed: %s", e)

    def _loop(self):
        while not self._stop.wait(self.interval):
            self._post_once()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def _parse_tenants(specs):
    """``name:weight[:qos]`` flags -> the AdmissionController map."""
    tenants = {}
    for spec in specs or ():
        parts = spec.split(":")
        if not parts[0]:
            raise ValueError("tenant spec %r needs a name" % spec)
        entry = {"weight": float(parts[1]) if len(parts) > 1 else 1.0}
        if len(parts) > 2:
            if parts[2] not in QOS_MULTIPLIER:
                raise ValueError(
                    "tenant spec %r: unknown QoS %r (one of %s)"
                    % (spec, parts[2], sorted(QOS_MULTIPLIER)))
            entry["qos"] = parts[2]
        tenants[parts[0]] = entry
    return tenants or None


def _parse_models(specs):
    """``[name=]path`` flags -> the ServingFrontend model dict."""
    models = {}
    for spec in specs:
        name, sep, path = spec.partition("=")
        if not sep or "://" in name:
            # no name, or the "=" is inside a URI's query
            name, path = None, spec
        if name in models:
            # dict insertion would silently drop one artifact
            if name is None:
                raise ValueError("with multiple --model flags, every "
                                 "one needs a name= prefix")
            raise ValueError("duplicate model route %r (--model %s)"
                             % (name, spec))
        models[name] = path
    if len(models) == 1:
        name, path = next(iter(models.items()))
        return path if name is None else {name: path}
    if None in models:
        raise ValueError("with multiple --model flags, every one "
                         "needs a name= prefix")
    return models


#: the JAX command's flags the port refuses: none
REFUSED_FLAGS = {}


def _parser():
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch serve",
        description="dynamic-batching inference server on the card")
    parser.add_argument("--model", required=True, action="append",
                        help="snapshot file or directory, snapshot URI "
                             "(http(s)://..., sqlite://<db>[#key]), or "
                             "export package; repeat with name=path to "
                             "serve several models from one process")
    parser.add_argument("--name", default=None,
                        help="model name in the store (default: the "
                             "artifact's; single --model only)")
    parser.add_argument("--host", default="")
    parser.add_argument("--port", type=int, default=8180)
    parser.add_argument("--path", default="/api")
    parser.add_argument("--replicas", type=int, default=1,
                        help="initial replica-pool size per model")
    parser.add_argument("--min-replicas", type=int, default=None,
                        help="autoscaler floor (default: --replicas)")
    parser.add_argument("--max-replicas", type=int, default=None,
                        help="autoscaler ceiling; setting it enables "
                             "the autoscaler")
    parser.add_argument("--max-batch-size", type=int, default=64)
    parser.add_argument("--batch-timeout-ms", type=float, default=5.0)
    parser.add_argument("--max-queue", type=int, default=256,
                        help="admission bound; beyond it requests get "
                             "503 + Retry-After")
    parser.add_argument("--cache-mb", type=float, default=64.0,
                        help="result-cache byte budget per model "
                             "(0 disables the cache)")
    parser.add_argument("--cache-ttl-s", type=float, default=300.0)
    parser.add_argument("--tenant", action="append", metavar="SPEC",
                        help="name:weight[:qos] -- pre-register a "
                             "tenant admission bucket (qos one of "
                             "interactive/batch/best_effort); repeat "
                             "per tenant")
    parser.add_argument("--keep-last", type=int, default=None,
                        help="retain at most K versions per model "
                             "(pinned exempt)")
    parser.add_argument("--response-timeout", type=float, default=30.0)
    parser.add_argument("--web-status", default=None, metavar="HOST:PORT",
                        help="push serving metrics to this dashboard")
    parser.add_argument("--trace-out", default=None, metavar="FILE",
                        help="enable span tracing and dump the trace "
                             "buffer (Chrome trace-event JSON, open in "
                             "Perfetto) to FILE at exit")
    parser.add_argument("-a", "--backend", default="auto",
                        choices=["auto", "cuda", "cpu"],
                        help="where to serve: the CUDA card (auto, the "
                             "default) or the CPU")
    parser.add_argument("-d", "--device", default=None,
                        help="CUDA device index")
    parser.add_argument("-v", "--verbosity", default="info",
                        choices=["debug", "info", "warning", "error"])
    return parser


def serve(argv=None):
    """Parse ``serve``'s arguments, load the models onto the card and
    start the frontend; returns it (``stop()`` ends it and writes the
    ``--trace-out`` files)."""
    args = _parser().parse_args(argv)
    from veles_tpu_torch.launcher import resolve_backend
    from veles_tpu_torch.logger import setup_logging
    setup_logging(getattr(logging, args.verbosity.upper()))
    models = _parse_models(args.model)
    if args.name and isinstance(models, str):
        models = {args.name: models}
    tenants = _parse_tenants(args.tenant)
    device = resolve_backend(args.backend, args.device)
    if args.trace_out:
        profiler.start_trace(args.trace_out)
    profiler.start_memory_sampler()
    frontend = ServingFrontend(
        models, host=args.host, port=args.port, path=args.path,
        replicas=args.replicas, max_batch_size=args.max_batch_size,
        batch_timeout_ms=args.batch_timeout_ms, max_queue=args.max_queue,
        response_timeout=args.response_timeout,
        cache_mb=args.cache_mb, cache_ttl_s=args.cache_ttl_s,
        tenants=tenants, min_replicas=args.min_replicas,
        max_replicas=args.max_replicas, keep_last=args.keep_last,
        device=device, trace_out=args.trace_out)
    if args.web_status:
        frontend.report_to(args.web_status)
    return frontend.start()


def main(argv=None):
    """``python -m veles_tpu_torch serve ...``: serve until interrupted."""
    frontend = serve(argv)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        frontend.stop()
    return 0
