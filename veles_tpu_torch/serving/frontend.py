"""HTTP frontend of the serving engine, for one model route.

The port of ``veles_tpu/serving/frontend.py`` with the same request
contract (``veles_tpu/restful_api.py``):

* ``POST <path>`` with ``{"input": ..., "codec": "list"|"base64"[,
  "shape", "type", "id"]}`` -> ``{"result": [...][, "id"]}``;
* ``POST <path>/batch`` with ``{"inputs": [...], "codec": ...}`` (or
  base64 ``"input"`` with a leading batch axis in ``"shape"``) ->
  ``{"results": [...]}`` in order;
* ``GET /healthz`` -> liveness and the model's name, version and shape.

Malformed requests answer 400 with ``{"error": ...}``. Overload answers
503 with ``Retry-After`` (computed from the tenant's own drain rate);
a request whose ``X-Deadline-Ms`` budget passed while it queued answers
504. ``X-Tenant`` / ``X-QoS`` (or the body's ``"tenant"`` / ``"qos"``)
pick the admission bucket.

:func:`main` is ``python -m veles_tpu_torch serve --model <snapshot
file or directory | export package>`` with the JAX command's
``--name``, ``--host``, ``--port``, ``--path``, ``--replicas``,
``--max-batch-size``, ``--batch-timeout-ms``, ``--max-queue``,
``--keep-last``, ``--response-timeout`` and ``-v``, and the training
command's ``-a/--backend`` and ``-d/--device`` (the card unless ``-a
cpu``); :func:`serve` parses the same arguments and returns the started
frontend.

Not ported yet: multi-model routing (a second ``--model``), the result
cache (``--cache-mb``, ``--cache-ttl-s``), pre-registered tenants
(``--tenant``), the autoscaler (``--min-replicas``, ``--max-replicas``),
the status reporter (``--web-status``) and tracing (``--trace-out``):
each of those flags raises ``NotImplementedError`` naming it. Nor are
metrics endpoints, alerts and history.
"""

import argparse
import base64
import binascii
import concurrent.futures
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy

from veles_tpu_torch.serving.admission import (QOS_MULTIPLIER,
                                               AdmissionController)
from veles_tpu_torch.serving.engine import (DeadlineExceeded,
                                            DynamicBatcher,
                                            EngineOverloaded)
from veles_tpu_torch.serving.model_store import ModelStore
from veles_tpu_torch.serving.replica import ReplicaPool

_log = logging.getLogger(__name__)


# -- the request contract (copied from veles_tpu/restful_api.py) -----------

class _NumpyJSONEncoder(json.JSONEncoder):
    """Serializes numpy scalars and arrays."""

    def default(self, obj):
        if isinstance(obj, numpy.ndarray):
            return obj.tolist()
        if isinstance(obj, numpy.integer):
            return int(obj)
        if isinstance(obj, numpy.floating):
            return float(obj)
        return super(_NumpyJSONEncoder, self).default(obj)


def respond_json(handler, code, payload, headers=None):
    """Write one JSON response with Content-Length and extra headers."""
    body = json.dumps(payload, cls=_NumpyJSONEncoder).encode("utf-8")
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(body)))
    for key, value in (headers or {}).items():
        handler.send_header(key, value)
    handler.end_headers()
    handler.wfile.write(body)


def decode_base64_payload(request):
    """The base64 codec: needs "shape" and "type" attributes. Returns
    ``(array, None)`` or ``(None, error_message)``."""
    if "shape" not in request:
        return None, ("There is no \"shape\" attribute which "
                      "defines the input array shape")
    shape = request["shape"]
    if not isinstance(shape, list) or len(shape) < 1:
        return None, "\"shape\" must be a non-trivial array"
    if request.get("type") is None:
        return None, ("There is no \"type\" attribute which "
                      "defines the array data type (e.g., "
                      "\"float32\" or \"uint8\", see numpy.dtype)")
    dtype_name = request["type"]
    if not isinstance(dtype_name, str):
        return None, "\"type\" must be a string dtype name"
    byte_order = None
    if dtype_name and dtype_name[-1] in "<=>":
        byte_order = dtype_name[-1]
        dtype_name = dtype_name[:-1]
    try:
        dtype = numpy.dtype(dtype_name)
    except TypeError:
        return None, ("Invalid \"type\" value. For the list of "
                      "supported values, see numpy.dtype.")
    if byte_order is not None:
        dtype = dtype.newbyteorder(byte_order)
    try:
        buf = base64.b64decode(request["input"])
    except (binascii.Error, TypeError) as e:
        return None, "Failed to decode base64: %s." % e
    try:
        return numpy.frombuffer(buf, dtype).reshape(shape), None
    except Exception as e:
        return None, "Failed to create the numpy array: %s." % e


def parse_payload(request):
    """Validate and decode one ``{"input":..., "codec":...}`` request.
    Returns ``(array, None)`` or ``(None, error_message)``."""
    if not isinstance(request, dict) or "input" not in request \
            or "codec" not in request:
        return None, ("Invalid input format: there must be "
                      "\"input\" and \"codec\" attributes")
    codec = request["codec"]
    if codec not in ("list", "base64"):
        return None, ("Invalid codec value: must be either "
                      "\"list\" or \"base64\"")
    if codec == "list":
        try:
            return numpy.array(request["input"], numpy.float32), None
        except (TypeError, ValueError):
            return None, "Invalid input array format"
    return decode_base64_payload(request)


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


class ServingFrontend(object):
    """Model store + replica pool + dynamic batcher + HTTP server."""

    def __init__(self, model, host="", port=8180, path="/api",
                 replicas=1, max_batch_size=64, batch_timeout_ms=5.0,
                 max_queue=256, response_timeout=30.0, warm=True,
                 tenants=None, tenant_header="X-Tenant",
                 qos_header="X-QoS", deadline_header="X-Deadline-Ms",
                 store=None):
        self.store = store or ModelStore()
        self.path = path
        self.response_timeout = float(response_timeout)
        self.tenant_header = tenant_header
        self.qos_header = qos_header
        self.deadline_header = deadline_header
        served = self.store.add(model, version=model.version)
        self.pool = ReplicaPool(served, n_replicas=replicas,
                                max_batch_size=max_batch_size, warm=warm)
        self.admission = AdmissionController(capacity=max_queue,
                                             tenants=tenants)
        self.engine = DynamicBatcher(
            self.pool, max_batch_size=max_batch_size,
            batch_timeout_ms=batch_timeout_ms, max_queue=max_queue,
            admission=self.admission)
        try:
            self._server = _FrontendServer((host, port), _FrontendHandler)
        except Exception:
            self.engine.stop()
            self.pool.stop()
            raise
        self._server.frontend = self
        self.address = self._server.server_address
        self._thread = None

    @property
    def port(self):
        return self.address[1]

    @property
    def model(self):
        return self.pool.model

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="serving-http")
        self._thread.start()
        _log.info("serving %s v%d on %s:%d%s (%d replica(s), max batch "
                  "%d)", self.model.name, self.model.version,
                  self.address[0] or "0.0.0.0", self.port, self.path,
                  self.pool.size(), self.pool.max_batch_size)
        return self

    def stop(self):
        if self._thread is not None:
            # shutdown() waits for serve_forever: only after start()
            self._server.shutdown()
        self._server.server_close()
        self.engine.stop()
        self.pool.stop()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def swap_model(self, model, version=None):
        """Register a new version and promote the pool to it."""
        if tuple(model.sample_shape) != tuple(self.model.sample_shape):
            raise ValueError(
                "refusing hot-swap: new sample shape %s != serving %s"
                % (model.sample_shape, self.model.sample_shape))
        model = self.store.add(model, version=version,
                               name=self.model.name)
        self.pool.swap(model)
        return model

    # -- HTTP plumbing -----------------------------------------------------

    @staticmethod
    def _fail(handler, message, code=400, rid=None, headers=None):
        if code == 503:
            _log.debug(message)         # expected shedding under overload
        else:
            _log.warning(message)
        payload = {"error": message}
        if rid is not None:
            payload["id"] = rid
        respond_json(handler, code, payload, headers=headers)

    def handle_get(self, handler):
        if handler.path.startswith("/healthz"):
            respond_json(handler, 200, {
                "status": "ok", "model": self.model.name,
                "version": self.model.version,
                "sample_shape": list(self.model.sample_shape),
                "device": str(self.model.device),
                "replicas": self.pool.size()})
        else:
            respond_json(handler, 404, {"error": "not found"})

    def handle_post(self, handler):
        t0 = time.time()
        # unread bytes on a keep-alive connection corrupt the next request
        if handler.headers.get("Transfer-Encoding"):
            handler.close_connection = True
            self._fail(handler, "Content-Length required "
                       "(Transfer-Encoding is not supported)", code=411)
            return
        try:
            length = int(handler.headers.get("Content-Length", 0))
            raw = handler.rfile.read(length)
        except (TypeError, ValueError):
            handler.close_connection = True
            self._fail(handler, "Invalid Content-Length")
            return
        path = handler.path.rstrip("/") or "/"
        if path == self.path:
            batched = False
        elif path == self.path + "/batch":
            batched = True
        else:
            self._fail(handler, "API path %s is not supported"
                       % handler.path, code=404)
            return
        ctype = (handler.headers.get("Content-Type") or "").split(";")[0]
        if ctype.strip() != "application/json":
            self._fail(handler, "Unsupported Content-Type "
                       "(must be \"application/json\")")
            return
        try:
            request = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            self._fail(handler, "Failed to parse JSON")
            return
        body = request if isinstance(request, dict) else {}
        rid = body.get("id")
        tenant = handler.headers.get(self.tenant_header) or \
            body.get("tenant")
        qos = handler.headers.get(self.qos_header) or body.get("qos")
        if qos is not None and qos not in QOS_MULTIPLIER:
            self._fail(handler, "Unknown QoS class %r (one of %s)"
                       % (qos, sorted(QOS_MULTIPLIER)), rid=rid)
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
                self._fail(handler, "Invalid %s value %r (positive "
                           "milliseconds)" % (self.deadline_header,
                                              deadline_ms), rid=rid)
                return
            # relative budget -> absolute deadline at arrival
            deadline = t0 + deadline_ms / 1000.0
        try:
            if batched:
                rows = self._batch_rows(handler, request, rid)
            else:
                data, error = parse_payload(request)
                if error is not None:
                    self._fail(handler, error, rid=rid)
                    return
                rows = [data]
            if rows is None:
                return
            futures = []
            try:
                for row in rows:
                    futures.append(self.engine.submit(
                        row, tenant=tenant, qos=qos, deadline=deadline))
            except ValueError as e:
                # rows already admitted still complete; their results
                # are dropped with the failed request
                self._fail(handler, "Invalid input value: %s" % e,
                           rid=rid)
                return
            self._await_and_reply(handler, futures, rid, t0,
                                  single=not batched)
        except EngineOverloaded as e:
            self._fail(handler, str(e), code=503, rid=rid,
                       headers={"Retry-After": str(e.retry_after)})

    def _batch_rows(self, handler, request, rid):
        """The rows of a batch request, or None after answering 400."""
        if not isinstance(request, dict) or "codec" not in request or \
                ("inputs" not in request and "input" not in request):
            self._fail(handler, "Invalid input format: there must be "
                       "\"inputs\" and \"codec\" attributes", rid=rid)
            return None
        if "inputs" not in request:
            # base64 with a leading batch axis in "shape"
            data, error = parse_payload(request)
            if error is not None:
                self._fail(handler, error, rid=rid)
                return None
            return list(data)
        rows_spec = request["inputs"]
        if not isinstance(rows_spec, list) or not rows_spec:
            self._fail(handler, "\"inputs\" must be a non-empty array",
                       rid=rid)
            return None
        rows = []
        for r in rows_spec:
            data, error = parse_payload(dict(request, input=r, inputs=None))
            if error is not None:
                self._fail(handler, error, rid=rid)
                return None
            rows.append(data)
        return rows

    def _await_and_reply(self, handler, futures, rid, t0, single):
        try:
            deadline = t0 + self.response_timeout
            results = [f.result(timeout=max(deadline - time.time(), 0.001))
                       for f in futures]
        except concurrent.futures.TimeoutError:
            self._fail(handler, "The model did not respond in time",
                       code=500, rid=rid)
            return
        except DeadlineExceeded as e:
            self._fail(handler, str(e), code=504, rid=rid)
            return
        except EngineOverloaded:
            raise
        except Exception as e:
            self._fail(handler, "inference failed: %s"
                       % (str(e) or type(e).__name__), code=500, rid=rid)
            return
        payload = {"result": results[0]} if single else {"results": results}
        if rid is not None:
            payload["id"] = rid
        respond_json(handler, 200, payload)


#: the JAX command's flags whose machinery the port lacks, and why
REFUSED_FLAGS = {
    "cache_mb": ("--cache-mb", "the result cache"),
    "cache_ttl_s": ("--cache-ttl-s", "the result cache"),
    "tenant": ("--tenant", "pre-registered tenant buckets"),
    "min_replicas": ("--min-replicas", "the autoscaler"),
    "max_replicas": ("--max-replicas", "the autoscaler"),
    "web_status": ("--web-status", "the status reporter"),
    "trace_out": ("--trace-out", "span tracing"),
}


def _parser():
    parser = argparse.ArgumentParser(
        prog="veles_tpu_torch serve",
        description="dynamic-batching inference server on the card")
    parser.add_argument("--model", required=True, action="append",
                        help="snapshot file or directory, or export "
                             "package (directory or .tar)")
    parser.add_argument("--name", default=None,
                        help="model name in the store (default: the "
                             "artifact's)")
    parser.add_argument("--host", default="")
    parser.add_argument("--port", type=int, default=8180)
    parser.add_argument("--path", default="/api")
    parser.add_argument("--replicas", type=int, default=1)
    parser.add_argument("--max-batch-size", type=int, default=64)
    parser.add_argument("--batch-timeout-ms", type=float, default=5.0)
    parser.add_argument("--max-queue", type=int, default=256,
                        help="admission bound; beyond it requests get "
                             "503 + Retry-After")
    parser.add_argument("--keep-last", type=int, default=None,
                        help="retain at most K versions per model "
                             "(pinned exempt)")
    parser.add_argument("--response-timeout", type=float, default=30.0)
    parser.add_argument("-a", "--backend", default="auto",
                        choices=["auto", "cuda", "cpu"],
                        help="where to serve: the CUDA card (auto, the "
                             "default) or the CPU")
    parser.add_argument("-d", "--device", default=None,
                        help="CUDA device index")
    parser.add_argument("-v", "--verbosity", default="info",
                        choices=["debug", "info", "warning", "error"])
    for dest, (flag, _) in sorted(REFUSED_FLAGS.items()):
        parser.add_argument(flag, dest=dest, default=None,
                            action="append" if dest == "tenant" else None,
                            help="not in the port yet")
    return parser


def serve(argv=None):
    """Parse ``serve``'s arguments, load the model onto the card and
    start the frontend; returns it (``stop()`` ends it)."""
    args = _parser().parse_args(argv)
    for dest, (flag, machinery) in sorted(REFUSED_FLAGS.items()):
        if getattr(args, dest) is not None:
            raise NotImplementedError(
                "%s: %s is not in the port yet" % (flag, machinery))
    if len(args.model) > 1:
        raise NotImplementedError(
            "--model given %d times: multi-model routing is not in the "
            "port yet" % len(args.model))
    from veles_tpu_torch.launcher import resolve_backend
    from veles_tpu_torch.logger import setup_logging
    setup_logging(getattr(logging, args.verbosity.upper()))
    store = ModelStore(keep_last=args.keep_last)
    model = store.load(args.model[0], name=args.name,
                       device=resolve_backend(args.backend, args.device))
    frontend = ServingFrontend(
        model, host=args.host, port=args.port, path=args.path,
        replicas=args.replicas, max_batch_size=args.max_batch_size,
        batch_timeout_ms=args.batch_timeout_ms, max_queue=args.max_queue,
        response_timeout=args.response_timeout, store=store)
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
