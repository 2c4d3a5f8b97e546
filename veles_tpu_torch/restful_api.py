"""The RESTful inference unit and the HTTP request contract
(``veles_tpu/restful_api.py``).

:class:`RESTfulAPI` turns a workflow into an HTTP service: ``POST
<path>`` with a JSON body ``{"input": <data>, "codec": "list"|"base64"[,
"shape": [...], "type": "float32"][, "id": ...]}`` feeds the decoded
sample into the workflow's :class:`~veles_tpu_torch.loader.restful.
RestfulLoader`, the forward runs, and the reply is ``{"result": <output
row>}``, with the request's ``"id"`` echoed. A malformed request gets
``{"error": ...}`` and HTTP 400 (404 for another path, 411 for a chunked
body). Admission is bounded: beyond ``max_pending`` requests waiting on
the workflow a request gets 503 and ``Retry-After`` at once. One forward
answers up to ``batch_size`` pending requests when the loader coalesces
them (``api.link_attrs(loader, ("batch_size", "minibatch_size"))``).

The server is a stdlib ``ThreadingHTTPServer`` on a daemon thread; the
requests meet the workflow's loop through the loader's queue and a FIFO
of pending replies, fed under one lock so that row i of a forward
belongs to the i-th oldest request. The full serving engine
(``serving/frontend.py``) shares this module's request contract:
:func:`parse_payload`, :func:`decode_base64_payload` and
:func:`respond_json`.

Wiring::

    loader = RestfulLoader(workflow=wf, sample_shape=...)
    api = RESTfulAPI(wf, port=0)
    api.link_from(last_forward)
    api.link_attrs(last_forward, ("input", "output"))
    api.feed = loader.feed
"""

import base64
import binascii
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy
import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.units import Unit


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
    """Write one JSON response (numpy-aware) with Content-Length and
    extra headers: the response half of the request contract."""
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
    Returns ``(array, None)`` or ``(None, error_message)``: the one copy
    of the request contract of both HTTP services."""
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


class _APIHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # to the unit's logger
        self.server.api.debug("http: " + fmt, *args)

    def do_POST(self):
        self.server.api.serve(self)


class _APIServer(ThreadingHTTPServer):
    daemon_threads = True
    # the stdlib backlog (5) turns a burst of connects into SYN
    # retransmit stalls; the service sheds load itself (max_pending)
    request_queue_size = 128


class RESTfulAPI(Unit):
    """Serves the owning workflow's forward over HTTP.

    Demands ``feed`` (the loader's feed method) and ``input`` (the last
    forward's ``output``). ``result_transform``, if given, maps a raw
    output row (a numpy array) to the reply's ``result``."""

    def __init__(self, workflow, **kwargs):
        kwargs["view_group"] = "SERVICE"
        self.host = kwargs.pop("host", root.common.api.get("host",
                                                           "localhost"))
        self.port = kwargs.pop("port", root.common.api.get("port", 8180))
        self.path = kwargs.pop("path", root.common.api.get("path", "/api"))
        self.result_transform = kwargs.pop("result_transform", None)
        #: seconds a request waits for the workflow before HTTP 500
        self.response_timeout = kwargs.pop("response_timeout", 60.0)
        #: admission bound: beyond it, 503 and Retry-After at once
        self.max_pending = kwargs.pop("max_pending", 128)
        super(RESTfulAPI, self).__init__(workflow, **kwargs)
        #: replies one forward answers; link to the loader's
        #: ``minibatch_size`` when it coalesces requests
        self.batch_size = 1
        self.address = None
        self.demand("feed", "input")

    def init_unpickled(self):
        super(RESTfulAPI, self).init_unpickled()
        self._server_ = None
        self._pending_ = []
        self._pending_lock_ = threading.Lock()

    # -- validated properties --------------------------------------------

    @property
    def port(self):
        return self._port

    @port.setter
    def port(self, value):
        if not isinstance(value, int):
            raise ValueError("port must be an integer (got %s)" % type(value))
        if value < 0 or value > 65535:
            raise ValueError("port is out of range (%d)" % value)
        self._port = value

    @property
    def path(self):
        return self._path

    @path.setter
    def path(self, value):
        if not value.startswith("/"):
            raise ValueError("Invalid path: %s" % value)
        self._path = value

    # -- lifecycle ---------------------------------------------------------

    def initialize(self, **kwargs):
        self._server_ = _APIServer((self.host, self.port), _APIHandler)
        self._server_.api = self
        self.address = self._server_.server_address
        self.port = self.address[1]
        threading.Thread(target=self._server_.serve_forever, daemon=True,
                         name="%s-http" % self.name).start()
        # stop serving (and answer the waiting requests) when the
        # workflow ends
        from veles_tpu_torch.workflow import Workflow
        if isinstance(self.workflow, Workflow):
            self.workflow.add_finished_callback(self.stop)
        self.info("listening on %s:%d%s", self.host, self.port, self.path)

    def stop(self):
        if self._server_ is not None:
            self._server_.shutdown()
            self._server_.server_close()
            self._server_ = None
        with self._pending_lock_:
            pending, self._pending_ = self._pending_, []
        for slot in pending:
            slot["error"] = "service stopped"
            slot["event"].set()

    # -- workflow side -----------------------------------------------------

    def run(self):
        """One forward finished: answer the oldest request(s), up to
        ``batch_size`` of them, row i to the i-th oldest."""
        try:
            count = max(1, int(self.batch_size))
        except (TypeError, ValueError):
            count = 1
        with self._pending_lock_:
            if not self._pending_:
                return  # e.g. the EOF minibatch that stops the loop
            count = min(count, len(self._pending_))
            slots, self._pending_ = (self._pending_[:count],
                                     self._pending_[count:])
        out = self.input[:count]
        if isinstance(out, torch.Tensor):
            out = out.detach().cpu().numpy()
        out = numpy.array(out, copy=True)
        for i, slot in enumerate(slots):
            if slot["abandoned"]:
                # its client already had a 500; the slot stayed in the
                # FIFO so that rows and requests stay paired
                continue
            row = out[i]
            slot["result"] = (self.result_transform(row)
                              if self.result_transform is not None
                              else row)
            slot["event"].set()

    # -- HTTP side ---------------------------------------------------------

    def fail(self, handler, message, code=400, rid=None, headers=None):
        self.warning(message)
        payload = {"error": message}
        if rid is not None:
            payload["id"] = rid
        respond_json(handler, code, payload, headers=headers)

    def serve(self, handler):
        """On the HTTP thread: decode, feed, wait, reply."""
        # the body is read before any failure: on a keep-alive
        # connection unread bytes would parse as the next request
        if handler.headers.get("Transfer-Encoding"):
            # a chunked body cannot be drained by length (and with a
            # Content-Length too it is the smuggling shape): refuse it
            # and close
            handler.close_connection = True
            self.fail(handler, "Content-Length required "
                               "(Transfer-Encoding is not supported)",
                      code=411)
            return
        try:
            length = int(handler.headers.get("Content-Length", 0))
            raw = handler.rfile.read(length)
        except (TypeError, ValueError):
            handler.close_connection = True
            self.fail(handler, "Invalid Content-Length")
            return
        if handler.path != self.path:
            self.fail(handler, "API path %s is not supported" % handler.path,
                      code=404)
            return
        ctype = (handler.headers.get("Content-Type") or "").split(";")[0]
        if ctype.strip() != "application/json":
            self.fail(handler, "Unsupported Content-Type (must be "
                               "\"application/json\")")
            return
        try:
            request = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            self.fail(handler, "Failed to parse JSON")
            return
        rid = request.get("id") if isinstance(request, dict) else None
        trace_id = tracing.trace_id_from_request(handler.headers, rid)
        with tracing.request_span("http:%s" % self.path,
                                  trace_id=trace_id):
            self._serve_parsed(handler, request, rid)

    def _serve_parsed(self, handler, request, rid):
        data, error = parse_payload(request)
        if error is not None:
            self.fail(handler, error, rid=rid)
            return
        slot = {"event": threading.Event(), "result": None, "error": None,
                "abandoned": False}
        # the feed and the pending append under one lock: the loader's
        # queue and the reply FIFO keep one order across HTTP threads
        feed_error = None
        stopped = overloaded = False
        with self._pending_lock_:
            if self._server_ is None:
                stopped = True
            elif self.max_pending and \
                    len(self._pending_) >= self.max_pending:
                overloaded = True
            else:
                try:
                    self.feed(data)
                except Exception as e:
                    feed_error = str(e) or type(e).__name__
                else:
                    self._pending_.append(slot)
        if stopped:
            self.fail(handler, "service stopped", code=503, rid=rid,
                      headers={"Retry-After": "5"})
            return
        if overloaded:
            self.fail(handler, "service overloaded: %d requests already "
                               "pending" % self.max_pending,
                      code=503, rid=rid, headers={"Retry-After": "1"})
            return
        if feed_error is not None:
            self.fail(handler, "Invalid input value: %s" % feed_error,
                      rid=rid)
            return
        if not slot["event"].wait(self.response_timeout):
            # the slot stays: its sample is already queued, so run()
            # must still pop it, or every later client would get the
            # previous request's row
            with self._pending_lock_:
                slot["abandoned"] = True
            self.fail(handler, "The workflow did not respond in time",
                      code=500, rid=rid)
            return
        if slot["error"] is not None:
            self.fail(handler, slot["error"], code=500, rid=rid)
            return
        payload = {"result": slot["result"]}
        if rid is not None:
            payload["id"] = rid
        respond_json(handler, 200, payload)
