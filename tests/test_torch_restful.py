"""The port's RESTful inference unit (``veles_tpu_torch/restful_api.py``)
and ``RestfulLoader`` against the JAX package's, on the CPU.

The cases of ``tests/test_restful.py``, each run on both packages at
once: the same service workflow (``Repeater`` -> ``RestfulLoader`` ->
``All2AllSoftmax`` -> ``RESTfulAPI``) over the same weights (the JAX
unit's, handed to the port's unit), the same posts to both, and the same
status codes, error keys, echoed ids and replies, the results within
1e-6 (float32 softmax rows of the same weights and inputs). Plus: the
frontend's request contract is this module's (one copy), and importing
and serving the service loads neither ``jax`` nor any ``veles_tpu``
module.
"""

import base64
import http.client
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.accelerated_units import (  # noqa: E402
    AcceleratedWorkflow as JaxWorkflow)
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher  # noqa: E402
from veles_tpu.loader.restful import RestfulLoader as JaxLoader  # noqa: E402
from veles_tpu.nn.all2all import All2AllSoftmax as JaxSoftmax  # noqa: E402
from veles_tpu.plumbing import Repeater as JaxRepeater  # noqa: E402
from veles_tpu.restful_api import RESTfulAPI as JaxAPI  # noqa: E402

from veles_tpu_torch.accelerated_units import AcceleratedWorkflow  # noqa
from veles_tpu_torch.loader.restful import RestfulLoader  # noqa: E402
from veles_tpu_torch.nn.units import All2AllSoftmax  # noqa: E402
from veles_tpu_torch.plumbing import Repeater  # noqa: E402
from veles_tpu_torch.restful_api import RESTfulAPI  # noqa: E402

#: the replies' tolerance: float32 softmax rows of the same weights
ATOL = 1e-6


def _post(address, payload, content_type="application/json", path="/api"):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (address[1], path),
        data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": content_type}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class Service(object):
    """One package's service workflow; ``loop``: run it on a thread."""

    def __init__(self, port_side, seed, minibatch_size=1, loop=True,
                 params=None, **api_kwargs):
        api_kwargs.setdefault("response_timeout", 10)
        if port_side:
            wf = AcceleratedWorkflow()
            loader = RestfulLoader(workflow=wf, sample_shape=(4,),
                                   feed_timeout=30,
                                   minibatch_size=minibatch_size)
            fwd = All2AllSoftmax(wf, output_sample_shape=3, name="fc")
            fwd._params = dict(params)
            api = RESTfulAPI(wf, port=0, **api_kwargs)
            repeater = Repeater(wf) if loop else None
        else:
            jax_prng.get().seed(seed)
            wf = JaxWorkflow(DummyLauncher())
            loader = JaxLoader(wf, sample_shape=(4,), feed_timeout=30,
                               minibatch_size=minibatch_size)
            fwd = JaxSoftmax(wf, output_sample_shape=3, name="fc")
            api = JaxAPI(wf, port=0, **api_kwargs)
            repeater = JaxRepeater(wf) if loop else None
        if loop:
            repeater.link_from(wf.start_point)
            loader.link_from(repeater)
            repeater.link_from(api)
        fwd.link_from(loader)
        fwd.link_attrs(loader, ("input", "minibatch_data"))
        api.link_from(fwd)
        api.link_attrs(fwd, ("input", "output"))
        if minibatch_size > 1:
            api.link_attrs(loader, ("batch_size", "minibatch_size"))
        api.feed = loader.feed
        wf.initialize(device="cpu" if port_side else Device(backend="cpu"))
        self.wf, self.api, self.loader, self.fwd = wf, api, loader, fwd
        self.thread = None
        if loop:
            self.thread = threading.Thread(target=wf.run, daemon=True)
            self.thread.start()

    def close(self):
        self.loader.finish()
        if self.thread is not None:
            self.thread.join(timeout=20)
        self.api.stop()
        assert self.thread is None or not self.thread.is_alive()


class Pair(object):
    """The JAX service and the port's, the port's over the JAX unit's
    weights."""

    def __init__(self, seed, **kwargs):
        self.jax = Service(False, seed, **kwargs)
        params = {"weights": numpy.asarray(self.jax.fwd.weights.map_read()),
                  "bias": numpy.asarray(self.jax.fwd.bias.map_read())}
        self.port = Service(True, seed, params=params, **kwargs)

    def post(self, payload, **kwargs):
        """Post to both; the replies must agree. The port's reply."""
        want = _post(self.jax.api.address, payload, **kwargs)
        got = _post(self.port.api.address, payload, **kwargs)
        same_reply(got, want)
        return got

    def close(self):
        for side in (self.port, self.jax):
            side.close()


def same_reply(got, want):
    assert got[0] == want[0], (got, want)
    assert sorted(got[1]) == sorted(want[1]), (got, want)
    if "result" in want[1]:
        numpy.testing.assert_allclose(
            numpy.asarray(got[1]["result"], numpy.float64),
            numpy.asarray(want[1]["result"], numpy.float64), rtol=0,
            atol=ATOL)
    if "id" in want[1]:
        assert got[1]["id"] == want[1]["id"]


@pytest.fixture
def pair():
    services = Pair(11)
    try:
        yield services
    finally:
        services.close()


def test_list_codec_roundtrip(pair):
    status, reply = pair.post({"input": [1.0, 2.0, 3.0, 4.0],
                               "codec": "list"})
    assert status == 200
    result = numpy.asarray(reply["result"], numpy.float32)
    assert result.shape == (3,)
    assert abs(result.sum() - 1.0) < 1e-4
    assert (result > 0).all()


def test_base64_codec_matches_list_codec(pair):
    sample = numpy.array([0.5, -1.0, 2.0, 0.0], numpy.float32)
    _, via_list = pair.post({"input": sample.tolist(), "codec": "list"})
    status, via_b64 = pair.post({
        "input": base64.b64encode(sample.tobytes()).decode(),
        "codec": "base64", "shape": [4], "type": "float32"})
    assert status == 200
    numpy.testing.assert_allclose(via_b64["result"], via_list["result"],
                                  rtol=1e-5)


def test_request_validation(pair):
    cases = [
        ({"input": [1, 2, 3, 4]}, "application/json", "/api", 400),
        ({"codec": "list"}, "application/json", "/api", 400),
        ({"input": [1], "codec": "nope"}, "application/json", "/api", 400),
        ({"input": [1, 2], "codec": "list"}, "application/json", "/api", 400),
        ({"input": "x", "codec": "base64"}, "application/json", "/api", 400),
        ({"input": "x", "codec": "base64", "shape": [4]},
         "application/json", "/api", 400),
        ({"input": [1, 2, 3, 4], "codec": "list"}, "text/plain", "/api", 400),
        ({"input": [1, 2, 3, 4], "codec": "list"},
         "application/json", "/other", 404),
    ]
    for payload, ctype, path, want in cases:
        status, reply = pair.post(payload, content_type=ctype, path=path)
        assert status == want, (payload, ctype, path, status)
        assert "error" in reply
    status, reply = pair.post({"input": [0, 0, 0, 0], "codec": "list"})
    assert status == 200


def test_concurrent_requests_all_answered(pair):
    results = {"port": {}, "jax": {}}

    def ask(side, i):
        sample = numpy.zeros(4, numpy.float32)
        sample[i % 4] = float(i)
        results[side][i] = _post(getattr(pair, side).api.address,
                                 {"input": sample.tolist(),
                                  "codec": "list"})

    threads = [threading.Thread(target=ask, args=(side, i))
               for i in range(8) for side in ("port", "jax")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(results["port"]) == len(results["jax"]) == 8
    for i in range(8):
        same_reply(results["port"][i], results["jax"][i])
        status, reply = results["port"][i]
        assert status == 200 and len(reply["result"]) == 3


def test_result_transform(pair):
    for side in (pair.port, pair.jax):
        side.api.result_transform = lambda out: int(numpy.argmax(out))
    status, reply = pair.post({"input": [9.0, 0.0, 0.0, 0.0],
                               "codec": "list"})
    assert status == 200
    assert isinstance(reply["result"], int)
    assert 0 <= reply["result"] < 3


def test_keepalive_connection_survives_fail_paths(pair):
    """A failure drains the request's body: the next request on the same
    HTTP/1.1 connection is parsed whole."""
    body = json.dumps({"input": [1, 2, 3, 4], "codec": "list"})
    replies = {}
    for side in ("port", "jax"):
        conn = http.client.HTTPConnection(
            "127.0.0.1", getattr(pair, side).api.address[1], timeout=10)
        try:
            conn.request("POST", "/nope", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert resp.status == 404
            resp.read()
            conn.request("POST", "/api", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            replies[side] = (resp.status, json.loads(resp.read()))
        finally:
            conn.close()
    same_reply(replies["port"], replies["jax"])
    assert replies["port"][0] == 200
    assert len(replies["port"][1]["result"]) == 3


def test_workflow_finish_stops_service(pair):
    for side in (pair.port, pair.jax):
        side.loader.finish()
        deadline = 50
        while side.wf.is_running and deadline:
            threading.Event().wait(0.1)
            deadline -= 1
        assert not side.wf.is_running
        with pytest.raises((ConnectionError, urllib.error.URLError,
                            OSError)):
            _post(side.api.address, {"input": [0, 0, 0, 0],
                                     "codec": "list"})


def test_base64_type_must_be_string(pair):
    status, reply = pair.post({
        "input": "AA==", "codec": "base64", "shape": [1], "type": 5})
    assert status == 400 and "error" in reply
    status, reply = pair.post({"input": {"a": 1}, "codec": "list"})
    assert status == 400 and "error" in reply


def test_request_id_echo(pair):
    status, reply = pair.post({"input": [1.0, 2.0, 3.0, 4.0],
                               "codec": "list", "id": "abc-7"})
    assert status == 200 and reply["id"] == "abc-7"
    status, reply = pair.post({"codec": "list", "id": 99})
    assert status == 400 and reply["id"] == 99
    status, reply = pair.post({"input": [0, 0, 0, 0], "codec": "list"})
    assert status == 200 and "id" not in reply


def test_overload_fails_fast_with_503():
    """A saturated workflow sheds load with 503 and Retry-After at once
    instead of holding every HTTP thread for ``response_timeout``."""
    services = Pair(13, loop=False, response_timeout=3, max_pending=1)
    try:
        replies, firsts = {}, {}
        for side in ("port", "jax"):
            api = getattr(services, side).api
            firsts[side] = []

            def first(api=api, out=firsts[side]):
                out.append(_post(api.address, {"input": [0, 0, 0, 0],
                                               "codec": "list"})[0])

            t = threading.Thread(target=first)
            t.start()
            deadline = time.time() + 5
            while time.time() < deadline and not api._pending_:
                time.sleep(0.01)
            assert api._pending_, "first request never became pending"
            start = time.time()
            conn = http.client.HTTPConnection("127.0.0.1", api.address[1],
                                              timeout=10)
            try:
                conn.request("POST", "/api", body=json.dumps(
                    {"input": [0, 0, 0, 0], "codec": "list", "id": "shed"}),
                    headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = json.loads(resp.read())
                replies[side] = (resp.status, body,
                                 int(resp.headers["Retry-After"]))
                assert time.time() - start < 2.0
            finally:
                conn.close()
            t.join(timeout=10)
        assert replies["port"] == replies["jax"]
        assert replies["port"][0] == 503 and replies["port"][2] >= 1
        assert replies["port"][1]["id"] == "shed"
        assert firsts["port"] == firsts["jax"] == [500]
    finally:
        for side in (services.port, services.jax):
            side.api.stop()


def test_batched_service_answers_all_requests_consistently():
    """minibatch_size 4: concurrent requests share one forward, and each
    client gets the row it would get alone."""
    services = Pair(17, minibatch_size=4)
    try:
        assert tuple(services.port.loader.minibatch_data.shape) == (4, 4)
        samples = [numpy.eye(4, dtype=numpy.float32)[i % 4] * (i + 1)
                   for i in range(8)]
        expected = [services.post({"input": s.tolist(),
                                   "codec": "list"})[1]["result"]
                    for s in samples]
        results = {}

        def ask(i):
            results[i] = _post(services.port.api.address,
                               {"input": samples[i].tolist(),
                                "codec": "list", "id": i})

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(results) == 8
        for i, (status, reply) in results.items():
            assert status == 200 and reply["id"] == i
            numpy.testing.assert_allclose(reply["result"], expected[i],
                                          rtol=1e-5, atol=1e-6)
    finally:
        services.close()


def test_port_and_path_validation():
    wf = AcceleratedWorkflow()
    for kwargs in ({"port": "8080"}, {"port": 70000}, {"path": "api"}):
        with pytest.raises(ValueError):
            RESTfulAPI(wf, **kwargs)
        with pytest.raises(ValueError):
            JaxAPI(JaxWorkflow(DummyLauncher()), **kwargs)


def test_frontend_shares_the_request_contract():
    """One copy of the request contract: the serving frontend's decoder
    and writer are this module's, and they decode as JAX's."""
    from veles_tpu.restful_api import parse_payload as jax_parse
    from veles_tpu_torch import restful_api
    from veles_tpu_torch.serving import frontend
    assert frontend.parse_payload is restful_api.parse_payload
    assert frontend.respond_json is restful_api.respond_json
    sample = numpy.arange(6, dtype=">f4").reshape(2, 3)
    for request in ({"input": [[1, 2], [3, 4]], "codec": "list"},
                    {"input": base64.b64encode(sample.tobytes()).decode(),
                     "codec": "base64", "shape": [2, 3], "type": "float32>"},
                    {"input": "AA==", "codec": "base64", "shape": [1]},
                    {"codec": "list"}):
        got, want = restful_api.parse_payload(request), jax_parse(request)
        assert got[1] == want[1]
        if want[0] is not None:
            numpy.testing.assert_array_equal(got[0], want[0])
            assert got[0].dtype == want[0].dtype


SERVICE_NO_JAX = """
import json, sys, threading, urllib.request
import numpy
from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
from veles_tpu_torch.loader import RestfulLoader
from veles_tpu_torch.nn.units import All2AllSoftmax
from veles_tpu_torch.plumbing import Repeater
from veles_tpu_torch.restful_api import RESTfulAPI
import veles_tpu_torch.zmq_loader, veles_tpu_torch.ops.autotune
wf = AcceleratedWorkflow()
repeater = Repeater(wf)
repeater.link_from(wf.start_point)
loader = RestfulLoader(workflow=wf, sample_shape=(4,), feed_timeout=30)
loader.link_from(repeater)
fwd = All2AllSoftmax(wf, output_sample_shape=3)
fwd.link_from(loader)
fwd.link_attrs(loader, ("input", "minibatch_data"))
api = RESTfulAPI(wf, port=0)
api.link_from(fwd)
api.link_attrs(fwd, ("input", "output"))
api.feed = loader.feed
repeater.link_from(api)
wf.initialize(device="cpu")
thread = threading.Thread(target=wf.run, daemon=True)
thread.start()
req = urllib.request.Request(
    "http://127.0.0.1:%d/api" % api.address[1], method="POST",
    data=json.dumps({"input": [1, 2, 3, 4], "codec": "list"}).encode(),
    headers={"Content-Type": "application/json"})
with urllib.request.urlopen(req, timeout=10) as resp:
    reply = json.loads(resp.read())
loader.finish()
thread.join(20)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "veles_tpu" or m.startswith("veles_tpu."))
print(json.dumps({"bad": bad, "n": len(reply["result"])}))
"""


def test_service_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SERVICE_NO_JAX],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {"bad": [], "n": 3}
