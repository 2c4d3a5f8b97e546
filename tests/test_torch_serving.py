"""The port's serving slice against the JAX package's, on the CPU.

A tiny AlexNet-shaped net on 32x32x3 (space-to-depth conv -> LRN ->
max-pool -> conv -> LRN -> max-pool -> fc -> dropout -> fc -> dropout ->
softmax(10)) is built in JAX by ``AlexNetWorkflow`` over
``SyntheticImageLoader``; the JAX ``ServeableModel.from_workflow``
holds its weights, and the port's model loads them through
``params_from_jax``. The same numpy inputs then go through both, first
directly, then through the port's batcher, replica pool and HTTP
frontend over loopback.

Tolerance: float32 throughout; the two forwards differ only in the
order of float32 sums (XLA vs oneDNN convolutions, the LRN window, the
fc products), which moves the 10-class probabilities by ~1e-7;
atol = 1e-5 holds with margin and still catches a permuted flatten or
a wrong constant.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher  # noqa: E402
from veles_tpu.models.alexnet import (AlexNetWorkflow,  # noqa: E402
                                      SyntheticImageLoader)
from veles_tpu.nn import precision as jax_precision  # noqa: E402
from veles_tpu.serving.model_store import \
    ServeableModel as JaxServeableModel  # noqa: E402
from veles_tpu_torch.models.build import plain_forward  # noqa: E402
from veles_tpu_torch.serving.engine import DynamicBatcher  # noqa: E402
from veles_tpu_torch.serving.frontend import ServingFrontend  # noqa: E402
from veles_tpu_torch.serving.model_store import (ModelStore,  # noqa: E402
                                                 ServeableModel)
from veles_tpu_torch.serving.replica import (ReplicaPool,  # noqa: E402
                                             bucket_for, buckets_upto)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=0)

TINY_ALEXNET = [
    {"type": "conv_str", "n_kernels": 16, "kx": 5, "ky": 5,
     "sliding": (2, 2), "padding": 1, "space_to_depth": True},
    {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75},
    {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": (2, 2)},
    {"type": "conv_str", "n_kernels": 32, "kx": 3, "ky": 3,
     "padding": 1},
    {"type": "norm", "n": 5, "alpha": 1e-4, "beta": 0.75},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_str", "output_sample_shape": 64},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "all2all_str", "output_sample_shape": 48},
    {"type": "dropout", "dropout_ratio": 0.5},
    {"type": "softmax", "output_sample_shape": 10},
]


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
    return JaxServeableModel.from_workflow(wf, name="tiny_alexnet")


def _port_model(jax_model, policy="float32"):
    return ServeableModel.from_layers(
        TINY_ALEXNET, jax_model.sample_shape,
        params=[p for _, p in jax_model.layers], policy=policy,
        device="cpu", name="tiny_alexnet")


@pytest.fixture(scope="module")
def port_model(jax_model):
    return _port_model(jax_model)


def _inputs(n, seed=0):
    return numpy.random.RandomState(seed).uniform(
        -1, 1, (n, 32, 32, 3)).astype(numpy.float32)


def test_forward_matches_jax_serveable_model(jax_model, port_model):
    assert port_model.sample_shape == (32, 32, 3)
    x = _inputs(6)
    want = jax_model(x)
    got = port_model(x)
    assert got.shape == (6, 10)
    numpy.testing.assert_allclose(got, want, **TOL)
    numpy.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


def test_bfloat16_mixed_policy_matches_jax(jax_model):
    """bf16 operands at every conv and matmul, f32 accumulation and
    activations: bf16 rounding points match, but a rounding that lands
    on the other side of a tie shifts a value by one bf16 ulp (2^-8
    relative). On these inputs the probabilities (0.093 ... 0.108) read
    a max error of 1.4e-5 while the input moves them by up to 2.5e-4,
    and two swapped replies read 4e-4: atol = 1e-4 lies between, and
    the swapped control must fail it."""
    x = _inputs(3, seed=1)
    jax_precision.set_policy("bfloat16_mixed")
    try:
        want = JaxServeableModel(jax_model.layers,
                                 jax_model.sample_shape)(x)
    finally:
        jax_precision.set_policy(None)
    got = _port_model(jax_model, "bfloat16_mixed")(x)
    numpy.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    swapped = got[[1, 0, 2]]
    assert numpy.abs(swapped - want).max() > 1e-4


def test_plain_forward_is_the_same_function_on_cpu(port_model):
    x = torch.from_numpy(_inputs(2, seed=2))
    with torch.inference_mode():
        assert torch.equal(port_model.module(x),
                           plain_forward(port_model.module, x))


def test_entry_points_without_device_raise_off_the_card(monkeypatch,
                                                        jax_model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeableModel.from_layers(TINY_ALEXNET, (32, 32, 3), seed=1)


def test_unknown_layer_type_raises():
    with pytest.raises(ValueError, match="lstm"):
        ServeableModel.from_layers([{"type": "lstm"}], (4, 8),
                                   device="cpu")


# -- replicas, batcher, store ----------------------------------------------

def test_buckets():
    assert bucket_for(1, 64) == 1
    assert bucket_for(3, 64) == 4
    assert bucket_for(33, 64) == 64
    assert bucket_for(200, 64) == 64
    assert buckets_upto(8) == [1, 2, 4, 8]
    assert buckets_upto(48) == [1, 2, 4, 8, 16, 32, 48]


def test_batcher_scatters_rows_back_in_order(jax_model, port_model):
    pool = ReplicaPool(port_model, n_replicas=2, max_batch_size=4)
    engine = DynamicBatcher(pool, batch_timeout_ms=20)
    try:
        assert pool.replicas[0].warmed_buckets == [1, 2, 4]
        x = _inputs(7, seed=3)
        futures = [engine.submit(row) for row in x]
        got = numpy.stack([f.result(timeout=30) for f in futures])
        numpy.testing.assert_allclose(got, jax_model(x), **TOL)
        assert sum(r.rows_done for r in pool.replicas) == 7
        assert engine.queue_depth() == 0
    finally:
        engine.stop()
        pool.stop()


def test_pool_grows_shrinks_and_swaps_under_traffic(jax_model, port_model):
    pool = ReplicaPool(port_model, n_replicas=1, max_batch_size=2,
                       warm=False)
    engine = DynamicBatcher(pool, batch_timeout_ms=1)
    try:
        x = _inputs(4, seed=7)
        futures = [engine.submit(row) for row in x]
        pool.add_replica()
        assert pool.size() == 2
        futures += [engine.submit(row) for row in x]
        assert pool.remove_replica() is not None
        assert pool.remove_replica() is None        # never the last one
        assert pool.size() == 1
        v2 = ServeableModel(port_model.module, port_model.sample_shape,
                            name="tiny_alexnet", version=2)
        pool.swap(v2)
        assert pool.model is v2 and pool.replicas[0].model is v2
        futures += [engine.submit(row) for row in x]
        got = numpy.stack([f.result(timeout=30) for f in futures])
        numpy.testing.assert_allclose(got, numpy.concatenate(
            [jax_model(x)] * 3), **TOL)
    finally:
        engine.stop()
        pool.stop()


def test_model_store_versions_pins_and_retention(port_model):
    store = ModelStore(keep_last=2)
    models = [ServeableModel(port_model.module, (32, 32, 3), name="m")
              for _ in range(3)]
    for m in models:
        store.add(m)
    assert store.versions("m") == [2, 3]
    assert store.get("m") is models[2]
    store.pin("m", 2)
    assert store.get() is models[1]
    store.unpin("m")
    assert store.get("m", 3) is models[2]
    with pytest.raises(KeyError):
        store.get("m", 1)


# -- HTTP ------------------------------------------------------------------

def _post(port, payload, path="/api", headers=None):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path),
        data=json.dumps(payload).encode("utf-8"),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})),
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def test_http_single_and_batch_match_jax(jax_model, port_model):
    fe = ServingFrontend(port_model, host="127.0.0.1", port=0, replicas=1,
                         max_batch_size=4, batch_timeout_ms=5).start()
    try:
        x = _inputs(6, seed=4)
        want = jax_model(x)
        replies = {}

        def ask(i):
            replies[i] = _post(fe.port, {"input": x[i].tolist(),
                                         "codec": "list", "id": i})

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        for i in range(6):
            status, reply, _ = replies[i]
            assert status == 200 and reply["id"] == i
            numpy.testing.assert_allclose(reply["result"], want[i], **TOL)
        status, reply, _ = _post(fe.port, {"inputs": x.tolist(),
                                           "codec": "list"}, "/api/batch")
        assert status == 200
        numpy.testing.assert_allclose(reply["results"], want, **TOL)
        import base64
        status, reply, _ = _post(fe.port, {
            "input": base64.b64encode(x[:3].tobytes()).decode(),
            "codec": "base64", "shape": [3, 32, 32, 3],
            "type": "float32"}, "/api/batch")
        assert status == 200
        numpy.testing.assert_allclose(reply["results"], want[:3], **TOL)
        status, reply, _ = _post(fe.port, {"input": [1.0, 2.0],
                                           "codec": "list"})
        assert status == 400 and "shape" in reply["error"]
        status, reply, _ = _post(fe.port, {"codec": "list"})
        assert status == 400
        assert _health(fe.port)["sample_shape"] == [32, 32, 3]
        assert _health(fe.port)["device"] == "cpu"
        fe.swap_model(ServeableModel(port_model.module, (32, 32, 3)))
        assert _health(fe.port)["version"] == 2
        status, reply, _ = _post(fe.port, {"input": x[0].tolist(),
                                           "codec": "list"})
        numpy.testing.assert_allclose(reply["result"], want[0], **TOL)
        with pytest.raises(ValueError, match="sample shape"):
            fe.swap_model(ServeableModel(port_model.module, (16, 16, 3)))
    finally:
        fe.stop()


def test_http_serves_a_sequence_model():
    """A tiny attention + MoE model on (8, 16) samples behind the
    frontend: base64 single and batch requests, each row equal to the
    model's direct forward of the same rows (the buckets batch them
    differently, so the float32 sums may differ in order: TOL), and a
    sample of the wrong shape answered 400."""
    import base64
    from veles_tpu_torch.models.samples import sequence_layers
    model = ServeableModel.from_layers(
        sequence_layers(heads=4, n_classes=5, moe=True), (8, 16), seed=9,
        device="cpu", name="sequence")
    fe = ServingFrontend(model, host="127.0.0.1", port=0, replicas=1,
                         max_batch_size=4, batch_timeout_ms=5).start()
    try:
        x = numpy.random.RandomState(5).randn(5, 8, 16).astype(
            numpy.float32)
        want = model(x)
        assert want.shape == (5, 5)
        for i in (0, 3):
            status, reply, _ = _post(fe.port, {
                "input": base64.b64encode(x[i].tobytes()).decode(),
                "codec": "base64", "shape": [8, 16], "type": "float32",
                "id": i})
            assert status == 200 and reply["id"] == i
            numpy.testing.assert_allclose(reply["result"], want[i], **TOL)
        status, reply, _ = _post(fe.port, {
            "input": base64.b64encode(x.tobytes()).decode(),
            "codec": "base64", "shape": [5, 8, 16], "type": "float32"},
            "/api/batch")
        assert status == 200
        numpy.testing.assert_allclose(reply["results"], want, **TOL)
        status, reply, _ = _post(fe.port, {
            "input": base64.b64encode(x[0, :4].tobytes()).decode(),
            "codec": "base64", "shape": [4, 16], "type": "float32"})
        assert status == 400 and "shape" in reply["error"]
        assert _health(fe.port)["sample_shape"] == [8, 16]
    finally:
        fe.stop()


def _health(port):
    with urllib.request.urlopen("http://127.0.0.1:%d/healthz" % port,
                                timeout=10) as resp:
        return json.loads(resp.read())


class _SlowModel(ServeableModel):
    """The tiny model with a fixed delay per forward."""

    def __init__(self, model, delay_s):
        super(_SlowModel, self).__init__(model.module, model.sample_shape,
                                         name="slow")
        self.delay_s = delay_s

    def __call__(self, batch):
        time.sleep(self.delay_s)
        return super(_SlowModel, self).__call__(batch)


def test_http_overload_answers_503_with_retry_after(port_model):
    fe = ServingFrontend(_SlowModel(port_model, 0.3), host="127.0.0.1",
                         port=0, max_batch_size=1, batch_timeout_ms=0,
                         max_queue=2, warm=False).start()
    try:
        x = _inputs(1, seed=5)[0].tolist()
        statuses = {}

        def ask(i):
            status, _, headers = _post(fe.port, {"input": x,
                                                 "codec": "list"})
            statuses[i] = (status, headers)

        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        shed = [h for s, h in statuses.values() if s == 503]
        assert shed, "expected 503s at 4x the admission bound"
        assert any(s == 200 for s, _ in statuses.values())
        assert all(s in (200, 503) for s, _ in statuses.values())
        for headers in shed:
            assert int(headers["Retry-After"]) >= 1
    finally:
        fe.stop()


def test_http_deadline_passed_in_queue_answers_504(port_model):
    """While the only replica is busy the batcher keeps growing the
    next batch; the request's 50 ms budget runs out there, and it is
    shed before any compute."""
    fe = ServingFrontend(_SlowModel(port_model, 0.5), host="127.0.0.1",
                         port=0, max_batch_size=2, batch_timeout_ms=0,
                         warm=False).start()
    try:
        x = _inputs(1, seed=6)[0].tolist()
        first = threading.Thread(target=_post, args=(
            fe.port, {"input": x, "codec": "list"}))
        first.start()
        time.sleep(0.1)             # the replica is now busy for ~0.4 s
        status, reply, _ = _post(fe.port, {"input": x, "codec": "list"},
                                 headers={"X-Deadline-Ms": "50"})
        first.join(timeout=30)
        assert status == 504, reply
    finally:
        fe.stop()


def test_serving_imports_neither_jax_nor_the_jax_package():
    """A fresh interpreter that imports the port and serves a forward
    never loads jax or any veles_tpu module."""
    code = (
        "import sys, numpy\n"
        "from veles_tpu_torch.models.alexnet import small_alexnet_layers\n"
        "from veles_tpu_torch.serving.model_store import ServeableModel\n"
        "from veles_tpu_torch.serving.frontend import ServingFrontend\n"
        "m = ServeableModel.from_layers(small_alexnet_layers(5), "
        "(32, 32, 3), seed=0, device='cpu')\n"
        "y = m(numpy.zeros((2, 32, 32, 3), numpy.float32))\n"
        "assert y.shape == (2, 5)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'veles_tpu' or "
        "k.startswith('veles_tpu.'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
