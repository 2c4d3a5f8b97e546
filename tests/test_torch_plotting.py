"""The port's plotters, graphics server and rendering client, on the CPU.

Every test of ``tests/test_plotting.py`` on the port, over the port's
transport (one TCP listener, the coordinator's framing, a bounded queue
a subscriber) instead of ZeroMQ: the snapshot round trip stripped of the
graph, ``end`` on stop, no plotting on a slave, each plotter rendering,
the client's PNGs and backend fallback, a trained workflow's standard
plot set, and the master's ``SlaveStats`` ticker.

Held to the JAX package, exactly: each plotter's captured data from the
same linked inputs (the port's given as tensors, the JAX package's as
numpy arrays), and the data of the rendered figure (each axes' lines,
images, texts, bars and tables; not the pixels). A tensor captured by
``fill()`` lands on the host, so a snapshot unpickles without a card.
"""

import os
import pickle
import time
import zlib

import numpy
import pytest

torch = pytest.importorskip("torch")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")
import matplotlib.pyplot as pp  # noqa: E402

from veles_tpu import plotting_units as jax_units  # noqa: E402
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow  # noqa: E402
from veles_tpu_torch import plotting_units as units  # noqa: E402
from veles_tpu_torch.dummy import DummyWorkflow  # noqa: E402
from veles_tpu_torch.graphics_client import GraphicsClient  # noqa: E402
from veles_tpu_torch.graphics_server import (TOPIC, TOPIC_END,  # noqa
                                             GraphicsServer, Subscription)
from veles_tpu_torch.plotting_units import (AccumulatingPlotter,  # noqa
                                            ImagePlotter, MatrixPlotter,
                                            SimpleHistogram)


@pytest.fixture
def server():
    srv = GraphicsServer()
    yield srv
    srv.stop()


def _subscribe(srv):
    count = srv.subscribers
    sub = Subscription(srv.endpoints["tcp"])
    assert srv.wait_for_subscribers(count + 1, 10)
    return sub


def _next_snapshot(plotter, sub, timeout=5.0):
    """Run ``plotter`` until a snapshot arrives; its unpickled clone."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        plotter.run()
        got = sub.get(0.2)
        if got is not None:
            topic, payload = got
            assert topic == TOPIC
            return pickle.loads(zlib.decompress(payload))
    raise AssertionError("no snapshot arrived")


def test_pub_roundtrip_strips_graph(server):
    sub = _subscribe(server)
    wf = DummyWorkflow()
    plotter = AccumulatingPlotter(wf, name="err")
    plotter.input = torch.tensor(0.25)
    clone = _next_snapshot(plotter, sub)
    assert clone.values and clone.values[-1] == 0.25
    assert clone._workflow is None  # stripped: no graph dragged along
    sub.close()


def test_end_topic_on_stop():
    srv = GraphicsServer()
    sub = _subscribe(srv)
    srv.stop()
    topic, payload = sub.get(5.0)
    assert topic == TOPIC_END and payload == b""
    sub.close()


def test_plotter_skipped_on_slave(server):
    wf = DummyWorkflow()
    wf.workflow.mode = "slave"
    plotter = AccumulatingPlotter(wf, name="err")
    plotter.input = 1.0
    assert not plotter.enabled
    plotter.run()
    assert plotter.values == []
    assert server.enqueued == 0


def test_slow_subscriber_never_blocks_and_counts_drops():
    """A subscriber that reads nothing (its drain held): every enqueue
    returns at once, its queue keeps the newest ``queue_depth`` snapshots
    and counts the rest as dropped, and a subscriber beside it that keeps
    up loses none."""
    srv = GraphicsServer(queue_depth=3)
    try:
        keeper = _subscribe(srv)
        slow = _subscribe(srv)
        kept, held = srv._subscribers
        plotter = AccumulatingPlotter(DummyWorkflow(), name="err")
        with held.cond:     # its drain thread cannot take from the queue
            for i in range(10):
                t0 = time.perf_counter()
                plotter.input = float(i)
                plotter.run()
                assert time.perf_counter() - t0 < 1.0
                # the keeper keeps up: its queue drains between snapshots
                deadline = time.time() + 10
                while kept.queue and time.time() < deadline:
                    time.sleep(0.001)
            assert len(held.queue) == 3 and held.dropped == 7
        assert kept.dropped == 0

        def received(sub, n):
            return [pickle.loads(zlib.decompress(sub.get(10.0)[1])).values[-1]
                    for _ in range(n)]

        assert received(keeper, 10) == [float(i) for i in range(10)]
        assert received(slow, 3) == [7.0, 8.0, 9.0]
        assert srv.stats()["dropped"] == 7
        keeper.close()
        slow.close()
    finally:
        srv.stop()


def _with_input(plotter, value):
    plotter.input = value
    return plotter


@pytest.mark.parametrize("make", [
    lambda wf: _with_input(AccumulatingPlotter(wf, name="acc"), 0.5),
    lambda wf: _with_input(MatrixPlotter(wf, name="conf"),
                           numpy.arange(9).reshape(3, 3)),
    lambda wf: _with_input(SimpleHistogram(wf, name="hist"),
                           numpy.random.RandomState(0).randn(100)),
    lambda wf: _with_input(ImagePlotter(wf, name="imgs"),
                           numpy.random.RandomState(0).randn(5, 784)),
], ids=["accumulating", "matrix", "histogram", "image"])
def test_redraw_renders(tmp_path, make):
    wf = DummyWorkflow()
    plotter = make(wf)
    plotter.fill()
    figure = pp.figure()
    plotter.redraw(figure)
    out = tmp_path / "plot.png"
    figure.savefig(str(out))
    pp.close(figure)
    assert out.stat().st_size > 0


def test_client_renders_png(tmp_path, server):
    client = GraphicsClient(server.endpoints["tcp"], mode="png",
                            out=str(tmp_path))
    assert server.wait_for_subscribers(1, 10)
    wf = DummyWorkflow()
    plotter = AccumulatingPlotter(wf, name="val err")
    plotter.input = 0.1
    plotter.run()
    assert client.serve_one(timeout=5.0)
    client.close()
    assert client.rendered == 1
    files = os.listdir(str(tmp_path))
    assert any(f.endswith(".png") for f in files)


def test_client_process_renders_until_end(tmp_path, server):
    """``launch_client``: the client in a process of its own writes one
    PNG a plotter and exits 0 on ``end``."""
    proc = server.launch_client(mode="png", out=str(tmp_path))
    try:
        assert server.wait_for_subscribers(1, 60)
        wf = DummyWorkflow()
        for name, value in (("a", 0.5), ("b", 0.25)):
            plotter = AccumulatingPlotter(wf, name=name)
            plotter.input = value
            plotter.run()
        server.stop()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert sorted(os.listdir(str(tmp_path))) == ["a.png", "b.png"]


def _mnist(max_epochs=2):
    from veles_tpu_torch import prng
    from veles_tpu_torch.models.mnist import MnistWorkflow
    from test_torch_workflow import _tiny_provider
    prng.get().seed(3)
    prng.get("loader").seed(4)
    return MnistWorkflow(provider=_tiny_provider(), layers=(8,),
                         minibatch_size=20, max_epochs=max_epochs)


def test_mnist_workflow_with_plotters(server):
    """Full training run with the standard plot set wired in: plots
    stream out per epoch and carry the real metric history."""
    from veles_tpu_torch.train.runner import FusedRunner
    sub = _subscribe(server)
    wf = _mnist()
    wf.initialize(device="cpu")
    wf.add_plotters()
    assert len(wf.plotters) == 3
    FusedRunner(wf).run()
    snapshots = []
    while True:
        got = sub.get(1.0)
        if got is None:
            break
        snapshots.append(pickle.loads(zlib.decompress(got[1])))
    sub.close()
    curves = [s for s in snapshots if s.name == "validation n_err_pt"]
    assert curves, [s.name for s in snapshots]
    assert len(curves[-1].values) == 2  # one point per epoch
    history = wf.decision.epoch_history
    assert curves[-1].values == [h["validation"]["normalized"]
                                 for h in history]
    confusion = [s for s in snapshots if s.name == "confusion"]
    assert confusion and confusion[-1].matrix.shape[0] == \
        confusion[-1].matrix.shape[1]
    assert isinstance(confusion[-1].matrix, numpy.ndarray)


# -- the rest of the plotter family ------------------------------------------

class _FakeSlave(object):
    def __init__(self, sid, jobs_done, in_flight=1):
        self.id = sid
        self.power = 100.0
        self.mid = "0x0"
        self.pid = 4242
        self.state = "WORK"
        self.jobs_done = jobs_done
        self.last_seen = time.time()
        self.jobs_in_flight = list(range(in_flight))


class _FakeCoordinator(object):
    """snapshot_slaves()-shaped stand-in for CoordinatorServer."""

    def __init__(self):
        self.ticks = 0

    def snapshot_slaves(self):
        self.ticks += 1
        return [_FakeSlave("s0", 3 * self.ticks),
                _FakeSlave("s1", 5 * self.ticks, in_flight=2)]


def _make_immediate(wf, mod=units, arr=torch.from_numpy):
    rng = numpy.random.RandomState(0)
    return mod.ImmediatePlotter(wf, name="imm",
                                inputs=[arr(rng.randn(30)),
                                        arr(rng.randn(30))],
                                input_styles=["k-", "g--"], ylim=(-3, 3))


def _make_autohist(wf, mod=units, arr=torch.from_numpy):
    return _with_input(mod.AutoHistogramPlotter(wf, name="autohist"),
                       arr(numpy.random.RandomState(1).randn(500)))


def _make_multihist(wf, mod=units, arr=torch.from_numpy):
    return _with_input(mod.MultiHistogram(wf, name="multihist",
                                          hist_number=9, n_bars=10),
                       arr(numpy.random.RandomState(2).randn(12, 64)))


def _make_table(wf, mod=units, arr=torch.from_numpy):
    rng = numpy.random.RandomState(3)
    return mod.TableMaxMin(wf, name="maxmin",
                           y=[arr(rng.randn(10, 10)), arr(rng.randn(5))],
                           col_labels=["weights", "bias"])


def _make_slavestats(wf, mod=units, arr=None):
    plotter = mod.SlaveStats(wf, name="slavestats",
                             server=_FakeCoordinator())
    plotter.fill()  # two fills so per-tick job deltas exist
    return plotter


@pytest.mark.parametrize("make", [
    _make_immediate, _make_autohist, _make_multihist, _make_table,
    _make_slavestats,
])
def test_r4_plotters_render(tmp_path, make):
    wf = DummyWorkflow()
    plotter = make(wf)
    plotter.fill()
    figure = pp.figure()
    plotter.redraw(figure)
    out = tmp_path / "plot.png"
    figure.savefig(str(out))
    pp.close(figure)
    assert out.stat().st_size > 0


@pytest.mark.parametrize("make,check", [
    (_make_immediate,
     lambda c: len(c.series) == 2 and c.series[0].shape == (30,)),
    (_make_autohist, lambda c: c.bins >= 3 and c.data.shape == (500,)),
    (_make_multihist,
     lambda c: c.counts.shape == (9, 10) and
     int(c.counts[0].sum()) == 64),
    (_make_table,
     lambda c: c.values.shape == (2, 2) and
     c.values[0, 0] >= c.values[1, 0]),
    (_make_slavestats,
     lambda c: set(c.history) == {"s0", "s1"} and c.server is None and
     c.history["s1"][-1][0] == 5),  # jobs done since previous tick
])
def test_r4_plotters_pub_roundtrip(server, make, check):
    """Each plotter type snapshots through the server self-contained (no
    live handles, no workflow graph)."""
    sub = _subscribe(server)
    wf = DummyWorkflow()
    plotter = make(wf)
    clone = _next_snapshot(plotter, sub)
    sub.close()
    assert clone._workflow is None
    assert check(clone), "clone state wrong for %s" % type(clone).__name__


def test_client_backend_fallback(tmp_path, server):
    """--backend selection: an unloadable backend warns and lands on Agg
    instead of dying."""
    client = GraphicsClient(server.endpoints["tcp"], mode="png",
                            out=str(tmp_path),
                            backend="NoSuchBackend123")
    assert matplotlib.get_backend().lower() == "agg"
    client.close()


def test_master_slave_stats_ticker(server):
    """A master with a live graphics server gets the SlaveStats chart
    driven by the launcher's own timer: the master never runs its
    graph."""
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.workflow import Workflow

    launcher = Launcher(graphics=False)
    launcher.workflow = Workflow(launcher)
    launcher._graphics_server = server
    launcher._server = _FakeCoordinator()
    launcher._start_slave_stats(interval=0.05)
    plotter = launcher._slave_stats_plotter
    deadline = time.time() + 5
    while time.time() < deadline and len(
            plotter.history.get("s0", ())) < 2:
        time.sleep(0.05)
    launcher._finished.set()
    assert set(plotter.history) == {"s0", "s1"}
    assert len(plotter.history["s0"]) >= 2
    # per-tick deltas, not lifetime totals
    assert plotter.history["s1"][-1][0] == 5
    assert server.enqueued >= 2


# -- held to the JAX package ----------------------------------------------

def _fixed_slaves(mod, wf):
    plotter = _make_slavestats(wf, mod)
    plotter.fill()
    # staleness is a time difference of each fill: zeroed on both sides
    for series in plotter.history.values():
        series[:] = [(d, 0.0, f) for d, _, f in series]
    return plotter


#: (name, maker(workflow, plotting module, array constructor), attributes
#: fill() captures)
PARITY = [
    ("accumulating", lambda wf, mod, arr: _with_input(
        mod.AccumulatingPlotter(wf, name="acc"), arr(numpy.float32(0.5))),
     ("values",)),
    ("epoch_metric", lambda wf, mod, arr: _with_input(
        mod.EpochMetricPlotter(wf, name="ep", klass="train"),
        [{"train": {"normalized": 0.25}}, {"train": {"normalized": 0.125}}]),
     ("values",)),
    ("matrix", lambda wf, mod, arr: _with_input(
        mod.MatrixPlotter(wf, name="conf"),
        arr(numpy.random.RandomState(5).randint(0, 9, (4, 4)).astype(
            numpy.int32))), ("matrix",)),
    ("matrix_flat", lambda wf, mod, arr: _with_input(
        mod.MatrixPlotter(wf, name="conf"),
        arr(numpy.arange(9, dtype=numpy.int32))), ("matrix",)),
    ("histogram", lambda wf, mod, arr: _with_input(
        mod.SimpleHistogram(wf, name="hist"),
        arr(numpy.random.RandomState(0).randn(100).astype(numpy.float32))),
     ("data",)),
    ("image", lambda wf, mod, arr: _with_input(
        mod.ImagePlotter(wf, name="imgs"),
        arr(numpy.random.RandomState(0).randn(5, 784).astype(
            numpy.float32))), ("images",)),
    ("immediate", _make_immediate, ("series",)),
    ("autohist", _make_autohist, ("data", "bins")),
    ("multihist", _make_multihist, ("counts", "ranges")),
    ("table", _make_table, ("values",)),
    ("slavestats", lambda wf, mod, arr: _fixed_slaves(mod, wf),
     ("history", "labels")),
]


def _pair(make):
    """(port plotter over tensors, JAX plotter over numpy), filled."""
    port = make(DummyWorkflow(), units,
                lambda a: torch.from_numpy(numpy.asarray(a)))
    jax = make(JaxDummyWorkflow(), jax_units, numpy.asarray)
    if not isinstance(port, units.SlaveStats):
        port.fill()
        jax.fill()
    return port, jax


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, numpy.ndarray):
        assert isinstance(got, numpy.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        numpy.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name,make,fields", PARITY,
                         ids=[p[0] for p in PARITY])
def test_captured_data_equals_jax(name, make, fields):
    port, jax = _pair(make)
    for field in fields:
        _same(getattr(port, field), getattr(jax, field))
    clone = pickle.loads(pickle.dumps(port))
    for field in fields:
        _same(getattr(clone, field), getattr(jax, field))


def _figure_data(figure):
    """What a figure draws: each axes' lines, images, texts, bar heights,
    table cells and title, the figure's suptitle."""
    out = []
    for axes in figure.axes:
        out.append({
            "lines": [numpy.asarray(line.get_xydata()).tolist()
                      for line in axes.get_lines()],
            "styles": [(line.get_linestyle(), line.get_marker(),
                        line.get_color()) for line in axes.get_lines()],
            "images": [numpy.asarray(im.get_array()).tolist()
                       for im in axes.get_images()],
            "texts": [(t.get_text(), t.get_position())
                      for t in axes.texts],
            "bars": [(p.get_x(), p.get_width(), p.get_height())
                     for p in axes.patches],
            "tables": [sorted((k, c.get_text().get_text())
                              for k, c in t.get_celld().items())
                       for t in axes.tables],
            "labels": (axes.get_xlabel(), axes.get_ylabel(),
                       axes.get_title()),
            "ylim": axes.get_ylim() if axes.get_lines() else None,
        })
    title = figure._suptitle.get_text() if figure._suptitle else None
    return out, title


@pytest.mark.parametrize("name,make,fields", PARITY,
                         ids=[p[0] for p in PARITY])
def test_rendered_figure_equals_jax(name, make, fields):
    port, jax = _pair(make)
    figures = []
    for plotter in (port, jax):
        figure = pp.figure()
        plotter.redraw(figure)
        figure.canvas.draw()
        figures.append(_figure_data(figure))
        pp.close(figure)
    assert figures[0] == figures[1]
    assert figures[0][0], "the plot drew nothing"


def test_cuda_tensors_are_captured_to_the_host(monkeypatch):
    """``fill()`` copies a tensor through ``.detach().cpu()``: a tensor
    on any device lands in the snapshot as a host numpy array (a CUDA
    tensor is the card test's, ``tests/test_torch_cuda.py``)."""
    calls = []
    real = torch.Tensor.cpu

    def spy(self, *args, **kwargs):
        calls.append(self.device.type)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    plotter = MatrixPlotter(DummyWorkflow(), name="conf")
    plotter.input = torch.ones(3, 3, dtype=torch.int32, requires_grad=False)
    plotter.fill()
    assert calls == ["cpu"]
    plotter.stripped_pickle = True
    clone = pickle.loads(pickle.dumps(plotter))
    assert isinstance(clone.matrix, numpy.ndarray)
    assert not [k for k, v in vars(clone).items()
                if isinstance(v, torch.Tensor)]
