"""The port's workflow engine against the JAX package's, on the CPU.

* Engine: the graph cases of ``tests/test_workflow.py`` on the port's
  units (chain order, the diamond barrier, the repeater loop, gate_skip,
  gate_block, demand, partial initialization, change_unit, the pickle
  round trip, the checksum's change with topology, the DOT graph).
* Parity before training: under the same ``-s``, the port's
  ``initialize()`` gives the JAX workflow's initial weights bit for bit
  (``MnistWorkflow`` on the 6x6 tiny provider of ``tests/
  test_launcher.py``, and ``AlexNetWorkflow`` over
  ``small_alexnet_layers``), and the same topology checksum.
* Parity in training: 3 epochs through ``veles_tpu_torch.__main__.
  main([..., "-a", "cpu"])`` against ``veles_tpu.__main__.main``:
  ``epoch_history`` (samples and metric sums equal, normalized metrics
  within 1e-12; read: equal), final parameters and SGD velocity within
  1e-6 (``MnistWorkflow``, no dropout; read: 6e-8 and 6e-9), and the
  small AlexNet with dropout, JAX's own uniforms handed to the port as
  in ``tests/test_torch_train.py``, the same (read: 1.5e-8 and 3e-10).
* The runner's semantics: ``fused_compatible`` refusals, services fired
  once an epoch with gate_block swallowing and gate_skip propagating,
  ``--test -w`` on a finished snapshot (one forward-only epoch, no
  weight changed), and a finished snapshot resuming to nothing.
* The modes once refused: ``--eager`` runs the eager scheduler, ``-l``
  and ``-m`` run a master and a slave through the CLI to the last epoch
  (``tests/test_torch_distributed.py`` holds them to JAX's), and
  ``--auto-resume`` snapshots every closed epoch; ``--gspmd`` alone
  still raises ``NotImplementedError``. A graph the fused path rejects
  falls back to the eager scheduler (``tests/test_torch_eager.py``
  holds that path to JAX's).
"""

import json
import os
import pickle
import threading
import time

import jax
import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher  # noqa: E402
from veles_tpu.models.alexnet import AlexNetWorkflow as JaxAlexNet  # noqa
from veles_tpu.models.alexnet import \
    SyntheticImageLoader as JaxSyntheticImageLoader  # noqa: E402
from veles_tpu.models.mnist import MnistWorkflow as JaxMnist  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.convert import (layer_params,  # noqa: E402
                                     solver_state_to_jax, to_jax_layout)
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow  # noqa: E402
from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,  # noqa: E402
                                            SyntheticImageLoader,
                                            small_alexnet_layers)
from veles_tpu_torch.models.mnist import MnistWorkflow  # noqa: E402
from veles_tpu_torch.mutable import Bool  # noqa: E402
from veles_tpu_torch.plumbing import Repeater  # noqa: E402
from veles_tpu_torch.snapshotter import dump_workflow  # noqa: E402
from veles_tpu_torch.standard_workflow import TrainableWorkflow  # noqa
from veles_tpu_torch.train.runner import (FusedRunner,  # noqa: E402
                                          fused_compatible)
from veles_tpu_torch.units import TrivialUnit, Unit  # noqa: E402

TINY_PROVIDER = '''
import numpy


class TinyProvider(object):
    def __call__(self):
        rng = numpy.random.RandomState(0)
        x = rng.rand(80, 6, 6).astype(numpy.float32)
        y = (x.reshape(80, -1).sum(1) > 18).astype(numpy.int32)
        return x[:60], y[:60], x[60:], y[60:]
'''

#: the tiny MnistWorkflow file of tests/test_launcher.py, for a package
MNIST_FILE = TINY_PROVIDER + '''
from {package}.models.mnist import MnistWorkflow


def run(load, main):
    load(MnistWorkflow, provider=TinyProvider(), layers=(8,),
         minibatch_size=20, max_epochs={epochs})
    main()
'''

SMALL_LOADER = dict(n_train=40, n_valid=16, side=32, n_classes=10,
                    minibatch_size=16)

#: a small AlexNet file (dropout included) for a package
ALEXNET_FILE = '''
from {package}.models.alexnet import (AlexNetWorkflow,
                                      SyntheticImageLoader,
                                      small_alexnet_layers)


def run(load, main):
    load(AlexNetWorkflow,
         loader_factory=lambda wf: SyntheticImageLoader(
             {workflow_kw}, n_train=40, n_valid=16, side=32,
             n_classes=10, minibatch_size=16),
         layers=small_alexnet_layers(10), max_epochs={epochs})
    main()
'''


def workflow_file(tmp_path, template, package, epochs, stem):
    path = tmp_path / ("%s_%s.py" % (stem, package))
    workflow_kw = "wf" if package == "veles_tpu" else "workflow=wf"
    path.write_text(template.format(package=package, epochs=epochs,
                                    workflow_kw=workflow_kw))
    return str(path)


# -- the engine --------------------------------------------------------------

class Recorder(TrivialUnit):
    """Records the global order in which units run."""

    hide_from_registry = True
    trace = []

    def run(self):
        Recorder.trace.append(self.name)


def make_chain(wf, names):
    units = [Recorder(wf, name=n) for n in names]
    prev = wf.start_point
    for u in units:
        u.link_from(prev)
        prev = u
    wf.end_point.link_from(prev)
    return units


def _run(wf):
    Recorder.trace = []
    wf.initialize()
    wf.run()
    return Recorder.trace


def case_chain():
    wf = DummyWorkflow()
    make_chain(wf, ["a", "b", "c"])
    assert _run(wf) == ["a", "b", "c"]
    assert bool(wf.stopped)


def case_diamond():
    wf = DummyWorkflow()
    a, b, c, j = [Recorder(wf, name=n) for n in ("a", "b", "c", "join")]
    a.link_from(wf.start_point)
    b.link_from(a)
    c.link_from(a)
    j.link_from(b, c)
    wf.end_point.link_from(j)
    trace = _run(wf)
    assert trace.index("join") > max(trace.index("b"), trace.index("c"))
    assert trace.count("join") == 1


def case_repeater_loop():
    wf = DummyWorkflow()
    rep = Repeater(wf)
    body = Recorder(wf, name="body")
    complete = Bool(False)
    runs = []

    class Decision(TrivialUnit):
        hide_from_registry = True

        def run(self):
            runs.append(1)
            if len(runs) >= 3:
                complete.value = True

    dec = Decision(wf, name="decision")
    rep.link_from(wf.start_point)
    body.link_from(rep)
    dec.link_from(body)
    rep.link_from(dec)
    rep.gate_block = complete
    wf.end_point.link_from(dec)
    wf.end_point.gate_block = ~complete
    assert _run(wf) == ["body"] * 3
    assert bool(wf.stopped)


def case_gate_skip():
    wf = DummyWorkflow()
    a, b, c = make_chain(wf, ["a", "b", "c"])
    b.gate_skip <<= True
    assert _run(wf) == ["a", "c"]


def case_gate_block():
    wf = DummyWorkflow()
    a = Recorder(wf, name="a")
    blocked = Recorder(wf, name="blocked")
    a.link_from(wf.start_point)
    blocked.link_from(a)
    blocked.gate_block <<= True
    wf.end_point.link_from(a)
    assert _run(wf) == ["a"]


def case_demand():
    wf = DummyWorkflow()

    class Needy(Unit):
        hide_from_registry = True

        def __init__(self, workflow, **kwargs):
            super(Needy, self).__init__(workflow, **kwargs)
            self.demand("input")

    n = Needy(wf, name="needy")
    n.link_from(wf.start_point)
    wf.end_point.link_from(n)
    with pytest.raises(AttributeError):
        wf.initialize()
    provider = TrivialUnit(wf, name="p")
    provider.output = 123
    n.link_attrs(provider, ("input", "output"))
    wf.initialize()
    assert n.input == 123


def case_partial_initialization():
    wf = DummyWorkflow()
    order = []

    class Late(TrivialUnit):
        hide_from_registry = True
        attempts = 0

        def initialize(self, **kwargs):
            Late.attempts += 1
            order.append("late:%d" % Late.attempts)
            return Late.attempts < 2 or None

    class Early(TrivialUnit):
        hide_from_registry = True

        def initialize(self, **kwargs):
            order.append("early")

    late = Late(wf, name="late")
    early = Early(wf, name="early")
    late.link_from(wf.start_point)
    early.link_from(late)
    wf.end_point.link_from(early)
    wf.initialize()
    assert order == ["late:1", "early", "late:2"]


def case_change_unit():
    wf = DummyWorkflow()
    a, b, c = make_chain(wf, ["a", "b", "c"])
    gate = Bool(False)
    b.gate_skip = gate
    b2 = Recorder(wf, name="b2")
    assert wf.change_unit("b", b2) is b2
    assert b not in wf.units and b2 in wf.units
    assert a in b2.links_from and c in b2.links_to
    assert b2.gate_skip is gate
    assert not b.links_from and not b.links_to
    assert _run(wf) == ["a", "b2", "c"]


def case_pickle_round_trip():
    wf = DummyWorkflow()
    make_chain(wf, ["a", "b"])
    _run(wf)
    wf2 = pickle.loads(pickle.dumps(wf))
    assert [u.name for u in wf2.units if isinstance(u, Recorder)] == \
        ["a", "b"]
    wf2.workflow = DummyLauncher()
    assert _run(wf2) == ["a", "b"]


def case_checksum():
    wf1, wf2, wf3 = DummyWorkflow(), DummyWorkflow(), DummyWorkflow()
    make_chain(wf1, ["a", "b"])
    make_chain(wf2, ["a", "c"])
    make_chain(wf3, ["a", "b"])
    assert wf1.checksum != wf2.checksum
    assert wf1.checksum == wf3.checksum


def case_graph_dot():
    wf = DummyWorkflow()
    make_chain(wf, ["a"])
    dot = wf.generate_graph()
    assert dot.startswith("digraph") and "->" in dot


def case_insert_after():
    wf = DummyWorkflow()
    a, b = [TrivialUnit(wf, name=n) for n in "ab"]
    b.link_from(a)
    mid = TrivialUnit(wf, name="mid")
    a.insert_after(mid)
    assert mid in b.links_from and a in mid.links_from
    assert a not in b.links_from


ENGINE_CASES = {name[len("case_"):]: fn for name, fn in sorted(
    globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine(case):
    ENGINE_CASES[case]()


# -- parity before training --------------------------------------------------

def _seed_both(spec="7"):
    from veles_tpu.__main__ import Main as JaxMain
    from veles_tpu_torch.__main__ import Main
    JaxMain()._seed_random(spec)
    Main()._seed_random(spec)


def _tiny_provider():
    namespace = {}
    exec(TINY_PROVIDER, namespace)  # noqa: S102 -- the test's own text
    return namespace["TinyProvider"]()


def _jax_weights(wf):
    return [{k: numpy.asarray(a.map_read()) for k, a in
             fwd.param_arrays().items()} for fwd in wf.forwards]


def _port_weights(wf):
    return [to_jax_layout(layer_params(fwd.module)) for fwd in wf.forwards]


def _built(kind):
    if kind == "mnist":
        jax_wf = JaxMnist(JaxDummyLauncher(), provider=_tiny_provider(),
                          layers=(8,), minibatch_size=20, max_epochs=2)
        port_wf = MnistWorkflow(DummyLauncher(), provider=_tiny_provider(),
                                layers=(8,), minibatch_size=20,
                                max_epochs=2)
    else:
        jax_wf = JaxAlexNet(
            JaxDummyLauncher(), layers=small_alexnet_layers(10),
            loader_factory=lambda w: JaxSyntheticImageLoader(
                w, **SMALL_LOADER), max_epochs=2)
        port_wf = AlexNetWorkflow(
            DummyLauncher(), layers=small_alexnet_layers(10),
            loader_factory=lambda w: SyntheticImageLoader(
                workflow=w, **SMALL_LOADER), max_epochs=2)
    return jax_wf, port_wf


@pytest.mark.parametrize("kind", ["mnist", "alexnet"])
def test_initial_weights_bit_for_bit(kind):
    """Same ``-s``: the same initial weights, bit for bit, and the same
    topology checksum and unit names."""
    _seed_both("7")
    jax_wf, port_wf = _built(kind)
    jax_wf.initialize(device=Device(backend="cpu"))
    port_wf.initialize(device="cpu")
    got, want = _port_weights(port_wf), _jax_weights(jax_wf)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            numpy.testing.assert_array_equal(g[k], w[k])
    assert [u.name for u in port_wf.units] == [u.name for u in jax_wf.units]
    assert port_wf.checksum == jax_wf.checksum
    # the streams stand where JAX's stand after initialize
    assert prng.get().save_state()[0][2] == \
        jax_prng.get().save_state()[0][2]


def test_initial_weights_follow_the_seed():
    """A different seed draws different weights (the control)."""
    _seed_both("7")
    _, a = _built("mnist")
    a.initialize(device="cpu")
    _seed_both("8")
    _, b = _built("mnist")
    b.initialize(device="cpu")
    assert not numpy.array_equal(_port_weights(a)[0]["weights"],
                                 _port_weights(b)[0]["weights"])


# -- parity in training ------------------------------------------------------

class JaxUniforms(object):
    """JAX's dropout uniforms for the port (``tests/test_torch_train.
    py``): epoch e's base key is ``fold_in(PRNGKey(seed), counter + e)``
    of the JAX dropout stream, batch and layer folded in after it."""

    def __init__(self, seed_value, counter):
        self.seed_value, self.counter = seed_value, counter
        self.bases = {}

    def __call__(self, shape, seed, batch_index, layer_index, device):
        if seed not in self.bases:
            self.bases[seed] = jax.random.fold_in(
                jax.random.PRNGKey(self.seed_value),
                self.counter + len(self.bases))
        key = jax.random.fold_in(jax.random.fold_in(
            self.bases[seed], batch_index), layer_index)
        return torch.from_numpy(numpy.array(
            jax.random.uniform(key, shape))).to(device)


def _cli_pair(tmp_path, template, stem, epochs=3, extra=()):
    from veles_tpu.__main__ import Main as JaxMain
    from veles_tpu_torch.__main__ import Main
    jax_main = JaxMain()
    assert jax_main.run([workflow_file(tmp_path, template, "veles_tpu",
                                       epochs, stem), "-s", "7",
                         "--result-file", str(tmp_path / "jax.json")]) == 0
    port_main = Main()
    assert port_main.run([workflow_file(tmp_path, template,
                                        "veles_tpu_torch", epochs, stem),
                          "-s", "7", "-a", "cpu", "--result-file",
                          str(tmp_path / "port.json")] + list(extra)) == 0
    return jax_main.workflow, port_main.workflow


def _assert_history(got, want):
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
    for g, w in zip(got, want):
        for klass in ("validation", "train"):
            assert g[klass]["samples"] == w[klass]["samples"]
            assert g[klass]["metric"] == w[klass]["metric"]
            assert abs(g[klass]["normalized"] - w[klass]["normalized"]) \
                <= 1e-12


def _assert_trained(jax_wf, port_wf, atol):
    for g, w in zip(_port_weights(port_wf), _jax_weights(jax_wf)):
        for k in w:
            numpy.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0)
    jax_gds = {gd.name: gd for gd in jax_wf.gds}
    for gd in port_wf.gds:
        if not gd.opt_state:
            continue
        got = solver_state_to_jax([gd.opt_state])[0]
        want = jax_gds[gd.name].opt_state
        assert float(got["step"]) == float(numpy.asarray(want["step"]))
        for k, v in want["velocity"].items():
            numpy.testing.assert_allclose(got["velocity"][k],
                                          numpy.asarray(v), atol=atol,
                                          rtol=0)


def test_cli_three_epochs_match_jax_mnist(tmp_path):
    jax_wf, port_wf = _cli_pair(tmp_path, MNIST_FILE, "mnist")
    _assert_history(port_wf.decision.epoch_history,
                    jax_wf.decision.epoch_history)
    _assert_trained(jax_wf, port_wf, 1e-6)
    assert port_wf.decision.best_epoch == jax_wf.decision.best_epoch
    got = json.load(open(tmp_path / "port.json"))
    want = json.load(open(tmp_path / "jax.json"))
    for key in ("best_n_err_pt", "best_epoch", "epochs", "n_err"):
        assert got[key] == want[key]
    assert abs(got["loss"] - want["loss"]) <= 1e-5


def test_cli_three_epochs_match_jax_alexnet_dropout(tmp_path, monkeypatch):
    """The small AlexNet with dropout: the port's masks from JAX's own
    uniforms (the JAX dropout stream is ``default``, seeded 7, its key
    counter at 0 when training starts)."""
    monkeypatch.setattr(TrainableWorkflow, "uniform_source",
                        JaxUniforms(7, 0))
    jax_wf, port_wf = _cli_pair(tmp_path, ALEXNET_FILE, "alexnet")
    _assert_history(port_wf.decision.epoch_history,
                    jax_wf.decision.epoch_history)
    _assert_trained(jax_wf, port_wf, 1e-6)


# -- the runner's semantics --------------------------------------------------

def _small_mnist(max_epochs=2):
    prng.get().seed(3)
    prng.get("loader").seed(4)
    wf = MnistWorkflow(DummyLauncher(), provider=_tiny_provider(),
                       layers=(8,), minibatch_size=20,
                       max_epochs=max_epochs)
    return wf


class Service(TrivialUnit):
    """An epoch-boundary service that counts its runs."""

    hide_from_registry = True
    view_group = "SERVICE"

    def run(self):
        self.runs = getattr(self, "runs", 0) + 1


def _refusal(kind):
    wf = _small_mnist()
    if kind == "custom_unit":
        custom = TrivialUnit(wf, name="custom")
        custom.link_from(wf.decision)
    wf.initialize(device="cpu")
    if kind == "unaligned_offset":
        wf.loader._global_offset = 25
    elif kind == "requeued":
        wf.loader._global_offset = 40
        wf.loader.failed_minibatches = [{"indices": [0]}]
    elif kind == "no_labels":
        wf.loader.original_labels = None
    return fused_compatible(wf)


@pytest.mark.parametrize("kind,needle", [
    ("custom_unit", "custom"), ("unaligned_offset", "minibatch-aligned"),
    ("requeued", "requeued"), ("no_labels", "original_labels")])
def test_fused_compatible_refuses(kind, needle):
    reason = _refusal(kind)
    assert reason is not None and needle in reason


def test_fused_compatible_accepts_standard_graph():
    assert _refusal("none") is None


def test_services_fire_with_gate_semantics():
    """Once an epoch; gate_block swallows the signal (the dependent never
    runs), gate_skip propagates without running."""
    wf = _small_mnist(max_epochs=3)
    plain, skipped, after_skip, blocked, after_block = [
        Service(wf, name=n) for n in ("plain", "skipped", "after_skip",
                                      "blocked", "after_block")]
    plain.link_from(wf.decision)
    skipped.link_from(wf.decision)
    skipped.gate_skip <<= True
    after_skip.link_from(skipped)
    blocked.link_from(wf.decision)
    blocked.gate_block <<= True
    after_block.link_from(blocked)
    epoch_gated = Service(wf, name="epoch_gated")
    epoch_gated.link_from(wf.decision)
    epoch_gated.gate_skip = ~wf.loader.epoch_ended
    wf.initialize(device="cpu")
    assert fused_compatible(wf) is None
    FusedRunner(wf).run()
    runs = {u.name: getattr(u, "runs", 0) for u in
            (plain, skipped, after_skip, blocked, after_block, epoch_gated)}
    assert runs == {"plain": 3, "skipped": 0, "after_skip": 3,
                    "blocked": 0, "after_block": 0, "epoch_gated": 3}


def _finished_snapshot(tmp_path):
    from veles_tpu_torch.__main__ import Main
    main = Main()
    path = workflow_file(tmp_path, MNIST_FILE, "veles_tpu_torch", 2, "fin")
    assert main.run([path, "-s", "7", "-a", "cpu"]) == 0
    snap = str(tmp_path / "finished.pickle")
    with open(snap, "wb") as f:
        f.write(dump_workflow(main.workflow))
    return path, snap, main.workflow


def test_test_mode_on_finished_snapshot(tmp_path):
    """``--test -w``: one forward-only epoch over every class, no weight
    changed, its metrics in the history and the result file."""
    from veles_tpu_torch.__main__ import Main
    path, snap, trained = _finished_snapshot(tmp_path)
    before = _port_weights(trained)
    main = Main()
    result = str(tmp_path / "test.json")
    assert main.run([path, "-a", "cpu", "--test", "-w", snap,
                     "--result-file", result]) == 0
    wf = main.workflow
    hist = wf.decision.epoch_history
    assert len(hist) == 3 and hist[-1]["epoch"] == 2
    assert hist[-1]["train"]["samples"] == 60
    for g, w in zip(_port_weights(wf), before):
        for k in w:
            numpy.testing.assert_array_equal(g[k], w[k])
    assert json.load(open(result))["epochs"] == 3


def test_finished_snapshot_resumes_to_nothing(tmp_path):
    from veles_tpu_torch.__main__ import Main
    path, snap, trained = _finished_snapshot(tmp_path)
    main = Main()
    assert main.run([path, "-a", "cpu", "-w", snap]) == 0
    wf = main.workflow
    assert len(wf.decision.epoch_history) == 2
    assert main.launcher.runner.epoch_times == []
    for g, w in zip(_port_weights(wf), _port_weights(trained)):
        for k in w:
            numpy.testing.assert_array_equal(g[k], w[k])


# -- what the port refuses ---------------------------------------------------

def _cli_in_thread(argv):
    """``Main().run(argv)`` in a thread: (thread, Main, results)."""
    from veles_tpu_torch.__main__ import Main
    cli, results = Main(), []
    thread = threading.Thread(target=lambda: results.append(cli.run(argv)),
                              daemon=True)
    thread.start()
    return thread, cli, results


def _wait_for(predicate, timeout=60.0):
    deadline = time.time() + timeout
    while not predicate():
        assert time.time() < deadline, "timed out"
        time.sleep(0.02)


@pytest.mark.parametrize("flags", [["--eager"], ["-l", "127.0.0.1:0"],
                                   ["-m", "127.0.0.1:0"], ["--gspmd"],
                                   ["--auto-resume", "snapshots"]])
def test_cli_refuses_unported_modes(tmp_path, flags):
    """``--gspmd`` alone raises. ``--eager``, ``-l``, ``-m`` and
    ``--auto-resume``, once refused too, now run to the last epoch: the
    master and the slave each through the CLI (the other side of the
    pair through the launcher), the auto-resume master with a snapshot
    of every closed epoch in its directory."""
    from veles_tpu_torch.__main__ import Main, main
    from veles_tpu_torch.launcher import Launcher
    path = workflow_file(tmp_path, MNIST_FILE, "veles_tpu_torch", 1, "ref")
    if flags == ["--gspmd"]:
        with pytest.raises(NotImplementedError):
            main([path, "-a", "cpu"] + flags)
        return
    if flags == ["--eager"]:
        cli = Main()
        assert cli.run([path, "-a", "cpu"] + flags) == 0
        assert cli.launcher.run_mode_used == "eager"
        assert len(cli.workflow.decision.epoch_history) == 1
        return
    threads = []
    if flags[0] == "-m":
        # a master through the launcher, the slave under test the CLI
        prng.get().seed(7)
        prng.get("loader").seed(7)
        master = Launcher(listen_address="127.0.0.1:0")
        master_wf = MnistWorkflow(master, provider=_tiny_provider(),
                                  layers=(8,), minibatch_size=20,
                                  max_epochs=1)
        master.initialize()
        thread, cli, results = _cli_in_thread(
            [path, "-a", "cpu", "-s", "7", "-m",
             "127.0.0.1:%d" % master._server.address[1]])
        master.run()
        thread.join(timeout=60)
        assert not thread.is_alive() and results == [0]
        assert cli.launcher.run_mode_used == "slave"
        assert cli.launcher._client.jobs_done > 0
        history = master_wf.decision.epoch_history
    else:
        argv = [path, "-s", "7", "-l", "127.0.0.1:0"]
        if flags[0] == "--auto-resume":
            argv += ["--auto-resume", str(tmp_path / flags[1])]
        thread, cli, results = _cli_in_thread(argv)
        _wait_for(lambda: getattr(getattr(cli, "launcher", None),
                                  "_server", None) is not None)
        slave = Launcher(master_address="127.0.0.1:%d" %
                         cli.launcher._server.address[1], backend="cpu")
        prng.get().seed(7)
        prng.get("loader").seed(7)
        MnistWorkflow(slave, provider=_tiny_provider(), layers=(8,),
                      minibatch_size=20, max_epochs=1)
        slave.initialize()
        threads.append(threading.Thread(target=slave.run, daemon=True))
        threads[0].start()
        thread.join(timeout=60)
        threads[0].join(timeout=60)
        assert not thread.is_alive() and not threads[0].is_alive()
        assert results == [0]
        assert cli.launcher.run_mode_used == "master"
        history = cli.workflow.decision.epoch_history
        if flags[0] == "--auto-resume":
            assert any(name.endswith(".pickle.gz") for name in
                       os.listdir(str(tmp_path / flags[1])))
    assert [h["epoch"] for h in history] == [0]
    assert history[0]["train"]["samples"] == 60


def test_launcher_refuses_a_rejected_graph(caplog):
    """A graph the fused path refuses (a unit it does not model) is no
    longer refused: the launcher says why in the log and runs it eager,
    the custom unit once a minibatch."""
    from veles_tpu_torch.launcher import Launcher
    launcher = Launcher(backend="cpu")
    wf = MnistWorkflow(launcher, provider=_tiny_provider(), layers=(8,),
                       minibatch_size=20, max_epochs=1)
    custom = Recorder(wf, name="custom")
    custom.link_from(wf.decision)
    launcher.initialize()
    Recorder.trace = []
    with caplog.at_level("INFO"):
        launcher.run()
    assert launcher.run_mode_used == "eager"
    assert "fused path unavailable" in caplog.text and "custom" in \
        caplog.text
    assert Recorder.trace == ["custom"] * 4  # 80 samples, batches of 20
    assert len(wf.decision.epoch_history) == 1


def test_auto_backend_needs_a_card(monkeypatch):
    from veles_tpu_torch.launcher import resolve_backend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="-a cpu"):
        resolve_backend("auto")
    assert resolve_backend("cpu") == torch.device("cpu")


def test_cli_dry_runs_and_graph(tmp_path):
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.config import root
    path = workflow_file(tmp_path, MNIST_FILE, "veles_tpu_torch", 1, "dry")
    main = Main()
    assert main.run([path, "-a", "cpu", "--dry-run", "exec",
                     "root.testsection.alpha=42"]) == 0
    assert root.testsection.alpha == 42
    assert not main.workflow.is_initialized
    graph = str(tmp_path / "graph.dot")
    main = Main()
    assert main.run([path, "-a", "cpu", "--dry-run", "init",
                     "--workflow-graph", graph]) == 0
    assert main.workflow.forwards[0].module is not None
    assert main.workflow.decision.epoch_history == []
    assert "digraph" in open(graph).read()


def test_accelerated_workflow_binds_and_rates_its_device():
    """Every unit gets the workflow's device; ``computing_power`` is
    ``ops.benchmark.gemm_benchmark``'s rating of it."""
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    wf = _small_mnist(max_epochs=1)
    wf.initialize(device="cpu")
    assert isinstance(wf, AcceleratedWorkflow)
    assert wf.device == torch.device("cpu")
    assert all(f.device == wf.device for f in wf.forwards + wf.gds)
    assert wf.computing_power > 0
    state = wf.__getstate__()
    assert state["device"] is None
