"""The eager Kohonen unit graph of the port (``nn/kohonen.py``
``KohonenForward`` / ``KohonenTrainer``, ``models/mnist_ae.py``
``KohonenWorkflow``, ``train/som.py`` ``SOMFusedRunner``) against the JAX
package's.

At ``tests/test_torch_models.py``'s SOM sizes (a 4x3 map over 40
training and 12 validation golden digits, minibatch 16, the loader's
epoch counter stopping at 1: two sweeps of four minibatches) and its
tolerance (1e-5 absolute on the codebook, weights ~0.1; the JAX unit
computes its schedule in float64 and casts, the port in float32), each
run from the same seeds: the port's eager ``run()`` and its fused runner
against JAX's ``SOMFusedRunner``, and the port's eager run against its
own fused runner (0 values differ: the same functions on the same rows).
Each comparison runs in fresh interpreters, and again in ones that
collected ``tests/test_torch_cuda.py`` first, under several fixed
``PYTHONHASHSEED`` values; the port's codebook must be the same bytes
under every one (its loop depends on neither hashing nor memory layout).

JAX's eager ``run()`` is not the reference: in some interpreters it ends
0.40679 away from its fused runner (a codebook summing to -2937.13
against -4175.69). Its loader writes each minibatch's indices in place
into one host buffer (``veles_tpu/loader/base.py`` ``_apply_payload``,
``map_invalidate``) and uploads it with ``jax.device_put``
(``memory.py`` ``_upload``); where that 64-byte buffer happens to be
64-byte aligned, the CPU client aliases it instead of copying, so a
gather still queued behind JAX's asynchronous dispatch reads the next
minibatch's indices. Whether the buffer is aligned depends on the heap
layout, which a hash seed fixes per process.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy
import pytest

torch = pytest.importorskip("torch")

from veles_tpu import prng as jax_prng  # noqa: E402
from veles_tpu.backends import Device  # noqa: E402
from veles_tpu.dummy import DummyWorkflow as JaxDummyWorkflow  # noqa: E402
from veles_tpu.memory import Array  # noqa: E402
from veles_tpu.nn import kohonen as jax_kohonen  # noqa: E402
from veles_tpu_torch import prng  # noqa: E402
from veles_tpu_torch.datasets import golden_digits  # noqa: E402
from veles_tpu_torch.dummy import DummyLauncher, DummyWorkflow  # noqa: E402
from veles_tpu_torch.models.mnist import MnistLoader  # noqa: E402
from veles_tpu_torch.models.mnist_ae import KohonenWorkflow  # noqa: E402
from veles_tpu_torch.nn.kohonen import (KohonenForward,  # noqa: E402
                                        KohonenTrainer, SOMCodebook)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
#: the hash seeds each comparison runs under
HASH_SEEDS = ("0", "6", "9", "15")

#: the comparison, run in a fresh interpreter (argv: the repo, then
#: "fresh" or "after_cuda"); prints one JSON line
COMPARE = textwrap.dedent('''
    import hashlib
    import json
    import sys
    sys.path.insert(0, sys.argv[1])
    if sys.argv[2] == "after_cuda":
        import pytest
        assert pytest.main(["--collect-only", "-q", "-p",
                            "no:cacheprovider", sys.argv[1] +
                            "/tests/test_torch_cuda.py"]) == 0
    import numpy
    from veles_tpu import prng as jax_prng
    from veles_tpu.backends import Device
    from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
    from veles_tpu.models import mnist as jax_mnist
    from veles_tpu.models.mnist_ae import KohonenWorkflow as JaxKohonen
    from veles_tpu_torch import prng
    from veles_tpu_torch.datasets import golden_digits
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mnist import MnistLoader
    from veles_tpu_torch.models.mnist_ae import KohonenWorkflow

    DIGITS = golden_digits(40, 12, seed=31)

    def jax_fused_run():
        jax_prng.get().seed(21)
        jax_prng.get("loader").seed(22)
        wf = JaxKohonen(JaxDummyLauncher(),
                        loader_factory=lambda w: jax_mnist.MnistLoader(
                            w, provider=DIGITS, minibatch_size=16),
                        sx=4, sy=3, epochs=1)
        wf.initialize(device=Device(backend="cpu"))
        wf.make_fused_runner().run()
        return wf, numpy.array(wf.trainer.weights.map_read())

    def port_run(fused):
        prng.get().seed(21)
        prng.get("loader").seed(22)
        wf = KohonenWorkflow(DummyLauncher(),
                             loader_factory=lambda w: MnistLoader(
                                 workflow=w, provider=DIGITS,
                                 minibatch_size=16),
                             sx=4, sy=3, epochs=1)
        wf.initialize(device="cpu")
        (wf.make_fused_runner() if fused else wf).run()
        return wf, wf.trainer.weights.numpy().copy()

    jf, jfw = jax_fused_run()
    (pe, pew), (pf, pfw) = port_run(False), port_run(True)
    print(json.dumps({
        "port_vs_jax": float(numpy.abs(pew - jfw).max()),
        "port_fused_vs_jax": float(numpy.abs(pfw - jfw).max()),
        "port_eager_vs_fused_differing": int((pew != pfw).sum()),
        "port_digest": hashlib.sha256(pew.tobytes()).hexdigest(),
        "times": [jf.trainer.time, pe.trainer.time, pf.trainer.time],
        "stopped": [bool(pe.stopped), bool(pf.stopped)],
        "epochs": [jf.loader.epoch_number, pe.loader.epoch_number,
                   pf.loader.epoch_number]}))
''')


@pytest.mark.parametrize("where", ["fresh", "after_cuda"])
def test_eager_loop_matches_jax_and_the_fused_runner(where):
    digests = set()
    for seed in HASH_SEEDS:
        # one interpreter at a time: the suite's other workers share the
        # host's cores
        proc = subprocess.run(
            [sys.executable, "-c", COMPARE, REPO, where],
            capture_output=True, text=True, timeout=600, cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONHASHSEED=seed))
        out, err = proc.stdout, proc.stderr
        assert proc.returncode == 0, (seed, out[-3000:] + err[-3000:])
        got = json.loads(out.strip().splitlines()[-1])
        assert got["times"] == [8, 8, 8], seed
        assert all(got["stopped"]) and got["epochs"] == [1, 1, 1], seed
        assert got["port_vs_jax"] <= TOL, (seed, got)
        assert got["port_fused_vs_jax"] <= TOL, (seed, got)
        assert got["port_eager_vs_fused_differing"] == 0, (seed, got)
        digests.add(got["port_digest"])
    assert len(digests) == 1, digests


def _seed(weight=21, loader=22):
    jax_prng.get().seed(weight)
    jax_prng.get("loader").seed(loader)
    prng.get().seed(weight)
    prng.get("loader").seed(loader)


def test_trainer_unit_draws_and_steps_as_jax():
    """The unit with JAX's keywords: the same codebook drawn from the
    same stream, and three steps on the same rows within 1e-5; the
    forward's winners equal ``_winners`` of the same codebook."""
    assert KohonenTrainer.consumes_global_rng_on_init
    _seed()
    rng = numpy.random.RandomState(3)
    x = rng.rand(6, 5).astype(numpy.float32)
    jax_unit = jax_kohonen.KohonenTrainer(
        JaxDummyWorkflow(), sx=3, sy=2, sigma=1.5, learning_rate=0.4,
        decay=0.01)
    jax_unit.input = Array(x)
    jax_unit.initialize(device=Device(backend="cpu"))
    unit = KohonenTrainer(DummyWorkflow(), sx=3, sy=2, sigma=1.5,
                          learning_rate=0.4, decay=0.01)
    unit.input = torch.from_numpy(x)
    unit.initialize(device="cpu")
    numpy.testing.assert_array_equal(unit.weights.numpy(),
                                     jax_unit.weights.map_read())
    for _ in range(3):
        jax_unit.run()
        unit.run()
        numpy.testing.assert_array_equal(unit.winners.numpy(),
                                         jax_unit.winners.map_read())
    numpy.testing.assert_allclose(unit.weights.numpy(),
                                  jax_unit.weights.map_read(), atol=TOL,
                                  rtol=0)
    assert unit.time == jax_unit.time == 3
    forward = KohonenForward(DummyWorkflow())
    forward.input = torch.from_numpy(x)
    forward.weights = unit.weights
    forward.initialize(device="cpu")
    assert forward.output.device.type == "meta"
    forward.run()
    want = numpy.asarray(jax_kohonen._winners(unit.weights.numpy(), x))
    numpy.testing.assert_array_equal(forward.output.numpy(), want)


def test_unit_and_codebook_take_the_same_steps():
    """The unit and :class:`SOMCodebook` share the schedule and the
    update: from one codebook, three steps give the same values."""
    prng.get().seed(5)
    book = SOMCodebook(7, 3, 3, device="cpu")
    prng.get().seed(5)
    unit = KohonenTrainer(DummyWorkflow(), sx=3, sy=3)
    unit.input = torch.zeros(4, 7)
    unit.initialize(device="cpu")
    assert torch.equal(unit.weights, book.weights)
    x = torch.from_numpy(numpy.random.RandomState(1).rand(4, 7).astype(
        numpy.float32))
    for _ in range(3):
        unit.input = x
        unit.run()
        book.step(x)
    assert torch.equal(unit.weights, book.weights)


def _port_workflow(epochs=1):
    return KohonenWorkflow(
        DummyLauncher(), loader_factory=lambda w: MnistLoader(
            workflow=w, provider=golden_digits(40, 12, seed=31),
            minibatch_size=16), sx=4, sy=3, epochs=epochs)


def test_make_fused_runner_conditions():
    """JAX's conditions for no runner: no data loaded yet, or a loader
    inside an epoch (a mid-epoch snapshot); at an epoch's end it
    runs."""
    _seed()
    wf = _port_workflow()
    assert wf.make_fused_runner() is None
    wf.initialize(device="cpu")
    assert type(wf.make_fused_runner()).__name__ == "SOMFusedRunner"
    wf.loader._global_offset = 16
    assert wf.make_fused_runner() is None
    wf.loader._global_offset = wf.loader.total_samples
    assert wf.make_fused_runner() is not None


def test_launcher_runs_the_workflows_own_runner():
    """Under a launcher the workflow's runner is taken ("custom"), and
    the run ends where the eager one ends."""
    from veles_tpu_torch.launcher import Launcher
    _seed()
    eager = _port_workflow(epochs=2)
    eager.initialize(device="cpu")
    eager.run()
    _seed()
    launcher = Launcher(backend="cpu", graphics=False)
    wf = KohonenWorkflow(
        launcher, loader_factory=lambda w: MnistLoader(
            workflow=w, provider=golden_digits(40, 12, seed=31),
            minibatch_size=16), sx=4, sy=3, epochs=2)
    launcher.initialize()
    launcher.run()
    assert launcher.run_mode_used == "custom"
    assert wf.trainer.time == eager.trainer.time == 12
    assert torch.equal(wf.trainer.weights, eager.trainer.weights)
    assert len(launcher.runner.epoch_times) == 3


def test_jax_snapshot_resumes_in_the_port(monkeypatch):
    """A JAX ``KohonenWorkflow`` (the JAX constructor's 10 epochs)
    snapshotted after its first two sweeps, its ``SOMFusedRunner``
    stopped there, then resumed by JAX's runner and by the port's fused
    runner and eager loop: the codebook within 1e-5, ``time``, the epoch
    counter and ``complete`` equal. The JAX counter's class is local to
    the workflow's constructor, which ``pickle`` cannot name; the test
    gives it a module-level name for the dump (the class, its closure's
    limit and the JAX package are unchanged)."""
    import veles_tpu.models.mnist_ae as jax_ae
    from veles_tpu.dummy import DummyLauncher as JaxDummyLauncher
    from veles_tpu.models import mnist as jax_mnist
    from veles_tpu.snapshotter import dump_workflow as jax_dump
    from veles_tpu.snapshotter import load_workflow as jax_load
    from veles_tpu_torch.snapshotter import load_workflow
    _seed()
    digits = golden_digits(40, 12, seed=31)
    jax_wf = jax_ae.KohonenWorkflow(
        JaxDummyLauncher(), loader_factory=lambda w: jax_mnist.MnistLoader(
            w, provider=digits, minibatch_size=16), sx=4, sy=3)
    jax_wf.initialize(device=Device(backend="cpu"))
    counter_cls = type(jax_wf.counter)  # made for this workflow alone
    counter_cls.__qualname__ = "EpochCounter"
    monkeypatch.setattr(jax_ae, "EpochCounter", counter_cls, raising=False)
    count = counter_cls.run

    def stop_after_the_first_wrap(self):
        count(self)
        if self.epoch_number == 1:
            self.workflow.stop()

    monkeypatch.setattr(counter_cls, "run", stop_after_the_first_wrap)
    jax_wf.make_fused_runner().run()
    monkeypatch.setattr(counter_cls, "run", count)
    assert jax_wf.trainer.time == 8 and jax_wf.loader.epoch_number == 1
    assert not bool(jax_wf.counter.complete)
    blob = jax_dump(jax_wf)

    want = jax_load(blob)
    want.workflow = JaxDummyLauncher()
    want.initialize(device=Device(backend="cpu"))
    want.make_fused_runner().run()
    want_weights = numpy.asarray(want.trainer.weights.map_read())
    assert want.trainer.time == 44 and want.loader.epoch_number == 10

    for fused in (True, False):
        prng._generators.clear()
        got = load_workflow(blob)
        assert type(got).__name__ == "KohonenWorkflow"
        assert got.trainer.time == 8 and got.counter.epochs == 10
        got.workflow = DummyLauncher()
        got.initialize(device="cpu")
        (got.make_fused_runner() if fused else got).run()
        numpy.testing.assert_allclose(got.trainer.weights.numpy(),
                                      want_weights, atol=TOL, rtol=0)
        assert got.trainer.time == want.trainer.time
        assert got.loader.epoch_number == want.loader.epoch_number
        assert bool(got.counter.complete) and bool(got.stopped)
