"""The eager Kohonen unit graph of the port (``nn/kohonen.py``
``KohonenForward`` / ``KohonenTrainer``, ``models/mnist_ae.py``
``KohonenWorkflow``, ``train/som.py`` ``SOMFusedRunner``) against the JAX
package's.

At ``tests/test_torch_models.py``'s SOM sizes (a 4x3 map over 40
training and 12 validation golden digits, minibatch 16, the loader's
epoch counter stopping at 1: two sweeps of four minibatches) and its
tolerance (1e-5 absolute on the codebook, weights ~0.1; the JAX unit
computes its schedule in float64 and casts, the port in float32), each
run from the same seeds: the port's eager ``run()`` against JAX's eager
``run()``, the port's eager run against its own fused runner (0 values
differ: the same functions on the same rows), and JAX's eager run
against its ``SOMFusedRunner`` within the same 1e-5. Each comparison
runs in a fresh interpreter, and again in one that collected
``tests/test_torch_cuda.py`` first: the case in which JAX's eager loop
once ended 0.4 away from its fused runner.
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

#: the comparison, run in a fresh interpreter (argv: the repo, then
#: "fresh" or "after_cuda"); prints one JSON line
COMPARE = textwrap.dedent('''
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

    def jax_run(fused):
        jax_prng.get().seed(21)
        jax_prng.get("loader").seed(22)
        wf = JaxKohonen(JaxDummyLauncher(),
                        loader_factory=lambda w: jax_mnist.MnistLoader(
                            w, provider=DIGITS, minibatch_size=16),
                        sx=4, sy=3, epochs=1)
        wf.initialize(device=Device(backend="cpu"))
        (wf.make_fused_runner() if fused else wf).run()
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

    (je, jew), (jf, jfw) = jax_run(False), jax_run(True)
    (pe, pew), (pf, pfw) = port_run(False), port_run(True)
    print(json.dumps({
        "port_vs_jax": float(numpy.abs(pew - jew).max()),
        "port_eager_vs_fused_differing": int((pew != pfw).sum()),
        "jax_eager_vs_fused": float(numpy.abs(jew - jfw).max()),
        "times": [je.trainer.time, jf.trainer.time, pe.trainer.time,
                  pf.trainer.time],
        "stopped": [bool(je.stopped), bool(pe.stopped), bool(pf.stopped)],
        "epochs": [je.loader.epoch_number, pe.loader.epoch_number,
                   pf.loader.epoch_number]}))
''')


@pytest.mark.parametrize("where", ["fresh", "after_cuda"])
def test_eager_loop_matches_jax_and_the_fused_runner(where):
    proc = subprocess.run(
        [sys.executable, "-c", COMPARE, REPO, where], capture_output=True,
        text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["times"] == [8, 8, 8, 8]
    assert all(got["stopped"]) and got["epochs"] == [1, 1, 1]
    assert got["port_vs_jax"] <= TOL
    assert got["port_eager_vs_fused_differing"] == 0
    assert got["jax_eager_vs_fused"] <= TOL


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
