"""Rank programs of ``tests/test_torch_elastic.py``, run by
``tests/torch_world.py`` ``run_world`` in processes of their own.

Torch and the port only: a rank loads neither jax nor any ``veles_tpu``
module (the tests check the reports).
"""

from veles_tpu_torch import prng
from veles_tpu_torch.convert import solver_state_to_jax, to_jax_layout
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.models.mnist import MnistWorkflow
from veles_tpu_torch.parallel import mesh
from veles_tpu_torch.parallel.elastic import (ElasticContext, _DemoProvider,
                                              save_elastic_checkpoint)
from veles_tpu_torch.parallel.gspmd import GSPMDTrainer, gspmd_mesh
from veles_tpu_torch.train.runner import trainer_for

#: the demo worker's data and rate at small widths: a column layer (16
#: outputs), a row layer (16 inputs) and the head under ``1x2``
LAYERS = (16, 8)
SEED = 42


def demo_workflow(device="cpu", samples=128, valid=32, mb=16, epochs=3):
    """The elastic demo's ``MnistWorkflow``, seeded and initialized."""
    prng.get().seed(SEED)
    prng.get("loader").seed(SEED + 1)
    wf = MnistWorkflow(DummyLauncher(), provider=_DemoProvider(samples, valid),
                       layers=LAYERS, minibatch_size=mb, learning_rate=0.08,
                       momentum=0.9, max_epochs=epochs)
    wf.initialize(device=device)
    return wf


def generation_rank(snapdir, batch, model, epochs):
    """Train ``epochs`` epochs on a ``batch`` x ``model`` grid, cut one
    sharded generation, and return the whole parameters and solver
    states (JAX layout, gathered over the grid), the history's losses
    and the trainer's roles."""
    device = mesh.world_device()
    wf = demo_workflow(device)
    trainer = trainer_for(wf, GSPMDTrainer,
                          grid=gspmd_mesh(batch, model, device))
    trainer.epoch_history = wf.decision.epoch_history
    trainer.train(max_epochs=epochs)
    ctx = ElasticContext(0, mesh.world_size(), mesh.world_rank(),
                         snapshot_dir=snapdir)
    save_elastic_checkpoint(trainer, ctx, trainer.params, trainer.states,
                            wf, compression="")
    params, states = trainer.pull_params()
    trainer.shutdown()
    return {"params": [to_jax_layout(layer) for layer in params],
            "states": solver_state_to_jax(states),
            "roles": list(trainer.roles),
            "losses": [e["train"]["losses"] for e in wf.decision.epoch_history]}
