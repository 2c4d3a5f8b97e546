"""veles_tpu_torch: the PyTorch/CUDA port of ``veles_tpu``.

A second package beside the JAX one, laid out like it (``nn/``,
``ops/``, ``models/``, ``serving/``, ``train/``, ``loader/``). It
imports ``torch``, numpy and the standard library only -- never JAX,
and nothing of ``veles_tpu`` -- save ``scipy.ndimage``, which
``datasets.golden_digits`` draws its digits with, as the JAX package's
``datasets.py`` does.

Every kernel the JAX package wrote in Pallas for the TPU becomes a
hand-written CUDA kernel for Hopper under ``csrc/``, with a plain
PyTorch version beside it that runs on CPU tensors.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no device and no card they raise.

It serves AlexNet-227 and the sequence models
(``serving.model_store.ServeableModel`` ->
``serving.frontend.ServingFrontend``) and trains them, the BASELINE
family -- MNIST fully connected and conv, CIFAR-quick, the MNIST
autoencoder -- and the wine, lines and kanji samples (``models/``,
``models.build.build_training`` -> ``train.step.FusedTrainer``), and the
Kohonen SOM (``train.som``), with every fully-connected hidden layer and
attention projection on ``ops.gemm.linear_act``
(``csrc/gemm_bias_act.cu``) and every bias gradient on
``ops.reduce.column_sum`` (``csrc/column_reduce.cu``). The sequence
models' attention core and mixture of experts (``parallel/``) run on
PyTorch's products, as the JAX package leaves them to XLA.

:func:`run` is the programmatic entry, ``veles_tpu.run``'s: a workflow
class (or any factory of one) built under a ``launcher.Launcher``,
initialized and run as ``python -m veles_tpu_torch`` runs it.
"""


def run(workflow_factory, config_update=None, snapshot=None, **kwargs):
    """Build, initialize and run a workflow standalone; returns it.

    ``config_update`` (a nested dict) is merged into ``config.root``
    first. The keywords that ``launcher.KWARGS`` names (``backend``,
    ``device``, ``eager``, ...) go to the ``Launcher``, the rest to
    ``workflow_factory(launcher, **rest)``. With ``snapshot`` (a path
    or URI of ``SnapshotterToFile.import_``) the workflow is the
    snapshot's, re-parented to the launcher, and the factory is not
    called. The launcher and the snapshotter are imported here, not
    with the package."""
    from veles_tpu_torch.config import root
    from veles_tpu_torch.launcher import KWARGS, Launcher

    if config_update:
        root.update(config_update)
    launcher = Launcher(**{k: v for k, v in kwargs.items() if k in KWARGS})
    wf_kwargs = {k: v for k, v in kwargs.items() if k not in KWARGS}
    if snapshot is not None:
        from veles_tpu_torch.snapshotter import SnapshotterToFile
        workflow = SnapshotterToFile.import_(snapshot)
        workflow.workflow = launcher
    else:
        workflow = workflow_factory(launcher, **wf_kwargs)
    launcher.initialize()
    launcher.run()
    return workflow

