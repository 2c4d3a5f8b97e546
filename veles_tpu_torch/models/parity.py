"""The accuracy-parity harness (``veles_tpu/models/parity.py``).

One source of the FC, conv, autoencoder, SOM and CIFAR parity recipes:
:func:`train_fc`, :func:`train_conv`, :func:`train_ae`, :func:`train_som`
and :func:`train_cifar` seed the weights' stream with 1234 and the
loader's with 1235, build the JAX package's workflow for the recipe on
``device`` (the card unless the caller passes ``"cpu"``) and train it
through ``train.runner.trainer_for`` (the SOM through its own
``KohonenWorkflow`` loop), returning the best validation error, RMSE or
the SOM's quality.

:data:`CONV_LAYERS` is the conv topology of BASELINE config 2's MNIST
analog; the ``*_TRAINING`` dicts are the harness's hyper-parameters, also
the keyword arguments of ``models.build.build_training`` for the same
recipes (``train_cifar`` trains at ``models.cifar.CIFAR_TRAINING``);
``PARITY_MINIBATCH`` is their minibatch size.
"""

import math

from veles_tpu_torch import prng
from veles_tpu_torch.dummy import DummyLauncher

CONV_LAYERS = [
    {"type": "conv_relu", "n_kernels": 16, "kx": 5, "ky": 5},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "conv_relu", "n_kernels": 32, "kx": 5, "ky": 5},
    {"type": "max_pooling", "kx": 2, "ky": 2},
    {"type": "all2all_relu", "output_sample_shape": 100},
    {"type": "softmax", "output_sample_shape": 10},
]

PARITY_MINIBATCH = 100
#: ``train_fc``: 784-100-10, momentum 0.9 with the rate scaled down
FC_TRAINING = {"learning_rate": 0.04, "weights_decay": 0.0,
               "momentum": 0.9, "lr_decay": 1.0}
#: ``train_conv``: :data:`CONV_LAYERS` on 28x28x1
CONV_TRAINING = {"learning_rate": 0.03}
#: ``train_ae``: the 784-100-784 autoencoder under MSE
AE_TRAINING = {"learning_rate": 0.001, "momentum": 0.9}


def best_val(history):
    """The least validation ``normalized`` metric of a history."""
    return min(h["validation"]["normalized"] for h in history)


def _seed():
    prng.get().seed(1234)
    prng.get("loader").seed(1235)


def _trained(wf, device):
    """Initialize ``wf`` on ``device`` and train it fused to its
    decision's stop; the history."""
    from veles_tpu_torch.train.runner import trainer_for
    wf.initialize(device=device)
    trainer = trainer_for(wf)
    try:
        return trainer.train(max_epochs=wf.decision.max_epochs,
                             fail_iterations=wf.decision.fail_iterations)
    finally:
        trainer.shutdown()


def train_fc(provider, max_epochs, learning_rate=0.04, weights_decay=0.0,
             momentum=0.9, lr_decay=1.0, device=None):
    """784-100-10 (BASELINE config 1) in minibatches of 100; the best
    validation error."""
    from veles_tpu_torch.models.mnist import MnistWorkflow
    _seed()
    wf = MnistWorkflow(DummyLauncher(), provider=provider, layers=(100,),
                       minibatch_size=PARITY_MINIBATCH,
                       learning_rate=learning_rate,
                       weights_decay=weights_decay, momentum=momentum,
                       lr_decay=lr_decay, max_epochs=max_epochs)
    return best_val(_trained(wf, device))


def train_conv(provider, max_epochs, learning_rate=0.03, layers=None,
               device=None):
    """The conv stack (:data:`CONV_LAYERS` unless ``layers``) on 28x28
    NHWC digits; the best validation error."""
    from veles_tpu_torch.models.mnist import MnistLoader
    from veles_tpu_torch.standard_workflow import StandardWorkflow
    _seed()
    wf = StandardWorkflow(
        DummyLauncher(),
        loader=lambda w: MnistLoader(workflow=w, provider=provider,
                                     flatten=False,
                                     minibatch_size=PARITY_MINIBATCH),
        layers=layers if layers is not None else CONV_LAYERS,
        loss="softmax", learning_rate=learning_rate, max_epochs=max_epochs)
    return best_val(_trained(wf, device))


def train_ae(provider, max_epochs, bottleneck=100, learning_rate=0.001,
             momentum=0.9, minibatch_size=PARITY_MINIBATCH, device=None):
    """The MNIST autoencoder (BASELINE config 4's first half); the best
    validation RMSE, the square root of the least mean per-sample MSE on
    ``linear``-normalized inputs."""
    from veles_tpu_torch.models.mnist_ae import MnistAEWorkflow
    _seed()
    wf = MnistAEWorkflow(DummyLauncher(), provider=provider,
                         bottleneck=bottleneck,
                         minibatch_size=minibatch_size,
                         learning_rate=learning_rate, momentum=momentum,
                         max_epochs=max_epochs)
    return math.sqrt(best_val(_trained(wf, device)))


def train_som(provider, epochs, sx=8, sy=8, minibatch_size=100,
              device=None):
    """The Kohonen SOM (BASELINE config 4's second half) after ``epochs``
    sweeps of ``KohonenWorkflow``'s loop: ``nn.kohonen.som_quality`` on
    the TRAIN samples, with the untrained codebook's quantization and
    topographic errors beside it."""
    from veles_tpu_torch.models.mnist import MnistLoader
    from veles_tpu_torch.models.mnist_ae import KohonenWorkflow
    from veles_tpu_torch.nn.kohonen import som_quality
    _seed()
    wf = KohonenWorkflow(
        DummyLauncher(),
        loader_factory=lambda w: MnistLoader(
            workflow=w, provider=provider, minibatch_size=minibatch_size),
        sx=sx, sy=sy, epochs=epochs)
    wf.initialize(device=device)
    # the TRAIN class: the loader lays its data out [valid, train]
    data = wf.loader.original_data[wf.loader.class_lengths[1]:]
    untrained = som_quality(wf.trainer.weights, sx, sy, data)
    wf.run()
    trained = som_quality(wf.trainer.weights, sx, sy, data)
    trained["untrained_quantization_error"] = \
        untrained["quantization_error"]
    trained["untrained_topographic_error"] = untrained["topographic_error"]
    return trained


def train_cifar(provider, max_epochs, learning_rate=0.01, device=None):
    """The CIFAR-quick stack (BASELINE config 2) over ``mean_disp``
    inputs, ``CifarWorkflow``'s defaults otherwise; the best validation
    error."""
    from veles_tpu_torch.models.cifar import CifarWorkflow
    _seed()
    wf = CifarWorkflow(DummyLauncher(), provider=provider,
                       learning_rate=learning_rate, max_epochs=max_epochs)
    return best_val(_trained(wf, device))
