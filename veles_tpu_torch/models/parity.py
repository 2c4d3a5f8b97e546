"""The accuracy-parity recipes of the JAX package
(``veles_tpu/models/parity.py``), as constants.

:data:`CONV_LAYERS` is the conv topology of BASELINE config 2's MNIST
analog; the ``*_TRAINING`` dicts are the hyper-parameters of the JAX
harness functions (``train_fc``, ``train_conv``, ``train_ae``; its
``train_cifar`` trains at ``models.cifar.CIFAR_TRAINING``), the keyword
arguments of ``models.build.build_training``; ``PARITY_MINIBATCH`` is
their minibatch size. The harness functions themselves are not
ported.
"""

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
