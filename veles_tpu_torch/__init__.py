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
"""
