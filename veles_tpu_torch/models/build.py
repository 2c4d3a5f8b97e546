"""Layer descriptors -> ``nn.Sequential``, and the training set-up.

The port of ``veles_tpu/standard_workflow.py``'s descriptor map
(``LAYER_TYPES``): each ``{"type": <name>, ...params}`` becomes one
module, with its per-sample input shape carried over from the previous
layer's output. Every layer type of the JAX package is here, the
sequence models' ``attention`` and ``moe`` (on (seq, dim) samples)
included. :func:`build_model` ignores the training keys of a
descriptor (``learning_rate``, ``learning_rate_bias``, ``weights_decay``,
``momentum``, ``name``); :func:`build_training` reads them, as
``StandardWorkflow`` and its GD units do (``veles_tpu/nn/gd.py``): a
layer's own value, else the workflow-level default.
"""

import numpy
from torch import nn

from veles_tpu_torch.convert import params_from_jax
from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.nn.activation import ActivationUnit
from veles_tpu_torch.nn.attention import MultiHeadAttentionForward
from veles_tpu_torch.nn.all2all import (All2All, All2AllRELU,
                                        All2AllSigmoid, All2AllSoftmax,
                                        All2AllStrictRELU, All2AllTanh)
from veles_tpu_torch.nn.base import WeightedBase
from veles_tpu_torch.nn.conv import (Conv, ConvRELU, ConvSigmoid,
                                     ConvStrictRELU, ConvTanh, Deconv)
from veles_tpu_torch.nn.dropout import DropoutForward
from veles_tpu_torch.nn.moe import MoEForward
from veles_tpu_torch.nn.normalization import LRNormalizerForward
from veles_tpu_torch.nn.pooling import (AvgPooling, Depooling,
                                        MaxAbsPooling, MaxPooling)
from veles_tpu_torch.nn.precision import get_policy

#: descriptor type -> module class (the JAX package's names)
LAYER_TYPES = {
    "all2all": All2All,
    "all2all_tanh": All2AllTanh,
    "all2all_relu": All2AllRELU,
    "all2all_str": All2AllStrictRELU,
    "all2all_sigmoid": All2AllSigmoid,
    "softmax": All2AllSoftmax,
    "conv": Conv,
    "conv_tanh": ConvTanh,
    "conv_relu": ConvRELU,
    "conv_str": ConvStrictRELU,
    "conv_sigmoid": ConvSigmoid,
    "deconv": Deconv,
    "max_pooling": MaxPooling,
    "maxabs_pooling": MaxAbsPooling,
    "avg_pooling": AvgPooling,
    "depooling": Depooling,
    "norm": LRNormalizerForward,
    "dropout": DropoutForward,
    "activation": ActivationUnit,
    "attention": MultiHeadAttentionForward,
    "moe": MoEForward,
}

_TRAINING_KEYS = ("learning_rate", "learning_rate_bias", "weights_decay",
                  "momentum", "name")


def build_model(layers, sample_shape, params=None, seed=None,
                policy="float32", device=None, trainable=False):
    """An ``nn.Sequential`` of the port's modules for ``layers``.

    ``sample_shape`` is the per-sample input shape (NHWC without the
    batch axis, (seq, dim) for a sequence model). Weights come from
    ``params`` (the JAX package's per-layer ``{"weights", "bias"}``
    numpy dicts, with ``up`` and ``down`` for a ``moe`` layer, see
    :func:`veles_tpu_torch.convert.params_from_jax`) or, without them,
    are drawn from ``numpy.random.RandomState(seed)`` with the JAX
    package's filler contract. ``device`` defaults to ``cuda`` and
    raises when there is none; tests pass ``device="cpu"``.
    ``trainable`` makes the parameters require gradients."""
    device = resolve_device(device)
    pol = get_policy(policy)
    pol.configure_backends()
    modules = []
    shape = tuple(sample_shape)
    for descr in layers:
        descr = dict(descr)
        ltype = descr.pop("type")
        cls = LAYER_TYPES.get(ltype)
        if cls is None:
            raise ValueError("unknown layer type %r (have %s)"
                             % (ltype, sorted(LAYER_TYPES)))
        for key in _TRAINING_KEYS:
            descr.pop(key, None)
        if "output_shape" in descr:
            descr["output_sample_shape"] = descr.pop("output_shape")
        kwargs = dict(descr, policy=pol)
        if issubclass(cls, WeightedBase):
            kwargs["device"] = device
            kwargs["trainable"] = trainable
        module = cls(shape, **kwargs)
        modules.append(module)
        shape = tuple(module.output_shape())
        if min(shape) <= 0:
            raise ValueError("layer %d (%s) leaves no output: %s" % (
                len(modules) - 1, ltype, shape))
    model = nn.Sequential(*modules)
    if params is None:
        rng = numpy.random.RandomState(seed)
        params = [m.init_jax_params(rng) if m.has_weights else {}
                  for m in modules]
    params_from_jax(model, params)
    return model


def plain_forward(model, x):
    """``model(x)`` with every kernel replaced by its plain PyTorch
    version: the reference the kernels are held against on the card."""
    for module in model:
        x = module.plain_forward(x)
    return x


def layer_hypers(layers, learning_rate=0.01, weights_decay=0.0,
                 momentum=0.0, lr_decay=1.0, learning_rate_bias=None):
    """Per-layer solver hyper-parameters, the JAX GD units' ``hyper``:
    ``learning_rate``, ``weight_decay`` and ``momentum`` from the
    descriptor or the defaults, for every parameter of the layer (a
    ``moe`` layer's ``up`` and ``down`` too), ``lr_overrides = {"bias":
    ...}`` where a ``learning_rate_bias`` applies, ``lr_decay`` where it
    is not 1."""
    hypers = []
    for descr in layers:
        hp = {"learning_rate": descr.get("learning_rate", learning_rate),
              "weight_decay": descr.get("weights_decay", weights_decay),
              "momentum": descr.get("momentum", momentum)}
        bias_lr = descr.get("learning_rate_bias", learning_rate_bias)
        if bias_lr is not None:
            hp["lr_overrides"] = {"bias": bias_lr}
        if lr_decay != 1.0:
            hp["lr_decay"] = lr_decay
        hypers.append(hp)
    return hypers


def build_training(layers, sample_shape, loader, learning_rate=0.01,
                   weights_decay=0.0, momentum=0.0, lr_decay=1.0,
                   learning_rate_bias=None, solver="sgd", loss="softmax",
                   params=None, seed=None, policy="float32", device=None,
                   uniform_source=None, **residency):
    """A :class:`veles_tpu_torch.train.step.FusedTrainer` for ``layers``
    over ``loader`` (initialized here, its dataset staged on the
    device once): the model built trainable from ``params`` or
    ``seed`` (see :func:`build_model`), with per-layer hyper-parameters
    from :func:`layer_hypers`. ``solver`` is a rule of ``nn/optim.py``
    by name or class; ``loss`` is ``softmax`` (the loader's labels) or
    ``mse`` (the targets of a ``FullBatchLoaderMSE``). ``device``
    defaults to the card; ``uniform_source`` replaces the dropout masks'
    Philox fill (see the trainer). ``residency`` holds the trainer's
    ``stream``, ``prefetch_depth``, ``prefetch_workers``, ``offload``,
    ``offload_depth`` and ``offload_workers``; with ``offload=True`` the
    model is built on the host, where its state stays."""
    from veles_tpu_torch.train.step import FusedTrainer
    device = resolve_device(device)
    model = build_model(layers, sample_shape, params=params, seed=seed,
                        policy=policy, trainable=True,
                        device="cpu" if residency.get("offload") else device)
    hypers = layer_hypers(layers, learning_rate, weights_decay, momentum,
                          lr_decay, learning_rate_bias)
    return FusedTrainer(model, loader.initialize(), hypers, solver=solver,
                        loss=loss, uniform_source=uniform_source,
                        device=device, **residency)
