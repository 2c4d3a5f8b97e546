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


def model_cost(model):
    """Analytic cost of ONE sample through ``model``, the cost book's
    source (``telemetry/profiler.py``):

    * ``forward_flops``: ``bench.py``'s accounting of the forward --
      2 x the multiply-adds of the convolutions, the fully-connected
      layers, the attention layers (4 projections, the scores and their
      product with the values) and the mixture of experts (one expert's
      up and down per token, and the router); LRN, pooling, dropout,
      activations and deconvolutions count nothing;
    * ``train_flops``: 3 x ``forward_flops`` (forward, data gradient,
      weight gradient), ``bench.py``'s ``model_train_flops_per_sample``;
    * ``param_bytes``: every parameter's bytes, once;
    * ``input_bytes`` and ``activation_bytes``: the sample's input and
      the sum of every layer's output, at the policy's compute type.
    """
    total = 0.0
    for module in model:
        if isinstance(module, Conv):
            cout, cin, ky, kx = module.weights.shape
            h, w, _ = module.output_shape()
            total += 2.0 * h * w * ky * kx * cin * cout
        elif isinstance(module, All2All):
            fin, fout = module.jax_weights_shape()
            total += 2.0 * fin * fout
        elif isinstance(module, MultiHeadAttentionForward):
            s, d = module.input_shape
            total += 4 * 2.0 * s * d * d + 2 * 2.0 * s * s * d
        elif isinstance(module, MoEForward):
            s, d = module.input_shape
            total += s * (2.0 * d * module.hidden * 2 +
                          2.0 * d * module.n_experts)
    size = model[0].policy.compute_dtype.itemsize
    return {"forward_flops": total, "train_flops": 3.0 * total,
            "param_bytes": float(sum(p.numel() * p.element_size()
                                     for p in model.parameters())),
            "input_bytes": float(numpy.prod(model[0].input_shape)) * size,
            "activation_bytes": float(sum(
                numpy.prod(m.output_shape()) for m in model)) * size}


def forward_cost(cost, rows):
    """(FLOPs, bytes) of one forward of ``rows`` samples given
    :func:`model_cost`'s ``cost``: the parameters read once, each
    sample's input read once and each layer's output written once and
    read once."""
    return (cost["forward_flops"] * rows,
            cost["param_bytes"] + rows * (cost["input_bytes"] +
                                          2.0 * cost["activation_bytes"]))


def sweep_cost(cost, samples, batches, train):
    """(FLOPs, bytes) of one class sweep of ``samples`` samples in
    ``batches`` minibatches: training counts :func:`model_cost`'s
    ``train_flops`` a sample and, a minibatch, the parameters read and
    written; evaluation the forward's. Each sample's input is read once
    and each activation written once and read once (the backward's
    read, or the next layer's)."""
    flops = cost["train_flops" if train else "forward_flops"] * samples
    return (flops, batches * cost["param_bytes"] * (2.0 if train else 1.0) +
            samples * (cost["input_bytes"] + 2.0 * cost["activation_bytes"]))


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
