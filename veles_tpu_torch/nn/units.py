"""The units of a training workflow: forward, gradient and evaluator
units (``veles_tpu/nn/base.py``, ``nn/gd.py``, ``nn/evaluator.py`` and
the forward units' modules).

A forward unit wraps one of the port's layer modules (``nn/*.py``): it
keeps the descriptor's parameters and builds the module at
``initialize()``, from the per-sample shape of its ``input`` (the
previous unit's ``output``, or the loader's ``minibatch_data``). The
classes carry the JAX units' names (``All2AllTanh``, ``ConvStrictRELU``,
...). Weights are drawn from the ``prng`` registry at that moment, in
unit order, as the JAX units' ``fill_weights`` draws them, so the same
seeds give the JAX workflow's initial weights bit for bit. ``weights``
and ``bias`` are the module's parameters themselves.

A gradient unit holds its layer's solver hyper-parameters (``hyper``,
the JAX unit's) and its slice of the solver state (``opt_state``). The
evaluator units carry the JAX units' summary state (``loss``,
``n_err``, ``confusion_matrix``, ``rmse``, ``testing``) and
``get_metric_values``. ``FusedRunner`` drives all of them; none has an
eager ``run()`` yet.

``input``, ``output``, ``err_output`` and ``err_input`` are tensors on
the ``meta`` device: the shapes of the minibatch each link carries.

In a snapshot a forward unit keeps its parameters and a gradient unit
its solver state as numpy arrays in the JAX package's layout
(``convert.to_jax_layout``, ``convert.solver_state_to_jax``); both go
back onto the device that ``initialize()`` is given. A JAX snapshot's
units arrive the same way (``jax_snapshot.py``).
"""

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import (layer_params, params_from_jax,
                                     solver_state_from_jax,
                                     solver_state_to_jax, to_jax_layout)
from veles_tpu_torch.nn import (activation, all2all, attention, conv,
                                dropout, moe, normalization, pooling)
from veles_tpu_torch.nn.base import WeightedBase
from veles_tpu_torch.nn.optim import get_solver
from veles_tpu_torch.result_provider import IResultProvider

#: descriptor keys the workflow reads for training, never the module
_TRAINING_KEYS = ("learning_rate", "learning_rate_bias", "weights_decay",
                  "momentum")


def _meta(shape, dtype=torch.float32):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


class ForwardBase(AcceleratedUnit):
    """A forward unit: ``LAYER`` (a module class of the port) built from
    the descriptor's parameters at ``initialize()``."""

    hide_from_registry = True
    view_group = "WORKER"
    # weight filling advances the "default" stream: the unit keeps what
    # it drew, as the JAX units do
    consumes_global_rng_on_init = True
    LAYER = None
    INCLUDE_BIAS = True

    def __init__(self, workflow, **kwargs):
        self.include_bias = kwargs.pop("include_bias", self.INCLUDE_BIAS)
        self.weights_stddev = kwargs.pop("weights_stddev", None)
        self.bias_stddev = kwargs.pop("bias_stddev", None)
        self.weights_filling = kwargs.pop("weights_filling", "uniform")
        self.bias_filling = kwargs.pop("bias_filling", "uniform")
        self.rand_name = kwargs.pop("rand", "default")
        unit_kwargs = {k: kwargs.pop(k) for k in ("name", "view_group",
                                                  "timings")
                       if k in kwargs}
        super(ForwardBase, self).__init__(workflow, **unit_kwargs)
        for key in _TRAINING_KEYS:
            kwargs.pop(key, None)
        if "output_shape" in kwargs:
            kwargs["output_sample_shape"] = kwargs.pop("output_shape")
        #: the module's constructor parameters (the descriptor's)
        self.layer_kwargs = kwargs
        self.input = None
        self.output = None
        self.demand("input")

    def init_unpickled(self):
        super(ForwardBase, self).init_unpickled()
        self.module_ = None
        self._built_for_ = None

    @property
    def module(self):
        """The layer module (built at ``initialize()``)."""
        return self.module_

    @property
    def has_weights(self):
        return issubclass(self.LAYER, WeightedBase)

    @property
    def weights(self):
        return None if self.module_ is None else \
            getattr(self.module_, "weights", None)

    @property
    def bias(self):
        return None if self.module_ is None else \
            getattr(self.module_, "bias", None)

    @property
    def input_shape(self):
        """The per-sample input shape."""
        return tuple(self.input.shape[1:])

    def initialize(self, device=None, **kwargs):
        super(ForwardBase, self).initialize(device=device, **kwargs)
        shape = self.input_shape
        module = self.module_
        if self._built_for_ != (shape, self.device):
            # the parameters: a snapshot's, the module's on another
            # device, or else drawn
            params = self.__dict__.pop("_params", None)
            if params is None and module is not None and self.has_weights:
                params = to_jax_layout(layer_params(module))
            self.module_ = module = self._build(shape)
            self._built_for_ = (shape, self.device)
            if self.has_weights:
                if params is None:
                    params = self.fill_weights()
                params_from_jax([module], [params])
        self.output = _meta((self.input.shape[0],) +
                            tuple(module.output_shape()))

    def _build(self, shape):
        kwargs = dict(self.layer_kwargs, policy=root.common.engine.get(
            "precision_type", "float32"))
        if self.has_weights:
            kwargs.update(device=self.device, trainable=True,
                          include_bias=self.include_bias)
        return self.LAYER(shape, **kwargs)

    def fill_weights(self):
        """The JAX units' filler (``veles_tpu/nn/base.py``
        ``fill_weights``) from the unit's stream: weights U(-s, s) (or
        N(0, s) with ``weights_filling="gaussian"``) with s the
        ``weights_stddev`` or 1/sqrt(fan_in), then the bias the same way
        over ``bias_stddev`` or s (``constant`` sets it to that value).
        Returns the parameters in the JAX layout."""
        rng = prng.get(self.rand_name)
        module = self.module_
        if self.weights_stddev is None and self.bias_stddev is None and \
                self.weights_filling == "uniform" and \
                self.bias_filling == "uniform":
            return module.init_jax_params(rng)
        if module.EXTRA_PARAMS:
            raise NotImplementedError(
                "%s: the filler options apply to weights and bias only"
                % self.name)
        shape = module.jax_weights_shape()
        fan_in = int(numpy.prod(shape[:-1])) if len(shape) > 1 \
            else shape[0]
        stddev = self.weights_stddev or 1.0 / numpy.sqrt(max(fan_in, 1))
        if self.weights_filling == "gaussian":
            weights = rng.normal(0.0, stddev, shape)
        else:
            weights = rng.uniform(-stddev, stddev, shape)
        params = {"weights": weights.astype(numpy.float32)}
        if self.include_bias:
            bshape = tuple(module.bias_shape())
            bstd = self.bias_stddev or stddev
            if self.bias_filling == "gaussian":
                bias = rng.normal(0.0, bstd, bshape)
            elif self.bias_filling == "constant":
                bias = numpy.full(bshape, bstd)
            else:
                bias = rng.uniform(-bstd, bstd, bshape)
            params["bias"] = bias.astype(numpy.float32)
        return params

    def __getstate__(self):
        state = super(ForwardBase, self).__getstate__()
        if self.module_ is not None and self.has_weights:
            state["_params"] = to_jax_layout(layer_params(self.module_))
        return state


def _forward_class(name, layer, include_bias=True, doc=None):
    return type(name, (ForwardBase,), {
        "LAYER": layer, "INCLUDE_BIAS": include_bias,
        "hide_from_registry": False, "__module__": __name__,
        "__doc__": doc or "The unit of ``nn.%s.%s``." % (
            layer.__module__.rsplit(".", 1)[-1], layer.__name__)})


All2All = _forward_class("All2All", all2all.All2All)
All2AllTanh = _forward_class("All2AllTanh", all2all.All2AllTanh)
All2AllRELU = _forward_class("All2AllRELU", all2all.All2AllRELU)
All2AllStrictRELU = _forward_class("All2AllStrictRELU",
                                   all2all.All2AllStrictRELU)
All2AllSigmoid = _forward_class("All2AllSigmoid", all2all.All2AllSigmoid)
All2AllSoftmax = _forward_class("All2AllSoftmax", all2all.All2AllSoftmax)
Conv = _forward_class("Conv", conv.Conv)
ConvTanh = _forward_class("ConvTanh", conv.ConvTanh)
ConvRELU = _forward_class("ConvRELU", conv.ConvRELU)
ConvStrictRELU = _forward_class("ConvStrictRELU", conv.ConvStrictRELU)
ConvSigmoid = _forward_class("ConvSigmoid", conv.ConvSigmoid)
Deconv = _forward_class("Deconv", conv.Deconv, include_bias=False)
MaxPooling = _forward_class("MaxPooling", pooling.MaxPooling)
MaxAbsPooling = _forward_class("MaxAbsPooling", pooling.MaxAbsPooling)
AvgPooling = _forward_class("AvgPooling", pooling.AvgPooling)
Depooling = _forward_class("Depooling", pooling.Depooling)
LRNormalizerForward = _forward_class("LRNormalizerForward",
                                     normalization.LRNormalizerForward)
ActivationUnit = _forward_class("ActivationUnit",
                                activation.ActivationUnit)
MultiHeadAttentionForward = _forward_class(
    "MultiHeadAttentionForward", attention.MultiHeadAttentionForward)
MoEForward = _forward_class("MoEForward", moe.MoEForward)


class DropoutForward(ForwardBase):
    """The unit of ``nn.dropout.DropoutForward``: identity when
    ``testing``; its masks are drawn from the unit's stream
    (``rand_name``)."""

    hide_from_registry = False
    LAYER = dropout.DropoutForward
    INCLUDE_BIAS = False

    def __init__(self, workflow, **kwargs):
        super(DropoutForward, self).__init__(workflow, **kwargs)
        self.testing = False

    def _build(self, shape):
        return self.LAYER(shape, rand=self.rand_name, **dict(
            self.layer_kwargs, policy=root.common.engine.get(
                "precision_type", "float32")))


class GradientDescentBase(AcceleratedUnit):
    """The gradient unit of one forward unit: its solver (by name), its
    hyper-parameters and its solver state."""

    hide_from_registry = True
    view_group = "TRAINER"

    def __init__(self, workflow, forward=None, **kwargs):
        self.learning_rate = kwargs.pop("learning_rate", 0.01)
        self.learning_rate_bias = kwargs.pop("learning_rate_bias", None)
        self.weights_decay = kwargs.pop("weights_decay", 0.0)
        self.gradient_moment = kwargs.pop("momentum",
                                          kwargs.pop("gradient_moment",
                                                     0.0))
        self.solver_name = kwargs.pop("solver", "sgd")
        self._solver_hp = dict(kwargs.pop("solver_hp", {}))
        self.need_err_input = kwargs.pop("need_err_input", True)
        super(GradientDescentBase, self).__init__(workflow, **kwargs)
        self.forward = forward
        self.err_output = None
        self.err_input = None
        self.opt_state = None
        self.demand("err_output")

    @property
    def hyper(self):
        hp = {"learning_rate": self.learning_rate,
              "weight_decay": self.weights_decay,
              "momentum": self.gradient_moment}
        if self.learning_rate_bias is not None:
            hp["lr_overrides"] = {"bias": self.learning_rate_bias}
        hp.update(self._solver_hp)
        return hp

    def initialize(self, device=None, **kwargs):
        if self.forward is None:
            raise ValueError("%s needs its paired forward unit" % self.name)
        super(GradientDescentBase, self).initialize(device=device, **kwargs)
        if self.need_err_input:
            self.err_input = _meta(self.forward.input.shape)
        module = self.forward.module
        params = layer_params(module)
        saved = self.__dict__.pop("_solver_state", None)
        if not params:
            self.opt_state = None
        elif saved is not None:
            self.opt_state = solver_state_from_jax([module], [saved])[0]
        elif self.opt_state is None:
            self.opt_state = get_solver(self.solver_name).init(params)
        else:
            self.opt_state = _to_device(self.opt_state, self.device)

    def __getstate__(self):
        state = super(GradientDescentBase, self).__getstate__()
        state["opt_state"] = None
        if self.opt_state:
            state["_solver_state"] = solver_state_to_jax(
                [self.opt_state])[0]
        return state


def _to_device(state, device):
    if isinstance(state, dict):
        return {k: _to_device(v, device) for k, v in state.items()}
    return state.to(device)


def _gd_class(name, doc):
    return type(name, (GradientDescentBase,), {
        "hide_from_registry": False, "__module__": __name__,
        "__doc__": doc})


GradientDescent = _gd_class("GradientDescent", "For All2All (linear).")
GDTanh = _gd_class("GDTanh", "For All2AllTanh.")
GDRELU = _gd_class("GDRELU", "For All2AllRELU.")
GDStrictRELU = _gd_class("GDStrictRELU", "For All2AllStrictRELU.")
GDSigmoid = _gd_class("GDSigmoid", "For All2AllSigmoid.")
GDSoftmax = _gd_class("GDSoftmax", "For the softmax head (its "
                      "err_output is the gradient of the logits).")
GDConv = _gd_class("GDConv", "For the convolutions.")
GDPooling = _gd_class("GDPooling", "For the poolings (no parameters).")
GDActivation = _gd_class("GDActivation", "For ActivationUnit.")
DropoutBackward = _gd_class("DropoutBackward", "For DropoutForward "
                            "(the mask, no parameters).")


class EvaluatorBase(AcceleratedUnit, IResultProvider):
    """Loss head: its ``output`` is linked from the head forward unit;
    ``err_output`` seeds the gradient chain."""

    hide_from_registry = True
    view_group = "EVALUATOR"

    def __init__(self, workflow, **kwargs):
        self.testing = kwargs.pop("testing", False)
        super(EvaluatorBase, self).__init__(workflow, **kwargs)
        self.output = None
        self.err_output = None
        self.batch_size = None
        self.demand("output")

    def initialize(self, device=None, **kwargs):
        super(EvaluatorBase, self).initialize(device=device, **kwargs)
        self.err_output = _meta(self.output.shape)


class EvaluatorSoftmax(EvaluatorBase):
    """Cross-entropy over a softmax head: the last minibatch's ``loss``
    and ``n_err``, and the ``confusion_matrix`` of the last evaluation
    sweep."""

    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        self.compute_confusion = kwargs.pop("compute_confusion", True)
        super(EvaluatorSoftmax, self).__init__(workflow, **kwargs)
        self.labels = None
        self.n_err = 0
        self.loss = 0.0
        self.max_err_output_sum = 0.0
        self.confusion_matrix = None
        self.demand("labels")

    def get_metric_values(self):
        return {"n_err": self.n_err, "loss": self.loss}


class EvaluatorMSE(EvaluatorBase):
    """Mean squared error head (autoencoders, regression): the last
    minibatch's ``rmse``."""

    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        super(EvaluatorMSE, self).__init__(workflow, **kwargs)
        self.target = None
        self.indices = None
        self.rmse = 0.0
        self.mse_per_sample = None
        self.demand("target")

    def get_metric_values(self):
        return {"rmse": self.rmse}
