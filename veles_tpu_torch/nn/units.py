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
``get_metric_values``. ``FusedRunner`` drives all of them, or the eager
scheduler (``Workflow.run``) runs each one's ``compute()``, one
minibatch at a time:

* a forward unit runs its module on its ``input`` (the kernels on the
  card); on a training minibatch it keeps the graph of that call, its
  input a detached leaf, for its gradient unit, and the softmax head
  keeps its logits beside its probabilities (``apply_for_grad``);
* the evaluator differentiates the fused trainer's own loss
  (``nn/evaluator.py``) with respect to the softmax head's logits (the
  MSE head's output) into ``err_output``, so the eager chain and the
  fused step run the same backward functions on the same values;
* a gradient unit takes ``torch.autograd.grad`` of its forward's graph
  at ``err_output`` for the parameters (K6 in the bias gradients, K4
  through ``LRNFunction``) and, when the layer before needs it, the
  input (``err_input``), then updates the parameters and ``opt_state``
  with the solver of ``nn/optim.py``, the state dicts the fused
  trainer updates too;
* dropout draws its mask in the fused trainer's order (one seed an
  epoch, ``TrainableWorkflow.dropout_draw``; K7, or the workflow's
  ``uniform_source``) on training minibatches only, and
  :class:`DropoutBackward` multiplies by the stored mask.

Unlike the JAX package's eager dropout, which also masks evaluation
minibatches (its ``testing`` flag is set by ``--test`` alone), the
port's masks only training minibatches, as both fused trainers do.
A layer's auxiliary loss (the mixture of experts' load balance) is the
fused step's alone, as in the JAX package: the eager gradient unit
trains without it and says so once.

``input``, ``output``, ``err_output`` and ``err_input`` are tensors on
the ``meta`` device after ``initialize()``, the shapes of the minibatch
each link carries; an eager run puts real tensors there, and a snapshot
keeps only their shapes.

Master/slave (``veles_tpu/nn/gd.py``): a gradient unit on the master
sends its forward's parameters with every job; the slave copies them
into the parameter tensors in place (the solver state and the trainer
hold references to those tensors) and keeps a copy on the device as
the job's base; after the job it returns ``new - base``, an IEEE
float32 subtraction taken on the device before one copy to the host;
the master adds each delta to its host tensors. The round trip is
exact wherever the subtraction is (the weight moved by less than a
factor of 2, Sterbenz); elsewhere -- a weight shrinking toward zero --
``base + delta`` may round, and no float32 delta lands on ``new``. On
the wire parameters are float32 numpy arrays in the JAX package's
layout (HWIO convolutions), as in a snapshot.

In a snapshot a forward unit keeps its parameters and a gradient unit
its solver state as numpy arrays in the JAX package's layout
(``convert.to_jax_layout``, ``convert.solver_state_to_jax``); both go
back onto the device that ``initialize()`` is given. A JAX snapshot's
units arrive the same way (``jax_snapshot.py``).
"""

import warnings

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.accelerated_units import AcceleratedUnit
from veles_tpu_torch.convert import (layer_params, params_from_jax,
                                     solver_state_from_jax,
                                     solver_state_to_jax, to_jax_layout)
from veles_tpu_torch.mutable import link_source
from veles_tpu_torch.nn import (activation, all2all, attention, conv,
                                dropout, moe, normalization, pooling)
from veles_tpu_torch.nn.base import WeightedBase
from veles_tpu_torch.nn.evaluator import (batch_confusion,
                                          masked_difference,
                                          mse_loss_and_metrics, mse_rmse,
                                          softmax_loss_and_metrics)
from veles_tpu_torch.nn.optim import get_solver
from veles_tpu_torch.nn.precision import active_policy
from veles_tpu_torch.ops.random import dropout_uniforms
from veles_tpu_torch.result_provider import IResultProvider

#: descriptor keys the workflow reads for training, never the module
_TRAINING_KEYS = ("learning_rate", "learning_rate_bias", "weights_decay",
                  "momentum")


def _meta(shape, dtype=torch.float32):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def training_minibatch(unit):
    """Whether the minibatch in flight trains: the workflow's
    ``training_minibatch`` (a TRAIN minibatch outside ``--test``), True
    in a workflow that does not say."""
    flag = getattr(unit.workflow, "training_minibatch", None)
    return True if flag is None else bool(flag)


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
    SHAPE_ONLY_STATE = ("output",)

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
        #: whether the gradient unit wants ``err_input`` (its
        #: ``need_err_input``, set at its ``initialize()``)
        self.need_input_grad = True
        self.demand("input")

    def init_unpickled(self):
        super(ForwardBase, self).init_unpickled()
        self.module_ = None
        self._built_for_ = None
        #: (input leaf, differentiated output) of the last training
        #: minibatch's forward, until the gradient unit consumes it
        self.graph_ = None

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

    @property
    def policy(self):
        return self.module_.policy

    def compute(self):
        """The module on ``input``; on a training minibatch with the
        graph kept for the gradient unit."""
        if not training_minibatch(self):
            self.graph_ = None
            with torch.no_grad():
                self.output = self._differentiated(self.input)
            return
        leaf = self.input.detach().requires_grad_(self.need_input_grad)
        out = self._differentiated(leaf)
        self.graph_ = (leaf, out)
        self.output = out.detach()

    def _differentiated(self, x):
        """The function the gradient unit differentiates (the JAX unit's
        ``apply_for_grad``): the module's forward."""
        return self.module_(x)

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
        kwargs = dict(self.layer_kwargs, policy=active_policy())
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


def _forward_class(name, layer, include_bias=True, doc=None,
                   base=ForwardBase):
    return type(name, (base,), {
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


class All2AllSoftmax(ForwardBase):
    """The unit of ``nn.all2all.All2AllSoftmax``: ``output`` holds the
    probabilities and ``logits`` the logits they come from, the output
    its gradient unit differentiates."""

    hide_from_registry = False
    LAYER = all2all.All2AllSoftmax
    SHAPE_ONLY_STATE = ("output", "logits")

    def __init__(self, workflow, **kwargs):
        super(All2AllSoftmax, self).__init__(workflow, **kwargs)
        self.logits = None

    def compute(self):
        super(All2AllSoftmax, self).compute()
        self.logits = self.output
        self.output = self.module_.softmax(self.logits)

    def _differentiated(self, x):
        return self.module_.logits(x)

Conv = _forward_class("Conv", conv.Conv)
ConvTanh = _forward_class("ConvTanh", conv.ConvTanh)
ConvRELU = _forward_class("ConvRELU", conv.ConvRELU)
ConvStrictRELU = _forward_class("ConvStrictRELU", conv.ConvStrictRELU)
ConvSigmoid = _forward_class("ConvSigmoid", conv.ConvSigmoid)
Deconv = _forward_class("Deconv", conv.Deconv, include_bias=False)
#: the poolings' common unit, registered as the JAX package registers it
PoolingBase = _forward_class("PoolingBase", pooling.PoolingBase,
                             doc="The poolings' unit: a ``(ky, kx)`` "
                                 "window moved by ``sliding``.")
MaxPooling = _forward_class("MaxPooling", pooling.MaxPooling,
                            base=PoolingBase)
MaxAbsPooling = _forward_class("MaxAbsPooling", pooling.MaxAbsPooling,
                               base=PoolingBase)
AvgPooling = _forward_class("AvgPooling", pooling.AvgPooling,
                            base=PoolingBase)
Depooling = _forward_class("Depooling", pooling.Depooling,
                           base=PoolingBase)
LRNormalizerForward = _forward_class("LRNormalizerForward",
                                     normalization.LRNormalizerForward)
ActivationUnit = _forward_class("ActivationUnit",
                                activation.ActivationUnit)
MultiHeadAttentionForward = _forward_class(
    "MultiHeadAttentionForward", attention.MultiHeadAttentionForward)
MoEForward = _forward_class("MoEForward", moe.MoEForward, include_bias=False)


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

    def init_unpickled(self):
        super(DropoutForward, self).init_unpickled()
        #: the 0/1 mask of the last training minibatch, None otherwise
        self.mask_ = None

    def compute(self):
        """Identity off training minibatches; else the inverted-dropout
        mask of the uniforms the workflow's ``dropout_draw`` names, at
        this layer's index."""
        x = self.input.detach()
        if self.testing or not training_minibatch(self):
            self.mask_ = None
            self.output = x
            return
        workflow = self.workflow
        seed, batch = workflow.dropout_draw()
        u = dropout_uniforms(x.shape, seed, batch,
                             workflow.forwards.index(self), x.device,
                             workflow.uniform_source)
        module = self.module_
        self.mask_ = (u < 1.0 - module.dropout_ratio).to(x.dtype)
        self.output = module.train_forward(x, u)

    def _build(self, shape):
        return self.LAYER(shape, rand=self.rand_name, **dict(
            self.layer_kwargs, policy=active_policy()))


class GradientDescentBase(AcceleratedUnit):
    """The gradient unit of one forward unit: its solver (by name), its
    hyper-parameters and its solver state."""

    hide_from_registry = True
    view_group = "TRAINER"
    SHAPE_ONLY_STATE = ("err_input",)
    #: the eager step noted that it trains without the auxiliary loss
    _aux_noted = False

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
        self.forward.need_input_grad = self.need_err_input
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

    @property
    def policy(self):
        return self.forward.policy

    def compute(self):
        """The gradient of the forward's last training graph at
        ``err_output``: the parameters' (updated in place with the
        solver and ``opt_state``) and, with ``need_err_input``, the
        input's into ``err_input``."""
        forward = self.forward
        if forward.graph_ is None:
            raise RuntimeError("%s: %s kept no training graph" % (
                self.name, forward.name))
        if getattr(forward.module, "aux_loss_weight", 0.0) and \
                not self._aux_noted:
            # the JAX package adds the term to the fused loss only
            # (veles_tpu/nn/moe.py); its eager step trains without it
            self._aux_noted = True
            self.info("%s: the auxiliary loss of %s is added by the fused "
                      "step only; the eager step trains without it",
                      self.name, forward.name)
        leaf, out = forward.graph_
        forward.graph_ = None
        params = {k: p for k, p in layer_params(forward.module).items()
                  if p.requires_grad}
        inputs = list(params.values())
        if self.need_err_input:
            inputs.append(leaf)
        if not inputs or not out.requires_grad:
            return
        grads = torch.autograd.grad(out, inputs,
                                    grad_outputs=self.err_output)
        if self.need_err_input:
            self.err_input = grads[-1]
        if params:
            get_solver(self.solver_name).update(
                params, dict(zip(params, grads)), self.opt_state,
                self.hyper)

    # -- distribution: the master's weights go out with each job, the
    # slave's steps come back as a delta the master adds --------------------

    def generate_data_for_slave(self, slave=None):
        params = layer_params(self.forward.module)
        return {k: _wire_array(p, copy=True)
                for k, p in params.items()} or None

    def apply_data_from_master(self, data):
        params = layer_params(self.forward.module)
        base = {}
        with torch.no_grad():
            for k, value in (data or {}).items():
                target = params[k]
                target.copy_(_wire_tensor(value))
                base[k] = target.detach().clone()
        self._job_base_params_ = base

    def generate_data_for_master(self):
        base = getattr(self, "_job_base_params_", None) or {}
        with torch.no_grad():
            return {k: _wire_array(p - base[k] if k in base else p,
                                   copy=k not in base)
                    for k, p in layer_params(
                        self.forward.module).items()} or None

    def apply_data_from_slave(self, data, slave=None):
        params = layer_params(self.forward.module)
        with torch.no_grad():
            for k, delta in (data or {}).items():
                params[k].add_(_wire_tensor(delta))

    def __getstate__(self):
        state = super(GradientDescentBase, self).__getstate__()
        state["opt_state"] = None
        if self.opt_state:
            state["_solver_state"] = solver_state_to_jax(
                [self.opt_state])[0]
        return state


def _wire_array(tensor, copy):
    """A parameter (or delta) tensor as the float32 numpy array the wire
    carries, in the JAX layout; ``copy`` when the tensor is the host
    parameter itself (a job must not alias live weights)."""
    array = tensor.detach().float().cpu().numpy()
    if array.ndim == 4:                              # OIHW -> HWIO
        array = array.transpose(2, 3, 1, 0)
    return numpy.array(array, order="C") if copy else \
        numpy.ascontiguousarray(array)


def _wire_tensor(array):
    """Inverse of :func:`_wire_array`: a CPU tensor in the port's
    layout over the (possibly read-only) received array, uncopied."""
    array = numpy.asarray(array, numpy.float32)
    if array.ndim == 4:                              # HWIO -> OIHW
        array = array.transpose(3, 2, 0, 1)
    with warnings.catch_warnings():
        # decoded leaves are read-only views; they are only read here
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(array)


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
GDAttention = _gd_class("GDAttention", "For the attention block: autograd "
                        "through its projections and its attention core.")


class DropoutBackward(GradientDescentBase):
    """For DropoutForward: ``err_input = err_output / keep * mask``, the
    order of the fused step's backward through ``x * mask / keep``."""

    hide_from_registry = False

    def compute(self):
        forward = self.forward
        if forward.mask_ is None:
            self.err_input = self.err_output
        else:
            keep = 1.0 - forward.module.dropout_ratio
            self.err_input = self.err_output / keep * forward.mask_


class EvaluatorBase(AcceleratedUnit, IResultProvider):
    """Loss head: its ``output`` is linked from the head forward unit;
    ``err_output`` seeds the gradient chain.

    ``publish_output``: in testing mode only (one clean forward pass),
    each minibatch's output (and labels), pad rows trimmed, is recorded
    and published as ``Output`` (and ``Labels``) in the results."""

    hide_from_registry = True
    view_group = "EVALUATOR"
    SHAPE_ONLY_STATE = ("err_output",)

    def __init__(self, workflow, **kwargs):
        self.testing = kwargs.pop("testing", False)
        self.publish_output = kwargs.pop("publish_output", False)
        super(EvaluatorBase, self).__init__(workflow, **kwargs)
        self.output = None
        self.err_output = None
        self.batch_size = None
        self.recorded_outputs = []
        self.recorded_labels = []
        self.demand("output")

    def initialize(self, device=None, **kwargs):
        super(EvaluatorBase, self).initialize(device=device, **kwargs)
        self.recorded_outputs = []
        self.recorded_labels = []
        self.err_output = _meta(self.output.shape)

    def _loss(self, out, loss_fn, truth, valid):
        """(report_loss, metric) of ``loss_fn`` at ``out``, and its
        gradient with respect to ``out`` into ``err_output`` unless
        testing: the fused step's loss, differentiated alone."""
        train = not self.testing
        leaf = out.detach().requires_grad_(train)
        with torch.enable_grad():
            grad_loss, report, metric = loss_fn(leaf, truth, valid)
        if train:
            self.err_output = torch.autograd.grad(grad_loss, leaf)[0]
        return report, metric

    def _record(self, output, labels=None):
        if not (self.publish_output and self.testing):
            return
        output = output.detach().float().cpu().numpy()
        labels = None if labels is None else labels.cpu().numpy()
        # the short tail minibatch is padded at its end
        if self.batch_size is not None:
            n = int(self.batch_size)
        elif labels is not None:
            valid = numpy.flatnonzero(labels >= 0)
            n = int(valid[-1]) + 1 if len(valid) else 0
        else:
            n = len(output)
        self.recorded_outputs.append(output[:n])
        if labels is not None:
            self.recorded_labels.append(labels[:n])

    def _recorded_metrics(self):
        if not (self.publish_output and self.recorded_outputs):
            return {}
        out = {"Output": numpy.concatenate(self.recorded_outputs).tolist()}
        if self.recorded_labels:
            out["Labels"] = numpy.concatenate(
                self.recorded_labels).tolist()
        return out


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

    def compute(self):
        """Loss, error count, ``max_err_output_sum`` and this
        minibatch's confusion matrix; pad rows (label -1) count
        nothing."""
        source = link_source(self, "output")
        logits = None if source is None else \
            getattr(source[0], "logits", None)
        if logits is None:
            raise NotImplementedError(
                "%s: the eager softmax evaluator differentiates the logits "
                "of the All2AllSoftmax unit its output is linked from"
                % self.name)
        labels = self.labels
        valid = labels >= 0
        report, n_err = self._loss(logits, softmax_loss_and_metrics,
                                   labels, valid)
        stats = [report, n_err.to(report.dtype)]
        if not self.testing:
            stats.append(self.err_output.reshape(len(labels), -1).abs()
                         .sum(dim=1).max().to(report.dtype))
        stats = torch.stack(stats).tolist()  # one wait for the device
        self.loss, self.n_err = stats[0], int(stats[1])
        if not self.testing:
            self.max_err_output_sum = stats[2]
        if self.compute_confusion:
            self.confusion_matrix = batch_confusion(
                logits.detach(), labels, valid).cpu().numpy()
        self._record(self.output, labels)

    def get_metric_values(self):
        out = {"n_err": self.n_err, "loss": self.loss}
        out.update(self._recorded_metrics())
        return out


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

    def compute(self):
        """RMSE over the valid rows (``indices`` >= 0, when linked) and
        each row's mean squared difference."""
        out, target = self.output, self.target
        valid = (self.indices >= 0 if self.indices is not None else
                 torch.ones(len(out), dtype=torch.bool, device=out.device))
        self._loss(out, mse_loss_and_metrics, target, valid)
        out = out.detach()
        self.mse_per_sample = torch.mean(torch.square(masked_difference(
            out, target, valid)), dim=1).cpu().numpy()
        self.rmse = float(mse_rmse(out, target, valid))
        self._record(out)

    def get_metric_values(self):
        out = {"rmse": self.rmse}
        out.update(self._recorded_metrics())
        return out
