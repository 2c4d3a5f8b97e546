"""The weight carrier between the JAX package and the port, both ways.

The JAX package holds one ``{"weights", "bias"}`` numpy dict per
forward layer (``ServeableModel.from_workflow``, ``FusedTrainer.
pull_params``; empty for layers without weights). Layouts:

* convolution weights HWIO in JAX, OIHW (channels_last memory) here;
* All2All weights ``(in, out)`` in both;
* biases ``(out,)`` in both;
* attention weights (4, dim, dim) and biases (4, dim), and the mixture
  of experts' router (dim, E) and its ``up`` (E, dim, hidden) and
  ``down`` (E, hidden, dim), in both (a module's ``EXTRA_PARAMS``
  cross beside its weights and bias).

:func:`params_from_jax` loads JAX parameters into the port's modules and
:func:`params_to_jax` reads them back out. A transposed convolution's
HWOI weights (``nn.conv.Deconv``) take the same permutation, to
(in, out, kH, kW). The solvers' state crosses too:
:func:`solver_state_to_jax` / :func:`solver_state_from_jax` map each
layer's state of a rule of ``veles_tpu_torch.nn.optim`` onto the JAX
rule's: the per-parameter tensors (SGD's ``velocity``, AdaGrad's
``accum``, AdaDelta's ``accum_g``/``accum_dx``, Adam's ``m``/``v``) in
the parameters' JAX layout, the scalars (SGD's ``step``, Adam's ``t``)
as float32. ``sgd_state_to_jax`` / ``sgd_state_from_jax`` are the same
functions under their first names.
"""

import numpy
import torch


def params_from_jax(layers, jax_params):
    """Load ``jax_params`` (one dict per layer, in order) into
    ``layers`` (the port's modules, e.g. a built ``nn.Sequential``).
    Returns ``layers``."""
    modules = list(layers)
    jax_params = list(jax_params)
    if len(modules) != len(jax_params):
        raise ValueError("%d layers but %d parameter dicts" %
                         (len(modules), len(jax_params)))
    for index, (module, params) in enumerate(zip(modules, jax_params)):
        if not module.has_weights:
            if params:
                raise ValueError("layer %d (%s) has no weights but got %s"
                                 % (index, type(module).__name__,
                                    sorted(params)))
            continue
        weights = numpy.asarray(params["weights"], numpy.float32)
        want = tuple(module.jax_weights_shape())
        if weights.shape != want:
            raise ValueError("layer %d (%s): weights %s, expected %s" % (
                index, type(module).__name__, weights.shape, want))
        if weights.ndim == 4:                       # HWIO -> OIHW
            weights = weights.transpose(3, 2, 0, 1)
        with torch.no_grad():
            module.weights.copy_(torch.from_numpy(numpy.array(weights)))
            if module.include_bias:
                if "bias" not in params:
                    raise ValueError("layer %d (%s) needs a bias" % (
                        index, type(module).__name__))
                bias = numpy.array(params["bias"], numpy.float32)
                if bias.shape != tuple(module.bias_shape()):
                    raise ValueError("layer %d: bias %s, expected %s" % (
                        index, bias.shape, tuple(module.bias_shape())))
                module.bias.copy_(torch.from_numpy(bias))
            for name in module.EXTRA_PARAMS:
                target = getattr(module, name)
                if name not in params:
                    raise ValueError("layer %d (%s) needs %r" % (
                        index, type(module).__name__, name))
                value = numpy.array(params[name], numpy.float32)
                if value.shape != tuple(target.shape):
                    raise ValueError("layer %d: %s %s, expected %s" % (
                        index, name, value.shape, tuple(target.shape)))
                target.copy_(torch.from_numpy(value))
    return layers


def to_jax_layout(tensors):
    """``{name: tensor}`` of a module's parameters (values, gradients
    or velocities) as float32 numpy arrays in the JAX layout."""
    out = {}
    for name, value in tensors.items():
        array = value.detach().float().cpu().numpy()
        if array.ndim == 4:                          # OIHW -> HWIO
            array = array.transpose(2, 3, 1, 0)
        out[name] = numpy.ascontiguousarray(array)
    return out


def from_jax_layout(module, arrays, like):
    """Inverse of :func:`to_jax_layout`: numpy arrays in the JAX layout
    into tensors shaped, typed and placed like ``like`` ({name:
    tensor})."""
    out = {}
    for name, array in arrays.items():
        array = numpy.asarray(array, numpy.float32)
        if array.ndim == 4:                          # HWIO -> OIHW
            array = array.transpose(3, 2, 0, 1)
        ref = like[name]
        if tuple(array.shape) != tuple(ref.shape):
            raise ValueError("%s %s: got %s, expected %s" % (
                type(module).__name__, name, array.shape, tuple(ref.shape)))
        out[name] = torch.empty_like(ref).copy_(torch.from_numpy(
            numpy.array(array)))
    return out


def layer_params(module):
    """``{"weights", "bias"}`` parameters of a weighted module (bias only
    where it has one) and its ``EXTRA_PARAMS``; ``{}`` for a module
    without weights."""
    if not module.has_weights:
        return {}
    params = {"weights": module.weights}
    if module.bias is not None:
        params["bias"] = module.bias
    for name in module.EXTRA_PARAMS:
        params[name] = getattr(module, name)
    return params


def params_to_jax(layers):
    """The modules' parameters as the JAX package's per-layer numpy
    dicts (HWIO convolutions), ``{}`` for layers without weights."""
    return [to_jax_layout(layer_params(m)) for m in layers]


def solver_state_to_jax(states):
    """Per-layer solver states of the port as the JAX rule's states:
    ``{name: tensor}`` dicts in the JAX layout, scalars as
    ``numpy.float32``; ``{}`` stays ``{}``."""
    return [{key: to_jax_layout(value) if isinstance(value, dict)
             else numpy.float32(value.item())
             for key, value in state.items()} for state in states]


def solver_state_from_jax(layers, jax_states):
    """JAX solver states as the port's, on each module's device."""
    out = []
    for module, state in zip(layers, jax_states):
        if not state:
            out.append({})
            continue
        params = layer_params(module)
        out.append({key: from_jax_layout(module, value, params)
                    if isinstance(value, dict) else torch.tensor(
                        float(numpy.asarray(value)), dtype=torch.float32,
                        device=module.weights.device)
                    for key, value in state.items()})
    return out


sgd_state_to_jax = solver_state_to_jax
sgd_state_from_jax = solver_state_from_jax
