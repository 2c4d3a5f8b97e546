"""Tensor parallelism over a ``model`` axis (``veles_tpu/parallel/tp.py``).

:func:`tp_roles` is the JAX package's column/row alternation over a
stack of layers, dense and convolution alike: a column layer splits its
output features (dense ``fout``, convolution ``cout``), the next
sharded layer its input features (``fin``, ``cin``); a layer whose split
dimension does not divide the axis stays whole without consuming the
alternation, and the last layer stays whole. :func:`tp_param_shardings`
turns the roles into each parameter's
:class:`~veles_tpu_torch.parallel.mesh.Sharding` in the port's layouts
(dense ``(in, out)``; convolution OIHW, so ``cout`` is dimension 0 and
``cin`` dimension 1).

The JAX package declares the layouts and lets its partitioner derive
the collectives; here they are written out (:mod:`~veles_tpu_torch.
parallel.collectives`):

* a column layer takes its input whole (:class:`CopyToAxis`: its input
  cotangent is the all_reduce of the ranks' partial ones) and gives
  its output split along the channels;
* a row layer takes its input split along the channels (this rank's
  part of a whole one, :class:`ScatterToAxis`), runs K1 -- or the
  convolution -- without its bias, all_reduces the partial sums
  (:class:`ReduceFromAxis`) and then adds its bias and applies its
  activation, elementwise work the JAX package leaves to XLA (the bias
  through :func:`~veles_tpu_torch.nn.base.bias_add_nhwc`, its gradient
  through K6);
* a split activation is gathered (:class:`GatherFromAxis`) where the
  next op needs every channel: LRN's window of 5 channels, a dense
  layer after a convolution (the flatten's feature order is H, W, C, so
  a channel split is no contiguous ``fin`` split: the gathered
  activation is flattened and cut again), and any other layer but
  pooling, dropout and activations, which work channel by channel.

:func:`shard_map_linear` is the explicit two-layer block of the JAX
package: ``act(x @ Wcol) @ Wrow`` with one all_reduce, K1 for both
products.
"""

import torch
import torch.nn.functional as F

from veles_tpu_torch.nn.activation import ACTIVATIONS, ActivationUnit
from veles_tpu_torch.nn.all2all import All2All
from veles_tpu_torch.nn.base import bias_add_nhwc
from veles_tpu_torch.nn.conv import Conv
from veles_tpu_torch.nn.dropout import DropoutForward
from veles_tpu_torch.nn.pooling import PoolingBase
from veles_tpu_torch.ops.gemm import LinearActFunction, linear_act
from veles_tpu_torch.parallel.collectives import (CopyToAxis, GatherFromAxis,
                                                  ReduceFromAxis,
                                                  ScatterToAxis, all_reduce)
from veles_tpu_torch.parallel.mesh import named_sharding

#: layers that work channel by channel, so a split activation passes
CHANNELWISE = (PoolingBase, DropoutForward, ActivationUnit)


def tp_roles(forwards, n_shards):
    """``"column"``, ``"row"`` or None for each layer: the JAX
    package's alternation over the weights' JAX layouts (the last two
    axes of a 2-D or 4-D weight are (fan_in, fan_out))."""
    roles = []
    column = True
    last = len(forwards) - 1
    for i, fwd in enumerate(forwards):
        shape = tuple(fwd.jax_weights_shape()) \
            if getattr(fwd, "has_weights", False) else ()
        if i == last or len(shape) not in (2, 4):
            roles.append(None)
            continue
        fan_in, fan_out = shape[-2], shape[-1]
        if column and fan_out % n_shards == 0:
            roles.append("column")
        elif not column and fan_in % n_shards == 0:
            roles.append("row")
        else:
            roles.append(None)
            continue
        column = not column
    return roles


def _split_dims(fwd, role):
    """(weights dimension, bias dimension or None) a role splits in the
    port's layout."""
    conv = len(fwd.jax_weights_shape()) == 4
    if role == "column":
        return (0 if conv else 1), 0
    return (1 if conv else 0), None


def tp_param_shardings(forwards, grid, axis="model"):
    """Each layer's {parameter: Sharding} of :func:`tp_roles` over the
    ``axis`` of ``grid`` (whole parameters replicated)."""
    roles = tp_roles(forwards, grid.shape[axis])
    specs = []
    for fwd, role in zip(forwards, roles):
        names = (["weights"] + (["bias"] if getattr(fwd, "bias", None)
                                is not None else []) +
                 list(getattr(fwd, "EXTRA_PARAMS", ()))) \
            if getattr(fwd, "has_weights", False) else []
        spec = {k: named_sharding(grid) for k in names}
        if role is not None:
            wdim, bdim = _split_dims(fwd, role)
            spec["weights"] = named_sharding(grid, *(None,) * wdim + (axis,))
            if "bias" in spec and bdim is not None:
                spec["bias"] = named_sharding(grid, axis)
        specs.append(spec)
    return specs


def _conv_partial(module, x, w):
    """The convolution of NHWC ``x`` with OIHW ``w``, no bias: the
    port's ``Conv._apply`` up to its bias (NHWC output in the policy's
    accumulation dtype)."""
    if x.dim() == 3:
        x = x.unsqueeze(-1)
    pol = module.policy
    xc, wc = pol.cast_in(x, w)
    y = F.conv2d(xc.permute(0, 3, 1, 2), wc, None, module.stride,
                 module.pad).to(pol.accum_dtype)
    return y.permute(0, 2, 3, 1).contiguous()


def column_forward(module, x, params, axis, plain=False, reduce=True):
    """A column layer on this rank: the whole input ``x``, its output
    channels ``params`` (this rank's block), the split output.
    ``reduce=False`` (a control) keeps the input cotangent partial."""
    x = CopyToAxis.apply(x, axis, reduce)
    w, b = params["weights"], params.get("bias")
    if isinstance(module, Conv):
        y = bias_add_nhwc(_conv_partial(module, x, w), b, plain)
        return module.policy.cast_out(module._activation(y))
    batch = x.shape[0]
    xc, wc = module.policy.cast_in(x.reshape(batch, -1), w)
    return LinearActFunction.apply(xc, wc, b, module.activation_name,
                                   module.policy.keep_dtype, plain)


def row_forward(module, x, params, axis, plain=False):
    """A row layer on this rank: ``x`` this rank's input channels (a
    dense layer's: its block of the flattened features), the whole
    output: the partial product, the all_reduce, then bias and
    activation."""
    w, b = params["weights"], params.get("bias")
    if isinstance(module, Conv):
        y = ReduceFromAxis.apply(_conv_partial(module, x, w), axis)
        y = bias_add_nhwc(y, b, plain)
        return module.policy.cast_out(module._activation(y))
    batch = x.shape[0]
    xc, wc = module.policy.cast_in(x.reshape(batch, -1), w)
    y = LinearActFunction.apply(xc, wc, None, "linear", torch.float32,
                                plain)
    y = bias_add_nhwc(ReduceFromAxis.apply(y, axis), b, plain)
    return ACTIVATIONS[module.activation_name](y).to(
        module.policy.keep_dtype)


def check_supported(forwards, roles):
    """Raise for a sharded layer this module cannot run."""
    for i, (fwd, role) in enumerate(zip(forwards, roles)):
        if role is not None and not isinstance(fwd, (Conv, All2All)):
            raise NotImplementedError(
                "layer %d (%s) is planned %s-sharded; the port's tensor "
                "parallelism runs convolutions and dense layers"
                % (i, type(fwd).__name__, role))


def enter_row(module, x, split, axis, gather=True):
    """A row layer's input: ``x`` as this rank's channels (``split``:
    ``x`` already is; a dense layer after a split convolution gathers,
    flattens and cuts the features again). ``gather=False`` (a control)
    leaves the cut's cotangent this rank's part."""
    if split and isinstance(module, All2All) and x.dim() > 2:
        x = GatherFromAxis.apply(x, axis, x.dim() - 1)
        split = False
    if not split:
        if isinstance(module, All2All):
            x = x.reshape(x.shape[0], -1)
        x = ScatterToAxis.apply(x, axis, x.dim() - 1, gather)
    return x


def shard_map_linear(x, w_col, w_row, axis, activation="linear"):
    """``act(x @ Wcol) @ Wrow`` over ``axis``: this rank's column block
    ``w_col`` (in, hidden / N) and row block ``w_row`` (hidden / N,
    out), the whole ``x``; one all_reduce. K1 for both products."""
    h = linear_act(x, w_col, None, activation, torch.float32)
    return all_reduce(linear_act(h, w_row, None, "linear", torch.float32),
                      axis)
