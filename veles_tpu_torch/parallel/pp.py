"""GPipe pipeline parallelism over a ``pipe`` axis (``veles_tpu/parallel/
pp.py``).

One process a rank, each rank one stage and its parameters. Every clock
tick each stage applies its function to the activation it holds, the
last stage keeps its result as microbatch ``t - (n_stages - 1)``'s
output, and the activations move one stage on
(:class:`RingShift`, ``ppermute`` by one step; its backward is the
inverse rotation): ``n_micro + n_stages - 1`` ticks, bubble included.
The outputs are summed over the axis, so every rank returns them whole
(only the last stage's are not zero; the backward of that sum is the
identity).

Reverse-mode autograd runs the backward pipeline: the cotangents hop
back stage by stage through the rotations' transposes, and each stage's
parameter gradients accumulate over its microbatches, as differentiating
the mean loss over all microbatches gives them
(:func:`pipeline_train_step`). For that every rank's graph has the same
rotations in the same order: stage 0's injected microbatch is selected
with ``torch.where`` over the received activation (both stay in the
graph, as the JAX function's ``where``), and a stage whose result is not
kept still ties it to the output (:class:`Tie`), so no rank skips a
transposed rotation its neighbours wait for.

:func:`hetero_pipeline_apply` lifts the shape restriction, as the JAX
function does: per-stage functions and parameters, the boundary shapes
found by running the stages once on a microbatch of zeros,
and the activations carried in one float32 buffer of the largest
boundary's size, so the flagship's conv -> pool -> fc trunk pipelines.
Each rank holds only its own stage's parameters, so the JAX package's
padded parameter stack (``stack_stage_params``) has no counterpart.
With a ``data_axis`` (pp x dp) each data rank pipelines its block of
every microbatch's rows (:class:`~veles_tpu_torch.parallel.collectives.
ScatterToAxis`), its stage's parameters enter through
:class:`~veles_tpu_torch.parallel.collectives.CopyToAxis` (their
gradients summed over the data axis) and the outputs are gathered whole.
With a ``seed`` the stages are stochastic: each is called ``fn(params,
x, key)`` with ``key = (seed, data index, stage, microbatch)``, the JAX
function's fold order, for the stage to draw its masks from (K7 takes
the key's parts as a seed and an offset); autograd keeps each mask for
the backward pipeline.
"""

import math

import torch

from veles_tpu_torch.parallel.collectives import (CopyToAxis, GatherFromAxis,
                                                  ReduceFromAxis,
                                                  ScatterToAxis, ring_shift)


class RingShift(torch.autograd.Function):
    """``ppermute`` by ``shift`` along an axis; backward the inverse."""

    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.args = (axis, shift)
        return ring_shift([x], axis, shift)[0]

    @staticmethod
    def backward(ctx, g):
        axis, shift = ctx.args
        return ring_shift([g], axis, -shift)[0], None, None


class Tie(torch.autograd.Function):
    """``value``, with ``dep`` kept in the graph (a zero cotangent)."""

    @staticmethod
    def forward(ctx, value, dep):
        ctx.dep = (dep.shape, dep.dtype, dep.device)
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep
        return g, torch.zeros(shape, dtype=dtype, device=device)


def _run(step, inject, n_micro, out_shape, dtype, pipe):
    """The clock loop: ``step(state, t) -> (next state, result)`` each
    tick, ``inject(t)`` stage 0's input. Returns the outputs whole."""
    n_stages, stage = pipe.size, pipe.index
    last = n_stages - 1
    state = inject(n_micro)  # zeros of the carried shape
    outputs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        if stage == 0:
            state = torch.where(torch.tensor(True, device=state.device),
                                inject(t), state)
        state, result = step(state, t)
        out = t - last
        if stage == last and out >= 0:
            outputs[out] = result
        else:
            keep = max(out, 0)
            zero = torch.zeros(out_shape, dtype=dtype, device=state.device)
            tied = Tie.apply(zero, result)
            outputs[keep] = tied if outputs[keep] is None \
                else outputs[keep] + tied
        if t < n_micro + n_stages - 2:
            state = RingShift.apply(state, pipe, 1)
    return ReduceFromAxis.apply(torch.stack(outputs), pipe)


def pipeline_apply(stage_fn, params, x_microbatches, grid, axis="pipe"):
    """Microbatches ``x_microbatches`` (n_micro, mb, ...) whole on every
    rank through the stages: ``stage_fn(params, x) -> x`` with this
    rank's stage ``params``, shape-preserving. Returns (n_micro, mb,
    ...) whole, differentiable in ``params`` and the inputs."""
    pipe = grid.axis(axis)
    xs = x_microbatches
    n_micro = xs.shape[0]

    def inject(t):
        return xs[t] if t < n_micro else torch.zeros_like(xs[0])

    def step(state, t):
        y = stage_fn(params, state)
        return y, y

    return _run(step, inject, n_micro, tuple(xs.shape[1:]), xs.dtype, pipe)


def _leaves(params):
    return list(params.values()) if isinstance(params, dict) else [params]


def _sgd(params, grads, learning_rate):
    if isinstance(params, dict):
        return {k: (p - learning_rate * g).detach()
                for (k, p), g in zip(params.items(), grads)}
    return (params - learning_rate * grads[0]).detach()


def _with_grad(params):
    if isinstance(params, dict):
        return {k: p.detach().requires_grad_() for k, p in params.items()}
    return params.detach().requires_grad_()


def _mean_loss(outs, y_microbatches, loss_fn):
    return torch.stack([loss_fn(outs[i], y_microbatches[i])
                        for i in range(outs.shape[0])]).mean()


def pipeline_train_step(stage_fn, params, x_microbatches, y_microbatches,
                        loss_fn, grid, axis="pipe", learning_rate=0.05):
    """One SGD step of this rank's stage: ``loss_fn(out, y)`` averaged
    over the microbatches and differentiated through
    :func:`pipeline_apply` (the backward pipeline; each stage's gradient
    summed over its microbatches). Returns (new params, loss)."""
    params = _with_grad(params)
    outs = pipeline_apply(stage_fn, params, x_microbatches, grid, axis)
    loss = _mean_loss(outs, y_microbatches, loss_fn)
    grads = torch.autograd.grad(loss, _leaves(params))
    return _sgd(params, grads, learning_rate), loss.detach()


def boundary_shapes(stage_fns, stage_params, x, seed=None):
    """The activation shape entering each stage and leaving the last:
    the stages run in turn on a microbatch of zeros shaped as ``x``
    (without gradients; the kernels take no ``meta`` tensors)."""
    shapes = [tuple(x.shape)]
    y = torch.zeros_like(x)
    with torch.no_grad():
        for i, (fn, params) in enumerate(zip(stage_fns, stage_params)):
            y = fn(params, y) if seed is None else fn(params, y,
                                                      (seed, 0, i, 0))
            shapes.append(tuple(y.shape))
    return shapes


def _entering(params, axis):
    """``params`` (a tensor or a dict of them) through ``CopyToAxis``."""
    if isinstance(params, dict):
        return {k: CopyToAxis.apply(v, axis) for k, v in params.items()}
    return CopyToAxis.apply(params, axis)


def hetero_pipeline_apply(stage_fns, stage_params, x_microbatches, grid,
                          axis="pipe", data_axis=None, seed=None):
    """The pipeline over stages with different activation shapes:
    ``stage_fns[i](params_i, x_i) -> x_{i+1}``; ``stage_params`` every
    stage's parameters (this rank's train; the others only find the
    boundary shapes); ``data_axis`` and ``seed`` as the module docstring
    says. Returns (n_micro, mb, ...) of the last stage whole."""
    pipe = grid.axis(axis)
    if len(stage_fns) != pipe.size:
        raise ValueError("%d stage fns for a %d-wide pipe axis" %
                         (len(stage_fns), pipe.size))
    xs = x_microbatches
    data = grid.axis(data_axis) if data_axis is not None else None
    if data is not None:
        xs = ScatterToAxis.apply(xs, data, 1)
    n_micro = xs.shape[0]
    stage = pipe.index
    bounds = boundary_shapes(stage_fns, stage_params, xs[0], seed)
    sizes = [math.prod(b) for b in bounds]
    buf = max(sizes[:-1])
    fn, params = stage_fns[stage], stage_params[stage]
    if data is not None:
        params = _entering(params, data)
    last = stage == pipe.size - 1

    def inject(t):
        flat = torch.zeros(buf, dtype=torch.float32, device=xs.device)
        if t < n_micro:
            flat[:sizes[0]] = xs[t].reshape(-1).float()
        return flat

    def step(state, t):
        x = state[:sizes[stage]].reshape(bounds[stage]).to(xs.dtype)
        if seed is None:
            y = fn(params, x)
        else:
            # a bubble tick's microbatch index is clipped: its output
            # is never kept
            y = fn(params, x, (seed, 0 if data is None else data.index,
                               stage, max(t - stage, 0)))
        zero = torch.zeros(buf, dtype=torch.float32, device=y.device)
        if last:
            return Tie.apply(zero, y), y
        flat = torch.cat([y.reshape(-1).float(),
                          zero[:buf - y.numel()]])
        return flat, y

    out = _run(step, inject, n_micro, bounds[-1], xs.dtype, pipe)
    if data is not None:
        out = GatherFromAxis.apply(out, data, 1)
    return out


def hetero_pipeline_train_step(stage_fns, stage_params, x_microbatches,
                               y_microbatches, loss_fn, grid, axis="pipe",
                               learning_rate=0.05, data_axis=None,
                               seed=None):
    """One SGD step through :func:`hetero_pipeline_apply`: (this rank's
    new stage parameters, the mean loss). A stochastic stage's masks are
    constants of the step: the backward reuses the forward's."""
    pipe = grid.axis(axis)
    stage_params = list(stage_params)
    mine = _with_grad(stage_params[pipe.index])
    stage_params[pipe.index] = mine
    outs = hetero_pipeline_apply(stage_fns, stage_params, x_microbatches,
                                 grid, axis, data_axis, seed)
    loss = _mean_loss(outs, y_microbatches, loss_fn)
    grads = torch.autograd.grad(loss, _leaves(mine))
    return _sgd(mine, grads, learning_rate), loss.detach()
