"""The SPMD training tier of ``--gspmd`` (``veles_tpu/parallel/
gspmd.py``).

A ``batch`` x ``model`` :class:`~veles_tpu_torch.parallel.mesh.RankGrid`
unifies :mod:`~veles_tpu_torch.parallel.dp`'s batch placement and
:mod:`~veles_tpu_torch.parallel.tp`'s model rules in one trainer, one
process per rank:

* over ``batch``: the row-sharded dataset, each rank's columns of every
  minibatch, the per-sample values gathered before the loss (so every
  rank reduces the loss and the metrics in the standalone order), the
  gradients summed between the backward pass and the solver;
* over ``model`` (wider than 1): each sharded layer's parameters and
  solver state are this rank's block of them (:func:`~veles_tpu_torch.
  parallel.tp.tp_param_shardings`), its forward the explicit column or
  row form, the dropout masks this rank's columns of the standalone
  fill, the gradient norm the norm of every block.

``reduce_gradients = False`` (the control that must fail) skips the
gradient all_reduce over ``batch`` and the model axis's backward
collectives: the all_reduce of a column layer's partial input
cotangents and the all_gather of a row layer's input cotangent.

:meth:`GSPMDTrainer.unit_states` is the train -> serve move of the JAX
trainer's ``push_params``: the sharded parameters gathered whole into
the modules (and their solver states whole), through the measured
reshard seam, so snapshots and the model store read whole tensors.

Telemetry: ``veles_gspmd_step_ms{phase}`` (a class sweep, compute and
exchange, synchronized), ``veles_reshard_ms{src,dst}``, and the sweeps'
cost-book rows under ``gspmd_``.

Unlike the JAX tier the runs are not bitwise the standalone one on more
than one rank: the partial gradients are summed in another order
(ROADMAP.md §C). One rank (``1x1``) is.
"""

import time

import torch
from torch import nn

from veles_tpu_torch.parallel import collectives, reshard
from veles_tpu_torch.parallel.dp import DataParallelTrainer, _map_state
from veles_tpu_torch.parallel.mesh import (build_mesh, infer_sizes,
                                           replicated)
from veles_tpu_torch.parallel.tp import (CHANNELWISE, check_supported,
                                         column_forward, enter_row,
                                         row_forward, tp_param_shardings,
                                         tp_roles)
from veles_tpu_torch.nn.dropout import DropoutForward
from veles_tpu_torch.ops.random import dropout_uniforms
from veles_tpu_torch.telemetry.registry import get_registry
from veles_tpu_torch.train.step import trainer_device

#: the tier's axis names
BATCH_AXIS = "batch"
MODEL_AXIS = "model"


def parse_mesh_spec(spec, n=None):
    """``--gspmd``'s argument -> {batch: b, model: m} over ``n`` ranks
    (``-1`` inferred when ``n`` is given): ``auto`` (every rank on
    ``batch``), ``batch=4,model=2`` (any order) or ``4x2`` (batch x
    model)."""
    spec = (spec or "auto").strip().lower()
    axes = {BATCH_AXIS: -1, MODEL_AXIS: 1}
    if spec not in ("auto", "1", "true", "on"):
        if "=" in spec:
            for part in spec.split(","):
                name, _, value = part.partition("=")
                name = name.strip()
                if name not in axes:
                    raise ValueError(
                        "unknown GSPMD mesh axis %r (have batch, model)"
                        % name)
                axes[name] = int(value)
        else:
            sizes = spec.split("x")
            if len(sizes) > 2:
                raise ValueError("GSPMD mesh shorthand is BATCHxMODEL, "
                                 "got %r" % spec)
            axes[BATCH_AXIS] = int(sizes[0])
            if len(sizes) > 1:
                axes[MODEL_AXIS] = int(sizes[1])
    if n is not None:
        names, sizes = infer_sizes(axes, n)
        axes = dict(zip(names, sizes))
    return axes


def gspmd_mesh(batch=-1, model=1, device=None):
    """The ``batch`` x ``model`` grid of the live world; the model axis
    exists at size 1 too."""
    return build_mesh({BATCH_AXIS: batch, MODEL_AXIS: model}, device)


class GSPMDTrainer(DataParallelTrainer):
    """The SPMD trainer over the ``batch`` x ``model`` ``grid`` (see the
    module docstring; default: every rank on ``batch``, the grid on the
    trainer's device)."""

    _op_prefix = "gspmd_"

    def __init__(self, model, loader, hypers, grid=None, **kwargs):
        if kwargs.get("offload"):
            # the offload engine walks whole layers; a rank of the model
            # axis holds its blocks of them
            raise ValueError("the GSPMD trainer keeps the model state "
                             "in-core on every rank")
        kwargs["offload"] = False
        if grid is None:
            grid = gspmd_mesh(device=trainer_device(model,
                                                    kwargs.get("device")))
        for name in (BATCH_AXIS, MODEL_AXIS):
            if name not in grid.shape:
                raise ValueError("GSPMD mesh %r has no %r axis "
                                 "(gspmd_mesh/parse_mesh_spec build the "
                                 "right one)" % (grid.shape, name))
        self.model_axis = grid.axis(MODEL_AXIS)
        forwards = list(model)
        self._tp = self.model_axis.size > 1
        self.roles = tp_roles(forwards, self.model_axis.size) if self._tp \
            else [None] * len(forwards)
        check_supported(forwards, self.roles)
        self._specs = tp_param_shardings(forwards, grid, MODEL_AXIS) \
            if self._tp else None
        self._step_ms = get_registry().histogram(
            "veles_gspmd_step_ms",
            "GSPMD class sweep: compute + exchange, synchronized",
            labels=("phase",))
        super(GSPMDTrainer, self).__init__(model, loader, hypers, grid=grid,
                                           axis=BATCH_AXIS, **kwargs)
        if self._tp:
            self._shard_params()

    # -- the model axis ------------------------------------------------------

    def param_specs(self):
        if not self._tp:
            return super(GSPMDTrainer, self).param_specs()
        return self._specs

    def _shard_params(self):
        """Each sharded layer's parameters and solver state become this
        rank's blocks, placed through the reshard seam."""
        repl = replicated(self.grid)
        for i, role in enumerate(self.roles):
            if role is None:
                continue
            spec = self._specs[i]
            local = {}
            for k, p in self.params[i].items():
                block = reshard.reshard(p.detach(), spec[k], repl)
                if block.dim() == 4:
                    block = block.contiguous(
                        memory_format=torch.channels_last)
                local[k] = nn.Parameter(block.clone(), requires_grad=True)
            self.params[i] = local
            self.states[i] = _map_state(
                self.states[i], spec,
                lambda v, sp: reshard.reshard(v, sp, repl).clone())

    def unit_states(self):
        """The modules get the sharded parameters whole (gathered
        through the reshard seam); returns every layer's solver state
        whole."""
        if not self._tp:
            return self.states
        repl = replicated(self.grid)
        states = list(self.states)
        with torch.no_grad():
            for i, role in enumerate(self.roles):
                if role is None:
                    continue
                spec = self._specs[i]
                module = self.forwards[i]
                for k, p in self.params[i].items():
                    getattr(module, k).copy_(
                        reshard.reshard(p.detach(), repl, spec[k]))
                states[i] = _map_state(
                    states[i], spec,
                    lambda v, sp: reshard.reshard(v, repl, sp))
        return states

    def _forward_range(self, x, lo, hi, train, batch_index=0, seed=0,
                       aux=None, valid=None):
        """The chain with the model axis's explicit column and row forms
        (the plain chain without tensor parallelism)."""
        if not self._tp:
            return super(GSPMDTrainer, self)._forward_range(
                x, lo, hi, train, batch_index, seed, aux, valid)
        axis = self.model_axis
        gather = collectives.GatherFromAxis.apply
        split = False
        last = len(self.forwards) - 1
        for i in range(lo, hi):
            module, role = self.forwards[i], self.roles[i]
            if role == "column":
                if split:
                    x = gather(x, axis, x.dim() - 1)
                x = column_forward(module, x, self.params[i], axis,
                                   self.plain, self.reduce_gradients)
                split = True
                continue
            if role == "row":
                x = row_forward(module, enter_row(
                    module, x, split, axis, self.reduce_gradients),
                    self.params[i], axis, self.plain)
                split = False
                continue
            if split and not isinstance(module, CHANNELWISE):
                x = gather(x, axis, x.dim() - 1)
                split = False
            if aux is not None and getattr(module, "aux_loss_weight", 0.0):
                aux.append(module.aux_loss(x, valid))
            if isinstance(module, DropoutForward):
                if train:
                    x = module.train_forward(x, self._tp_uniforms(
                        x, split, seed, batch_index, i))
            elif i == last and hasattr(module, "logits"):
                x = module.logits(x, self.plain)
            elif self.plain:
                x = module.plain_forward(x)
            else:
                x = module(x)
        if split:
            x = gather(x, axis, x.dim() - 1)
        return x

    def _tp_uniforms(self, x, split, seed, batch_index, i):
        """This rank's rows -- and, of a split activation, columns -- of
        the standalone mask's uniforms."""
        shape = [x.shape[0] * self.batch_axis.size] + list(x.shape[1:])
        if split:
            shape[-1] *= self.model_axis.size
        full = dropout_uniforms(tuple(shape), seed, batch_index, i,
                                x.device, self.uniform_source, self.plain)
        full = collectives.local_part(full, self.batch_axis, 0)
        if split:
            full = collectives.local_part(full, self.model_axis,
                                          full.dim() - 1)
        return full

    def grad_norm(self):
        """The global gradient norm over every block: the sharded
        layers' squares summed over the model axis."""
        if not self._tp:
            return super(GSPMDTrainer, self).grad_norm()
        sharded = torch.zeros((), device=self.device)
        whole = torch.zeros((), device=self.device)
        for params, role in zip(self.params, self.roles):
            for p in params.values():
                sq = torch.linalg.vector_norm(p.grad).square()
                if role is None:
                    whole = whole + sq
                else:
                    sharded = sharded + sq
        collectives.all_reduce(sharded, self.model_axis)
        return torch.sqrt(sharded + whole)

    # -- measured sweeps -----------------------------------------------------

    def _timed(self, phase, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._step_ms.labels(phase=phase).observe(
            (time.perf_counter() - t0) * 1e3)
        return out

    def train_class(self, skip=0):
        return self._timed("train", super(GSPMDTrainer, self).train_class,
                           skip=skip)

    def eval_class(self, klass, skip=0):
        return self._timed("eval", super(GSPMDTrainer, self).eval_class,
                           klass, skip=skip)
