"""Data-parallel fused training (``veles_tpu/parallel/dp.py``).

One process per rank of a :class:`~veles_tpu_torch.parallel.mesh.
RankGrid`; each trains its share of every minibatch with its own copy of
the parameters, and the gradients are summed over the ``data`` axis
between the backward pass and the solver, where the JAX package's
partitioner inserts its ``psum``.

* The dataset stays row-sharded: each rank's device holds ``ceil(rows /
  N)`` rows of the zero-padded dataset, rows ``[r * per, (r + 1) *
  per)``, placed through :func:`veles_tpu_torch.loader.prefetch.
  sharded_placer`. Every rank derives the same index matrices from the
  same seeds. Rank r trains columns ``[r * mb / N, (r + 1) * mb / N)``
  of each minibatch row; the rows it needs come from the ranks that own
  them in one all_to_all a minibatch: each rank sends every rank the
  rows of that rank's columns it owns (zero rows elsewhere), and each
  keeps, per column, the row of its owner. A streamed dataset needs no
  exchange: each rank streams its own columns from the host.
* The loss and the metrics read the whole minibatch: the per-sample
  outputs, truths and valid flags are gathered over the axis before any
  cross-sample reduction (``GSPMDTrainer._loss_and_metrics`` in the JAX
  package), so every rank computes the standalone loss, and the
  cotangent of each rank's own rows is the standalone run's. The sum of
  the ranks' gradients is then the standalone gradient; only the order
  of its additions differs.
* Dropout masks are the standalone run's rows: every rank draws the
  global (minibatch, width) fill of K7 at the standalone shape and keeps
  its own rows.
* :attr:`DataParallelTrainer.reduce_gradients` False skips the
  gradient all_reduce (the control that must fail).
* A sharded checkpoint (:meth:`FusedTrainer.checkpoint_records`): each
  rank gives the blocks it owns with their global index, a replicated
  leaf from its first replica alone (the rank at index 0 of every axis
  the leaf is not split over), so the ranks' part files cover every
  leaf once (:meth:`DataParallelTrainer._record_leaf`).
"""

import torch

from veles_tpu_torch.loader import prefetch
from veles_tpu_torch.ops.random import dropout_uniforms
from veles_tpu_torch.parallel import collectives, reshard
from veles_tpu_torch.parallel.mesh import (build_mesh, named_sharding,
                                           replicated)
from veles_tpu_torch.train.step import (FusedTrainer, jax_index,
                                        jax_layout, trainer_device)


class DataParallelTrainer(FusedTrainer):
    """:class:`FusedTrainer` whose ranks split the minibatch over the
    ``axis`` of ``grid`` (default: every rank on ``data``, the grid on
    the trainer's device). The minibatch size must divide over the
    axis. Every rank holds the whole model state, in-core or offloaded
    (``offload``, as the JAX trainer passes its kwargs on): an offloaded
    layer group's gradients are summed over the axis before its
    update."""

    def __init__(self, model, loader, hypers, grid=None, axis="data",
                 **kwargs):
        self.grid = grid if grid is not None else build_mesh(
            device=trainer_device(model, kwargs.get("device")))
        self.axis = axis
        self.batch_axis = self.grid.axis(axis)
        n_shards = self.batch_axis.size
        mb = loader.max_minibatch_size
        if mb % n_shards:
            raise ValueError(
                "minibatch size %d does not divide over the %r mesh axis "
                "(%d shards); pick a minibatch the pod's every reachable "
                "world size divides, or a smaller mesh"
                % (mb, axis, n_shards))
        self.reduce_gradients = True
        self._data_spec = named_sharding(self.grid, axis)
        self._rows_per_rank = -(-loader.original_data.shape[0] // n_shards)
        super(DataParallelTrainer, self).__init__(model, loader, hypers,
                                                  **kwargs)

    # -- the row-sharded dataset -------------------------------------------

    def _dataset_device_bytes(self, total_bytes):
        return total_bytes / self.batch_axis.size

    def _shard_placer(self):
        return prefetch.sharded_placer(self._data_spec)

    def _columns(self, idx):
        """This rank's columns of the index matrix (or row) ``idx``."""
        return collectives.local_part(idx, self.batch_axis, idx.ndim - 1)

    def _stream_segment(self, kind, idx, run_shard):
        import numpy
        return super(DataParallelTrainer, self)._stream_segment(
            kind, numpy.ascontiguousarray(self._columns(
                torch.from_numpy(idx)).numpy()), run_shard)

    def _gather(self, indices, data_args=None):
        """(x, truth, valid) of this rank's columns of the minibatch row
        ``indices``: gathered from a streamed shard (its columns
        already), or exchanged from the row-sharded dataset."""
        if data_args is not None:
            return self.loader.gather_from(data_args, indices)
        axis = self.batch_axis
        n, r = axis.size, axis.index
        per = self._rows_per_rank
        cols = indices.shape[0] // n
        idx = indices.long()
        owner = torch.where(idx >= 0, idx // per, -1)
        local = torch.where(owner == r, idx - r * per, -1)
        rows, truth, _ = self.loader.gather_from(self._data_args,
                                                 local.to(indices.dtype))
        if n > 1:
            rows = collectives.all_to_all(rows, axis, 0, 0)
            truth = collectives.all_to_all(truth, axis, 0, 0)
        mine = owner.view(n, cols)[r]
        pick = mine.clamp(min=0) * cols + torch.arange(
            cols, device=mine.device)
        valid = idx.view(n, cols)[r] >= 0
        return rows.index_select(0, pick), truth.index_select(0, pick), valid

    # -- the whole minibatch's reductions ----------------------------------

    def _per_sample(self, out, truth, valid):
        axis = self.batch_axis
        if axis.size == 1:
            return out, truth, valid
        out = collectives.GatherFromAxis.apply(out, axis, 0)
        truth = collectives.all_gather(truth, axis, 0)
        valid = collectives.all_gather(valid.to(torch.uint8), axis,
                                       0).bool()
        return out, truth, valid

    def _uniforms(self, x, seed, batch_index, i):
        """This rank's rows of the standalone mask's uniforms (the fill
        at the whole minibatch's shape)."""
        shape = (x.shape[0] * self.batch_axis.size,) + tuple(x.shape[1:])
        return collectives.local_part(dropout_uniforms(
            shape, seed, batch_index, i, x.device, self.uniform_source,
            self.plain), self.batch_axis, 0)

    def _reduce_gradients(self):
        """The sum of the ranks' gradients over the axis, one all_reduce
        of all of them."""
        self._reduce_gradient_list(
            [p.grad for params in self.params for p in params.values()])

    def _reduce_gradient_list(self, grads):
        """The sum of the ranks' ``grads`` over the axis, in place, one
        all_reduce of all of them."""
        if not self.reduce_gradients or self.batch_axis.size == 1 or \
                not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        collectives.all_reduce(flat, self.batch_axis)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    # -- parameters ----------------------------------------------------------

    def param_specs(self):
        """Each layer's {parameter: :class:`Sharding`}: replicated."""
        repl = replicated(self.grid)
        return [{k: repl for k in params} for params in self.params]

    def pull_params(self):
        """(params, states), every tensor whole, gathered through the
        measured reshard seam from its placement."""
        params, states = super(DataParallelTrainer, self).pull_params()
        specs = self.param_specs()
        repl = replicated(self.grid)
        return (reshard.reshard_tree(params, repl, specs),
                [_map_state(s, spec, lambda v, sp: reshard.reshard(
                    v, repl, sp)) for s, spec in zip(states, specs)])

    def _record_leaf(self, i, name, tensor):
        """This rank's block of one checkpoint leaf of layer ``i`` (a
        parameter, a solver state leaf kept per parameter ``name``, or a
        scalar, replicated) as a :class:`~veles_tpu_torch.snapshotter.
        ShardedLeaf` in the JAX layout: the global shape, and the block
        with its global index when this rank is the leaf's first replica
        (no shard otherwise)."""
        from veles_tpu_torch.snapshotter import ShardedLeaf
        like = self.params[i].get(name)
        sharding = self.param_specs()[i][name] \
            if like is not None and like.shape == tensor.shape \
            else replicated(self.grid)
        spec = list(sharding.spec) + [None] * tensor.dim()
        index, shape, split = [], [], set()
        for d, n in enumerate(tensor.shape):
            if spec[d] is None:
                index.append(slice(None))
                shape.append(n)
                continue
            axis = self.grid.axis(spec[d])
            split.add(spec[d])
            index.append(slice(axis.index * n, (axis.index + 1) * n))
            shape.append(n * axis.size)
        first = all(self.grid.coords[a] == 0 for a in self.grid.axis_names
                    if a not in split)
        shards = [(jax_index(tuple(index)), jax_layout(
            tensor.detach().float().cpu().numpy()))] if first else []
        return ShardedLeaf(jax_index(tuple(shape)), "float32", shards)

    def push_params(self, params, states):
        """Load whole ``params`` and ``states``: each rank keeps its
        block of each, through the reshard seam."""
        specs = self.param_specs()
        repl = replicated(self.grid)
        super(DataParallelTrainer, self).push_params(
            reshard.reshard_tree(params, specs, repl),
            [_map_state(s, spec, lambda v, sp: reshard.reshard(
                v, sp, repl)) for s, spec in zip(states, specs)])


def _map_state(state, specs, fn):
    """A solver state with ``fn(tensor, spec)`` applied to each tensor
    kept per parameter (``velocity[k]``, ...); scalars (``step``) kept."""
    if isinstance(state, dict):
        if state and set(state) <= set(specs) and all(
                isinstance(v, torch.Tensor) for v in state.values()):
            return {k: fn(v, specs[k]) for k, v in state.items()}
        return {k: _map_state(v, specs, fn) for k, v in state.items()}
    return state
