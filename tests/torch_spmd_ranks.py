"""Rank programs of the port's SPMD tests, run by
``tests/torch_world.py`` ``run_world`` in processes of their own.

This module imports torch and the port only: a rank loads neither jax
nor any ``veles_tpu`` module (the tests check the ranks' reports). Each
function takes numpy inputs made by the test process and returns numpy
results; the world it runs in is already joined.
"""

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.convert import to_jax_layout
from veles_tpu_torch.loader.base import TRAIN
from veles_tpu_torch.models.alexnet import (ALEXNET_TRAINING,
                                            SyntheticImageLoader)
from veles_tpu_torch.models.build import build_model, layer_hypers
from veles_tpu_torch.parallel import collectives, mesh, reshard
from veles_tpu_torch.train.step import FusedTrainer

#: the nets, data and seeds of tests/test_torch_spmd.py
SAMPLE = (21, 21, 3)
LOADER = dict(n_train=40, n_valid=16, side=21, n_classes=10,
              minibatch_size=16)
WEIGHT_SEED, LOADER_SEED = 7, 8


class RecordedUniforms(object):
    """A dropout uniform source replaying a table of (epoch, batch,
    layer) -> uniforms of the whole minibatch's shape; epochs are the
    order in which the trainer's seeds first appear."""

    def __init__(self, table):
        self.table = table
        self.epochs = {}

    def __call__(self, shape, seed, batch_index, layer_index, device):
        epoch = self.epochs.setdefault(seed, len(self.epochs))
        values = self.table[(epoch, batch_index, layer_index)]
        if tuple(values.shape) != tuple(shape):
            raise ValueError("uniforms of %s asked, %s recorded"
                             % (tuple(shape), values.shape))
        return torch.from_numpy(values).to(device)


def trainer(layers, params, table, cls=FusedTrainer, **kwargs):
    """``cls`` over the tests' loader and seeds, from JAX-layout
    ``params``, dropout from ``table``."""
    prng.get().seed(WEIGHT_SEED)
    prng.get("loader").seed(LOADER_SEED)
    device = mesh.world_device() or "cpu"
    model = build_model(layers, SAMPLE, params=params, device=device,
                        trainable=True)
    return cls(model, SyntheticImageLoader(**LOADER).initialize(),
               layer_hypers(layers, **ALEXNET_TRAINING),
               uniform_source=RecordedUniforms(table), device=device,
               **kwargs)


def whole_grads(t):
    """Each layer's gradients whole, JAX layout (gathered over the
    model axis where the trainer shards them)."""
    specs = t.param_specs() if hasattr(t, "param_specs") else None
    out = []
    for i, layer in enumerate(t.params):
        grads = {}
        for k, p in layer.items():
            g = p.grad
            if specs is not None:
                g = reshard.reshard(g, mesh.replicated(t.grid), specs[i][k])
            grads[k] = g
        out.append(to_jax_layout(grads))
    return out


def run_state(t, history):
    """(per-epoch train and validation losses, whole params, JAX
    layout) after a run."""
    params, _ = t.pull_params()
    return {"train": [h["train"]["losses"] for h in history],
            "validation": [h["validation"]["losses"] for h in history],
            "means": [[h[k]["loss"] for k in ("train", "validation")]
                      for h in history],
            "params": [to_jax_layout(p) for p in params]}


def gspmd_case(layers, params, table, batch, model, reduce=True,
               epochs=2, axis=None, **kwargs):
    """One batch's gradients, then ``epochs`` of training, by the
    GSPMD trainer on a batch x model grid (``axis``: the
    ``DataParallelTrainer`` on a grid of that one axis instead);
    ``reduce=False`` skips the gradient all_reduce (the control);
    ``kwargs`` go to the trainer (``stream=True``)."""
    from veles_tpu_torch.parallel.dp import DataParallelTrainer
    from veles_tpu_torch.parallel.gspmd import GSPMDTrainer, gspmd_mesh
    if axis is None:
        grid = gspmd_mesh(batch, model)
        t = trainer(layers, params, table, GSPMDTrainer, grid=grid,
                    **kwargs)
    else:
        grid = mesh.build_mesh({axis: batch})
        t = trainer(layers, params, table, DataParallelTrainer, grid=grid,
                    axis=axis, **kwargs)
    t.reduce_gradients = reduce
    idx = t._segment_indices(TRAIN)[:1]
    if t.streaming:
        t._stream_segment("train", idx, lambda data, local, row0:
                          t.gradients(local[0], 0, 0, data))
    else:
        t.gradients(torch.from_numpy(idx[0]).to(t.device), 0, 0)
    grads = whole_grads(t)
    for params_ in t.params:
        for p in params_.values():
            p.grad = None
    # a fresh uniform epoch count: the step above drew with seed 0
    t.uniform_source.epochs.clear()
    state = run_state(t, t.train(max_epochs=epochs))
    state["grads"] = grads
    state["rows_on_device"] = None if t.streaming else int(
        t._data_args[0].shape[0])
    state["streaming"] = t.streaming
    state["rank"] = mesh.world_rank()
    return state


def cases(specs):
    """:func:`gspmd_case` for each (name, args, kwargs) of ``specs``,
    every rank running them all in order."""
    return {name: gspmd_case(*args, **kwargs) for name, args, kwargs in specs}


def reshard_case(seed):
    """Round trips through the reshard seam on a batch x model grid,
    the placer's padding and the layout labels."""
    from veles_tpu_torch.loader.prefetch import sharded_placer
    grid = mesh.build_mesh({"batch": -1, "model": 1})
    tp = mesh.build_mesh({"batch": 1, "model": -1})
    rng = numpy.random.RandomState(seed)
    whole = torch.from_numpy(rng.randn(6, 4, 8).astype(numpy.float32))
    repl = mesh.replicated(tp)
    split = mesh.named_sharding(tp, None, None, "model")
    block = reshard.reshard(whole, split)
    back = reshard.reshard(block, repl, split)
    rows = torch.arange(7 * 3, dtype=torch.float32).reshape(7, 3)
    placed = sharded_placer(mesh.named_sharding(grid, "batch"))(rows)
    host = reshard.gather_to_host(block, split)
    labels = sorted({labels["src"] + ">" + labels["dst"]
                     for labels, _ in reshard.reshard_histogram().series()})
    return {"block": block.numpy(), "back": back.numpy(),
            "host": host.numpy(),
            "whole": whole.numpy(), "placed": placed.numpy(),
            "labels": labels,
            "label_of": [reshard.layout_label(s) for s in (
                repl, split, mesh.named_sharding(grid, "batch"),
                mesh.named_sharding(tp, None, "model"), None)]}


def linear_case(x, w_col, w_row):
    """``shard_map_linear`` on a model axis of the world."""
    from veles_tpu_torch.parallel.tp import shard_map_linear
    grid = mesh.build_mesh({"model": -1})
    axis = grid.axis("model")
    wc = collectives.local_part(torch.from_numpy(w_col), axis, 1)
    wr = collectives.local_part(torch.from_numpy(w_row), axis, 0)
    return shard_map_linear(torch.from_numpy(x), wc.contiguous(),
                            wr.contiguous(), axis, "strict_relu").numpy()


def world_cases(specs, linear):
    """Every case of tests/test_torch_spmd.py's world, in one order on
    every rank."""
    from veles_tpu_torch.parallel.dp import DataParallelTrainer
    out = {"trainers": cases(specs), "reshard": reshard_case(3),
           "linear": linear_case(*linear)}
    layers, params, table = specs[0][1][:3]
    try:
        loader = dict(LOADER, minibatch_size=15)
        DataParallelTrainer(
            build_model(layers, SAMPLE, params=params, device="cpu",
                        trainable=True),
            SyntheticImageLoader(**loader).initialize(),
            layer_hypers(layers), grid=mesh.build_mesh({"data": 2}))
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    spec = mesh._MULTIHOST["spec"]
    same = mesh.init_multihost(*spec)
    try:
        mesh.init_multihost(spec[0], spec[1], 1 - spec[2])
        other = None
    except RuntimeError as e:
        other = type(e).__name__
    out["multihost"] = [same, other]
    return out


def dead_peer_case():
    """Rank 1 dies right after the world formed; rank 0 all-reduces
    with it and must fail, not hang."""
    import os
    grid = mesh.build_mesh({"data": -1})
    if grid.rank == 1:
        os._exit(3)
    collectives.all_reduce(torch.ones(4), grid.axis("data"))


def dp_offload_case(layers, params, table, group_mb, epochs=2):
    """``epochs`` of the ``DataParallelTrainer`` over every rank of the
    world, the model state resident, then offloaded in layer groups of
    ``group_mb`` MB: the two run states."""
    import os
    from veles_tpu_torch.parallel.dp import DataParallelTrainer
    os.environ["VELES_OFFLOAD_GROUP_MB"] = str(group_mb)
    out = {}
    for name, offload in (("resident", False), ("offloaded", True)):
        grid = mesh.build_mesh({"data": mesh.world_size()})
        t = trainer(layers, params, table, DataParallelTrainer, grid=grid,
                    axis="data", offload=offload)
        state = run_state(t, t.train(max_epochs=epochs))
        state["offloaded"] = t.offloaded
        state["groups"] = t._offload_engine.plan.n_groups \
            if t.offloaded else 0
        t.shutdown()
        out[name] = state
    return out
