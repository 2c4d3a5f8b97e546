"""Rank programs of the port's sequence- and pipeline-parallel tests,
run by ``tests/torch_world.py`` ``run_world`` in processes of
their own. Imports torch and the port only."""

import contextlib

import numpy
import torch

from veles_tpu_torch.parallel import mesh
from veles_tpu_torch.parallel.collectives import (AllToAll, CopyToAxis,
                                                  all_to_all, local_part)


def _t(a, grad=False):
    t = torch.from_numpy(numpy.asarray(a))
    return t.requires_grad_() if grad else t


class LocalAllToAll(AllToAll):
    """:class:`AllToAll` whose backward keeps only the part this rank
    sent itself: an inverse all_to_all that drops the other ranks'
    terms."""

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        back = all_to_all(g, axis, concat_dim, split_dim)
        kept = torch.zeros_like(back)
        local_part(kept, axis, split_dim).copy_(
            local_part(back, axis, split_dim))
        return kept, None, None, None


@contextlib.contextmanager
def dropped_term(schedule):
    """A sharded backward that drops a term, the control that must fail:
    the ring's reverse ring without the dK/dV it carries (each K/V block
    keeps only its last hop's contribution), Ulysses's inverse
    all_to_alls without the other ranks' parts. The forward is
    unchanged."""
    from veles_tpu_torch.parallel import sequence
    saved = sequence.ring_shift, sequence.AllToAll

    def shift(tensors, axis, step=1):
        got = saved[0](tensors, axis, step)
        if len(tensors) == 4:   # the reverse ring's (K, V, dK, dV)
            got[2:] = [torch.zeros_like(t) for t in got[2:]]
        return got

    if schedule == "ring":
        sequence.ring_shift = shift
    else:
        sequence.AllToAll = LocalAllToAll
    try:
        yield
    finally:
        sequence.ring_shift, sequence.AllToAll = saved


class _Unreduced(object):
    """:class:`CopyToAxis` without its backward all_reduce."""

    @staticmethod
    def apply(x, axis):
        return CopyToAxis.apply(x, axis, False)


@contextlib.contextmanager
def router_unreduced():
    """The expert-parallel backward without the sum of the router's
    gradient over the ranks, the control that must fail: each rank keeps
    its own shard's part."""
    from veles_tpu_torch.parallel import ep
    saved = ep.CopyToAxis
    ep.CopyToAxis = _Unreduced
    try:
        yield
    finally:
        ep.CopyToAxis = saved


def attention_case(q, k, v, cotangent, causal, schedule, control=False):
    """This world's ring or Ulysses attention of the whole (B, H, S, D)
    q, k, v, each rank its sequence block: (output, dq, dk, dv) whole,
    the gradients of ``sum(out * cotangent)``; ``control`` under
    :func:`dropped_term`."""
    from veles_tpu_torch.parallel.sequence import (ring_attention,
                                                   ulysses_attention)
    grid = mesh.build_mesh({"seq": -1})
    seq = grid.axis("seq")
    n, me = seq.size, seq.index
    block = q.shape[2] // n
    cut = slice(me * block, (me + 1) * block)
    blocks = [_t(t[:, :, cut], grad=True) for t in (q, k, v)]
    fn = ring_attention if schedule == "ring" else ulysses_attention
    with dropped_term(schedule) if control else contextlib.nullcontext():
        out = fn(*blocks, grid, causal=causal)
        (out * _t(cotangent[:, :, cut])).sum().backward()
    from veles_tpu_torch.parallel.collectives import all_gather
    whole = [all_gather(t.detach(), seq, 2).numpy()
             for t in [out] + [b.grad for b in blocks]]
    return whole


def attention_cases(specs):
    return {name: attention_case(*args) for name, args in specs}


def moe_case(x, router_w, w_up, w_down, cotangent, capacity_factor,
             control=False):
    """This world's expert-parallel ``moe_ffn`` over the whole tokens
    ``x`` (each rank its shard, its expert): (output, dx, d router, d up,
    d down) whole, the gradients of ``sum(out * cotangent)``;
    ``control`` under :func:`router_unreduced`."""
    from veles_tpu_torch.parallel.collectives import all_gather
    from veles_tpu_torch.parallel.ep import moe_ffn
    grid = mesh.build_mesh({"expert": -1})
    experts = grid.axis("expert")
    n, me = experts.size, experts.index
    t = x.shape[0] // n
    xs = _t(x[me * t:(me + 1) * t], grad=True)
    rw = _t(router_w, grad=True)
    up = _t(w_up[me], grad=True)
    down = _t(w_down[me], grad=True)
    with router_unreduced() if control else contextlib.nullcontext():
        out = moe_ffn(xs, rw, up, down, grid,
                      capacity_factor=capacity_factor)
        (out * _t(cotangent[me * t:(me + 1) * t])).sum().backward()
    return [all_gather(out.detach(), experts, 0).numpy(),
            all_gather(xs.grad, experts, 0).numpy(), rw.grad.numpy(),
            all_gather(up.grad[None], experts, 0).numpy(),
            all_gather(down.grad[None], experts, 0).numpy()]


def pipeline_case(params, xs, ys, lr):
    """The homogeneous pipeline on this world's ``pipe`` axis: outputs,
    then a training step; this rank's stage is ``params[stage]``."""
    from veles_tpu_torch.parallel.pp import (pipeline_apply,
                                             pipeline_train_step)
    grid = mesh.build_mesh({"pipe": -1})
    stage = grid.axis("pipe").index

    def stage_fn(w, x):
        return torch.tanh(torch.matmul(x, w))

    def loss_fn(out, y):
        return torch.mean(torch.square(out - y))

    w = _t(params[stage])
    out = pipeline_apply(stage_fn, w, _t(xs), grid).numpy()
    losses = []
    for _ in range(3):
        w, loss = pipeline_train_step(stage_fn, w, _t(xs), _t(ys), loss_fn,
                                      grid, learning_rate=lr)
        losses.append(float(loss))
    return {"out": out, "losses": losses, "stage": stage,
            "params": w.numpy()}


#: the sequence data of tests/test_torch_sequence_parallel.py
PROVIDER = dict(n_train=40, n_valid=12, seq=8, dim=16)
WEIGHT_SEED, LOADER_SEED = 41, 42


def attach(model, schedule=None, experts=False):
    """``use_ring`` on every attention layer over the world's ``seq``
    axis (``schedule``), ``use_experts`` on every moe layer over its
    ``expert`` axis."""
    from veles_tpu_torch.nn.attention import MultiHeadAttentionForward
    from veles_tpu_torch.nn.moe import MoEForward
    seq = mesh.build_mesh({"seq": -1}) if schedule else None
    expert = mesh.build_mesh({"expert": -1}) if experts else None
    for module in model:
        if schedule and isinstance(module, MultiHeadAttentionForward):
            module.use_ring(seq, "seq", schedule)
        if experts and isinstance(module, MoEForward):
            module.use_experts(expert)


def unit_case(layer, params, sample, x, cotangent, schedule=None,
              experts=False):
    """One layer with its sharded plan attached: (output, the gradients
    of its parameters by name, the input's gradient) of ``sum(out *
    cotangent)``."""
    from veles_tpu_torch.convert import layer_params
    from veles_tpu_torch.models.build import build_model
    model = build_model([layer], sample, params=[params], device="cpu",
                        trainable=True)
    attach(model, schedule, experts)
    xt = _t(x, grad=True)
    out = model(xt)
    (out * _t(cotangent)).sum().backward()
    return (out.detach().numpy(),
            {k: p.grad.numpy() for k, p in layer_params(model[0]).items()},
            xt.grad.numpy())


def workflow_case(moe, params, schedule, epochs=2):
    """``samples.sequence`` trained ``epochs`` by the fused trainer with
    the sharded plans attached: per-epoch (validation, train) losses and
    the parameters (JAX layout)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.convert import params_to_jax
    from veles_tpu_torch.models import samples
    from veles_tpu_torch.models.build import build_training
    prng.get().seed(WEIGHT_SEED)
    prng.get("loader").seed(LOADER_SEED)
    sample = samples.sequence(samples.SequenceProvider(**PROVIDER),
                              minibatch_size=16, heads=4, moe=moe,
                              n_experts=4)
    t = build_training(sample.layers, sample.sample_shape, sample.loader,
                       params=params, device="cpu", **sample.training)
    attach(t.model, schedule, moe)
    losses = []
    for epoch in range(epochs):
        stats = t.run_epoch(epoch)
        losses.append((stats["validation"]["losses"],
                       stats["train"]["losses"]))
    return {"losses": losses, "params": params_to_jax(t.model)}


def sequence_world(attention, units, workflows, moe=None):
    """Every case of one world of tests/test_torch_sequence_parallel.py,
    in one order on every rank."""
    out = {"attention": attention_cases(attention),
           "units": {name: unit_case(*args, **kw)
                     for name, args, kw in units},
           "workflows": {name: workflow_case(*args)
                         for name, args in workflows}}
    if moe is not None:
        out["moe"] = moe_case(*moe)
        out["moe control"] = moe_case(*moe, control=True)
    return out


def _trunk_conv(p, x):
    """The trunk's first stage: 3x3 conv (OIHW) + bias, relu, 2x2
    max-pool, NHWC in and out."""
    import torch.nn.functional as F
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"], p["b"])
    return F.max_pool2d(torch.relu(y), 2).permute(0, 2, 3, 1)


def _trunk_fc(p, x):
    """The trunk's second stage: flatten (H, W, C order), dense."""
    return torch.matmul(x.reshape(x.shape[0], -1), p["w"]) + p["b"]


def _trunk_loss(out, y):
    return torch.nn.functional.cross_entropy(out, y.long())


def hetero_case(stage_params, xs, ys, lr):
    """The conv -> pool -> fc trunk on this world's 2-stage ``pipe``
    axis: outputs, then a training step of this rank's stage."""
    from veles_tpu_torch.parallel.pp import (hetero_pipeline_apply,
                                             hetero_pipeline_train_step)
    grid = mesh.build_mesh({"pipe": -1})
    stage = grid.axis("pipe").index
    params = [{k: _t(v) for k, v in p.items()} for p in stage_params]
    fns = [_trunk_conv, _trunk_fc]
    out = hetero_pipeline_apply(fns, params, _t(xs), grid).numpy()
    new, loss = hetero_pipeline_train_step(fns, params, _t(xs), _t(ys),
                                           _trunk_loss, grid,
                                           learning_rate=lr)
    return {"out": out, "loss": float(loss), "stage": stage,
            "params": {k: v.numpy() for k, v in new.items()}}


def pipeline_world(homogeneous, hetero, flagship):
    return {"homogeneous": pipeline_case(*homogeneous),
            "hetero": hetero_case(*hetero),
            "flagship": flagship_case(*flagship)}


class _Group(torch.nn.Module):
    """A run of the port's layers as one stage: dropout the identity,
    the softmax head's logits when it ends the chain."""

    def __init__(self, modules, logits):
        super(_Group, self).__init__()
        self.layers = torch.nn.ModuleList(modules)
        self.logits = logits

    def forward(self, x):
        last = len(self.layers) - 1
        for i, module in enumerate(self.layers):
            if self.logits and i == last:
                x = module.logits(x)
            else:
                x = module(x)
        return x


def flagship_case(layers, sample, params, split, xs, ys, lr):
    """The small AlexNet's conv -> pool -> conv -> pool | fc -> dropout
    -> softmax trunk (JAX-layout ``params``) cut at layer ``split`` over
    this world's 2-stage ``pipe`` axis: outputs, loss and this rank's
    stage after one SGD step (JAX layout)."""
    from veles_tpu_torch.convert import to_jax_layout
    from veles_tpu_torch.models.build import build_model
    from veles_tpu_torch.parallel.pp import (hetero_pipeline_apply,
                                             hetero_pipeline_train_step)
    model = list(build_model(layers, sample, params=params, device="cpu"))
    groups = [_Group(model[:split], False), _Group(model[split:], True)]
    stage_params = [{k: p.detach() for k, p in g.named_parameters()}
                    for g in groups]
    fns = [lambda p, x, g=g: torch.func.functional_call(g, p, (x,))
           for g in groups]
    grid = mesh.build_mesh({"pipe": -1})
    stage = grid.axis("pipe").index
    out = hetero_pipeline_apply(fns, stage_params, _t(xs), grid).numpy()
    new, loss = hetero_pipeline_train_step(fns, stage_params, _t(xs),
                                           _t(ys), _trunk_loss, grid,
                                           learning_rate=lr)
    mine = []
    for j, module in enumerate(groups[stage].layers):
        names = [k for k in new if k.startswith("layers.%d." % j)]
        mine.append(to_jax_layout({k.split(".")[-1]: new[k]
                                   for k in names}))
    return {"out": out, "loss": float(loss), "stage": stage,
            "params": mine}


def _dropped(y, key, rate=0.5):
    """Inverted dropout of ``y`` from K7's fill at the stage's key:
    seed = key[0], offset = (data index, stage, microbatch) packed."""
    from veles_tpu_torch.ops.random import uniform_fill
    seed, d, stage, m = key
    u = uniform_fill((y.shape[0], y[0].numel()), seed,
                     (d << 40) | (stage << 20) | m, device=y.device)
    return y * (u.reshape(y.shape) >= rate).to(y.dtype) / (1 - rate)


def data_pipeline_case(stage_params, xs, ys, lr, seed):
    """The conv -> pool | fc trunk on a 2-stage ``pipe`` x 2-rank
    ``data`` grid: outputs, loss and this rank's stage after one step,
    deterministic (``seed`` None) or with a dropout after each stage."""
    from veles_tpu_torch.parallel.pp import (hetero_pipeline_apply,
                                             hetero_pipeline_train_step)
    grid = mesh.build_mesh({"pipe": 2, "data": 2})
    params = [{k: _t(v) for k, v in p.items()} for p in stage_params]
    if seed is None:
        fns = [_trunk_conv, _trunk_fc]
    else:
        fns = [lambda p, x, key: _dropped(_trunk_conv(p, x), key),
               lambda p, x, key: _dropped(_trunk_fc(p, x), key)]
    out = hetero_pipeline_apply(fns, params, _t(xs), grid,
                                data_axis="data", seed=seed).numpy()
    new, loss = hetero_pipeline_train_step(
        fns, params, _t(xs), _t(ys), _trunk_loss, grid, learning_rate=lr,
        data_axis="data", seed=seed)
    return {"out": out, "loss": float(loss),
            "stage": grid.axis("pipe").index,
            "params": {k: v.numpy() for k, v in new.items()}}


def sequential_dropout(stage_params, xs, ys, lr, seed, n_data=2):
    """The dropout trunk in one process with the pipeline's keys: each
    microbatch cut into the data ranks' blocks; (outputs, loss, the
    stages after one SGD step)."""
    params = [{k: _t(v, grad=True) for k, v in p.items()}
              for p in stage_params]
    fns = [_trunk_conv, _trunk_fc]
    outs = []
    for m in range(xs.shape[0]):
        blocks = list(_t(xs[m]).chunk(n_data))
        for i, fn in enumerate(fns):
            blocks = [_dropped(fn(params[i], b), (seed, d, i, m))
                      for d, b in enumerate(blocks)]
        outs.append(torch.cat(blocks))
    outs = torch.stack(outs)
    loss = torch.stack([_trunk_loss(outs[m], _t(ys[m]))
                        for m in range(xs.shape[0])]).mean()
    leaves = [v for p in params for v in p.values()]
    grads = iter(torch.autograd.grad(loss, leaves))
    new = [{k: (v - lr * next(grads)).detach().numpy()
            for k, v in p.items()} for p in params]
    return outs.detach().numpy(), float(loss.detach()), new


def data_pipeline_world(stage_params, xs, ys, lr, seed):
    return {"deterministic": data_pipeline_case(stage_params, xs, ys, lr,
                                                None),
            "dropout": data_pipeline_case(stage_params, xs, ys, lr, seed),
            "other seed": data_pipeline_case(stage_params, xs, ys, lr,
                                             seed + 1)["out"]}
