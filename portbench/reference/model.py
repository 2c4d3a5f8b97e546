"""The plain reference: a configuration's layer list trained in plain
PyTorch, with no kernel, cache or batching of the program.

It reads a configuration's layers as the paper or the prototxt defines
them and computes, on NHWC activations:

* ``conv*``: a cross-correlation (``F.conv2d``) plus bias, then the
  layer's activation (``_str``: max(x, 0));
* ``norm``: cross-channel LRN, ``x * (k + alpha * sum over the n
  nearest channels of x^2) ^ -beta``, channels beyond the edge zero;
* ``max_pooling`` / ``avg_pooling``: VALID windows, the max or the mean;
* ``all2all*``: the sample flattened in (h, w, c) order times the (in,
  out) weights plus bias, then the activation;
* ``dropout``: ``x * (u < keep) / keep`` with ``u`` from the frozen
  Philox copy (:mod:`portbench.reference.philox`);
* ``softmax``: float32 logits, and the mean cross-entropy over the
  batch;

then autograd's gradients and SGD with momentum and L2 decay as the
configuration states them: ``g' = g + wd * p``, ``v = momentum * v - lr
* g'``, ``p = p + v``.

A :class:`Precision` says what the products see:

* ``float32``: float32 operands, TF32 off (the float32 policy);
* ``tf32``: the same with TF32 on for matmuls and cuDNN: the control of
  a float32 cell;
* ``bfloat16``: operands bfloat16, products accumulated in float32 and
  rounded once, activations bfloat16 between layers, the logits and the
  loss float32 (the bf16 policy);
* ``fp8``: as ``bfloat16`` with every product's operands rounded to
  float8 e4m3 under a per-tensor scale (amax to 448) on the way in: the
  control of a bfloat16 cell.

It imports nothing of the program.
"""

import contextlib
import math

import torch
import torch.nn.functional as F

from portbench.reference import philox


class Precision(object):
    def __init__(self, name, compute, tf32, fp8):
        self.name = name
        self.compute = compute
        self.tf32 = tf32
        self.fp8 = fp8

    @contextlib.contextmanager
    def switches(self):
        """The backend switches of this precision held for the duration,
        the caller's restored after."""
        matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = (matmul.allow_tf32, cudnn.allow_tf32,
                 matmul.allow_bf16_reduced_precision_reduction)
        matmul.allow_tf32 = cudnn.allow_tf32 = self.tf32
        matmul.allow_bf16_reduced_precision_reduction = False
        try:
            yield
        finally:
            (matmul.allow_tf32, cudnn.allow_tf32,
             matmul.allow_bf16_reduced_precision_reduction) = saved


PRECISIONS = {
    "float32": Precision("float32", torch.float32, False, False),
    "tf32": Precision("tf32", torch.float32, True, False),
    "bfloat16": Precision("bfloat16", torch.bfloat16, False, False),
    "fp8": Precision("fp8", torch.bfloat16, False, True),
}

#: the precision a policy of the program states, and the one below it
#: (the control)
POLICY_PRECISION = {"float32": ("float32", "tf32"),
                    "bfloat16": ("bfloat16", "fp8")}


def _fake_fp8(t):
    """``t`` with its values rounded to float8 e4m3 under a per-tensor
    scale; the gradient passes straight through."""
    scale = 448.0 / t.detach().abs().amax().float().clamp(min=1e-30)
    q = ((t.detach().float() * scale).to(torch.float8_e4m3fn).float()
         / scale).to(t.dtype)
    return t + (q - t).detach()


def _operand(t, prec):
    t = t.to(prec.compute)
    return _fake_fp8(t) if prec.fp8 else t


def _act(kind, y):
    return torch.clamp(y, min=0.0) if kind.endswith("_str") else y


def _pair(value):
    if isinstance(value, (list, tuple)):
        return int(value[0]), int(value[1])
    return int(value), int(value)


def _lrn(x, k, alpha, beta, n):
    xf = x.float()
    sq = F.pad(xf * xf, (n // 2, n // 2))
    channels = x.shape[-1]
    window = sum(sq[..., i:i + channels] for i in range(n))
    return (xf * torch.pow(k + alpha * window, -beta)).to(x.dtype)


def forward(layers, params, x, prec, dropout=None):
    """Logits (float32) of NHWC ``x``. ``params[i]`` holds layer i's
    ``weights`` (JAX layout) and ``bias``; ``dropout`` is ``(seed,
    batch_index)`` in training, None at evaluation."""
    keep_dtype = prec.compute
    x = x.to(keep_dtype)
    last = len(layers) - 1
    for i, descr in enumerate(layers):
        kind = descr["type"]
        if kind.startswith("conv"):
            w = params[i]["weights"].permute(3, 2, 0, 1)      # HWIO->OIHW
            sx, sy = _pair(descr.get("sliding", (1, 1)))
            pad = descr.get("padding", 0)
            pad = (0, 0) if pad == "VALID" else _pair(pad)
            y = F.conv2d(_operand(x, prec).permute(0, 3, 1, 2),
                         _operand(w, prec), None, (sy, sx), pad)
            y = y.permute(0, 2, 3, 1).float() + params[i]["bias"]
            x = _act(kind, y).to(keep_dtype)
        elif kind == "norm":
            x = _lrn(x, float(descr.get("k", 2.0)), float(descr["alpha"]),
                     float(descr["beta"]), int(descr["n"]))
        elif kind.endswith("pooling"):
            kx, ky = int(descr["kx"]), int(descr["ky"])
            sx, sy = _pair(descr.get("sliding", (kx, ky)))
            pool = F.max_pool2d if kind == "max_pooling" else F.avg_pool2d
            x = pool(x.permute(0, 3, 1, 2), (ky, kx),
                     (sy, sx)).permute(0, 2, 3, 1)
        elif kind == "dropout":
            if dropout is not None:
                keep = 1.0 - float(descr["dropout_ratio"])
                u = philox.uniforms(tuple(x.shape), dropout[0], dropout[1],
                                    i, x.device)
                x = x * (u < keep).to(x.dtype) / keep
        elif kind.startswith("all2all") or kind == "softmax":
            flat = x.reshape(x.shape[0], -1)
            y = torch.matmul(_operand(flat, prec).float(),
                             _operand(params[i]["weights"], prec).float())
            y = y + params[i]["bias"]
            if i == last:
                return y
            x = _act(kind, y).to(keep_dtype)
        else:
            raise ValueError("the reference has no layer type %r" % kind)
    raise ValueError("the layer list ends without a softmax head")


def train_epochs(config, prec, weights, epochs):
    """SGD of ``config`` (a configuration file's dict) from ``weights``
    (one ``{"weights", "bias"}`` dict of float32 tensors a layer, ``{}``
    for a layer without) through ``epochs``, each a dict of

    * ``eval``: batches (NHWC data, int labels) evaluated first, with
      no dropout;
    * ``train``: batches trained then, dropout masks of the epoch's
      ``dropout_seed`` at batch index 0, 1, ...

    Returns a dict of

    * ``losses``: each training step's mean cross-entropy (floats);
    * ``eval_losses``: each epoch's evaluation batches' mean
      cross-entropies (lists of floats);
    * ``grad``: {(layer, name): the first step's gradient as the solver
      takes it, g + wd * p};
    * ``raw_grad``: {(layer, name): the first step's g};
    * ``params``: {(layer, name): each parameter after the last step}.
    """
    layers = config["layers"]
    hp = config["training"]
    lr, mom = float(hp["learning_rate"]), float(hp["momentum"])
    wd = float(hp["weights_decay"])
    params = [{k: v.detach().clone().float().requires_grad_(True)
               for k, v in layer.items()} for layer in weights]
    leaves = [(i, k) for i, layer in enumerate(params) for k in sorted(layer)]
    velocity = {leaf: torch.zeros_like(params[leaf[0]][leaf[1]])
                for leaf in leaves}
    out = {"losses": [], "eval_losses": [], "grad": {}, "raw_grad": {}}
    with prec.switches():
        for epoch in epochs:
            with torch.no_grad():
                out["eval_losses"].append([
                    float(F.cross_entropy(forward(layers, params, x, prec)
                                          .float(), labels.long()))
                    for x, labels in epoch["eval"]])
            for step, (x, labels) in enumerate(epoch["train"]):
                logits = forward(layers, params, x, prec,
                                 (epoch["dropout_seed"], step))
                loss = F.cross_entropy(logits.float(), labels.long())
                grads = torch.autograd.grad(
                    loss, [params[i][k] for i, k in leaves])
                first = not out["losses"]
                out["losses"].append(float(loss.detach()))
                with torch.no_grad():
                    for (i, k), g in zip(leaves, grads):
                        p = params[i][k]
                        g_solver = g + wd * p
                        if first:
                            out["grad"][(i, k)] = g_solver.clone()
                            out["raw_grad"][(i, k)] = g.clone()
                        v = velocity[(i, k)]
                        v.mul_(mom).sub_(lr * g_solver)
                        p.add_(v)
    out["params"] = {(i, k): params[i][k].detach() for i, k in leaves}
    values = out["losses"] + [v for e in out["eval_losses"] for v in e]
    if not all(math.isfinite(v) for v in values):
        raise FloatingPointError("the reference's loss is not finite: %s"
                                 % values)
    return out
