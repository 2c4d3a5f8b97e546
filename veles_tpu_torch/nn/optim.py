"""Parameter update rules (``veles_tpu/nn/optim.py``).

SGD only, written out as the JAX package writes it, which is not
``torch.optim.SGD``: the learning rate lives inside the velocity, the
weight decay applies to every parameter (biases too), and ``lr_decay``
scales the rate by ``lr_decay ** step`` with a float32 step counter:

    g' = g + weight_decay * p
    v  = momentum * v - lr * lr_decay**step * g'
    p  = p + v

``lr`` is the layer's ``learning_rate`` or, for a parameter named in
``hp["lr_overrides"]`` (the bias, from ``learning_rate_bias``), its
override. State per layer: ``{"velocity": {name: tensor}, "step":
float32 scalar}``.

Unlike the JAX package's pure functions, :meth:`SGD.update` updates the
parameters, velocities and step IN PLACE under ``torch.no_grad()``: the
optimizer state of AlexNet is as large as its weights, and a copy per
step would double it.
"""

import torch


def _lr_for(hp, key):
    overrides = hp.get("lr_overrides")
    if overrides and overrides.get(key) is not None:
        return overrides[key]
    return hp["learning_rate"]


class SGD(object):
    """Classical momentum and L2 weight decay, as the JAX ``SGD``."""

    name = "sgd"

    @staticmethod
    def init(params):
        device = next(iter(params.values())).device
        return {"velocity": {k: torch.zeros_like(p)
                             for k, p in params.items()},
                "step": torch.zeros((), dtype=torch.float32,
                                    device=device)}

    @staticmethod
    def update(params, grads, state, hp):
        """One step over ``params`` ({name: parameter}) with ``grads``
        ({name: gradient}), in place."""
        wd = hp.get("weight_decay", 0.0)
        mom = hp.get("momentum", 0.0)
        decay = hp.get("lr_decay", 1.0)
        step = state["step"]
        with torch.no_grad():
            scale = None
            if decay != 1.0:
                scale = torch.pow(torch.tensor(decay, dtype=torch.float32,
                                               device=step.device), step)
            for k, p in params.items():
                g = grads[k] + wd * p
                lr = _lr_for(hp, k)
                rate = lr if scale is None else lr * scale
                v = state["velocity"][k]
                v.mul_(mom).sub_(rate * g)
                p.add_(v)
            step.add_(1.0)


_LATER = ("adagrad", "adadelta", "adam")


def get_solver(name):
    """The update rule by name: ``sgd``; the JAX package's other rules
    raise until they are ported."""
    if name == SGD.name:
        return SGD
    if name in _LATER:
        raise NotImplementedError("solver %r is not ported yet (have sgd)"
                                  % name)
    raise ValueError("unknown solver %r (have sgd)" % (name,))
