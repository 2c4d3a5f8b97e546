"""Parameter update rules (``veles_tpu/nn/optim.py``).

Written out as the JAX package writes them, in the same order of
operations, which is not ``torch.optim``'s. Every rule adds the weight
decay to the gradient first (``g' = g + weight_decay * p``, biases too),
and takes its rate from ``hp["learning_rate"]`` or, for a parameter named
in ``hp["lr_overrides"]`` (the bias, from ``learning_rate_bias``), its
override:

* :class:`SGD` -- ``v = momentum * v - lr * lr_decay**step * g'``,
  ``p = p + v``; the learning rate lives inside the velocity, and
  ``lr_decay`` rides a float32 step counter. State ``{"velocity":
  {name: tensor}, "step": float32 scalar}``;
* :class:`AdaGrad` -- ``a = a + g'^2``, ``p = p - lr * g' / (sqrt(a) +
  eps)``, eps 1e-8. State ``{"accum": {...}}``;
* :class:`AdaDelta` -- ``ag = rho * ag + (1 - rho) * g'^2``, ``dx =
  -sqrt(adx + eps) / sqrt(ag + eps) * g'``, ``p = p + dx``, ``adx = rho *
  adx + (1 - rho) * dx^2``; rho 0.95, eps 1e-6, no learning rate. State
  ``{"accum_g": {...}, "accum_dx": {...}}``;
* :class:`Adam` -- ``t = t + 1`` (float32), ``c = sqrt(1 - b2**t) / (1
  - b1**t)`` with the powers taken in float32 on ``t``'s device as
  ``jnp`` takes them, ``m = b1 * m + (1 - b1) * g'``, ``v = b2 * v + (1 -
  b2) * g'^2``, ``p = p - lr * c * m / (sqrt(v) + eps)``; b1 0.9, b2
  0.999, eps 1e-8. State ``{"m": {...}, "v": {...}, "t": float32}``.

``hp`` may set ``epsilon``, ``rho``, ``beta1`` and ``beta2``.

Unlike the JAX package's pure functions, ``update`` changes the
parameters and the state IN PLACE under ``torch.no_grad()``: the
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


class AdaGrad(object):
    """Accumulated squared gradients scale each step."""

    name = "adagrad"

    @staticmethod
    def init(params):
        return {"accum": _zeros_like(params)}

    @staticmethod
    def update(params, grads, state, hp):
        wd = hp.get("weight_decay", 0.0)
        eps = hp.get("epsilon", 1e-8)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] + wd * p
                a = state["accum"][k]
                a.add_(torch.square(g))
                p.sub_(_lr_for(hp, k) * g / (torch.sqrt(a) + eps))


class AdaDelta(object):
    """Steps scaled by the ratio of running RMS of steps and gradients."""

    name = "adadelta"

    @staticmethod
    def init(params):
        return {"accum_g": _zeros_like(params),
                "accum_dx": _zeros_like(params)}

    @staticmethod
    def update(params, grads, state, hp):
        rho = hp.get("rho", 0.95)
        eps = hp.get("epsilon", 1e-6)
        wd = hp.get("weight_decay", 0.0)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k] + wd * p
                ag, adx = state["accum_g"][k], state["accum_dx"][k]
                ag.mul_(rho).add_((1 - rho) * torch.square(g))
                dx = -torch.sqrt(adx + eps) / torch.sqrt(ag + eps) * g
                p.add_(dx)
                adx.mul_(rho).add_((1 - rho) * torch.square(dx))


class Adam(object):
    """Bias-corrected first and second moments."""

    name = "adam"

    @staticmethod
    def init(params):
        device = next(iter(params.values())).device
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "t": torch.zeros((), dtype=torch.float32, device=device)}

    @staticmethod
    def update(params, grads, state, hp):
        b1 = hp.get("beta1", 0.9)
        b2 = hp.get("beta2", 0.999)
        eps = hp.get("epsilon", 1e-8)
        wd = hp.get("weight_decay", 0.0)
        t = state["t"]
        with torch.no_grad():
            t.add_(1.0)
            one = torch.ones((), dtype=torch.float32, device=t.device)
            correction = torch.sqrt(one - torch.pow(b2 * one, t)) / (
                one - torch.pow(b1 * one, t))
            for k, p in params.items():
                g = grads[k] + wd * p
                m, v = state["m"][k], state["v"][k]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * torch.square(g))
                p.sub_(_lr_for(hp, k) * correction * m /
                       (torch.sqrt(v) + eps))


def _zeros_like(params):
    return {k: torch.zeros_like(p) for k, p in params.items()}


SOLVERS = {cls.name: cls for cls in (SGD, AdaGrad, AdaDelta, Adam)}


def get_solver(name):
    """The update rule by name, or a rule class itself."""
    if isinstance(name, type) and name in SOLVERS.values():
        return name
    try:
        return SOLVERS[name]
    except (KeyError, TypeError):
        raise ValueError("unknown solver %r (have %s)" %
                         (name, sorted(SOLVERS)))
