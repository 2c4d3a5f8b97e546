"""Activation functions: the table of ``veles_tpu/nn/activation.py``,
and :class:`ActivationUnit`, the weightless layer that applies one.

Constants are kept exactly: LeCun-scaled tanh ``1.7159 * tanh(0.6666
x)``, and the softplus "relu" that turns linear above 15.
"""

import torch

from veles_tpu_torch.nn.base import ForwardBase


def linear(x):
    return x


def tanh_scaled(x):
    """LeCun-scaled tanh used by Znicz All2AllTanh."""
    return 1.7159 * torch.tanh(0.6666 * x)


def sigmoid(x):
    return torch.sigmoid(x)


def relu_soft(x):
    """Znicz's default "RELU": log(1 + exp(x)), linear above 15."""
    return torch.where(x > 15.0, x,
                       torch.log1p(torch.exp(torch.clamp(x, max=15.0))))


def relu_strict(x):
    return torch.clamp(x, min=0.0)


def leaky_relu(x, alpha=0.01):
    return torch.where(x >= 0, x, alpha * x)


def log_activation(x):
    return torch.log(x + torch.sqrt(x * x + 1.0))


def sincos(x):
    """Znicz ActivationSinCos: odd features sin, even features cos."""
    odd = torch.arange(x.shape[-1], device=x.device) % 2 == 1
    return torch.where(odd, torch.sin(x), torch.cos(x))


ACTIVATIONS = {
    "linear": linear,
    "tanh": tanh_scaled,
    "sigmoid": sigmoid,
    "relu": relu_soft,
    "strict_relu": relu_strict,
    "leaky_relu": leaky_relu,
    "log": log_activation,
    "sincos": sincos,
}


def get_activation(name):
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise ValueError("unknown activation %r (have: %s)" %
                         (name, sorted(ACTIVATIONS)))


class ActivationUnit(ForwardBase):
    """A standalone elementwise activation (``activation``, a name of
    :data:`ACTIVATIONS`): no weights, the output shape of the input,
    applied in the input's dtype as the JAX unit's ``apply`` is."""

    def __init__(self, input_shape, activation="linear", policy="float32"):
        super(ActivationUnit, self).__init__(input_shape, policy)
        self.activation_name = activation
        self._activation = get_activation(activation)

    def forward(self, x):
        return self._activation(x)
