"""Inverted dropout (``veles_tpu/nn/dropout.py`` ``DropoutForward``).

At serving and at evaluation dropout is the identity (the module's
``forward``). In training the trainer hands :meth:`DropoutForward.
train_forward` the uniform numbers of the mask, drawn by its uniform
source (by default the Philox fill K7, ``ops/random.py``), and the layer
computes ``x * (u < keep) / keep`` with ``keep = 1 - dropout_ratio``,
as ``apply_with_key`` does with ``jax.random.uniform``. Autograd keeps
the mask for the backward, which multiplies by it again.
"""

from veles_tpu_torch.nn.base import ForwardBase


class DropoutForward(ForwardBase):
    """Identity at serving and evaluation; the inverted-dropout mask of
    given uniforms in training."""

    def __init__(self, input_shape, dropout_ratio=0.5, rand="default",
                 policy="float32"):
        super(DropoutForward, self).__init__(input_shape, policy)
        self.dropout_ratio = dropout_ratio
        #: the random stream (``veles_tpu_torch.prng``) the trainer draws
        #: this layer's mask seeds from, as the JAX unit's ``rand_name``
        self.rand_name = rand

    def forward(self, x):
        return x

    def train_forward(self, x, u):
        """``x * (u < keep) / keep`` for uniforms ``u`` of x's shape."""
        keep = 1.0 - self.dropout_ratio
        return x * (u < keep).to(x.dtype) / keep
