"""Local response normalization layer (``veles_tpu/nn/normalization.py``
``LRNormalizerForward``): the AlexNet cross-channel LRN over NHWC
activations, always through :class:`veles_tpu_torch.ops.lrn.LRNFunction`
(the hand-written forward kernel K3 and backward kernel K4 on the
card)."""

from veles_tpu_torch.nn.base import ForwardBase
from veles_tpu_torch.ops.lrn import LRNFunction


class LRNormalizerForward(ForwardBase):
    def __init__(self, input_shape, k=2.0, alpha=1e-4, beta=0.75, n=5,
                 policy="float32"):
        super(LRNormalizerForward, self).__init__(input_shape, policy)
        self.k, self.alpha, self.beta, self.n = k, alpha, beta, n

    def forward(self, x):
        return LRNFunction.apply(x, self.k, self.alpha, self.beta, self.n,
                                 False)

    def plain_forward(self, x):
        return LRNFunction.apply(x, self.k, self.alpha, self.beta, self.n,
                                 True)
