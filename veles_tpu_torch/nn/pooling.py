"""Max pooling over NHWC activations (``veles_tpu/nn/pooling.py``).

VALID windows of ``(ky, kx)`` with stride ``(sliding[1], sliding[0])``
for (H, W); ``sliding`` defaults to the window. ``F.max_pool2d`` on an
NCHW view in channels_last memory, permuted back to NHWC. The gradient
is torch's own (``max_pool2d``'s backward), as the JAX package leaves
it to XLA's ``reduce_window`` VJP; both route a window's gradient to its
first maximum in row-major order, so windows of equal values (the
zeros of a strict ReLU) route alike.
"""

import torch.nn.functional as F

from veles_tpu_torch.nn.base import ForwardBase


class MaxPooling(ForwardBase):
    def __init__(self, input_shape, kx=2, ky=2, sliding=None,
                 policy="float32"):
        input_shape = tuple(input_shape)
        if len(input_shape) == 2:
            input_shape += (1,)
        super(MaxPooling, self).__init__(input_shape, policy)
        self.kx, self.ky = int(kx), int(ky)
        self.sliding = tuple(sliding) if sliding else (self.kx, self.ky)
        self.stride = (int(self.sliding[1]), int(self.sliding[0]))

    def output_shape(self):
        h, w, c = self.input_shape
        sh, sw = self.stride
        return ((h - self.ky) // sh + 1, (w - self.kx) // sw + 1, c)

    def forward(self, x):
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        y = F.max_pool2d(x.permute(0, 3, 1, 2), (self.ky, self.kx),
                         self.stride)
        return y.permute(0, 2, 3, 1).contiguous()
