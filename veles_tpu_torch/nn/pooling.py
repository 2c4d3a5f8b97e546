"""Pooling over NHWC activations (``veles_tpu/nn/pooling.py``).

VALID windows of ``(ky, kx)`` with stride ``(sliding[1], sliding[0])``
for (H, W); ``sliding`` defaults to the window. Each layer runs
PyTorch's own pooling on an NCHW view of the NHWC input (channels_last
memory) and permutes back to NHWC; the gradients are torch's own, as the
JAX package leaves all of them to XLA:

* :class:`MaxPooling` -- ``F.max_pool2d``. Its backward and XLA's
  ``reduce_window`` VJP both route a window's gradient to its first
  maximum in row-major order, so windows of equal values (the zeros of a
  strict ReLU) route alike;
* :class:`MaxAbsPooling` -- the value of largest magnitude, from a max
  and a min window: the max where ``max >= -min`` (a tie of +v and -v
  picks +v), else the min, whose gradient goes to the window's first
  minimum, as XLA's min-window VJP routes it;
* :class:`AvgPooling` -- the window sum (``F.avg_pool2d`` with divisor
  1), rounded to the input's dtype, then divided by ``kx * ky`` in that
  dtype: the JAX package's depthwise ones-kernel convolution and
  division. In float32 the two agree to a few ulp; in bfloat16 the sum
  is rounded once in both, from sums taken in different orders, so an
  output may differ by one bf16 rounding;
* :class:`Depooling` -- nearest-neighbour upsampling by ``(ky, kx)``,
  the autoencoder's inverse of a pooling.
"""

import torch
import torch.nn.functional as F

from veles_tpu_torch.nn.base import ForwardBase


class PoolingBase(ForwardBase):
    """Window ``(ky, kx)``, stride ``(sliding[1], sliding[0])``."""

    def __init__(self, input_shape, kx=2, ky=2, sliding=None,
                 policy="float32"):
        input_shape = tuple(input_shape)
        if len(input_shape) == 2:
            input_shape += (1,)
        super(PoolingBase, self).__init__(input_shape, policy)
        self.kx, self.ky = int(kx), int(ky)
        self.sliding = tuple(sliding) if sliding else (self.kx, self.ky)
        self.stride = (int(self.sliding[1]), int(self.sliding[0]))

    def output_shape(self):
        h, w, c = self.input_shape
        sh, sw = self.stride
        return ((h - self.ky) // sh + 1, (w - self.kx) // sw + 1, c)

    @staticmethod
    def _nchw(x):
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        return x.permute(0, 3, 1, 2)

    @staticmethod
    def _nhwc(y):
        return y.permute(0, 2, 3, 1).contiguous()

    def _max(self, x_nchw):
        return F.max_pool2d(x_nchw, (self.ky, self.kx), self.stride)


class MaxPooling(PoolingBase):
    def forward(self, x):
        return self._nhwc(self._max(self._nchw(x)))


class MaxAbsPooling(PoolingBase):
    """The window's value of largest magnitude."""

    def forward(self, x):
        x = self._nchw(x)
        mx = self._max(x)
        mn = -self._max(-x)
        return self._nhwc(torch.where(mx >= -mn, mx, mn))


class AvgPooling(PoolingBase):
    """The window's mean: its sum in the input's dtype over ``kx*ky``."""

    def forward(self, x):
        x = self._nchw(x)
        summed = F.avg_pool2d(x, (self.ky, self.kx), self.stride,
                              divisor_override=1)
        return self._nhwc(summed / (self.kx * self.ky))


class Depooling(PoolingBase):
    """Each value repeated over a ``(ky, kx)`` block."""

    def output_shape(self):
        h, w, c = self.input_shape
        return (h * self.ky, w * self.kx, c)

    def forward(self, x):
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        return x.repeat_interleave(self.ky, dim=1).repeat_interleave(
            self.kx, dim=2)
