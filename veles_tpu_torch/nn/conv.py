"""Convolution layers over NHWC activations.

The port of ``veles_tpu/nn/conv.py`` ``Conv`` and its activation
variants. The JAX package keeps weights HWIO and convolves NHWC through
XLA; here the weights are OIHW in ``channels_last`` memory and the
convolution is ``F.conv2d`` (cuDNN on the card: the JAX package left
convolutions to XLA, not to a Pallas kernel). The input arrives NHWC;
``permute(0, 3, 1, 2)`` of it is an NCHW view in channels_last memory,
so cuDNN convolves without a layout copy and the output, permuted back,
is NHWC-contiguous as the LRN kernel needs. The bias is added to that
NHWC output through :func:`veles_tpu_torch.nn.base.bias_add_nhwc`, whose
backward sums the bias gradient with the column-sum kernel (K6); the
convolution's data and weight gradients stay with cuDNN, as the JAX
package leaves them to XLA.

* The stride is ``(sliding[1], sliding[0])`` for (H, W), as in the JAX
  package (``sliding`` is given x first).
* Padding: an int (all sides), a 2-tuple ``(H, W)``, or ``"VALID"``.
* ``space_to_depth`` is accepted and validated as in the JAX package,
  whose s2d conv is an exact restatement of the strided conv; the port
  runs the strided conv itself.

:class:`Deconv` is the JAX package's transposed convolution,
``lax.conv_transpose`` with HWOI weights and ``transpose_kernel=False``:
a correlation of the stride-dilated input, padded by ``(lo, hi)`` per
spatial axis, with the kernel as stored (not flipped). ``VALID`` pads
``(k-1, k+s-2+max(k-s, 0)-(k-1))`` and gives ``(in-1)*s + k``; ``SAME``
pads ``k+s-2`` in all, ``k-1`` before when ``s > k-1`` and else half
rounded up, and gives ``in*s``; an int ``p`` or explicit pairs pad the
dilated input itself. ``F.conv_transpose2d`` with the kernel flipped
spatially computes that correlation at ``lo = hi = k-1``, the full
output; any other ``(lo, hi)`` is that output cropped, or padded with
zeros, by ``k-1-lo`` before and ``k-1-hi`` after. The weights are kept
(in, out, kH, kW), the HWOI array permuted as a convolution's HWIO is
(``convert``'s 4-D rule), and flipped at each forward.
"""

import torch
import torch.nn.functional as F

from veles_tpu_torch.nn.activation import get_activation
from veles_tpu_torch.nn.base import WeightedBase, bias_add_nhwc


def _pad_hw(padding):
    """(pad_h, pad_w) of a symmetric padding spec."""
    if padding == "VALID":
        return 0, 0
    if isinstance(padding, int):
        return padding, padding
    if isinstance(padding, (tuple, list)) and len(padding) == 2:
        return int(padding[0]), int(padding[1])
    raise ValueError("padding must be an int, a 2-tuple (H, W) or "
                     "\"VALID\" (got %r)" % (padding,))


class Conv(WeightedBase):
    """y = act(conv(x, W) + b) over NHWC input."""

    ACTIVATION = "linear"

    def __init__(self, input_shape, n_kernels, kx, ky, sliding=(1, 1),
                 padding="VALID", space_to_depth=False, activation=None,
                 policy="float32", include_bias=True, device=None,
                 trainable=False):
        input_shape = tuple(input_shape)
        if len(input_shape) == 2:
            input_shape += (1,)
        self.n_kernels, self.kx, self.ky = int(n_kernels), int(kx), int(ky)
        self.sliding = tuple(sliding)
        self.padding = padding
        self.pad = _pad_hw(padding)
        self.stride = (int(self.sliding[1]), int(self.sliding[0]))
        self.space_to_depth = bool(space_to_depth)
        if self.space_to_depth:
            if self.sliding[0] != self.sliding[1] or self.sliding[0] < 2:
                raise ValueError("space_to_depth needs a square stride >= 2 "
                                 "(got %r)" % (self.sliding,))
            if not (isinstance(padding, int) or padding == "VALID"):
                raise ValueError("space_to_depth supports int or VALID "
                                 "padding (got %r)" % (padding,))
        self.activation_name = activation or self.ACTIVATION
        self._activation = get_activation(self.activation_name)
        super(Conv, self).__init__(input_shape, policy, include_bias,
                                   device, trainable)
        self.weights.data = self.weights.data.contiguous(
            memory_format=torch.channels_last)

    def jax_weights_shape(self):
        return (self.ky, self.kx, self.input_shape[2], self.n_kernels)

    def weights_shape(self):
        return (self.n_kernels, self.input_shape[2], self.ky, self.kx)

    def output_shape(self):
        h, w, _ = self.input_shape
        (sh, sw), (ph, pw) = self.stride, self.pad
        return ((h + 2 * ph - self.ky) // sh + 1,
                (w + 2 * pw - self.kx) // sw + 1, self.n_kernels)

    def _apply(self, x, plain):
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        pol = self.policy
        xc, wc = pol.cast_in(x, self.weights)
        # a low-precision policy rounds the conv output to its compute
        # dtype before the upcast, as the JAX package's conv does
        y = F.conv2d(xc.permute(0, 3, 1, 2), wc, None, self.stride,
                     self.pad).to(pol.accum_dtype)
        y = bias_add_nhwc(y.permute(0, 2, 3, 1).contiguous(), self.bias,
                          plain)
        return pol.cast_out(self._activation(y))

    def forward(self, x):
        return self._apply(x, plain=False)

    def plain_forward(self, x):
        return self._apply(x, plain=True)


class ConvTanh(Conv):
    ACTIVATION = "tanh"


class ConvRELU(Conv):
    ACTIVATION = "relu"


class ConvStrictRELU(Conv):
    ACTIVATION = "strict_relu"


class ConvSigmoid(Conv):
    ACTIVATION = "sigmoid"


def _transpose_pads(k, s, padding):
    """(lo, hi) zeros around the stride-dilated input of one spatial axis
    (``lax._conv_transpose_padding`` for the strings)."""
    if padding == "VALID":
        total = k + s - 2 + max(k - s, 0)
        return k - 1, total - (k - 1)
    if padding == "SAME":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else -(-total // 2)
        return lo, total - lo
    lo, hi = padding
    return int(lo), int(hi)


class Deconv(WeightedBase):
    """Transposed convolution over NHWC input, ``n_kernels`` output
    channels; weights HWOI in the JAX layout, no bias unless asked."""

    def __init__(self, input_shape, n_kernels, kx, ky, sliding=(1, 1),
                 padding="VALID", policy="float32", include_bias=False,
                 device=None, trainable=False):
        input_shape = tuple(input_shape)
        if len(input_shape) == 2:
            input_shape += (1,)
        self.n_kernels, self.kx, self.ky = int(n_kernels), int(kx), int(ky)
        self.sliding = tuple(sliding)
        self.stride = (int(self.sliding[1]), int(self.sliding[0]))
        if isinstance(padding, str):
            if padding not in ("VALID", "SAME"):
                raise ValueError("padding must be VALID, SAME, an int or "
                                 "two (lo, hi) pairs (got %r)" % (padding,))
            spec = (padding, padding)
        elif isinstance(padding, int):
            spec = ((padding, padding), (padding, padding))
        else:
            spec = tuple(tuple(p) for p in padding)
        self.pads = tuple(_transpose_pads(k, st, p) for k, st, p in zip(
            (self.ky, self.kx), self.stride, spec))
        super(Deconv, self).__init__(input_shape, policy, include_bias,
                                     device, trainable)

    def jax_weights_shape(self):
        return (self.ky, self.kx, self.n_kernels, self.input_shape[2])

    def weights_shape(self):
        return (self.input_shape[2], self.n_kernels, self.ky, self.kx)

    def bias_shape(self):
        return (self.n_kernels,)

    def output_shape(self):
        h, w, _ = self.input_shape
        (sh, sw), ((ph0, ph1), (pw0, pw1)) = self.stride, self.pads
        return ((h - 1) * sh + ph0 + ph1 - self.ky + 2,
                (w - 1) * sw + pw0 + pw1 - self.kx + 2, self.n_kernels)

    def _apply(self, x, plain):
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        pol = self.policy
        xc, wc = pol.cast_in(x, self.weights)
        y = F.conv_transpose2d(xc.permute(0, 3, 1, 2),
                               torch.flip(wc, (2, 3)), None, self.stride)
        (ph0, ph1), (pw0, pw1) = self.pads
        y = F.pad(y, (pw0 - self.kx + 1, pw1 - self.kx + 1,
                      ph0 - self.ky + 1, ph1 - self.ky + 1))
        y = bias_add_nhwc(y.to(pol.accum_dtype).permute(0, 2, 3, 1)
                          .contiguous(), self.bias, plain)
        return pol.cast_out(y)

    def forward(self, x):
        return self._apply(x, plain=False)

    def plain_forward(self, x):
        return self._apply(x, plain=True)
