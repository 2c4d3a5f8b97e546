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
