"""``act(x @ w + bias)``: the fused linear layer of fc6 and fc7.

:func:`linear_act` is the port of ``pallas_gemm(..., bias=...)`` /
``fused_linear`` (``veles_tpu/ops/gemm.py``). ``w`` is stored
``(in, out)`` as in the JAX package. On a CUDA tensor it launches the
hand-written kernel ``csrc/gemm_bias_act.cu`` (see its header for the
bound and the design); on a CPU tensor it runs
:func:`linear_act_plain`, the same function in plain PyTorch. There is
no other route: a CUDA tensor that the kernel does not take raises.

:class:`LinearActFunction` is the differentiable layer, the port of
``fused_linear``'s ``custom_vjp``: forward :func:`linear_act`, residuals
(x, w, y), and a backward that takes the activation's derivative from
the output y (:data:`ACTIVATION_GRADS`), sums the bias gradient with
:func:`veles_tpu_torch.ops.reduce.column_sum` (K6) and leaves the two
products to ``torch.matmul``, as the JAX package leaves them to XLA's
dot.

The five epilogues keep the JAX package's exact constants: LeCun tanh
``1.7159 * tanh(0.6666 x)``, sigmoid, softplus "relu" linear above 15,
strict relu, linear. The product accumulates in float32 from float32
or bfloat16 operands; the bias is float32.
"""

import collections
import ctypes
import threading

import torch

from veles_tpu_torch.nn.activation import ACTIVATIONS
from veles_tpu_torch.ops import build
from veles_tpu_torch.ops.reduce import column_sum, column_sum_plain

#: the kernel's epilogue codes
EPILOGUES = ("linear", "tanh", "sigmoid", "relu", "strict_relu")
_DTYPES = (torch.float32, torch.bfloat16)
_count_lock = threading.Lock()

#: each epilogue's derivative as a function of its OUTPUT y
#: (``_EPILOGUE_GRADS``, ``veles_tpu/ops/gemm.py``), so the backward
#: keeps only (x, w, y) and never the pre-activation
ACTIVATION_GRADS = {
    "linear": lambda y: torch.ones_like(y),
    "tanh": lambda y: 1.7159 * 0.6666 * (1.0 - torch.square(y / 1.7159)),
    "sigmoid": lambda y: y * (1.0 - y),
    # y = log1p(e^x) => dy/dx = sigmoid(x) = 1 - e^-y
    "relu": lambda y: 1.0 - torch.exp(-y),
    "strict_relu": lambda y: (y > 0.0).to(y.dtype),
}


def linear_act_plain(x, w, bias=None, activation="linear",
                     out_dtype=None):
    """The plain PyTorch version: float32 product of the (possibly
    bf16) operands, + bias, activation, cast to ``out_dtype``."""
    _check(x, w, bias, activation)
    y = torch.matmul(x.float(), w.float())
    if bias is not None:
        y = y + bias
    return ACTIVATIONS[activation](y).to(out_dtype or x.dtype)


def _check(x, w, bias, activation):
    if activation not in EPILOGUES:
        raise ValueError("no fused epilogue for activation %r (have %s)"
                         % (activation, list(EPILOGUES)))
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError("linear_act needs x (M, K) and w (K, N), got %s "
                         "and %s" % (tuple(x.shape), tuple(w.shape)))
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError("x and w must share dtype float32 or bfloat16, "
                        "got %s and %s" % (x.dtype, w.dtype))
    if x.device != w.device:
        raise ValueError("x on %s but w on %s" % (x.device, w.device))
    if bias is not None and (bias.dtype != torch.float32 or
                             tuple(bias.shape) != (w.shape[1],) or
                             bias.device != x.device or
                             not bias.is_contiguous()):
        raise ValueError("bias must be contiguous float32 (%d,) on %s" %
                         (w.shape[1], x.device))


def linear_act(x, w, bias=None, activation="linear", out_dtype=None):
    """``act(x @ w + bias)`` with x (M, K), w (K, N), bias (N,) or None.

    Any M, N, K: the kernel masks ragged edges itself. ``out_dtype``
    defaults to ``x.dtype``. Counts each kernel launch in
    ``linear_act.launches``, and in ``linear_act.launches_by_form`` under
    ``(M, K, N, x.dtype, has_bias)``."""
    _check(x, w, bias, activation)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPES:
        raise TypeError("out_dtype must be float32 or bfloat16")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("linear_act needs row-major contiguous x and w")
    if x.device.type == "cpu":
        return linear_act_plain(x, w, bias, activation, out_dtype)
    if x.device.type != "cuda":
        raise ValueError("linear_act runs on cuda or cpu, not %s"
                         % x.device)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.veles_gemm_bias_act(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(),
            out.data_ptr(), m, n, k, int(x.dtype == torch.bfloat16),
            int(out_dtype == torch.bfloat16), EPILOGUES.index(activation),
            stream)
        with _count_lock:
            linear_act.launches += 1
            linear_act.launches_by_form[
                (m, k, n, x.dtype, bias is not None)] += 1
    build.check(status, "gemm_bias_act")
    return out


linear_act.launches = 0
linear_act.launches_by_form = collections.Counter()


def _library():
    lib = build.library("gemm_bias_act")
    fn = lib.veles_gemm_bias_act
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


class LinearActFunction(torch.autograd.Function):
    """Differentiable ``act(x @ w + bias)``: forward :func:`linear_act`
    (K1), backward as ``_fused_linear_bwd``:

    * ``dpre = g * act'(y)`` in float32;
    * ``db = column_sum(dpre)`` (K6);
    * ``dx = dpre_c @ w^T`` and ``dw = x^T @ dpre_c`` on ``torch.matmul``,
      with ``dpre_c`` cast to the compute dtype (w's).

    ``plain=True`` runs the plain versions of both kernels."""

    @staticmethod
    def forward(ctx, x, w, bias, activation, out_dtype, plain=False):
        forward = linear_act_plain if plain else linear_act
        y = forward(x, w, bias, activation, out_dtype)
        ctx.save_for_backward(x, w, y)
        ctx.constants = (activation, bias is not None, plain)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        activation, has_bias, plain = ctx.constants
        dpre = g.float() * ACTIVATION_GRADS[activation](y.float())
        db = None
        if has_bias:
            db = (column_sum_plain if plain else column_sum)(
                dpre.contiguous())
        dpre_c = dpre.to(w.dtype)
        dx = torch.matmul(dpre_c, w.t()).to(x.dtype)
        dw = torch.matmul(x.t(), dpre_c).to(w.dtype)
        return dx, dw, db, None, None, None
