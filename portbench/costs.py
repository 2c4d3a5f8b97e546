"""The yardstick's arithmetic: shapes, operations and bytes.

Everything here is worked out from a configuration's layer list (the
file under ``configs/``), never from the program, so a change to the
program's models or cost book cannot move it:

* :func:`walk` -- each layer's per-sample input and output shape and
  its parameter shapes in the JAX layout (convolutions HWIO, fully
  connected (in, out));
* :func:`train_flops_per_sample` -- 2 x the multiply-adds of the
  convolutions and fully connected layers, times 3 for the forward, the
  data gradient and the weight gradient (LRN, pooling, dropout and the
  activations count nothing): AlexNet-227 6.835 GFLOP, CIFAR-quick
  64.6 MFLOP;
* :data:`PEAKS` -- one H100 SXM's dense rates (NVIDIA's data sheet) and
  :func:`peak_flops` the one a precision policy computes in;
* :func:`kernel_bound_s` -- the least time of one call of a hand-written
  kernel of the port from its shapes: the larger of its operations over
  the peak and its bytes over the memory bandwidth, each input byte read
  once and each output byte written once.
"""

import math

#: dense peaks of one NVIDIA H100 SXM, from its data sheet: FLOP/s by
#: the precision the products run in, and the HBM3 bandwidth in bytes/s
PEAKS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
         "hbm_bytes_per_s": 3.35e12}

#: the precision policy -> the rate its products run at: float32 runs
#: outside the tensor cores (the port keeps TF32 off), the bf16 policies
#: on them
POLICY_PEAK = {"float32": "float32", "bfloat16": "bfloat16",
               "bfloat16_mixed": "bfloat16"}

_WEIGHTED = ("conv", "all2all", "softmax")


def _pair(value):
    if isinstance(value, (list, tuple)):
        return int(value[0]), int(value[1])
    return int(value), int(value)


def _conv_pad(padding):
    if padding == "VALID" or padding is None:
        return 0, 0
    return _pair(padding)


def walk(layers, sample_shape):
    """One dict a layer: ``type``, ``in`` and ``out`` (per-sample
    shapes), and for a weighted layer ``weights`` and ``bias`` (shapes
    in the JAX layout) and ``macs`` (multiply-adds a sample)."""
    shape = tuple(int(d) for d in sample_shape)
    out = []
    for descr in layers:
        kind = descr["type"]
        item = {"type": kind, "in": shape}
        if kind.startswith("conv"):
            h, w, c = shape
            kx, ky = int(descr["kx"]), int(descr["ky"])
            sx, sy = _pair(descr.get("sliding", (1, 1)))
            ph, pw = _conv_pad(descr.get("padding", "VALID"))
            n = int(descr["n_kernels"])
            oh = (h + 2 * ph - ky) // sy + 1
            ow = (w + 2 * pw - kx) // sx + 1
            shape = (oh, ow, n)
            item.update(weights=(ky, kx, c, n), bias=(n,),
                        macs=oh * ow * ky * kx * c * n)
        elif kind.endswith("pooling"):
            h, w, c = shape
            kx, ky = int(descr["kx"]), int(descr["ky"])
            sx, sy = _pair(descr.get("sliding", (kx, ky)))
            shape = ((h - ky) // sy + 1, (w - kx) // sx + 1, c)
        elif kind.startswith("all2all") or kind == "softmax":
            fin = math.prod(shape)
            fout = int(descr["output_sample_shape"])
            shape = (fout,)
            item.update(weights=(fin, fout), bias=(fout,), macs=fin * fout)
        elif kind not in ("norm", "dropout"):
            raise ValueError("the yardstick has no cost for layer type %r"
                             % kind)
        item["out"] = shape
        out.append(item)
    return out


def train_flops_per_sample(layers, sample_shape):
    """Analytic training FLOPs of one sample: 3 x 2 x the multiply-adds
    of the forward's convolutions and fully connected layers."""
    return 6.0 * sum(item.get("macs", 0) for item in walk(layers,
                                                          sample_shape))


def peak_flops(policy):
    """The dense peak FLOP/s of the products a precision policy runs."""
    return PEAKS[POLICY_PEAK[policy]]


def _size(dtype):
    return 2 if "bfloat16" in str(dtype) else 4


def kernel_bound_s(kernel, key):
    """Least seconds of one call of a hand-written kernel, from the key
    under which the port counts the call (its ``launches_by_form``):

    * ``K1`` gemm + bias + activation, key ``(M, K, N, dtype, bias)``:
      2MKN operations at the dtype's peak; A, B and the bias read, C
      written in the input's dtype;
    * ``K3`` LRN forward, key ``(shape, dtype)``: x read, y written;
      per element a square, the window's n adds, a multiply-add, a power
      (counted as 2) and a product, n + 5 operations at the float32 peak
      (the arithmetic is float32 whatever the dtype);
    * ``K4`` LRN backward, key ``(shape, dtype)``: x and g read, dx
      written; 2n + 10 operations an element;
    * ``K6`` column sum, key ``(rows, cols, dtype)``: x read, the float32
      sums written; one add an element;
    * ``K7`` uniform fill, key ``(rows, cols)``: float32 written; its
      Philox rounds are integer work and count no FLOPs.

    Returns ``(seconds, "ops" or "bytes")``."""
    hbm = PEAKS["hbm_bytes_per_s"]
    if kernel == "K1":
        m, k, n, dtype, bias = key
        size = _size(dtype)
        ops = 2.0 * m * k * n
        nbytes = size * (m * k + k * n + m * n) + (4 * n if bias else 0)
        peak = PEAKS["bfloat16" if size == 2 else "float32"]
    elif kernel in ("K3", "K4"):
        shape, dtype = key
        elems = math.prod(shape)
        size = _size(dtype)
        window = 5
        if kernel == "K3":
            ops, nbytes = (window + 5.0) * elems, 2.0 * size * elems
        else:
            ops, nbytes = (2 * window + 10.0) * elems, 3.0 * size * elems
        peak = PEAKS["float32"]
    elif kernel == "K6":
        rows, cols, dtype = key
        ops = float(rows * cols)
        nbytes = _size(dtype) * rows * cols + 4.0 * cols
        peak = PEAKS["float32"]
    elif kernel == "K7":
        rows, cols = key
        ops, nbytes, peak = 0.0, 4.0 * rows * cols, PEAKS["float32"]
    else:
        raise ValueError("no bound for kernel %r" % kernel)
    by_ops, by_bytes = ops / peak, nbytes / hbm
    return (by_ops, "ops") if by_ops >= by_bytes else (by_bytes, "bytes")
