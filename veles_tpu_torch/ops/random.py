"""Uniform fill from Philox4x32-10: the dropout masks' random numbers.

:func:`uniform_fill` is the port of ``pallas_uniform``
(``veles_tpu/ops/random.py``): a 2-D float32 fill on ``[vmin, vmax)``
whose values lie on a 2^-24 grid, from the top 24 bits of each 32-bit
random word, as the TPU kernel maps its hardware PRNG's bits. The TPU's
bits cannot be reproduced off the TPU, so the generator here is
Philox4x32-10 (Salmon et al., SC'11; Random123's constants):

* key = the 64-bit ``seed``;
* counter = (element index / 4 as 64 bits, ``offset`` as 64 bits);
* element e takes word e % 4 of its counter's output.

A (seed, offset) pair names one stream; the trainer passes its dropout
seed and an offset made of the batch index and the layer index
(:func:`dropout_offset`), as the JAX trainer folds those into its key.

On a CUDA device :func:`uniform_fill` launches ``csrc/uniform_fill.cu``
through its CPython binding (``csrc/uniform_fill_binding.cpp``), which
allocates the output and launches in one C call; on the CPU it runs
:func:`uniform_fill_plain`, the same Philox in integer torch ops, which
gives the same bits.

:func:`xorshift128plus` and :func:`fill_xorshift` are the reference's
host-side generator, bit for bit, as the JAX package keeps them.
"""

import collections
import math
import threading

import numpy
import torch

from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.ops import build

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U64 = (1 << 64) - 1
_count_lock = threading.Lock()


def dropout_offset(batch_index, layer_index):
    """The stream offset of one dropout mask: batch index in the epoch
    in the high 32 bits, absolute layer index in the low 32."""
    return ((int(batch_index) & _MASK) << 32) | (int(layer_index) & _MASK)


def dropout_uniforms(shape, seed, batch_index, layer_index, device,
                     source=None, plain=False):
    """The uniforms of one dropout mask of ``shape``: ``source``'s
    (``source(shape, seed, batch_index, layer_index, device)``), or else
    this module's fill (its plain version when ``plain``) at stream
    (seed, :func:`dropout_offset`), filled as (shape[0], rest) and
    reshaped. The fused trainer and the eager dropout unit both draw
    through here, so the two give the same masks."""
    shape = tuple(shape)
    if source is not None:
        return source(shape, seed, batch_index, layer_index, device)
    fill = uniform_fill_plain if plain else uniform_fill
    return fill((shape[0], math.prod(shape[1:])), seed,
                dropout_offset(batch_index, layer_index),
                device=device).reshape(shape)


def _mulhilo(a, m):
    """(hi, lo) 32-bit halves of ``a * m``: ``a`` an int64 tensor of
    32-bit values, ``m`` a 32-bit int. 16-bit limbs keep every partial
    product inside int64."""
    mh, ml = m >> 16, m & 0xFFFF
    ah, al = a >> 16, a & 0xFFFF
    p0 = al * ml
    p1 = ah * ml + al * mh
    low = p0 + ((p1 & 0xFFFF) << 16)
    return (ah * mh + (p1 >> 16) + (low >> 32)) & _MASK, low & _MASK


def philox4x32(counter, key):
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words:
    ``counter`` a 4-tuple, ``key`` a 2-tuple of ints. Returns the four
    output words."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in counter)
    k0, k1 = (int(k) & _MASK for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_uniform(bits, vmin=0.0, vmax=1.0):
    """The TPU kernel's map of 32-bit words to ``[vmin, vmax)``: the top
    24 bits times 2^-24, then ``vmin + (vmax - vmin) * u``, each product
    rounded to float32 on its own."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    lo = torch.tensor(numpy.float32(vmin), device=u.device)
    span = torch.tensor(numpy.float32(vmax) - numpy.float32(vmin),
                        device=u.device)
    return lo + span * u


def _check(shape, seed, offset):
    if len(shape) != 2:
        raise ValueError("uniform_fill wants a 2-D shape, got %r"
                         % (tuple(shape),))
    if not (0 <= seed <= _U64 and 0 <= offset <= _U64):
        raise ValueError("seed and offset are unsigned 64-bit integers")
    return int(shape[0]), int(shape[1])


def uniform_fill_plain(shape, seed, offset=0, vmin=0.0, vmax=1.0,
                       device="cpu"):
    """The plain PyTorch version: the same Philox and the same map in
    integer and float32 torch ops on ``device``."""
    shape = _check(shape, seed, offset)
    n = shape[0] * shape[1]
    index = torch.arange((n + 3) // 4, dtype=torch.int64,
                         device=torch.device(device))
    offset, seed = int(offset), int(seed)
    words = philox4x32(
        (index & _MASK, index >> 32,
         torch.tensor(offset & _MASK, device=index.device),
         torch.tensor(offset >> 32, device=index.device)),
        (seed & _MASK, seed >> 32))
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    return bits_to_uniform(bits, vmin, vmax).reshape(shape)


def uniform_fill(shape, seed, offset=0, vmin=0.0, vmax=1.0, device=None):
    """A float32 ``shape`` (2-D) fill on ``[vmin, vmax)`` from stream
    (``seed``, ``offset``). ``device`` defaults to the card. Counts each
    kernel launch in ``uniform_fill.launches``, and in
    ``uniform_fill.launches_by_form`` under ``shape``."""
    shape = _check(shape, seed, offset)
    if not isinstance(device, torch.device):  # the trainer passes one
        device = resolve_device(device)
    kind = device.type  # a new string at each read: read once
    if kind == "cpu":
        return uniform_fill_plain(shape, seed, offset, vmin, vmax, device)
    if kind != "cuda":
        raise ValueError("uniform_fill runs on cuda or cpu, not %s"
                         % device)
    rows, cols = shape
    if rows * cols == 0:
        return torch.empty(rows, cols, dtype=torch.float32, device=device)
    # the binding allocates out on the card (-1: the current one) and
    # launches: one C call, vmin and vmax rounded to float32 as ctypes'
    # c_float rounds them
    out = build.launch(
        build.binding("uniform_fill", "veles_uniform_fill").fill, device,
        rows, cols, int(seed), int(offset), vmin, vmax,
        -1 if device.index is None else device.index)
    with _count_lock:
        uniform_fill.launches += 1
        uniform_fill.launches_by_form[shape] += 1
    return out


uniform_fill.launches = 0
uniform_fill.launches_by_form = collections.Counter()


def xorshift128plus(state):
    """One xorshift128+ step on a 2-element uint64 state (host-side):
    (new_state, output)."""
    s0, s1 = int(state[0]), int(state[1])
    x, y = s0, s1
    x ^= (x << 23) & _U64
    x ^= x >> 17
    x ^= y ^ (y >> 26)
    return numpy.array([y, x], dtype=numpy.uint64), (x + y) & _U64


def fill_xorshift(state, count):
    """``count`` uint64 outputs of :func:`xorshift128plus` from
    ``state``: (the evolved state, the outputs)."""
    out = numpy.empty(count, dtype=numpy.uint64)
    for i in range(count):
        state, out[i] = xorshift128plus(state)
    return state, out
