"""A frozen copy of the dropout masks' arithmetic, for the reference.

The reference works out again every number the program derives from
the seed, so this file restates, in plain integer torch operations:

* the per-epoch dropout seed: splitmix64 of (the stream's 32-bit seed
  << 32 | the epoch's counter);
* the stream offset of one mask: the batch index in the epoch in the
  high 32 bits, the absolute layer index in the low 32;
* Philox4x32-10 (Salmon et al., SC'11, Random123's constants), key =
  the 64-bit seed, counter = (element index / 4 as 64 bits, offset as
  64 bits), element e taking word e % 4;
* the map of a 32-bit word to [0, 1): its top 24 bits times 2^-24.

A mask over an activation of shape (batch, ...) is filled as (batch,
rest) and reshaped; element i keeps its value where u_i < 1 - ratio.
"""

import math

import torch

_MASK = 0xFFFFFFFF
_U64 = (1 << 64) - 1
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


def splitmix64(value):
    """One splitmix64 output for a 64-bit ``value``."""
    z = (value + 0x9E3779B97F4A7C15) & _U64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return z ^ (z >> 31)


def epoch_seed(stream_seed, epoch):
    """The dropout seed of ``epoch`` for a stream seeded with
    ``stream_seed`` (its low 32 bits count)."""
    return splitmix64(((stream_seed & _MASK) << 32) | (epoch & _MASK))


def _mulhilo(a, m):
    mh, ml = m >> 16, m & 0xFFFF
    ah, al = a >> 16, a & 0xFFFF
    p0 = al * ml
    p1 = ah * ml + al * mh
    low = p0 + ((p1 & 0xFFFF) << 16)
    return (ah * mh + (p1 >> 16) + (low >> 32)) & _MASK, low & _MASK


def uniforms(shape, seed, batch_index, layer_index, device):
    """Float32 uniforms of one mask of ``shape``."""
    n = math.prod(shape)
    offset = ((batch_index & _MASK) << 32) | (layer_index & _MASK)
    index = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    c0, c1 = index & _MASK, index >> 32
    c2 = torch.full_like(index, offset & _MASK)
    c3 = torch.full_like(index, offset >> 32)
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    bits = torch.stack((c0, c1, c2, c3), dim=1).reshape(-1)[:n]
    return ((bits >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(
        shape)
