"""Kohonen self-organizing map (``veles_tpu/nn/kohonen.py``).

A codebook of ``sx * sy`` units over the sample features, trained by
the batch SOM update: each sample's winner is the unit of least
``|c|^2 - 2 x.c`` (:func:`winners`), each unit is pulled towards the
samples by a Gaussian of its grid distance to their winners, and the
radius and the rate decay with the step count (:class:`KohonenTrainer`).
The two products stay ``torch.matmul``: the JAX package computes them
with plain ``jnp.dot``, outside any Pallas kernel. :func:`som_quality`
gives the map's quantization and topographic errors.
"""

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.device import resolve_device


def make_grid(sx, sy):
    """(sx*sy, 2) float32 unit-grid coordinates, x fastest: the layout
    of the trainer's neighbourhood and of the topographic error."""
    gx, gy = numpy.meshgrid(numpy.arange(sx), numpy.arange(sy))
    return numpy.stack([gx.ravel(), gy.ravel()],
                       axis=1).astype(numpy.float32)


def _squared_distances(codebook, x):
    """|c|^2 - 2 x.c per (sample, unit): the squared distance less the
    sample's own |x|^2."""
    dots = torch.matmul(x, codebook.t())
    return torch.sum(torch.square(codebook), dim=1)[None, :] - 2.0 * dots


def winners(codebook, x):
    """Each row of ``x`` (batch, features)'s best-matching unit."""
    return torch.argmin(_squared_distances(codebook, x), dim=1)


def som_update(codebook, x, grid, sigma, lr):
    """One batch update: (new codebook, winners). ``sigma`` and ``lr``
    float32 scalars (tensors on the codebook's device)."""
    win = winners(codebook, x)
    win_pos = grid.index_select(0, win)
    d2 = torch.sum(torch.square(grid[None, :, :] - win_pos[:, None, :]),
                   dim=2)
    h = torch.exp(-d2 / (2.0 * sigma * sigma))
    num = torch.matmul(h.t(), x)
    den = torch.sum(h, dim=0)[:, None]
    delta = num - den * codebook
    return codebook + lr * delta / x.shape[0], win


def som_quality(weights, sx, sy, data):
    """{"quantization_error", "topographic_error"} of a codebook over
    ``data`` (samples first, flattened): the mean Euclidean distance of
    each sample to its best-matching unit, and the share of samples whose
    two best units are not 8-neighbours on the grid. Tensors or arrays;
    computed in float32 on the codebook's device."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    x = torch.as_tensor(data, dtype=torch.float32, device=w.device)
    x = x.reshape(len(x), -1)
    grid = torch.from_numpy(make_grid(sx, sy)).to(w.device)
    x2 = torch.sum(torch.square(x), dim=1)
    d2 = torch.clamp(x2[:, None] + _squared_distances(w, x), min=0.0)
    best2 = torch.topk(-d2, 2, dim=1).indices
    qe = torch.mean(torch.sqrt(d2.gather(1, best2[:, :1])))
    cheb = torch.amax(torch.abs(grid[best2[:, 0]] - grid[best2[:, 1]]),
                      dim=1)
    te = torch.mean((cheb > 1.0).to(torch.float32))
    return {"quantization_error": float(qe),
            "topographic_error": float(te)}


class KohonenTrainer(object):
    """An ``sx`` x ``sy`` codebook over ``features``, drawn uniform in
    [-0.1, 0.1) from the ``rand`` stream of ``veles_tpu_torch.prng`` as
    the JAX trainer draws it, on ``device`` (the card unless the caller
    asks for the CPU). Schedule at step t: ``sigma = max(sigma0 *
    exp(-decay t), 0.5)``, ``lr = max(learning_rate * exp(-decay t),
    0.01)``; ``sigma0`` is half the longer side by default."""

    def __init__(self, features, sx=8, sy=8, sigma=None, learning_rate=0.5,
                 decay=0.005, rand="default", device=None):
        self.sx, self.sy = int(sx), int(sy)
        self.sigma0 = max(sx, sy) / 2.0 if sigma is None else sigma
        self.learning_rate = learning_rate
        self.decay = decay
        self.device = resolve_device(device)
        w = numpy.zeros((self.sx * self.sy, int(features)), numpy.float32)
        prng.get(rand).fill(w, -0.1, 0.1)
        self.weights = torch.from_numpy(w).to(self.device)
        self.grid = torch.from_numpy(make_grid(self.sx, self.sy)).to(
            self.device)
        #: update steps taken
        self.time = 0

    def schedule(self, t):
        """(sigma, lr) at step ``t`` (a float32 tensor), in float32."""
        sigma = torch.clamp(self.sigma0 * torch.exp(-self.decay * t),
                            min=0.5)
        lr = torch.clamp(self.learning_rate * torch.exp(-self.decay * t),
                         min=0.01)
        return sigma, lr

    def step(self, x):
        """One batch update of the codebook by ``x`` (batch, features);
        returns the winners."""
        t = torch.full((), float(self.time), dtype=torch.float32,
                       device=self.device)
        sigma, lr = self.schedule(t)
        self.weights, win = som_update(self.weights, x, self.grid, sigma,
                                       lr)
        self.time += 1
        return win
