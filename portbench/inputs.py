"""Inputs and initial weights made on the device from ``--seed``.

Both sides get the same tensors: the program through its loader and
``build_training(params=...)``, the reference by calling these functions
again with the same seed after the window. Every draw comes from a
``torch.Generator`` on the device seeded by :func:`sub_seed`, in a few
large calls:

* :func:`make_data`: the samples, ``[validation, train]``, uniform in
  ``[low, high)`` in the configuration's storage dtype, drawn in chunks
  of :data:`CHUNK` samples (chunk c from its own generator, so
  :func:`data_rows` can make any rows again alone), and the labels,
  uniform over the classes, int32;
* :func:`make_weights`: every parameter of the layer list from one
  uniform draw, each leaf scaled to +-1/sqrt(fan_in) (fan_in the product
  of all but the last axis of its JAX-layout shape; a bias takes its
  layer's range).
"""

import hashlib
import math

import torch

from portbench import costs

#: samples drawn by one call of the data generator
CHUNK = 1024


def sub_seed(seed, purpose, index=0):
    """A 63-bit seed for ``purpose`` (and ``index``) from the run's
    ``seed``, any whole number."""
    digest = hashlib.sha256(("%d:%s:%d" % (int(seed), purpose, index))
                            .encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def _generator(device, seed):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _chunk(spec, shape, seed, c, device):
    rows = min(CHUNK, spec["n_valid"] + spec["n_train"] - c * CHUNK)
    u = torch.rand((rows,) + tuple(shape), generator=_generator(
        device, sub_seed(seed, "data", c)), device=device)
    low, high = float(spec["low"]), float(spec["high"])
    return (u * (high - low) + low).to(getattr(torch, spec["dtype"]))


def make_data(config, seed, device, host=False):
    """``(data, labels)`` of the configuration's dataset: on ``device``,
    or, with ``host``, made there chunk by chunk and kept in host
    memory."""
    spec = config["data"]
    shape = tuple(config["sample_shape"])
    total = spec["n_valid"] + spec["n_train"]
    data = torch.empty((total,) + shape, dtype=getattr(torch, spec["dtype"]),
                       device="cpu" if host else device)
    for c in range(-(-total // CHUNK)):
        data[c * CHUNK:(c + 1) * CHUNK] = _chunk(spec, shape, seed, c, device)
    labels = torch.randint(
        0, spec["n_classes"], (total,), generator=_generator(
            device, sub_seed(seed, "labels")), device=device,
        dtype=torch.int64).to(torch.int32)
    return data, labels.cpu() if host else labels


def data_rows(config, seed, rows, device):
    """``(data, labels)`` at the dataset indices ``rows`` (a list of
    ints), made again from the seed: only the chunks they fall in."""
    spec = config["data"]
    shape = tuple(config["sample_shape"])
    chunks = {}
    out = []
    for r in rows:
        c = r // CHUNK
        if c not in chunks:
            chunks[c] = _chunk(spec, shape, seed, c, device)
        out.append(chunks[c][r - c * CHUNK])
    total = spec["n_valid"] + spec["n_train"]
    labels = torch.randint(
        0, spec["n_classes"], (total,), generator=_generator(
            device, sub_seed(seed, "labels")), device=device,
        dtype=torch.int64).to(torch.int32)
    index = torch.tensor(rows, dtype=torch.int64, device=device)
    return torch.stack(out), labels[index]


def make_weights(config, seed, device):
    """One ``{"weights", "bias"}`` dict of float32 tensors on ``device``
    a layer (JAX layout), ``{}`` for a layer without parameters."""
    items = costs.walk(config["layers"], config["sample_shape"])
    sizes = []
    for item in items:
        if "weights" in item:
            sizes += [math.prod(item["weights"]), math.prod(item["bias"])]
    u = torch.rand(sum(sizes), generator=_generator(
        device, sub_seed(seed, "weights")), device=device) * 2 - 1
    pieces = iter(torch.split(u, sizes))
    out = []
    for item in items:
        if "weights" not in item:
            out.append({})
            continue
        scale = 1.0 / math.sqrt(max(math.prod(item["weights"][:-1]), 1))
        out.append({"weights": (next(pieces) * scale).reshape(
                        item["weights"]),
                    "bias": next(pieces) * scale})
    return out
