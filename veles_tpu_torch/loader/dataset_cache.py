"""On-disk cache of generated datasets (``veles_tpu/loader/
dataset_cache.py``).

A generated dataset is a function of its config (sizes, seed, dtype),
so its arrays are kept under a hash of that config and a schema
version. The layout is the JAX package's, under the same directory and
the same hash, so a cache written by either package is read by the
other: ``<cache>/datasets/<name>-<hash12>/`` with ``meta.json`` and one
raw little-endian ``.bin`` per array. The arrays land in a
``.tmp-<pid>`` directory renamed into place after ``meta.json`` is
written, and a cache that fails to load is generated again. bfloat16
arrays go through their raw 16-bit patterns (no ``ml_dtypes`` here).

``VELES_DATASET_CACHE=0`` generates always; anything else reads and
writes. The cache root is ``root.common.dirs.cache`` or
``~/.veles_tpu/cache``.
"""

import hashlib
import json
import logging
import os
import shutil

import numpy
import torch

from veles_tpu_torch.envknob import env_flag

#: bump to invalidate every cached dataset at once (the JAX package's)
CACHE_VERSION = 1

_log = logging.getLogger("dataset_cache")


def veles_cache_dir(*parts):
    """``<cache root>/<parts...>``, made on demand: the JAX package's
    ``backends.veles_cache_dir``."""
    from veles_tpu_torch.config import root
    base = root.common.dirs.get("cache", os.path.join(
        os.path.expanduser("~"), ".veles_tpu", "cache"))
    path = os.path.join(base, *parts)
    os.makedirs(path, exist_ok=True)
    return path


def enabled():
    return env_flag("VELES_DATASET_CACHE", True)


def config_hash(config):
    """Stable short hash of a JSON-able config dict."""
    blob = json.dumps({"version": CACHE_VERSION, "config": config},
                      sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _dataset_dir(name, config):
    return os.path.join(veles_cache_dir("datasets"),
                        "%s-%s" % (name, config_hash(config)))


def _dtype_name(tensor):
    return str(tensor.dtype).replace("torch.", "")


def _load(path):
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version") != CACHE_VERSION:
        raise ValueError("stale schema %r" % meta.get("version"))
    arrays = {}
    for name, spec in meta["arrays"].items():
        dtype = getattr(torch, spec["dtype"])
        raw = numpy.fromfile(os.path.join(path, name + ".bin"),
                             dtype=numpy.uint8)
        arrays[name] = torch.from_numpy(raw).view(dtype).reshape(
            tuple(spec["shape"]))
    return arrays


def _sweep_stale_tmp(path):
    """Remove the ``.tmp-<pid>`` directories of dead writers."""
    base = os.path.dirname(path)
    for entry in os.listdir(base):
        full = os.path.join(base, entry)
        if ".tmp-" not in entry or not os.path.isdir(full):
            continue
        try:
            pid = int(entry.rsplit(".tmp-", 1)[1])
        except ValueError:
            pid = -1
        try:
            if pid > 0:
                os.kill(pid, 0)  # alive: its writer is at work
                continue
        except ProcessLookupError:
            pass
        except OSError:
            continue
        _log.info("removing orphaned dataset staging dir %s", full)
        shutil.rmtree(full, ignore_errors=True)


def _store(path, arrays):
    _sweep_stale_tmp(path)
    tmp = "%s.tmp-%d" % (path, os.getpid())
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    meta = {"version": CACHE_VERSION, "arrays": {}}
    for name, arr in arrays.items():
        arr = torch.as_tensor(arr).contiguous()
        arr.view(torch.uint8).numpy().tofile(os.path.join(tmp, name + ".bin"))
        meta["arrays"][name] = {"dtype": _dtype_name(arr),
                                "shape": list(arr.shape)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    shutil.rmtree(path, ignore_errors=True)
    try:
        os.replace(tmp, path)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)


def cached_build(name, config, generate):
    """``generate() -> {name: tensor or array}``, kept on disk: a hit
    reads the arrays back as CPU tensors; a miss (or a cache that does
    not load) calls ``generate`` and stores its output."""
    if not enabled():
        return generate()
    path = _dataset_dir(name, config)
    if os.path.isdir(path):
        try:
            arrays = _load(path)
            _log.info("dataset cache hit: %s", path)
            return arrays
        except Exception as e:  # a corrupt cache is a miss
            _log.warning("ignoring unreadable dataset cache %s (%s: %s)",
                         path, type(e).__name__, e)
    arrays = generate()
    try:
        _store(path, arrays)
        _log.info("dataset cache store: %s", path)
    except OSError as e:
        _log.warning("dataset cache store failed for %s (%s)", path, e)
    return arrays
