"""Serveable models and the named, versioned store.

The port of ``veles_tpu/serving/model_store.py`` without the snapshot
and export-package loaders (they need the snapshotter's port). A
:class:`ServeableModel` is what a replica runs: the port's model
(``nn.Sequential`` on one device), the per-sample input shape the
frontend validates against, a name and a version. Models come from a
layer list with weights drawn from a seed, or from the JAX package's
per-layer parameters through :func:`veles_tpu_torch.convert.
params_from_jax`, or from any module the caller built.

:class:`ModelStore` keeps versions per name with pinning and
keep-last-K retention; the replica pool promotes whatever ``get``
returns.
"""

import logging
import threading

import numpy
import torch

from veles_tpu_torch.models.build import build_model
from veles_tpu_torch.nn.precision import policy_of

_log = logging.getLogger(__name__)


class ServeableModel(object):
    """An inference function: module + sample shape + identity."""

    def __init__(self, module, sample_shape, name="model", version=1,
                 source=None):
        self.module = module.eval()
        self.sample_shape = tuple(sample_shape)
        self.name = name
        self.version = int(version)
        self.source = source
        self.device = next(module.parameters()).device
        self.policy = policy_of(module)

    def __repr__(self):
        return "<ServeableModel %s v%d sample=%s on %s>" % (
            self.name, self.version, self.sample_shape, self.device)

    @classmethod
    def from_layers(cls, layers, sample_shape, params=None, seed=None,
                    policy="float32", device=None, name="model",
                    version=1):
        """Build from a layer list: weights from ``params`` (the JAX
        package's per-layer dicts) or drawn from ``seed``. ``device``
        defaults to the card and raises without one."""
        module = build_model(layers, sample_shape, params=params,
                             seed=seed, policy=policy, device=device)
        return cls(module, sample_shape, name=name, version=version,
                   source="layers" if params is None else "jax params")

    def __call__(self, batch):
        """Forward a numpy batch (leading batch axis); float32 numpy
        out. Waits for the device. Runs under the policy's
        ``backends()``: no TF32, no bf16 reductions in bf16."""
        with torch.inference_mode(), self.policy.backends():
            x = torch.from_numpy(numpy.ascontiguousarray(
                batch, numpy.float32)).to(self.device)
            return self.module(x).float().cpu().numpy()


class ModelStore(object):
    """Named, versioned serveable models with pinning and retention.

    Versions count up per name. ``get(name)`` returns the pinned
    version if one is set, else the newest. ``keep_last=K`` bounds each
    name to its newest K versions: on ``add()``, older unpinned
    versions are dropped. Pinned versions are exempt."""

    def __init__(self, keep_last=None):
        self._lock = threading.Lock()
        self._models = {}   # name -> {version: ServeableModel}
        self._pins = {}     # name -> version
        self.keep_last = int(keep_last) if keep_last else None

    def add(self, model, version=None, name=None):
        """Register under ``name`` (default: the model's own name)."""
        with self._lock:
            key = name or model.name
            versions = self._models.setdefault(key, {})
            if version is None:
                version = max(versions, default=0) + 1
            model.version = int(version)
            versions[model.version] = model
            retired = self._retire_locked(key)
        _log.info("registered %s v%d (from %s)", key, model.version,
                  model.source)
        for old in retired:
            _log.info("retired %s v%d (keep_last=%d)", old.name,
                      old.version, self.keep_last)
        return model

    def _retire_locked(self, name):
        """Drop the oldest unpinned versions beyond ``keep_last``."""
        if not self.keep_last:
            return []
        versions = self._models.get(name, {})
        pinned = self._pins.get(name)
        retired = []
        for v in sorted(versions):
            if len(versions) <= self.keep_last:
                break
            if v == pinned or v == max(versions):
                continue                # pinned + newest are exempt
            retired.append(versions.pop(v))
        return retired

    def get(self, name=None, version=None):
        with self._lock:
            if name is None:
                if len(self._models) != 1:
                    raise KeyError(
                        "store holds %d models — name one of %s" %
                        (len(self._models), sorted(self._models)))
                name = next(iter(self._models))
            versions = self._models.get(name)
            if not versions:
                raise KeyError("no model named %r" % name)
            if version is None:
                version = self._pins.get(name, max(versions))
            model = versions.get(int(version))
            if model is None:
                raise KeyError("no version %s of %r (have %s)" %
                               (version, name, sorted(versions)))
            return model

    def pin(self, name, version):
        """Pin ``get(name)`` to an exact version (rollback lever)."""
        with self._lock:
            versions = self._models.get(name) or {}
            if int(version) not in versions:
                raise KeyError("no version %s of %r (have %s)" %
                               (version, name, sorted(versions)))
            self._pins[name] = int(version)

    def unpin(self, name):
        with self._lock:
            self._pins.pop(name, None)

    def versions(self, name):
        with self._lock:
            return sorted(self._models.get(name, {}))

    def names(self):
        with self._lock:
            return sorted(self._models)
