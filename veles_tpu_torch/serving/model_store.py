"""Serveable models and the named, versioned store
(``veles_tpu/serving/model_store.py``).

A :class:`ServeableModel` is what a replica runs: the port's model
(``nn.Sequential`` on one device), the per-sample input shape the
frontend validates against, a name and a version. Models come from a
layer list with weights drawn from a seed, or from the JAX package's
per-layer parameters through :func:`veles_tpu_torch.convert.
params_from_jax`, or from a trained workflow or a snapshot of one (the
port's or the JAX package's), or from an export package
(``export/package.py``, the port's or the JAX package's: a directory or
``.tar`` holding ``contents.json``), or from any module the caller
built.

A package is served as the JAX loader serves it: the dense units only
(``All2All`` and its activations, ``All2AllSoftmax``,
``ActivationUnit``, ``DropoutForward`` as the identity), rebuilt as the
port's modules, so ``All2All`` layers run K1 on the card and the
softmax head its plain product; any other unit raises
:class:`ModelLoadError` (serve the snapshot instead).

:class:`ModelStore` keeps versions per name with pinning and
keep-last-K retention; the replica pool promotes whatever ``get``
returns. ``load`` takes a package, a snapshot file, or a snapshot
directory whose newest loadable snapshot it serves (a corrupt newest
file is skipped with a warning).
"""

import io
import json
import logging
import os
import tarfile
import threading

import numpy
import torch

from veles_tpu_torch.models.build import build_model
from veles_tpu_torch.nn.precision import policy_of

_log = logging.getLogger(__name__)

#: package unit class -> the layer descriptor type it serves as
_DENSE_TYPES = {"All2All": "all2all", "All2AllTanh": "all2all_tanh",
                "All2AllRELU": "all2all_relu",
                "All2AllStrictRELU": "all2all_str",
                "All2AllSigmoid": "all2all_sigmoid",
                "All2AllSoftmax": "softmax",
                "ActivationUnit": "activation",
                "DropoutForward": "dropout"}


class ModelLoadError(Exception):
    """The artifact at the given path is not a serveable model."""


def _dense_layer(entry, resolve):
    """(descriptor, JAX-layout params) of one package unit."""
    cls = entry["class"]["name"]
    data = entry["data"]
    ltype = _DENSE_TYPES.get(cls)
    if ltype is None:
        raise ModelLoadError(
            "package unit %r is not supported by the serving loader "
            "(serve the snapshot instead)" % cls)
    descr = {"type": ltype}
    if ltype == "activation":
        descr["activation"] = data["activation"]
    if ltype == "dropout" or ltype == "activation":
        return descr, {}
    descr["output_sample_shape"] = tuple(data["output_sample_shape"])
    if ltype != "softmax":
        descr["activation"] = data["activation"]
    params = {"weights": resolve(data["weights"])}
    if "bias" in data:
        params["bias"] = resolve(data["bias"])
    else:
        descr["include_bias"] = False
    return descr, params


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

    @classmethod
    def from_workflow(cls, workflow, name=None, version=1, source=None):
        """Serve an initialized training workflow's model: its forward
        units' modules, with dropout the identity (the modules' own
        ``forward``). The sample shape is the loader's."""
        forwards = getattr(workflow, "forwards", None)
        if not forwards or any(f.module is None for f in forwards):
            raise ValueError("workflow %r has no initialized forward chain "
                             "to serve" % (workflow,))
        for fwd in forwards:
            if hasattr(fwd, "testing"):
                fwd.testing = True
        return cls(workflow.model, forwards[0].input_shape,
                   name=name or workflow.name, version=version,
                   source=source or "workflow")

    @classmethod
    def from_package(cls, path, name=None, version=1, device=None):
        """Serve an export package (a directory or ``.tar``), put on
        ``device`` (the card by default)."""
        contents, members = _read_package(path)
        info = contents.get("workflow") or {}

        def resolve(ref):
            array = members.get(ref)
            if array is None:
                raise ModelLoadError("package member %r missing" % ref)
            return numpy.asarray(array, numpy.float32)

        layers = [_dense_layer(entry, resolve)
                  for entry in info.get("units", [])]
        if not layers:
            raise ModelLoadError("package %s has no units" % path)
        input_shape = contents.get("input_shape")
        if input_shape:
            sample_shape = tuple(input_shape[1:])
        elif "weights" in layers[0][1]:
            sample_shape = (int(layers[0][1]["weights"].shape[0]),)
        else:
            raise ModelLoadError("cannot infer the sample shape of %s"
                                 % path)
        module = build_model([d for d, _ in layers], sample_shape,
                             params=[p for _, p in layers], device=device)
        return cls(module, sample_shape, name=name or info.get(
            "name", "model"), version=version, source=str(path))

    @classmethod
    def from_snapshot(cls, path, name=None, version=1, device=None):
        """Serve the model of a snapshot file (the port's or the JAX
        package's), put on ``device`` (the card by default)."""
        from veles_tpu_torch.snapshotter import load_workflow
        workflow = load_workflow(path)
        workflow.initialize(device=device)
        return cls.from_workflow(workflow, name=name, version=version,
                                 source=str(path))

    def __call__(self, batch):
        """Forward a numpy batch (leading batch axis); float32 numpy
        out. Waits for the device. Runs under the policy's
        ``backends()``: no TF32, no bf16 reductions in bf16."""
        with torch.inference_mode(), self.policy.backends():
            x = torch.from_numpy(numpy.ascontiguousarray(
                batch, numpy.float32)).to(self.device)
            return self.module(x).float().cpu().numpy()


def _read_package(path):
    """(contents.json, {member: array}) of a package directory or tar."""
    members = {}
    if os.path.isdir(path):
        with open(os.path.join(path, "contents.json"), "rb") as f:
            contents = json.loads(f.read())
        for fname in os.listdir(path):
            if fname.startswith("@") and fname.endswith(".npy"):
                members[fname[:-len(".npy")]] = numpy.load(
                    os.path.join(path, fname), allow_pickle=False)
    else:
        with tarfile.open(path, "r") as tar:
            contents = json.loads(tar.extractfile("contents.json").read())
            for info in tar.getmembers():
                if info.name.startswith("@") and \
                        info.name.endswith(".npy"):
                    members[info.name[:-len(".npy")]] = numpy.load(
                        io.BytesIO(tar.extractfile(info).read()),
                        allow_pickle=False)
    return contents, members


def _is_package(path):
    """A directory holding ``contents.json``, or a ``.tar`` that holds
    it."""
    if os.path.isdir(path):
        return os.path.exists(os.path.join(path, "contents.json"))
    if str(path).endswith(".tar") and os.path.exists(path):
        try:
            with tarfile.open(path, "r") as tar:
                return "contents.json" in tar.getnames()
        except tarfile.TarError:
            return False
    return False


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

    def load(self, source, name=None, version=None, device=None):
        """Load an export package, a snapshot file, or the newest
        loadable snapshot of a snapshot directory, and register it;
        returns the model."""
        path = str(source)
        if _is_package(path):
            model = ServeableModel.from_package(path, name=name,
                                                device=device)
        elif os.path.isdir(path):
            model = self._load_from_snapshot_dir(path, name, device)
        else:
            model = ServeableModel.from_snapshot(path, name=name,
                                                 device=device)
        return self.add(model, version=version)

    def _load_from_snapshot_dir(self, path, name, device):
        from veles_tpu_torch.snapshotter import snapshot_candidates
        candidates = snapshot_candidates(path)
        if not candidates:
            raise FileNotFoundError("no snapshots under %s" % path)
        last_error = None
        for candidate in candidates:
            try:
                return ServeableModel.from_snapshot(candidate, name=name,
                                                    device=device)
            except Exception as e:  # noqa: BLE001 -- any load failure
                last_error = e
                _log.warning("skipping unloadable snapshot %s: %s",
                             candidate, e)
        raise FileNotFoundError("no loadable snapshot under %s (newest "
                                "error: %s)" % (path, last_error))

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
