"""Snapshotter: whole-workflow checkpoint and resume
(``veles_tpu/snapshotter.py``).

A checkpoint is the entire workflow object -- topology, parameters,
solver state, the loader's dataset and position, the decision's
history -- plus the named ``prng`` registry (the numpy streams and the
Philox seed chains), so a resumed run continues with the identical
random streams, mid-epoch included. No device buffer is pickled: the
units hold their tensors as numpy (``distributable.HostTensor``, the
forward and gradient units in the JAX layout) and put them back on the
device that ``initialize(device=...)`` is given, so a snapshot taken on
the card loads on the CPU and the reverse.

A snapshot file is one pickle stream of a header dict (``format``,
``checksum``, ``random``, ``workflow``), with the launcher cut out by a
persistent id, raw or gz/bz2/xz-compressed (read by its magic bytes),
written atomically through a hidden staging file, and pointed at by a
``<prefix>_current.pickle`` link. :func:`load_workflow` also reads a
snapshot written by the JAX package, without importing it
(:mod:`veles_tpu_torch.jax_snapshot`).

A *sharded generation* (the elastic tier's checkpoint,
``veles_tpu/snapshotter.py``'s layout) is a directory
``<prefix><tag>.<epoch>.shards`` of one ``part<k>.pickle[.<codec>]`` per
rank -- part 0 also carries the workflow's snapshot bytes -- and a
``MANIFEST.json`` that rank 0 writes last, after every rank's part is in
place (:func:`save_snapshot_sharded`); the manifest is the generation's
completeness mark. Each part holds the records of the leaves its rank
owns: ``{"spec", "shape", "dtype", "shards": [(global index, array)]}``.
:func:`load_sharded_generation` assembles every leaf from the union of
the parts, installs it into the restored workflow
(:func:`_apply_record`: the parameters and solver state the units load
at ``initialize()``, in the JAX layout), and raises on a missing
manifest or part or a leaf not fully covered, so :func:`restore_latest`
falls back to the previous complete generation. A generation written at
one world size loads at any other, and one written by the JAX package
loads too (its part 0's workflow through
:mod:`veles_tpu_torch.jax_snapshot`). Part files are read by an
unpickler that resolves numpy's array constructors and builtins only.

Not ported yet: the ``http(s)://`` and ``sqlite://`` restores and
``SnapshotterToDB``.
"""

import bz2
import gzip
import io
import json
import logging
import lzma
import os
import pickle
import sys
import tempfile
import time

import numpy

from veles_tpu_torch import prng
from veles_tpu_torch.config import root
from veles_tpu_torch.envknob import env_knob
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.parallel.mesh import is_rank_zero
from veles_tpu_torch.result_provider import IResultProvider
from veles_tpu_torch.units import Unit

_log = logging.getLogger("Snapshotter")

#: extension -> opener; "" means raw
CODECS = {
    "": open,
    "gz": gzip.open,
    "bz2": bz2.open,
    "xz": lzma.open,
}

#: magic bytes -> opener (robust against misleading file names)
MAGIC = ((b"\x1f\x8b", gzip.open), (b"BZh", bz2.open),
         (b"\xfd7zXZ\x00", lzma.open))

#: suffix of a sharded checkpoint generation directory: per-rank
#: ``part<k>.pickle[.<codec>]`` files and a ``MANIFEST.json`` that rank 0
#: writes last, the generation's completeness mark
SHARDED_SUFFIX = ".shards"
MANIFEST_NAME = "MANIFEST.json"


def _atomic_write(directory, name, write_fn):
    """Write ``directory/name`` through a hidden ``.*.tmp`` staging file
    and a rename: a crash mid-write neither destroys an artifact of the
    same name nor leaves a file :func:`snapshot_candidates` would take."""
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".", suffix=".tmp")
    os.close(fd)
    try:
        write_fn(tmp)
        os.replace(tmp, os.path.join(directory, name))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _read_payload(path):
    """A snapshot file's pickle bytes, the codec sniffed from its magic
    bytes (so links and renamed files load)."""
    with open(path, "rb") as probe:
        head = probe.read(8)
    for magic, opener in MAGIC:
        if head.startswith(magic):
            with opener(path, "rb") as fin:
                return fin.read()
    with open(path, "rb") as fin:
        return fin.read()


class SnapshotterBase(Unit, IResultProvider):
    """Gating and lifecycle; subclasses implement :meth:`export`.

    A snapshot is taken every ``interval`` runs, but not more often than
    every ``time_interval`` seconds, and not at all when
    ``root.common.disable.snapshotting`` is set. ``skip`` (a ``Bool``)
    suppresses it. Of a world of SPMD ranks, rank 0 alone writes."""

    hide_from_registry = True
    view_group = "SERVICE"

    def __init__(self, workflow, **kwargs):
        self.prefix = kwargs.pop("prefix", "wf")
        self.interval = kwargs.pop("interval", 1)
        self.time_interval = kwargs.pop("time_interval", 15.0)
        self.compression = kwargs.pop("compression", "gz")
        super(SnapshotterBase, self).__init__(workflow, **kwargs)
        self.suffix = ""
        self.destination = None
        self.time = 0.0
        self._skipped_counter = 0
        self.skip = Bool(False)
        #: (seconds, bytes) of each export: pickling and writing
        self.exports = []

    def initialize(self, **kwargs):
        self.time = time.time()

    def run(self):
        if root.common.disable.get("snapshotting", False):
            return
        if bool(self.skip) or not is_rank_zero():
            return
        self._skipped_counter += 1
        if self._skipped_counter < self.interval:
            return
        if time.time() - self.time < self.time_interval:
            return
        self._skipped_counter = 0
        # in the eager scheduler, after the gradient units of the
        # minibatch in flight have all run
        self.workflow.defer(self._export_now)

    def _export_now(self):
        self.export()
        self.time = time.time()

    def export(self):
        raise NotImplementedError

    def get_metric_values(self):
        """The newest snapshot's path lands in the results JSON."""
        return {"Snapshot": self.destination} if self.destination else {}


class SnapshotterToFile(SnapshotterBase):
    """Pickle the owning workflow (and the ``prng`` registry) to
    ``<directory>/<prefix>.<epoch>.pickle[.<codec>]``; the
    ``<prefix>_current.pickle[.<codec>]`` link points at the newest."""

    hide_from_registry = False

    def __init__(self, workflow, **kwargs):
        self.directory = kwargs.pop(
            "directory", root.common.dirs.get("snapshots", "."))
        super(SnapshotterToFile, self).__init__(workflow, **kwargs)

    def export(self):
        t0 = time.perf_counter()
        suffix = ("_" + self.suffix) if self.suffix else ""
        path, nbytes = save_snapshot(
            self.workflow, self.directory, tag=suffix, prefix=self.prefix,
            compression=self.compression)
        seconds = time.perf_counter() - t0
        self.destination = path
        self.exports.append((seconds, nbytes))
        self.info("snapshotted to %s (%.1f MiB in %.2f s)", path,
                  nbytes / 1048576.0, seconds)

    @staticmethod
    def import_(uri):
        """Load a snapshot from a file path (see :func:`load_workflow`)."""
        if isinstance(uri, str) and uri.startswith(
                ("http://", "https://", "sqlite://")):
            raise NotImplementedError(
                "restoring from %s is not ported yet: give a snapshot "
                "file or directory" % uri.split(":", 1)[0])
        return load_workflow(uri)


class SnapshotterToDB(SnapshotterBase):
    """The JAX package's sqlite target: not ported yet."""

    def __init__(self, workflow, **kwargs):
        raise NotImplementedError(
            "SnapshotterToDB is not ported yet: use SnapshotterToFile")


def wf_epoch(wf):
    """The epoch number a snapshot of ``wf`` is named after."""
    decision = getattr(wf, "decision", None)
    if decision is not None:
        return int(getattr(decision, "epoch_number", 0) or 0)
    loader = getattr(wf, "loader", None)
    if loader is not None:
        return int(getattr(loader, "epoch_number", 0) or 0)
    return 0


def save_snapshot(workflow, directory, tag="", prefix="wf",
                  compression="gz", payload=None):
    """Atomically write one snapshot file and refresh its ``_current``
    link; returns ``(path, payload_bytes)``. ``payload``, a
    :func:`dump_workflow` blob taken by the caller (the master dumps
    under its units' locks), skips the dump here."""
    if compression not in CODECS:
        raise ValueError("unknown compression %r (have %s)" %
                         (compression, sorted(CODECS)))
    ext = ("." + compression) if compression else ""
    name = "%s%s.%d.pickle%s" % (prefix, tag, wf_epoch(workflow), ext)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    if payload is None:
        payload = dump_workflow(workflow)

    def stage(tmp):
        with CODECS[compression](tmp, "wb") as fout:
            fout.write(payload)

    _atomic_write(directory, name, stage)
    link_path = os.path.join(directory,
                             "%s_current.pickle%s" % (prefix, ext))
    try:
        if os.path.islink(link_path) or os.path.exists(link_path):
            os.unlink(link_path)
        os.symlink(name, link_path)
    except OSError as exc:  # filesystems without symlinks
        _log.debug("could not update %s: %s", link_path, exc)
    return path, len(payload)


def _candidate_mtime(path):
    """Sort key of a candidate: a generation directory ages by its
    manifest (the last file written), not by the directory."""
    if os.path.isdir(path):
        manifest = os.path.join(path, MANIFEST_NAME)
        if os.path.exists(manifest):
            return os.path.getmtime(manifest)
    return os.path.getmtime(path)


def snapshot_candidates(directory, prefix=None):
    """Snapshot paths under a :class:`SnapshotterToFile` directory,
    best first: the ``_current`` link's target, then the rest newest
    first. Candidates are snapshot files and sharded generation
    directories with a manifest; hidden and ``*.tmp`` staging files and
    generations without their manifest (torn by a death mid-save) never
    are."""
    current = None
    rest = []
    for name in os.listdir(directory):
        if name.startswith(".") or name.endswith(".tmp"):
            continue
        if prefix is not None and not name.startswith(prefix):
            continue
        path = os.path.join(directory, name)
        if "_current.pickle" in name:
            # the link may point at a file or at a generation directory
            resolved = os.path.realpath(path)
            if os.path.isdir(resolved) and not os.path.exists(
                    os.path.join(resolved, MANIFEST_NAME)):
                continue
            if os.path.exists(resolved):
                current = resolved
            continue
        if os.path.isdir(path):
            if name.endswith(SHARDED_SUFFIX) and os.path.exists(
                    os.path.join(path, MANIFEST_NAME)):
                rest.append(path)
            continue
        if ".pickle" in name:
            rest.append(path)
    rest.sort(key=_candidate_mtime, reverse=True)
    if current is not None:
        rest = [p for p in rest if os.path.realpath(p) != current]
        return [current] + rest
    return rest


def latest_snapshot(directory, prefix=None):
    """The newest snapshot in a :class:`SnapshotterToFile` directory."""
    candidates = snapshot_candidates(directory, prefix)
    if not candidates:
        raise FileNotFoundError("no snapshots under %s" % directory)
    return candidates[0]


def restore_latest(directory, prefix=None):
    """Load the newest loadable snapshot: ``(workflow, path)``. A
    truncated or corrupt newest file falls back to the previous one with
    a warning."""
    candidates = snapshot_candidates(directory, prefix)
    if not candidates:
        raise FileNotFoundError("no snapshots under %s" % directory)
    last_error = None
    for path in candidates:
        try:
            return load_workflow(path), path
        except Exception as e:  # noqa: BLE001 -- any load failure
            last_error = e
            _log.warning("snapshot %s is unloadable (%s: %s); falling back "
                         "to the previous one", path, type(e).__name__, e)
    raise FileNotFoundError(
        "no loadable snapshot under %s (%d candidate(s), last error: %s)"
        % (directory, len(candidates), last_error))


class _LauncherCuttingPickler(pickle.Pickler):
    """Pickles a workflow without its launcher, which becomes a
    persistent id (restored as None)."""

    def __init__(self, fileobj, launcher):
        super(_LauncherCuttingPickler, self).__init__(
            fileobj, protocol=pickle.HIGHEST_PROTOCOL)
        self._launcher = launcher

    def persistent_id(self, obj):
        if self._launcher is not None and obj is self._launcher:
            return "veles-launcher"
        return None


class _SnapshotUnpickler(pickle.Unpickler):
    def persistent_load(self, pid):
        return None  # the restored workflow re-binds to a new launcher


def dump_workflow(workflow):
    """Serialize a workflow to bytes: header, graph, ``prng`` registry."""
    blob = {
        "format": 1,
        "checksum": workflow.checksum,
        "random": dict(prng._generators),
        "workflow": workflow,
    }
    buf = io.BytesIO()
    _LauncherCuttingPickler(buf, workflow.workflow).dump(blob)
    return buf.getvalue()


def mark_restored(container):
    """Flag a restored workflow and its units (any depth): their
    ``initialize()`` keeps the snapshot's epoch position."""
    container._restored_from_snapshot_ = True
    for unit in container:
        unit._restored_from_snapshot_ = True
        if hasattr(unit, "__iter__"):
            mark_restored(unit)


def load_workflow(path_or_bytes):
    """Inverse of :func:`dump_workflow` for a path or raw bytes, with the
    ``prng`` registry restored. A snapshot of the JAX package is read by
    :func:`veles_tpu_torch.jax_snapshot.load` (which imports neither
    JAX nor the JAX package); a sharded generation directory by
    :func:`load_sharded_generation`."""
    if isinstance(path_or_bytes, (str, os.PathLike)) and \
            os.path.isdir(path_or_bytes):
        return load_sharded_generation(os.fspath(path_or_bytes))
    payload = path_or_bytes if isinstance(path_or_bytes, bytes) \
        else _read_payload(path_or_bytes)
    from veles_tpu_torch import jax_snapshot
    if jax_snapshot.is_jax_snapshot(payload):
        return jax_snapshot.load(payload)
    blob = _SnapshotUnpickler(io.BytesIO(payload)).load()
    if not isinstance(blob, dict) or "workflow" not in blob:
        raise pickle.UnpicklingError(
            "not a veles snapshot stream (missing workflow header)")
    for key, gen in blob.get("random", {}).items():
        prng._generators[key] = gen
    workflow = blob["workflow"]
    mark_restored(workflow)
    if workflow.checksum != blob["checksum"]:
        workflow.warning("restored workflow checksum differs from the "
                         "one recorded at snapshot time")
    return workflow


# -- sharded checkpoint generations ---------------------------------------


class ShardedLeaf(object):
    """One checkpoint leaf as one rank holds it: the global ``shape`` and
    ``dtype``, and ``shards``, the ``[(global index, numpy block)]`` this
    rank writes (none when another rank writes its blocks)."""

    def __init__(self, shape, dtype, shards):
        self.shape = tuple(int(n) for n in shape)
        self.dtype = str(dtype)
        self.shards = list(shards)

    def __repr__(self):
        return "ShardedLeaf(%s, %s, %d shard(s))" % (
            self.shape, self.dtype, len(self.shards))


def shard_records(value):
    """``(meta, entries)`` of one checkpoint leaf as this rank holds it:
    a :class:`ShardedLeaf`'s shape and dtype and its shards; ``(None,
    None)`` for a host value, which rank 0 writes whole."""
    if not isinstance(value, ShardedLeaf):
        return None, None
    return {"shape": value.shape, "dtype": value.dtype}, list(value.shards)


def _part_name(k, compression="gz"):
    ext = ("." + compression) if compression else ""
    return "part%d.pickle%s" % (k, ext)


def _write_part_file(gen_dir, k, part, compression="gz"):
    """Atomically write rank ``k``'s part file; returns its pickled
    bytes."""
    payload = pickle.dumps(part, protocol=pickle.HIGHEST_PROTOCOL)

    def stage(tmp):
        with CODECS[compression](tmp, "wb") as fout:
            fout.write(payload)

    _atomic_write(gen_dir, _part_name(k, compression), stage)
    return len(payload)


def _write_manifest(gen_dir, nparts, epoch, checksum=None,
                    compression="gz", extra=None):
    manifest = {"format": 1, "kind": "veles-sharded-snapshot",
                "nparts": int(nparts), "epoch": int(epoch),
                "parts": [_part_name(k, compression)
                          for k in range(nparts)],
                "created": time.time(), "checksum": checksum}
    if extra:
        manifest.update(extra)

    def stage(tmp):
        with open(tmp, "w") as fout:
            json.dump(manifest, fout, indent=1)

    _atomic_write(gen_dir, MANIFEST_NAME, stage)


def save_snapshot_sharded(workflow, directory, records, *,
                          process_index=0, process_count=1, tag="",
                          prefix="wf", compression="gz", barrier=None,
                          link_tag=None, manifest_extra=None):
    """Write this rank's part of one sharded checkpoint generation.

    ``records``: ``[(spec, leaf)]`` (``FusedTrainer.checkpoint_records``),
    the same specs in the same order on every rank; a leaf is a
    :class:`ShardedLeaf` (each rank writes its shards) or a host value
    (rank 0 writes it, a numpy array as one shard covering it whole).
    ``barrier``, a callable (the world's ``torch.distributed.barrier``),
    runs after the part is written; rank 0 then writes the manifest,
    points ``<prefix><link_tag>_current.pickle`` at the generation when
    ``link_tag`` is given, and keeps the newest ``VELES_SNAPSHOT_KEEP``
    complete generations when that is set. Returns ``(generation
    directory, bytes pickled by this rank)``."""
    if compression not in CODECS:
        raise ValueError("unknown compression %r (have %s)" %
                         (compression, sorted(CODECS)))
    epoch = wf_epoch(workflow)
    name = "%s%s.%d%s" % (prefix, tag, epoch, SHARDED_SUFFIX)
    gen_dir = os.path.join(directory, name)
    os.makedirs(gen_dir, exist_ok=True)
    out_records = []
    for spec, value in records:
        meta, entries = shard_records(value)
        if meta is not None:
            out_records.append({"spec": spec, "shape": meta["shape"],
                                "dtype": meta["dtype"], "shards": entries})
        elif process_index == 0:
            if isinstance(value, numpy.ndarray):
                out_records.append({
                    "spec": spec, "shape": tuple(value.shape),
                    "dtype": str(value.dtype),
                    "shards": [((slice(None),) * value.ndim, value)]})
            else:
                out_records.append({"spec": spec, "value": value})
    part = {"format": 1, "part": int(process_index),
            "records": out_records}
    if process_index == 0:
        part["workflow"] = dump_workflow(workflow)
    nbytes = _write_part_file(gen_dir, process_index, part, compression)
    if barrier is not None:
        barrier()
    if process_index == 0:
        _write_manifest(gen_dir, process_count, epoch,
                        checksum=getattr(workflow, "checksum", None),
                        compression=compression, extra=manifest_extra)
        if link_tag is not None:
            link_path = os.path.join(
                directory, "%s%s_current.pickle" % (prefix, link_tag))
            try:
                if os.path.islink(link_path) or os.path.exists(link_path):
                    os.unlink(link_path)
                os.symlink(name, link_path)
            except OSError as exc:  # filesystems without symlinks
                _log.debug("could not update %s: %s", link_path, exc)
        keep = env_knob("VELES_SNAPSHOT_KEEP", None, parse=int,
                        on_error="default")
        if keep is not None and keep >= 1:
            prune_sharded_generations(directory, keep, prefix=prefix)
    return gen_dir, nbytes


def prune_sharded_generations(directory, keep, prefix="wf"):
    """Keep the newest ``keep`` complete generations (manifest present)
    under ``directory`` and remove the older ones; torn or in-flight
    generations and the target of any ``*_current.pickle*`` link are
    left alone. Returns the paths removed."""
    import shutil
    keep = int(keep)
    if keep < 1:
        raise ValueError("keep must be >= 1 (got %d)" % keep)
    protected = set()
    generations = []
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        if "_current.pickle" in name:
            protected.add(os.path.realpath(path))
            continue
        if name.startswith(".") or name.endswith(".tmp"):
            continue
        if not name.endswith(SHARDED_SUFFIX) or not os.path.isdir(path):
            continue
        if prefix is not None and not name.startswith(prefix):
            continue
        if not os.path.exists(os.path.join(path, MANIFEST_NAME)):
            continue
        generations.append(path)
    generations.sort(key=_candidate_mtime, reverse=True)
    removed = []
    for path in generations[keep:]:
        if os.path.realpath(path) in protected:
            continue
        try:
            shutil.rmtree(path)
        except OSError:
            continue  # a reader or another pruner got there first
        removed.append(path)
    return removed


def generation_manifest(gen_dir):
    """The manifest of a sharded generation (``world_size``,
    ``generation`` and the source grid's ``mesh_axes`` among its extras);
    raises on a torn generation."""
    with open(os.path.join(gen_dir, MANIFEST_NAME)) as fin:
        manifest = json.load(fin)
    if manifest.get("kind") != "veles-sharded-snapshot":
        raise pickle.UnpicklingError(
            "not a sharded snapshot manifest: %s" % gen_dir)
    return manifest


class _PartUnpickler(pickle.Unpickler):
    """Resolves numpy's array constructors and builtins only: a part
    file holds records of arrays and the workflow's snapshot bytes,
    whichever package wrote it."""

    def find_class(self, module, name):
        from veles_tpu_torch.jax_snapshot import _ALLOWED
        if name in _ALLOWED.get(module, ()):
            loaded = sys.modules.get(module)
            if loaded is not None:
                return getattr(loaded, name)
        raise pickle.UnpicklingError(
            "a sharded snapshot part names %s.%s" % (module, name))


def _read_part_file(path):
    part = _PartUnpickler(io.BytesIO(_read_payload(path))).load()
    if not isinstance(part, dict) or "records" not in part:
        raise pickle.UnpicklingError(
            "not a sharded-snapshot part: %s" % path)
    return part


def _apply_record(workflow, spec, value):
    """Install one assembled leaf into a restored, not yet initialized
    workflow, where the units keep a snapshot's state in the JAX layout
    until ``initialize()``:

    * ``{"kind": "param", "forward": i, "name": n}``: parameter ``n`` of
      forward ``i`` (its ``_params``);
    * ``{"kind": "opt", "forward": i, "path": [...]}``: one solver state
      leaf of the gradient unit of forward ``i`` (its ``_solver_state``).
    """
    kind = spec.get("kind")
    fwd = list(workflow.forwards)[spec["forward"]]
    if kind == "param":
        fwd.__dict__.setdefault("_params", {})[spec["name"]] = value
        return
    if kind == "opt":
        gd = next((g for g in getattr(workflow, "gds", ())
                   if g.forward is fwd), None)
        if gd is None:
            raise KeyError("no gradient unit for forward %d"
                           % spec["forward"])
        path = list(spec["path"])
        node = gd.__dict__.get("_solver_state")
        if not isinstance(node, dict):
            node = gd.__dict__["_solver_state"] = {}
        for key in path[:-1]:
            if not isinstance(node.get(key), dict):
                node[key] = {}
            node = node[key]
        node[path[-1]] = value
        return
    raise KeyError("unknown sharded record kind %r" % kind)


def load_sharded_generation(gen_dir):
    """One complete sharded generation -> the restored workflow (not
    initialized), the ``prng`` registry restored from part 0's snapshot.
    Raises when the manifest or any part is missing or unreadable, or a
    leaf's shards do not cover its global shape."""
    manifest = generation_manifest(gen_dir)
    parts = [_read_part_file(os.path.join(gen_dir, name))
             for name in manifest["parts"]]
    part0 = next((p for p in parts if "workflow" in p), None)
    if part0 is None:
        raise pickle.UnpicklingError(
            "no part carries the workflow: %s" % gen_dir)
    workflow = load_workflow(part0["workflow"])
    assembled, order = {}, []
    for part in parts:
        for rec in part["records"]:
            key = json.dumps(rec["spec"], sort_keys=True)
            if key not in assembled:
                order.append(key)
                if "value" in rec:
                    assembled[key] = {"spec": rec["spec"],
                                      "value": rec["value"]}
                    continue
                assembled[key] = {
                    "spec": rec["spec"],
                    "out": numpy.empty(tuple(rec["shape"]),
                                       dtype=rec["dtype"]),
                    "covered": 0}
            slot = assembled[key]
            for index, data in rec.get("shards", ()):
                slot["out"][tuple(index)] = data
                slot["covered"] += int(numpy.asarray(data).size)
    for key in order:
        slot = assembled[key]
        if "value" in slot:
            _apply_record(workflow, slot["spec"], slot["value"])
            continue
        if slot["covered"] != slot["out"].size:
            raise ValueError(
                "sharded leaf %s covers %d of %d elements in %s: an "
                "incomplete generation" % (
                    key, slot["covered"], slot["out"].size, gen_dir))
        _apply_record(workflow, slot["spec"], slot["out"])
    return workflow
