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

Not ported yet: the sharded generation directories of the parallel
tier, the ``http(s)://`` and ``sqlite://`` restores and
``SnapshotterToDB``.
"""

import bz2
import gzip
import io
import logging
import lzma
import os
import pickle
import tempfile
import time

from veles_tpu_torch import prng
from veles_tpu_torch.config import root
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

#: suffix of the parallel tier's sharded generation directories
SHARDED_SUFFIX = ".shards"


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


def snapshot_candidates(directory, prefix=None):
    """Snapshot paths under a :class:`SnapshotterToFile` directory,
    best first: the ``_current`` link's target, then the rest newest
    first. Hidden and ``*.tmp`` staging files are never candidates;
    sharded generation directories are, and fail to load."""
    current = None
    rest = []
    for name in os.listdir(directory):
        if name.startswith(".") or name.endswith(".tmp"):
            continue
        if prefix is not None and not name.startswith(prefix):
            continue
        path = os.path.join(directory, name)
        if "_current.pickle" in name:
            resolved = os.path.realpath(path)
            if os.path.exists(resolved):
                current = resolved
            continue
        if os.path.isdir(path):
            if name.endswith(SHARDED_SUFFIX):
                rest.append(path)
            continue
        if ".pickle" in name:
            rest.append(path)
    rest.sort(key=os.path.getmtime, reverse=True)
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
    JAX nor the JAX package)."""
    if isinstance(path_or_bytes, (str, os.PathLike)) and \
            os.path.isdir(path_or_bytes):
        raise NotImplementedError(
            "%s is a sharded generation directory: the port reads single "
            "snapshot files until its parallel tier lands" % path_or_bytes)
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
