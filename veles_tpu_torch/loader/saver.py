"""Minibatch stream recording and replay (``veles_tpu/loader/saver.py``).

:class:`MinibatchesSaver`, a unit linked after a loader, appends every
minibatch the loader serves (data, labels, class, epoch flags) to a
stream file; :class:`MinibatchesLoader` replays a recording as a full
batch. The format is the JAX package's, both ways: an 8-byte magic,
then frames of a little-endian u64 length and a gzip-compressed pickle
(protocol 4) -- a header ``{"class_lengths", "max_minibatch_size"}``,
then one dict a minibatch whose arrays are numpy.
"""

import gzip
import os
import pickle
import struct

import numpy
import torch

from veles_tpu_torch.loader.fullbatch import FullBatchLoader
from veles_tpu_torch.units import Unit

MAGIC = b"VTPUMB1\x00"


def _write_frame(f, obj):
    blob = gzip.compress(pickle.dumps(obj, protocol=4))
    f.write(struct.pack("<Q", len(blob)))
    f.write(blob)


def _read_frame(f):
    header = f.read(8)
    if len(header) < 8:
        return None
    (length,) = struct.unpack("<Q", header)
    return pickle.loads(gzip.decompress(f.read(length)))


def _host(value, size):
    """The first ``size`` rows of a tensor or array as a numpy copy."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value[:size].detach().cpu().numpy().copy()
    return numpy.asarray(value)[:size].copy()


class MinibatchesSaver(Unit):
    """Records every minibatch the linked loader serves into
    ``file_name``."""

    view_group = "SERVICE"

    def __init__(self, workflow, **kwargs):
        self.file_name = kwargs.pop(
            "file_name", os.path.join(".", "minibatches.vtpu"))
        super(MinibatchesSaver, self).__init__(workflow, **kwargs)
        self.demand("minibatch_data", "minibatch_labels", "minibatch_size",
                    "minibatch_class", "last_minibatch", "epoch_ended",
                    "class_lengths", "max_minibatch_size")

    def initialize(self, **kwargs):
        self._file_ = open(self.file_name, "wb")
        self._file_.write(MAGIC)
        _write_frame(self._file_, {
            "class_lengths": list(self.class_lengths),
            "max_minibatch_size": int(self.max_minibatch_size)})
        from veles_tpu_torch.workflow import Workflow
        if isinstance(self.workflow, Workflow):
            self.workflow.add_finished_callback(self.close)

    def run(self):
        size = int(self.minibatch_size)
        _write_frame(self._file_, {
            "data": _host(self.minibatch_data, size),
            "labels": _host(self.minibatch_labels, size),
            "class": int(self.minibatch_class),
            "last": bool(self.last_minibatch),
            "epoch_ended": bool(self.epoch_ended)})

    def close(self):
        f = getattr(self, "_file_", None)
        if f is not None and not f.closed:
            f.close()

    def __getstate__(self):
        state = super(MinibatchesSaver, self).__getstate__()
        state.pop("_file_", None)
        return state


class MinibatchesLoader(FullBatchLoader):
    """Replays a :class:`MinibatchesSaver` recording: one epoch's frames,
    in serving order (test, validation, train), stitched back into the
    per-sample dataset."""

    def __init__(self, file_name=None, **kwargs):
        super(MinibatchesLoader, self).__init__(**kwargs)
        self.file_name = file_name

    def load_dataset(self):
        with open(self.file_name, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError("%s is not a minibatch recording"
                                 % self.file_name)
            header = _read_frame(f)
            self.class_lengths = list(header["class_lengths"])
            self.max_minibatch_size = int(header["max_minibatch_size"])
            frames, seen = [], 0
            while seen < self.total_samples:
                frame = _read_frame(f)
                if frame is None:
                    break
                frames.append(frame)
                seen += len(frame["data"])
        if seen < self.total_samples:
            raise ValueError("recording %s holds %d samples, its header "
                             "promises %d" % (self.file_name, seen,
                                              self.total_samples))
        self.original_data = torch.from_numpy(numpy.ascontiguousarray(
            numpy.concatenate([fr["data"] for fr in frames])))
        labels = [fr["labels"] for fr in frames]
        if all(lab is not None for lab in labels):
            self.original_labels = torch.from_numpy(numpy.ascontiguousarray(
                numpy.concatenate(labels).astype(numpy.int32)))
