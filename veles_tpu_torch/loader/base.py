"""Loader geometry, shuffling and epoch state (``veles_tpu/loader/base.py``).

A loader is a unit of the workflow graph; ``workflow`` is an optional
keyword, so a loader built on its own (``build_training`` and the tests
do) works as before. What the fused trainer and ``FusedRunner`` read,
kept as the JAX package has it:

* three sample classes laid out one after another in index space --
  TEST [0, t), VALIDATION [t, t+v), TRAIN [t+v, total) -- with
  ``class_lengths = [test, valid, train]`` and ``class_end_offsets``;
* ``shuffled_indices``, the global permutation; only the TRAIN segment
  is reshuffled between epochs (:meth:`Loader.shuffle`), from the
  loader's own named stream (``"loader"``) of ``veles_tpu_torch.prng``,
  so the same seed gives the JAX package's permutations, bit for bit;
* ``max_minibatch_size``, cut to the largest class, and
  ``shuffle_limit``, the last epoch after which a shuffle happens;
* the epoch state: ``epoch_number``, ``epoch_ended``,
  ``last_minibatch`` and ``train_ended`` (shared ``Bool`` cells the
  decision and the services gate on), ``minibatch_class``,
  ``minibatch_offset``, ``samples_served``, ``_global_offset`` (the
  position inside the epoch that a snapshot freezes) and
  ``failed_minibatches``; :meth:`Loader._finish_epoch` is the epoch
  wrap.

``minibatch_data``, ``minibatch_labels`` and ``minibatch_indices`` are
tensors on the ``meta`` device after ``initialize()``: they carry the
minibatch's shape to the units linked to them and hold no data. The
eager serving loop (``run()``, :meth:`Loader.serve_next_minibatch`) is
the JAX loader's: each call advances the epoch position by one
minibatch (classes in the order test, validation, train; a short tail
padded to ``max_minibatch_size`` with index -1), sets the flags the
decision reads, and has :meth:`Loader.fill_minibatch` put real device
tensors in those attributes. The fused trainer reads index matrices
instead (``train/step.py`` ``_segment_indices``). In a snapshot the
minibatch tensors keep only their shape. The distribution hooks are the
JAX loader's: a master serves index payloads, requeues what a dropped
slave held, and rewinds to an epoch's start on a resume
(:meth:`Loader.reset_to_epoch_start`, which the elastic tier's restore
uses too).
"""

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.units import Unit

TEST = 0
VALIDATION = 1
TRAIN = 2
CLASS_NAMES = ("test", "validation", "train")


class Loader(Unit):
    """Base loader; subclasses implement :meth:`load_data` (and
    :meth:`sample_shape`)."""

    hide_from_registry = True
    view_group = "LOADER"
    #: what :meth:`fill_minibatch` fills; a snapshot keeps their shapes
    SHAPE_ONLY_STATE = ("minibatch_data", "minibatch_labels",
                        "minibatch_indices")

    def __init__(self, minibatch_size=100, shuffle_limit=numpy.inf,
                 rand="loader", workflow=None, **kwargs):
        super(Loader, self).__init__(workflow, **kwargs)
        self.max_minibatch_size = int(minibatch_size)
        self.shuffle_limit = shuffle_limit
        self.rand_name = rand
        self.class_lengths = [0, 0, 0]
        self.shuffled_indices = None
        self.minibatch_data = None
        self.minibatch_labels = None
        self.minibatch_indices = None
        self.minibatch_size = 0
        self.minibatch_class = TRAIN
        self.minibatch_offset = 0
        self.epoch_number = 0
        self.epoch_ended = Bool(False)
        self.last_minibatch = Bool(False)
        self.train_ended = Bool(False)
        self.failed_minibatches = []
        self.samples_served = 0
        self._global_offset = 0

    def init_unpickled(self):
        super(Loader, self).init_unpickled()
        #: the device the eager minibatches go to (``initialize``'s)
        self.device_ = None
        #: master: slave id -> the payloads it holds, oldest first
        self._pending_ = {}

    @property
    def total_samples(self):
        return int(sum(self.class_lengths))

    @property
    def class_end_offsets(self):
        ends, acc = [], 0
        for length in self.class_lengths:
            acc += length
            ends.append(acc)
        return ends

    def load_data(self):
        """Set ``class_lengths`` (and hold the data)."""
        raise NotImplementedError

    def sample_shape(self):
        """The per-sample shape of the data (for ``minibatch_data``)."""
        raise NotImplementedError

    def fill_minibatch(self):
        """Put the minibatch of ``minibatch_indices`` (an int32 tensor on
        ``device_``, -1 in padded slots) into the minibatch tensors."""
        raise NotImplementedError

    def fill_indices(self, indices, kind="labels", out=None):
        """Host ETL of an arbitrary index vector without touching the
        minibatch state: ``(data_rows, truth_rows)`` host tensors, index
        -1 giving a zero data row and the truth taken at ``max(idx,
        0)``. Thread-safe over read-only state: the prefetch pipeline
        calls it from worker threads."""
        raise NotImplementedError(
            "%s does not support prefetchable fills" % type(self).__name__)

    def iter_shards(self, klass, shard_samples):
        """The class's shuffled sample indices in shards of
        ``shard_samples`` (the last one short), for consumers of
        :meth:`fill_indices` outside the fused trainer (which shards its
        index matrix itself)."""
        ends = self.class_end_offsets
        start = ends[klass] - self.class_lengths[klass]
        seg = numpy.asarray(self.shuffled_indices[start:ends[klass]],
                            numpy.int32)
        for offset in range(0, len(seg), shard_samples):
            yield seg[offset:offset + shard_samples]

    def initialize(self, device=None, **kwargs):
        """Load the data, cut the minibatch to the largest class, set up
        the permutation and the shape-only minibatch tensors. A loader
        restored from a snapshot keeps its epoch position and flags.
        Returns the loader."""
        self.device_ = device
        self.load_data()
        if self.total_samples == 0:
            raise ValueError("%s loaded an empty dataset"
                             % type(self).__name__)
        self.max_minibatch_size = min(self.max_minibatch_size, max(
            length for length in self.class_lengths if length))
        if self.shuffled_indices is None:
            self.shuffled_indices = numpy.arange(self.total_samples,
                                                 dtype=numpy.int32)
        mb = self.max_minibatch_size
        self.minibatch_data = torch.empty((mb,) + tuple(
            self.sample_shape()), device="meta")
        self.minibatch_labels = torch.empty((mb,), dtype=torch.int32,
                                            device="meta")
        self.minibatch_indices = torch.empty((mb,), dtype=torch.int32,
                                             device="meta")
        if getattr(self, "_restored_from_snapshot_", False):
            self._restored_from_snapshot_ = False
        else:
            self._global_offset = 0
            self.epoch_ended <<= False
            self.last_minibatch <<= False
        return self

    def run(self):
        if self.is_slave:
            # the minibatch came in with the job (apply_data_from_master):
            # a slave never advances the serving order itself
            return
        self.serve_next_minibatch()

    # -- the eager serving loop -------------------------------------------

    def _advance_global_offset(self):
        """Move to the next minibatch, wrapping the epoch (and
        reshuffling) first when the last one ended it. Returns (start,
        count) in index space."""
        if self._global_offset >= self.total_samples:
            self._finish_epoch()
        ends = self.class_end_offsets
        klass = next(k for k, end in enumerate(ends)
                     if self._global_offset < end and self.class_lengths[k])
        count = min(self.max_minibatch_size,
                    ends[klass] - self._global_offset)
        start = self._global_offset
        self._global_offset += count
        self.minibatch_class = klass
        self.minibatch_offset = self._global_offset
        self.minibatch_size = count
        self.last_minibatch <<= self._global_offset == ends[klass]
        self.train_ended <<= (klass == TRAIN and
                              self._global_offset == ends[TRAIN])
        self.epoch_ended <<= self._global_offset == self.total_samples
        return start, count

    def _next_payload(self):
        """The next minibatch as a self-contained description: its
        sample indices, class, position and flags (a requeued one
        first)."""
        if self.failed_minibatches:
            return self.failed_minibatches.pop()
        start, count = self._advance_global_offset()
        return {"indices": numpy.asarray(
                    self.shuffled_indices[start:start + count]),
                "class": self.minibatch_class, "start": start,
                "size": count, "epoch": self.epoch_number,
                "last": bool(self.last_minibatch),
                "train_ended": bool(self.train_ended),
                "epoch_ended": bool(self.epoch_ended)}

    def _apply_payload(self, data):
        count = data["size"]
        self.minibatch_class = data["class"]
        self.minibatch_size = count
        self.minibatch_offset = data["start"] + count
        self.epoch_number = data["epoch"]
        self.last_minibatch <<= data["last"]
        self.train_ended <<= data["train_ended"]
        self.epoch_ended <<= data["epoch_ended"]
        indices = numpy.full(self.max_minibatch_size, -1, numpy.int32)
        indices[:count] = data["indices"]
        self.minibatch_indices = torch.from_numpy(indices).to(self.device_)
        self.fill_minibatch()

    def serve_next_minibatch(self):
        """One step of the eager loop: the next minibatch, served."""
        payload = self._next_payload()
        self._apply_payload(payload)
        self.samples_served += payload["size"]

    def _finish_epoch(self):
        """The epoch wrap: the next epoch number, the offset back to 0,
        the TRAIN segment reshuffled (up to ``shuffle_limit``)."""
        self.epoch_number += 1
        self._global_offset = 0
        if self.epoch_number <= self.shuffle_limit:
            self.shuffle()

    def shuffle(self):
        """Reshuffle the TRAIN segment only, in place."""
        if not self.class_lengths[TRAIN]:
            return
        train_start = self.class_end_offsets[VALIDATION]
        prng.get(self.rand_name).shuffle(
            self.shuffled_indices[train_start:self.total_samples])

    # -- distribution (a master serves indices only) ------------------------

    def generate_data_for_slave(self, slave=None):
        payload = self._next_payload()
        sid = getattr(slave, "id", slave)
        self._pending_.setdefault(sid, []).append(payload)
        return payload

    def apply_data_from_master(self, data):
        self._apply_payload(data)

    def generate_data_for_master(self):
        return {"served": self.samples_served}

    def apply_data_from_slave(self, data, slave=None):
        sid = getattr(slave, "id", slave)
        pending = self._pending_.get(sid)
        # a segment update resolves several served minibatches at once
        count = (data or {}).get("count", 1)
        for _ in range(min(count, len(pending or ()))):
            pending.pop(0)

    def drop_slave(self, slave=None):
        """Requeue everything a dropped slave held."""
        sid = getattr(slave, "id", slave)
        for job in self._pending_.pop(sid, []):
            self.failed_minibatches.append(job)

    def reset_to_epoch_start(self, epoch):
        """Rewind the serving cursor to the start of ``epoch``, dropping
        partial-epoch progress (pending registrations, requeues, epoch
        flags): a restored master replays the epoch whose merge buckets
        died with its predecessor. A cursor still short of ``epoch``
        takes the epoch wraps it missed first, reshuffles included, so
        the replay serves that epoch's order and the shuffle stream
        skips no draw."""
        epoch = int(epoch)
        while self.epoch_number < epoch:
            self._finish_epoch()
        self.epoch_number = epoch
        self._global_offset = 0
        self.failed_minibatches = []
        self._pending_ = {}
        self.last_minibatch <<= False
        self.train_ended <<= False
        self.epoch_ended <<= False
