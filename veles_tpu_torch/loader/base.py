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
tensors on the ``meta`` device: they carry the minibatch's shape to the
units linked to them and hold no data. The eager serving loop of the
JAX loader (``run()``, ``serve_next_minibatch``) and its distribution
hooks are not ported yet: the fused trainer reads index matrices
(``train/step.py`` ``_segment_indices``).
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

    def initialize(self, device=None, **kwargs):
        """Load the data, cut the minibatch to the largest class, set up
        the permutation and the shape-only minibatch tensors. A loader
        restored from a snapshot keeps its epoch position and flags.
        Returns the loader."""
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
        raise NotImplementedError(
            "the loader's eager serve loop is not ported yet: the port's "
            "workflows run through FusedRunner")

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
