"""Loader geometry and shuffling (``veles_tpu/loader/base.py``).

What the fused trainer reads from a loader, kept as the JAX package has
it:

* three sample classes laid out one after another in index space --
  TEST [0, t), VALIDATION [t, t+v), TRAIN [t+v, total) -- with
  ``class_lengths = [test, valid, train]`` and ``class_end_offsets``;
* ``shuffled_indices``, the global permutation; only the TRAIN segment
  is reshuffled between epochs (:meth:`Loader.shuffle`), from the
  loader's own named stream (``"loader"``) of ``veles_tpu_torch.prng``,
  so the same seed gives the JAX package's permutations, bit for bit;
* ``max_minibatch_size``, cut to the largest class, and
  ``shuffle_limit``, the last epoch after which a shuffle happens.

The eager serving loop of the JAX loader (``serve_next_minibatch``, the
distribution hooks) is not ported: the fused trainer reads index
matrices (``train/step.py`` ``_segment_indices``).
"""

import numpy

from veles_tpu_torch import prng

TEST = 0
VALIDATION = 1
TRAIN = 2
CLASS_NAMES = ("test", "validation", "train")


class Loader(object):
    """Base loader; subclasses implement :meth:`load_data`."""

    def __init__(self, minibatch_size=100, shuffle_limit=numpy.inf,
                 rand="loader"):
        self.max_minibatch_size = int(minibatch_size)
        self.shuffle_limit = shuffle_limit
        self.rand_name = rand
        self.class_lengths = [0, 0, 0]
        self.shuffled_indices = None
        self.epoch_number = 0

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

    def initialize(self):
        self.load_data()
        if self.total_samples == 0:
            raise ValueError("%s loaded an empty dataset"
                             % type(self).__name__)
        self.max_minibatch_size = min(self.max_minibatch_size, max(
            length for length in self.class_lengths if length))
        if self.shuffled_indices is None:
            self.shuffled_indices = numpy.arange(self.total_samples,
                                                 dtype=numpy.int32)
        return self

    def shuffle(self):
        """Reshuffle the TRAIN segment only, in place."""
        if not self.class_lengths[TRAIN]:
            return
        train_start = self.class_end_offsets[VALIDATION]
        prng.get(self.rand_name).shuffle(
            self.shuffled_indices[train_start:self.total_samples])
