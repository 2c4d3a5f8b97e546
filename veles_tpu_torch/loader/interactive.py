"""Loaders fed from the outside (``veles_tpu/loader/interactive.py``).

:class:`QueueFedLoader` serves whatever a producer pushes through
:meth:`QueueFedLoader.feed` (a shell, a driving program, the REST unit,
the socket feed); :class:`InteractiveLoader` is its user-facing name.
The workflow runs forward-only: every fill is a TEST minibatch, and a
workflow that does not say whether its minibatch trains
(``training_minibatch``) is told it does not at ``initialize()``.

One fill drains up to ``max_minibatch_size`` queued samples: the first
``get`` blocks (``feed_timeout`` seconds at most), the rest are taken
only if already queued, rows past the valid count are zeroed and
``minibatch_size`` carries that count. So concurrent producers share one
forward while a lone one still gets single-sample latency. An EOF
(:meth:`QueueFedLoader.finish`) met while draining is served after the
batch collected so far, then stops the workflow.

``minibatch_data`` is a float32 tensor on the workflow's device,
``(max_minibatch_size,) + sample_shape``, written in place by each fill
(the JAX loader's ``map_invalidate``): the units linked to it read the
same tensor every iteration.
"""

import queue

import numpy
import torch

from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.loader.base import TEST, Loader


class QueueFedLoader(Loader):
    """Serves what the outside pushes into an unbounded queue.
    ``sample_shape`` is the per-sample shape every fed sample has."""

    hide_from_registry = True

    #: what :meth:`finish` pushes: no more data, end the workflow
    EOF = object()

    def __init__(self, sample_shape=(), feed_timeout=None, minibatch_size=1,
                 **kwargs):
        super(QueueFedLoader, self).__init__(minibatch_size=minibatch_size,
                                             **kwargs)
        self.feed_shape = tuple(int(n) for n in sample_shape)
        self.feed_timeout = feed_timeout
        self.has_labels = False

    def init_unpickled(self):
        super(QueueFedLoader, self).init_unpickled()
        self._queue_ = queue.Queue()

    def sample_shape(self):
        return self.feed_shape

    def feed(self, sample):
        """Push one sample (an array of ``sample_shape``)."""
        self._queue_.put(numpy.asarray(sample, numpy.float32))

    def finish(self):
        """Unblock the loop with no more data (ends the workflow)."""
        self._queue_.put(self.EOF)

    def load_data(self):
        if not self.feed_shape:
            raise ValueError("%s needs sample_shape" % self.name)
        # an endless TEST stream of max_minibatch_size samples a fill
        self.class_lengths = [self.max_minibatch_size, 0, 0]

    def initialize(self, device=None, **kwargs):
        super(QueueFedLoader, self).initialize(
            device=resolve_device(device), **kwargs)
        self.minibatch_data = torch.zeros(
            (self.max_minibatch_size,) + self.feed_shape,
            dtype=torch.float32, device=self.device_)
        workflow = self.workflow
        if workflow is not None and \
                getattr(workflow, "training_minibatch", None) is None:
            # the forwards behind a fed loader never train
            workflow.training_minibatch = False
        return self

    def fill_minibatch(self):
        item = self._queue_.get(timeout=self.feed_timeout)
        if item is self.EOF:
            # stop() aborts the signals in flight, so nothing downstream
            # runs this iteration; the zero size is for anyone reading
            # the loader after the run
            self.minibatch_size = 0
            self.workflow.stop()
            return
        rows = [item.reshape(self.feed_shape)]
        eof_seen = False
        # whatever is already queued joins this batch; never wait for
        # more (a lone producer keeps single-sample latency)
        while len(rows) < self.max_minibatch_size:
            try:
                item = self._queue_.get_nowait()
            except queue.Empty:
                break
            if item is self.EOF:
                eof_seen = True
                break
            rows.append(item.reshape(self.feed_shape))
        count = len(rows)
        batch = numpy.zeros((self.max_minibatch_size,) + self.feed_shape,
                            numpy.float32)
        batch[:count] = rows
        # one copy of the whole buffer: the rows past the valid count
        # are zeroed, so a stale row of the previous fill never leaks
        self.minibatch_data.copy_(torch.from_numpy(batch))
        self.minibatch_class = TEST
        self.minibatch_size = count
        if eof_seen:
            # the EOF ends the stream after this batch is served: the
            # next fill meets it first
            self._queue_.put(self.EOF)


class InteractiveLoader(QueueFedLoader):
    """The user-facing interactive feed (``InteractiveLoader`` of the
    JAX package)."""
