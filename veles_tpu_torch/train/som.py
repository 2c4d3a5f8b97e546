"""Kohonen SOM training over a full-batch loader
(``veles_tpu/train/som.py`` ``SOMFusedRunner``).

An epoch sweeps every class of the loader in its serving order, one
padded minibatch row at a time: the rows are gathered on the device, a
padded row is zero and stays in the batch (the update divides by the
full minibatch, as in the JAX package), and each row is one ``step`` of
the trainer (a :class:`~veles_tpu_torch.nn.kohonen.SOMCodebook` or the
``KohonenTrainer`` unit). Minibatches align to the class boundaries, as
the loader serves them, so each class's tail is its own padded batch.
As in the loader, an epoch closes lazily: the next epoch first advances
the loader's epoch number and reshuffles its TRAIN segment.

:class:`SOMFusedRunner` drives a ``KohonenWorkflow``
(``models/mnist_ae.py``) through the same sweeps, its workflow's own
runner (``make_fused_runner``): after each sweep the loader, the
trainer and the epoch counter are left as the eager unit graph leaves
them at the epoch's last minibatch, so both end on the same codebook.
"""

import time

import numpy
import torch


class SOMRunner(object):
    """Trains ``trainer`` over ``loader`` (a ``FullBatchLoader``,
    initialized here unless ``initialize`` is False, and staged on the
    trainer's device)."""

    def __init__(self, trainer, loader, initialize=True):
        self.trainer = trainer
        self.loader = loader.initialize() if initialize else loader
        loader.stage(trainer.device)
        self._swept = False
        #: winners of the last minibatch of the last epoch
        self.last_winners = None

    def epoch_indices(self):
        """The epoch's (n_batches, minibatch) int32 index matrix: each
        class's shuffled indices cut into rows of the minibatch size,
        each class's last row padded with -1."""
        loader = self.loader
        idx = numpy.asarray(loader.shuffled_indices, numpy.int32)
        mb = loader.max_minibatch_size
        rows, start = [], 0
        for length in loader.class_lengths:
            seg = idx[start:start + length]
            start += length
            for off in range(0, length, mb):
                row = numpy.full(mb, -1, numpy.int32)
                chunk = seg[off:off + mb]
                row[:len(chunk)] = chunk
                rows.append(row)
        if not rows:
            rows.append(numpy.full(mb, -1, numpy.int32))
        return numpy.stack(rows)

    def run_epoch(self):
        """One sweep; returns its seconds (synchronized)."""
        loader = self.loader
        if self._swept:
            loader.epoch_number += 1
            if loader.epoch_number <= loader.shuffle_limit:
                loader.shuffle()
        start = time.perf_counter()
        idx = torch.from_numpy(self.epoch_indices()).to(self.trainer.device)
        for row in idx:
            x, _, _ = loader.gather(row)
            self.last_winners = self.trainer.step(x.reshape(x.shape[0], -1))
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)
        self._swept = True
        return time.perf_counter() - start

    def train(self, epochs):
        """Sweeps until an epoch ends with the loader's epoch number at
        ``epochs`` or more, as the JAX runner's epoch counter stops: from
        a fresh loader that is ``epochs + 1`` sweeps, since the number
        advances at the start of the next sweep. Returns the seconds of
        each."""
        seconds = [self.run_epoch()]
        while self.loader.epoch_number < epochs:
            seconds.append(self.run_epoch())
        return seconds


class SOMFusedRunner(object):
    """Runs a ``KohonenWorkflow``: sweeps until its epoch counter
    completes (or the workflow is stopped), then finishes the workflow.
    A loader restored at an epoch's end closes that epoch first."""

    def __init__(self, workflow):
        self.workflow = workflow
        self.sweeps = None
        #: seconds of each sweep
        self.epoch_times = []

    def run(self):
        workflow = self.workflow
        loader, trainer = workflow.loader, workflow.trainer
        counter = workflow.counter
        if self.sweeps is None:
            self.sweeps = SOMRunner(trainer, loader, initialize=False)
            # a loader at an epoch's end wraps before its next sweep
            self.sweeps._swept = loader._global_offset >= \
                loader.total_samples
        workflow.stopped <<= False
        workflow.is_running = True
        start = time.perf_counter()
        try:
            while not bool(counter.complete) and \
                    not bool(workflow.stopped):
                # under the policy the eager unit computes in
                with trainer.policy.backends():
                    self.epoch_times.append(self.sweeps.run_epoch())
                # the eager loader's state at the epoch's last minibatch
                loader.samples_served += loader.total_samples
                loader._global_offset = loader.total_samples
                loader.minibatch_offset = loader.total_samples
                loader.last_minibatch <<= True
                loader.epoch_ended <<= True
                trainer.winners = self.sweeps.last_winners
                counter.run()
        finally:
            workflow.is_running = False
            workflow._run_time += time.perf_counter() - start
        workflow.on_workflow_finished()
        return workflow
