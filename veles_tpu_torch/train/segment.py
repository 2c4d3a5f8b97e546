"""Slave-side execution of segment jobs (``veles_tpu/train/segment.py``).

A segment job (``Workflow.generate_segment_for_slave``) carries the
master's unit payloads (weights, decision state) and a list of loader
minibatch payloads. :class:`SegmentExecutor` runs the whole segment
through the port's ``FusedTrainer`` -- the weights applied once, the
minibatches trained or evaluated on the card, one delta back -- where
the JAX package runs one compiled scan.

The trainer trains the units' own parameter tensors in place (the
gradient units copy each job's weights into those tensors), so a job's
weights reach it on every job without a pull or a push. Dropout: the
masks of a training minibatch are the standalone run's, whichever slave
trains it and however the epoch is cut into segments: the epoch's seed
is addressed by the epoch's number on the first dropout layer's stream
(``philox_seed_at``; a standalone trainer draws one seed an epoch from
counter 0), and the batch index is the minibatch's position in the
epoch's TRAIN class. (The JAX executor draws one base key a run and
folds in the segment-local index, which equals its standalone masks
only with one training run an epoch.)

Workflows the trainer cannot model, and ``--eager`` slaves, replay the
segment eagerly: the same minibatches through ``Workflow.do_job`` one
by one, giving an update of the same shape.
"""

import numpy

from veles_tpu_torch.loader.base import TRAIN, VALIDATION
from veles_tpu_torch.logger import Logger
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.train.runner import fused_compatible, trainer_for


def segment_capable(workflow):
    """Master side: can this workflow serve segment jobs? Weaker than
    :func:`fused_compatible` on purpose: the master stages no dataset,
    and a slave that cannot fuse replays the segment eagerly."""
    from veles_tpu_torch.nn.units import EvaluatorMSE, EvaluatorSoftmax
    for attr in ("loader", "forwards", "evaluator", "decision"):
        if getattr(workflow, attr, None) is None:
            return False
    return isinstance(workflow.evaluator,
                      (EvaluatorSoftmax, EvaluatorMSE))


class SegmentExecutor(Logger):
    """Executes segment jobs on a slave's workflow."""

    def __init__(self, workflow, eager=False):
        super(SegmentExecutor, self).__init__()
        self.workflow = workflow
        self._trainer = None
        reason = "--eager" if eager else fused_compatible(workflow)
        self.eager = reason is not None
        if self.eager:
            self.info("segment jobs will replay eagerly (%s)", reason)

    @property
    def trainer(self):
        if self._trainer is None:
            self._trainer = trainer_for(self.workflow)
        return self._trainer

    def execute(self, job):
        """job dict -> update list (``[(unit_name, payload)]``)."""
        with tracing.span("step:segment", batches=len(job["batches"]),
                          mode="eager" if self.eager else "fused"):
            if self.eager:
                return self._execute_eager(job)
            return self._execute_fused(job)

    def close(self):
        """Join the trainer's pipelines (a streamed or offloaded run)."""
        if self._trainer is not None:
            self._trainer.shutdown()

    # -- fused path --------------------------------------------------------

    def _idx_matrix(self, batches):
        mb = self.workflow.loader.max_minibatch_size
        mat = numpy.full((len(batches), mb), -1, numpy.int32)
        for i, batch in enumerate(batches):
            idx = numpy.asarray(batch["indices"], numpy.int32)
            mat[i, :len(idx)] = idx
        return mat

    def _execute_fused(self, job):
        wf = self.workflow
        wf.apply_data_from_master(job["units"])
        trainer = self.trainer
        testing = bool(getattr(wf.decision, "testing", False))
        stats = []
        # batches come contiguous per class, but a requeue can
        # interleave: each homogeneous run is swept on its own
        for run in self._class_runs(job["batches"]):
            klass = run[0]["class"]
            idx = self._idx_matrix(run)
            if klass == TRAIN and not testing:
                losses, metrics = trainer.train_rows(
                    idx, self._train_position(run[0]),
                    self._dropout_seed(run[0]["epoch"]))
            else:
                losses, metrics, _ = trainer.eval_rows(idx)
            losses = losses.float().cpu().numpy()
            metrics = metrics.float().cpu().numpy()
            for i, batch in enumerate(run):
                stats.append({
                    "klass": klass, "samples": batch["size"],
                    "metric": float(metrics[i]), "loss": float(losses[i]),
                    "epoch": batch["epoch"], "last": batch["last"],
                    "epoch_ended": batch["epoch_ended"]})
        wf.loader.samples_served += sum(b["size"] for b in job["batches"])
        return self._collect_update(job, stats)

    def _collect_update(self, job, stats):
        wf = self.workflow
        update = []
        for unit in wf._distributed_units():
            if unit is wf.loader:
                update.append((unit.name, {
                    "served": wf.loader.samples_served,
                    "count": len(job["batches"])}))
            elif unit is wf.decision:
                update.append((unit.name, stats))
            else:
                update.append((unit.name, unit.generate_data_for_master()))
        return update

    def _train_position(self, batch):
        """The minibatch's index in its epoch's TRAIN class."""
        loader = self.workflow.loader
        return (batch["start"] - loader.class_end_offsets[VALIDATION]) // \
            loader.max_minibatch_size

    def _dropout_seed(self, epoch):
        """Epoch ``epoch``'s dropout seed (0 without dropout)."""
        from veles_tpu_torch import prng
        from veles_tpu_torch.nn.dropout import DropoutForward
        for module in self.trainer.forwards:
            if isinstance(module, DropoutForward):
                return prng.get(module.rand_name).philox_seed_at(epoch)
        return 0

    @staticmethod
    def _class_runs(batches):
        """Runs of minibatches one after another in index space: the
        same class and epoch, each starting where the last ended."""
        runs = []
        for batch in batches:
            prev = runs[-1][-1] if runs else None
            if prev is not None and prev["class"] == batch["class"] and \
                    prev["epoch"] == batch["epoch"] and \
                    prev["start"] + prev["size"] == batch["start"]:
                runs[-1].append(batch)
            else:
                runs.append([batch])
        return runs

    # -- eager replay --------------------------------------------------------

    def _execute_eager(self, job):
        wf = self.workflow
        stats = []
        gd_updates = {}
        served = 0
        for i, batch in enumerate(job["batches"]):
            # the unit payloads (weights, decision reset) apply once;
            # later minibatches continue from the local weights, as the
            # fused sweep does
            eager_job = (list(job["units"]) if i == 0 else
                         [(name, {"reset_complete": True})
                          for name, _ in job["units"]
                          if name == wf.decision.name])
            eager_job.append((wf.loader.name, batch))
            update = wf.do_job(eager_job)
            served += batch["size"]
            for name, payload in update:
                if payload is None:
                    continue
                if name == wf.decision.name:
                    stats.append(payload)
                elif name != wf.loader.name:
                    # deltas against the weights applied at batch 0:
                    # each batch's payload is cumulative, keep the last
                    gd_updates[name] = payload
        update = []
        for unit in wf._distributed_units():
            if unit is wf.loader:
                update.append((unit.name, {
                    "served": served, "count": len(job["batches"])}))
            elif unit is wf.decision:
                update.append((unit.name, stats))
            else:
                update.append((unit.name, gd_updates.get(unit.name)))
        return update
