"""Decision units: epoch accounting + stop criterion + GD gating
(``veles_tpu/nn/decision.py``).

The decision unit is the control heart of every training workflow: it
accumulates per-class epoch statistics from the evaluator,
decides when training is complete (max epochs, or no validation
improvement for ``fail_iterations`` epochs), exposes ``gd_skip`` so
gradient units only run on TRAIN minibatches, and raises ``improved``
for the snapshotter. Topology contract (mirrors Znicz MnistWorkflow):

    repeater -> loader -> forwards... -> evaluator -> decision
    decision -> gd[n] -> ... -> gd[0] -> repeater
    end_point.link_from(decision); end_point.gate_block = ~complete
    gd[i].gate_skip = decision.gd_skip

``FusedRunner`` replays the per-minibatch bookkeeping at each epoch
boundary through the same methods (``epoch_stats``,
``_on_class_finished``, ``_on_epoch_finished``).

Master/slave, as the JAX decision: a slave's ``run`` closes the loop
after each minibatch and only records the minibatch's stats for the
master; the master accounts every slave's minibatches in per-epoch
buckets, closes a class and an epoch on *sample counts* (requeued
minibatches are exact replays), closes epochs strictly in order, drops
the updates of epochs past a stop decision, and withholds jobs while
the loader runs more than one epoch ahead of the oldest open epoch. A
slave's per-minibatch stats may carry the minibatch's mean ``loss``
(the port's slaves send it: from the trainer's sweep, or the softmax
evaluator's in an eager job); the master then reports each class's mean
minibatch loss beside the metric, as ``FusedRunner`` does.
"""

import numpy

from veles_tpu_torch.loader.base import TRAIN, VALIDATION, CLASS_NAMES
from veles_tpu_torch.mutable import Bool
from veles_tpu_torch.result_provider import IResultProvider
from veles_tpu_torch.units import Unit


class DecisionBase(Unit, IResultProvider):
    hide_from_registry = True
    view_group = "TRAINER"

    #: lower is better for these metrics
    METRIC_NAME = "n_err"

    def __init__(self, workflow, **kwargs):
        self.max_epochs = kwargs.pop("max_epochs", None)
        self.fail_iterations = kwargs.pop("fail_iterations", 100)
        super(DecisionBase, self).__init__(workflow, **kwargs)
        self.complete = Bool(False)
        self.improved = Bool(False)
        self.gd_skip = Bool(False)
        # forward-only mode: gradients always skipped, stop after one
        # full epoch (the ``--test`` pass)
        self.testing = False
        self.epoch_stats = [dict() for _ in range(3)]
        self.epoch_history = []
        self.best_metric = numpy.inf
        self.best_epoch = -1
        self.demand("minibatch_class", "last_minibatch", "epoch_ended",
                    "epoch_number", "class_lengths", "minibatch_size")

    def initialize(self, **kwargs):
        if getattr(self, "_restored_from_snapshot_", False):
            # mid-epoch snapshot resume: the partial epoch sums the
            # eager path accumulated per minibatch must survive — the
            # remaining minibatches complete them to the uninterrupted
            # totals (both schedulers rely on this)
            self._restored_from_snapshot_ = False
            return
        self._reset_epoch()

    def _reset_epoch(self):
        for stats in self.epoch_stats:
            stats.clear()
            stats.update(samples=0, metric=0.0)

    # -- per-minibatch metric from the evaluator ---------------------------

    def minibatch_metric(self):
        """Metric value summed over this minibatch (lower = better)."""
        raise NotImplementedError

    def run(self):
        klass = self.minibatch_class
        self.gd_skip <<= (klass != TRAIN) or self.testing
        metric = self.minibatch_metric()
        if self.is_slave:
            # one job = one minibatch: opening the end point after every
            # pass makes Workflow.do_job() run exactly one iteration; the
            # master does the epoch accounting from these updates
            self.complete <<= True
            self._pending_update_ = {
                "klass": klass, "samples": self.minibatch_size,
                "metric": metric, "epoch": self.epoch_number,
                "last": bool(self.last_minibatch),
                "epoch_ended": bool(self.epoch_ended)}
            loss = getattr(getattr(self.workflow, "evaluator", None),
                           "loss", None)
            if isinstance(loss, float):
                # the softmax evaluator's report loss, as segments send
                self._pending_update_["loss"] = loss
            return
        stats = self.epoch_stats[klass]
        stats["samples"] += self.minibatch_size
        stats["metric"] += metric
        if bool(self.last_minibatch):
            self._on_class_finished(klass)
        if bool(self.epoch_ended):
            self._on_epoch_finished()

    # -- distribution: metrics ride slave->master, the master decides ------

    def drop_slave(self, slave=None):
        # a dropped slave may have held the minibatches that keep the
        # oldest epoch open: the loader requeues them, and serving them
        # needs jobs, so the run-ahead throttle reopens (it re-closes on
        # the next update if the loader is still too far ahead)
        self.has_data_for_slave = True

    def generate_data_for_slave(self, slave=None):
        # non-None, so the slave's apply_data_from_master re-arms the
        # loop gate the previous job closed
        return {"reset_complete": True}

    def apply_data_from_master(self, data):
        if data.get("reset_complete"):
            self.complete <<= False

    def generate_data_for_master(self):
        update = getattr(self, "_pending_update_", None)
        self._pending_update_ = None
        return update

    def prepare_resume(self):
        """Re-arm epoch accounting after a snapshot restore.

        Returns the epoch the run should resume FROM (the one after
        the last closed epoch), or ``None`` when the restored run had
        already completed. A master's transient merge buckets died with
        it; the next merged update re-derives the next epoch to close
        from ``epoch_history``."""
        last_closed = max((h["epoch"] for h in self.epoch_history),
                          default=-1)
        if bool(self.complete) and self.max_epochs is not None and \
                last_closed + 1 >= self.max_epochs:
            return None
        self.complete <<= False
        self.improved <<= False
        self._stop_epoch_ = None
        self.has_data_for_slave = True
        return last_closed + 1

    def apply_data_from_slave(self, data, slave=None):
        """Master-side epoch accounting over every slave's minibatches,
        in per-epoch buckets (the first minibatches of epoch e+1 can
        return before the last one of epoch e)."""
        if data is None:
            return
        if isinstance(data, list):
            # a segment update: one stats dict a minibatch
            for item in data:
                self.apply_data_from_slave(item, slave)
            return
        stop_epoch = getattr(self, "_stop_epoch_", None)
        if stop_epoch is not None and data.get("epoch", 0) > stop_epoch:
            # run-ahead past the stop decision: never reopens a bucket
            return
        buckets = getattr(self, "_epoch_buckets_", None)
        if buckets is None:
            buckets = self._epoch_buckets_ = {}
        epoch = data.get("epoch", 0)
        bucket = buckets.setdefault(
            epoch, [dict(samples=0, metric=0.0) for _ in range(3)])
        klass = data["klass"]
        stats = bucket[klass]
        stats["samples"] += data["samples"]
        stats["metric"] += data["metric"]
        if "loss" in data:
            stats["loss_sum"] = stats.get("loss_sum", 0.0) + data["loss"]
            stats["loss_batches"] = stats.get("loss_batches", 0) + 1
        # close on sample counts, not on the last/epoch_ended flags: a
        # flagged minibatch can arrive while siblings are in flight
        if stats["samples"] == self.class_lengths[klass]:
            self._on_class_finished(klass, epoch=epoch, stats_set=bucket)
        if sum(b["samples"] for b in bucket) == sum(self.class_lengths):
            # epochs close strictly in order: a complete younger bucket
            # is parked until every older epoch has closed
            buckets.pop(epoch, None)
            done = getattr(self, "_complete_epochs_", None)
            if done is None:
                done = self._complete_epochs_ = {}
            done[epoch] = bucket
            nxt = getattr(self, "_next_close_epoch_", None)
            if nxt is None:
                # snapshot resume: continue after the last closed epoch
                nxt = max((h["epoch"] for h in self.epoch_history),
                          default=-1) + 1
            while nxt in done:
                self._on_epoch_finished(epoch=nxt,
                                        stats_set=done.pop(nxt))
                nxt += 1
                if getattr(self, "_stop_epoch_", None) is not None:
                    done.clear()  # run-ahead epochs are cancelled
            self._next_close_epoch_ = nxt
        # bound run-ahead to one epoch past the oldest open one (the
        # next epoch to close, once closing has begun), except while
        # requeued minibatches wait: they belong to the oldest open
        # epoch, and serving them is the only way it can close
        nxt = getattr(self, "_next_close_epoch_", None)
        if nxt is not None:
            min_open = nxt
        elif buckets:
            min_open = min(buckets)
        else:
            min_open = None
        loader = getattr(self.workflow, "loader", None)
        requeued = bool(getattr(loader, "failed_minibatches", ()))
        self.has_data_for_slave = (
            requeued or min_open is None or
            self.epoch_number - min_open <= 1)
        if bool(self.complete) and self.is_master:
            # the master's graph never runs: the stop goes straight to
            # the job source (NoMoreJobs)
            self.workflow.stop()

    def _on_class_finished(self, klass, epoch=None, stats_set=None):
        epoch = self.epoch_number if epoch is None else epoch
        stats = (self.epoch_stats if stats_set is None else stats_set)[klass]
        if not stats["samples"]:
            return
        normalized = stats["metric"] / stats["samples"]
        stats["normalized"] = normalized
        if stats.get("loss_batches"):
            stats["loss"] = stats.pop("loss_sum") / stats.pop(
                "loss_batches")
        if klass == VALIDATION or (klass == TRAIN and
                                   not self.class_lengths[VALIDATION]):
            self.improved <<= normalized < self.best_metric
            if bool(self.improved):
                self.best_metric = normalized
                self.best_epoch = epoch

    def _on_epoch_finished(self, epoch=None, stats_set=None):
        # on a master, self.epoch_number (linked from the loader) may
        # already have advanced past the epoch whose last update just
        # arrived — callers with better knowledge pass the true epoch
        epoch = self.epoch_number if epoch is None else epoch
        stats_set = self.epoch_stats if stats_set is None else stats_set
        summary = {CLASS_NAMES[i]: dict(stats_set[i])
                   for i in range(3) if self.class_lengths[i]}
        summary["epoch"] = epoch
        # insertion sort by epoch: out-of-order closes (async slaves)
        # must not scramble the history
        pos = len(self.epoch_history)
        while pos and self.epoch_history[pos - 1]["epoch"] > epoch:
            pos -= 1
        self.epoch_history.insert(pos, summary)
        self.info("epoch %d: %s", epoch, "  ".join(
            "%s %s=%.4f" % (CLASS_NAMES[i], self.METRIC_NAME,
                            stats_set[i].get("normalized", numpy.nan))
            for i in range(3) if self.class_lengths[i]))
        stop = False
        if self.testing:
            self.info("test pass complete")
            stop = True
        if self.max_epochs is not None and epoch + 1 >= self.max_epochs:
            self.info("stopping: max_epochs=%d reached", self.max_epochs)
            stop = True
        if epoch - self.best_epoch > self.fail_iterations:
            self.info("stopping: no improvement in %d epochs",
                      self.fail_iterations)
            stop = True
        if stop:
            self.complete <<= True
            self._stop_epoch_ = epoch
            # discard run-ahead buckets of epochs the stop cancels
            buckets = getattr(self, "_epoch_buckets_", None)
            if buckets:
                for run_ahead in [e for e in buckets if e > epoch]:
                    buckets.pop(run_ahead)
        self._reset_epoch()

    def get_metric_values(self):
        return {"best_%s" % self.METRIC_NAME: float(self.best_metric),
                "best_epoch": self.best_epoch,
                "epochs": len(self.epoch_history)}


class DecisionGD(DecisionBase):
    """Classification: metric = misclassification count / samples."""

    METRIC_NAME = "n_err_pt"

    def __init__(self, workflow, **kwargs):
        super(DecisionGD, self).__init__(workflow, **kwargs)
        self.demand("minibatch_n_err")

    def minibatch_metric(self):
        return float(self.minibatch_n_err)


class DecisionMSE(DecisionBase):
    """Regression/AE: metric = summed per-sample MSE."""

    METRIC_NAME = "rmse"

    def __init__(self, workflow, **kwargs):
        super(DecisionMSE, self).__init__(workflow, **kwargs)
        self.demand("minibatch_mse")

    def minibatch_metric(self):
        mse = self.minibatch_mse
        if hasattr(mse, "__len__"):
            return float(numpy.sum(
                numpy.asarray(mse)[:self.minibatch_size]))
        return float(mse) * self.minibatch_size

    def _on_class_finished(self, klass, epoch=None, stats_set=None):
        stats = (self.epoch_stats if stats_set is None else stats_set)[klass]
        if stats["samples"]:
            # report RMSE, compare on MSE (monotonic — same argmin)
            stats["metric_rmse"] = float(
                numpy.sqrt(stats["metric"] / stats["samples"]))
        super(DecisionMSE, self)._on_class_finished(
            klass, epoch=epoch, stats_set=stats_set)
