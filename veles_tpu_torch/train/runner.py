"""FusedRunner: what runs a training workflow (``veles_tpu/train/
runner.py``).

``python -m veles_tpu_torch`` runs a workflow of the standard trainable
shape

    loader + forwards + evaluator(softmax|mse) + gds + decision

through the port's :class:`~veles_tpu_torch.train.step.FusedTrainer`
(one class sweep at a time, parameters and solver state updated in
place on the device). Everything the eager graph does at epoch
boundaries happens through the same units, with the JAX runner's exact
semantics: the decision's bookkeeping (``epoch_stats`` ->
``_on_class_finished`` -> ``_on_epoch_finished``: the same
``epoch_history``, ``improved``/``best_*`` state and stop criterion),
and every service unit hanging off the graph (the snapshotter) fires
once per epoch with the loader's ``epoch_ended``/``last_minibatch``
raised. A snapshot taken mid-epoch resumes through the same sweeps,
serving only the remaining minibatches.

:func:`fused_compatible` says why a graph cannot run this way. The JAX
package then falls back to its eager per-unit scheduler; the port has
no eager compute units yet, so the launcher raises instead.

Each epoch's wall time is split in :attr:`FusedRunner.epoch_times`:
the evaluation and training sweeps (each ends in a host read of its
metrics, which waits for the device), the decision's bookkeeping and
the services; each class's mean minibatch loss rides beside. The JAX
runner's telemetry (tracing spans, metrics registry, flight recorder,
cost book, prefetch and offload gauges) is not ported yet.
"""

import collections
import logging
import time

from veles_tpu_torch.loader.base import (CLASS_NAMES, TEST, TRAIN,
                                         VALIDATION)
from veles_tpu_torch.nn.units import EvaluatorMSE, EvaluatorSoftmax
from veles_tpu_torch.plumbing import EndPoint, Repeater, StartPoint
from veles_tpu_torch.train.step import FusedTrainer

_log = logging.getLogger(__name__)

#: view groups whose units are epoch-boundary services -- safe to fire
#: once per epoch instead of once per minibatch
SERVICE_VIEW_GROUPS = ("PLOTTER", "SERVICE")


def _covered_units(workflow):
    """Units whose work the fused trainer subsumes."""
    covered = {workflow.start_point, workflow.end_point,
               workflow.loader, workflow.evaluator, workflow.decision}
    covered.update(workflow.forwards)
    covered.update(getattr(workflow, "gds", ()))
    for unit in workflow:
        if isinstance(unit, (Repeater, StartPoint, EndPoint)):
            covered.add(unit)
    return covered


def fused_compatible(workflow):
    """None if ``workflow`` can run fused, else a human-readable reason.

    Any unit the trainer does not model (other than pure epoch-boundary
    services) refuses the graph."""
    for attr in ("loader", "forwards", "evaluator", "decision"):
        if getattr(workflow, attr, None) is None:
            return "workflow has no %s" % attr
    if not workflow.forwards:
        return "workflow has an empty forward chain"
    evaluator = workflow.evaluator
    if not isinstance(evaluator, (EvaluatorSoftmax, EvaluatorMSE)):
        return "evaluator %s is not softmax/mse" % type(evaluator).__name__
    loader = workflow.loader
    for attr in ("original_data", "shuffled_indices", "class_lengths",
                 "max_minibatch_size"):
        if getattr(loader, attr, None) is None:
            return "loader lacks %s" % attr
    truth_attr = ("original_labels" if isinstance(evaluator,
                                                  EvaluatorSoftmax)
                  else "original_targets")
    if getattr(loader, truth_attr, None) is None:
        return "loader has no %s" % truth_attr
    offset = loader._global_offset
    if 0 < offset < loader.total_samples:
        if loader.failed_minibatches:
            return "loader has requeued minibatches pending"
        ends = loader.class_end_offsets
        for klass, end in enumerate(ends):
            if offset < end and loader.class_lengths[klass]:
                within = offset - (end - loader.class_lengths[klass])
                if within % loader.max_minibatch_size != 0:
                    return ("resume offset %d is not minibatch-aligned"
                            % offset)
                break
    covered = _covered_units(workflow)
    for unit in workflow:
        if unit in covered:
            continue
        if unit.view_group in SERVICE_VIEW_GROUPS:
            continue
        return "unit %r (%s, view_group=%s) is outside the fused step" % (
            unit.name, type(unit).__name__, unit.view_group)
    return None


def trainer_for(workflow):
    """The port's trainer over an initialized workflow: its ``model``,
    its loader, each layer's hyper-parameters and solver state from the
    layer's gradient unit (the state dicts themselves: the trainer
    updates them in place), the loss of its evaluator and its
    ``uniform_source``."""
    gd_for = {id(gd.forward): gd for gd in getattr(workflow, "gds", ())}
    gds = [gd_for.get(id(fwd)) for fwd in workflow.forwards]
    solvers = {gd.solver_name for gd in gds if gd is not None}
    if len(solvers) > 1:
        raise NotImplementedError(
            "the port's trainer runs one solver, the workflow has %s"
            % sorted(solvers))
    loss = ("softmax" if isinstance(workflow.evaluator, EvaluatorSoftmax)
            else "mse")
    return FusedTrainer(
        workflow.model, workflow.loader,
        [gd.hyper if gd is not None else {} for gd in gds],
        solver=solvers.pop() if solvers else "sgd", loss=loss,
        uniform_source=workflow.uniform_source,
        states=[gd.opt_state if gd is not None and gd.opt_state
                else {} for gd in gds])


class FusedRunner(object):
    """Drive a standard workflow through the trainer's class sweeps,
    firing the decision and the service units as the eager scheduler
    would at each epoch boundary."""

    def __init__(self, workflow, trainer=None):
        self.workflow = workflow
        self.trainer = trainer if trainer is not None \
            else trainer_for(workflow)
        self._last_batch = (0.0, 0.0)
        #: one dict per epoch run: seconds of the evaluation and
        #: training sweeps, the decision, the services, the whole epoch
        self.epoch_times = []

    # -- epoch bodies ------------------------------------------------------

    def _eval_classes(self, testing, skips=None):
        """Forward-only sweeps in the eager serving order, the softmax
        confusion matrix riding along. ``skips`` (a mid-epoch resume)
        maps class -> samples already served; ``None`` skips the class
        whole."""
        trainer = self.trainer
        loader = trainer.loader
        evaluator = self.workflow.evaluator
        skips = skips or {}
        stats = {}
        klasses = (TEST, VALIDATION, TRAIN) if testing \
            else (TEST, VALIDATION)
        for klass in klasses:
            skip = skips.get(klass, 0)
            if not loader.class_lengths[klass] or skip is None:
                continue
            losses, metrics, conf = trainer.eval_class(klass, skip=skip)
            if conf is not None and skip == 0:
                # later classes overwrite: validation over test
                evaluator.confusion_matrix = conf.cpu().numpy()
            stats[klass] = trainer._summarize(losses, metrics, klass)
            if skip:
                stats[klass]["samples"] -= skip
            self._last_batch = (float(losses[-1]), float(metrics[-1]))
        return stats

    def _train_class(self, skip=0):
        trainer = self.trainer
        losses, metrics = trainer.train_class(skip=skip)
        self._last_batch = (float(losses[-1]), float(metrics[-1]))
        stats = trainer._summarize(losses, metrics, TRAIN)
        if skip:
            stats["samples"] -= skip
        return stats

    # -- epoch-boundary side effects ---------------------------------------

    def _close_epoch(self, stats):
        """Replay the decision unit's last-minibatch bookkeeping.

        Stats accumulate into the decision's epoch buckets: zero for a
        fresh epoch, the snapshot's partial sums for a mid-epoch resume,
        which the remaining minibatches complete to the uninterrupted
        totals."""
        decision = self.workflow.decision
        loader = self.workflow.loader
        for klass in (TEST, VALIDATION, TRAIN):
            if klass not in stats:
                continue
            epoch_stats = decision.epoch_stats[klass]
            epoch_stats["samples"] += stats[klass]["samples"]
            epoch_stats["metric"] += stats[klass]["metric"]
            decision._on_class_finished(klass)
        loader.samples_served += sum(
            s["samples"] for s in stats.values())
        # the evaluator's state after the eager path's last minibatch
        evaluator = self.workflow.evaluator
        last_loss, last_metric = self._last_batch
        if isinstance(evaluator, EvaluatorSoftmax):
            evaluator.loss = last_loss
            evaluator.n_err = int(last_metric)
        else:
            evaluator.rmse = float(max(last_loss, 0.0)) ** 0.5
        # the eager loader state at an epoch's last minibatch, so a
        # snapshot taken here resumes exactly like an eager one
        loader._global_offset = loader.total_samples
        loader.minibatch_offset = loader.total_samples
        loader.last_minibatch <<= True
        loader.epoch_ended <<= True
        decision._on_epoch_finished()

    def _fire_services(self, services):
        """One epoch-boundary pass over the service subgraph with the
        eager scheduler's signal semantics (``Workflow._drain``):
        gate_block swallows the signal (dependents never fire),
        gate_skip propagates without running."""
        service_set = set(services)
        signals = collections.deque()
        for unit in services:
            for src in unit.links_from:
                if src not in service_set:
                    # the trainer stands in for every covered unit's
                    # firing on the epoch's last minibatch
                    signals.append((unit, src))
        while signals:
            dst, src = signals.popleft()
            if dst not in service_set:
                continue
            if bool(dst.gate_block):
                continue
            if not dst.open_gate(src):
                continue
            if bool(dst.gate_skip):
                for nxt in dst.links_to:
                    signals.append((nxt, dst))
                continue
            dst._run_wrapped()
            for nxt in dst.links_to:
                signals.append((nxt, dst))

    def _resume_partial_epoch(self, offset):
        """Finish the epoch a mid-epoch snapshot interrupted: the
        remaining samples of each class through the same sweeps, then
        :meth:`_close_epoch` accumulates onto the snapshot's partial
        sums."""
        loader = self.trainer.loader
        testing = bool(self.workflow.decision.testing)
        ends = loader.class_end_offsets
        skips = {}
        for klass in (TEST, VALIDATION, TRAIN):
            length = loader.class_lengths[klass]
            if not length:
                continue
            skips[klass] = None if offset >= ends[klass] else \
                max(offset - (ends[klass] - length), 0)
        stats = self._eval_classes(testing, skips=skips)
        train_skip = skips.get(TRAIN)
        if not testing and train_skip is not None:
            stats[TRAIN] = self._train_class(skip=train_skip)
        _log.info("resumed mid-epoch snapshot at offset %d: served the "
                  "remaining %d samples", offset,
                  sum(s["samples"] for s in stats.values()))
        self._close_epoch(stats)
        return stats

    def _refresh_units(self):
        """Point the gradient units at the trainer's solver state (what
        a snapshot pickles); the forward units hold the modules the
        trainer updates."""
        gd_for = {id(gd.forward): gd
                  for gd in getattr(self.workflow, "gds", ())}
        for fwd, state in zip(self.workflow.forwards, self.trainer.states):
            gd = gd_for.get(id(fwd))
            if gd is not None and state:
                gd.opt_state = state

    def _epoch_end(self, services, stats, times, start):
        times["loss"] = {CLASS_NAMES[k]: s["loss"] for k, s in stats.items()}
        self._refresh_units()
        t = time.perf_counter()
        self._fire_services(services)
        times["services_s"] = time.perf_counter() - t
        times["wall_s"] = time.perf_counter() - start
        self.epoch_times.append(times)

    # -- the loop ----------------------------------------------------------

    def run(self):
        workflow = self.workflow
        loader = workflow.loader
        decision = workflow.decision
        covered = _covered_units(workflow)
        services = [u for u in workflow.units_in_dependency_order
                    if u not in covered]
        workflow.event("run", "begin")
        workflow.stopped <<= False
        workflow.is_running = True
        start = time.perf_counter()
        epochs_done = samples_done = 0
        try:
            offset = loader._global_offset
            if 0 < offset < loader.total_samples and not (
                    bool(decision.complete) or bool(workflow.stopped)):
                t0 = time.perf_counter()
                stats = self._resume_partial_epoch(offset)
                self._epoch_end(services, stats, {
                    "epoch": loader.epoch_number, "resumed": True,
                    "sweeps_s": time.perf_counter() - t0}, t0)
                epochs_done += 1
                samples_done += sum(s["samples"] for s in stats.values())
            while not (bool(decision.complete) or bool(workflow.stopped)):
                if loader.total_samples and \
                        loader._global_offset >= loader.total_samples:
                    # the eager loader's lazy epoch wrap on next serve
                    loader._finish_epoch()
                    loader.epoch_ended <<= False
                    loader.last_minibatch <<= False
                epoch_start = time.perf_counter()
                times = {"epoch": loader.epoch_number}
                testing = bool(decision.testing)
                stats = self._eval_classes(testing)
                t = time.perf_counter()
                times["eval_s"] = t - epoch_start
                if not testing and loader.class_lengths[TRAIN]:
                    stats[TRAIN] = self._train_class()
                times["train_s"] = time.perf_counter() - t
                t = time.perf_counter()
                self._close_epoch(stats)
                times["decision_s"] = time.perf_counter() - t
                self._epoch_end(services, stats, times, epoch_start)
                epochs_done += 1
                samples_done += sum(s["samples"] for s in stats.values())
        finally:
            self._refresh_units()
            workflow.is_running = False
            elapsed = time.perf_counter() - start
            workflow._run_time += elapsed
            workflow.event("run", "end")
        workflow.on_workflow_finished()
        _log.info("fused run: %d epochs, %d samples in %.2fs "
                  "(%.0f samples/s)", epochs_done, samples_done, elapsed,
                  samples_done / max(elapsed, 1e-9))
        return workflow
