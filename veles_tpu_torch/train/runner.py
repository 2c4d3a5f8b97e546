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

:func:`fused_compatible` says why a graph cannot run this way (a unit
the trainer does not model, a loader position inside a minibatch, more
than one solver); the launcher then runs the eager per-unit scheduler
(``Workflow.run``), as the JAX launcher does.

Each epoch's wall time is split in :attr:`FusedRunner.epoch_times`:
the evaluation and training sweeps (each ends in a host read of its
metrics, which waits for the device), the decision's bookkeeping and
the services; each class's mean minibatch loss rides beside. A streamed
run adds the epoch's input wait and its starvation fraction (wait over
the sweeps' wall), an offloaded one its upload wait and the overlap
fraction (1 - wait over wall), as ``veles_tpu/train/runner.py``
publishes them; each is logged once an epoch. The run ends with
``trainer.shutdown()``, so no pipeline thread outlives it.

Telemetry, as the JAX runner's (``veles_tpu/train/runner.py``): each
sweep is a ``step:eval`` / ``step:train`` span and a
``veles_step_ms{phase}`` sample, timed to the host read of its losses
(the sweep's own wait for the card; nothing here synchronizes), the
same elapsed time the epoch's ``eval_s`` / ``train_s`` report; the first
training sweep is the ``first_step`` phase. The cost book receives each
sweep's analytic FLOPs and bytes (``train_segment`` / ``eval_segment``,
:meth:`FusedTrainer.note_sweep_cost`) and its time, and the train sweep
sets ``veles_step_mfu``. The flight recorder's stall watchdog is armed
around each sweep; the sweep's per-batch losses (already on the host)
and, after the sweep, its gradient norms go to its detectors. Each
epoch is an ``epoch`` span and a ``veles_epoch_ms`` sample, and sets
``veles_train_loss``, ``veles_train_samples_per_s`` and, streamed or
offloaded, ``veles_input_starvation_fraction`` /
``veles_offload_compute_overlap_fraction`` to the epoch's readings.
"""

import collections
import logging
import time

from veles_tpu_torch.loader import prefetch
from veles_tpu_torch.loader.base import (CLASS_NAMES, TEST, TRAIN,
                                         VALIDATION)
from veles_tpu_torch.nn.units import EvaluatorMSE, EvaluatorSoftmax
from veles_tpu_torch.plumbing import EndPoint, Repeater, StartPoint
from veles_tpu_torch.telemetry import flight, profiler, tracing
from veles_tpu_torch.telemetry.registry import get_registry
from veles_tpu_torch.train import offload
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
    solvers = sorted({gd.solver_name for gd in getattr(workflow, "gds", ())
                      if gd.opt_state})
    if len(solvers) > 1:
        return "the trainer runs one solver, the workflow has %s" % solvers
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
        self._epoch_index = 0
        self._first_step_done = False
        self._bind_telemetry()

    #: the process's telemetry handles: not part of a pickled runner (a
    #: workflow snapshot taken mid-run may hold it)
    _TELEMETRY = ("_step_ms", "_epoch_ms", "_m_loss", "_m_samples_per_s",
                  "_starvation", "_offload_overlap", "_flight", "_book")

    def __getstate__(self):
        state = dict(self.__dict__)
        for name in self._TELEMETRY:
            state.pop(name, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._bind_telemetry()

    def _bind_telemetry(self):
        registry = get_registry()
        self._step_ms = registry.histogram(
            "veles_step_ms", "Fused step (one class sweep) wall time",
            labels=("phase",))
        self._epoch_ms = registry.histogram(
            "veles_epoch_ms", "End-to-end epoch wall time")
        self._m_loss = registry.gauge(
            "veles_train_loss", "Last training batch loss")
        self._m_samples_per_s = registry.gauge(
            "veles_train_samples_per_s",
            "Samples served per second over the last epoch")
        self._starvation = prefetch.starvation_gauge()
        self._offload_overlap = offload.overlap_gauge()
        self._flight = flight.get_recorder()
        self._book = profiler.get_cost_book()

    def _timed_step(self, phase, fn, *args, **kwargs):
        """Run one sweep (``fn`` returns its per-class stats, read to the
        host) under the stall watchdog, a ``step:<phase>`` span and the
        step histogram; note its cost and time in the cost book (and the
        step MFU of a train sweep). Returns (stats, elapsed s)."""
        label = "%s sweep epoch %d" % (phase, self._epoch_index)
        self._flight.step_begin(label)
        start = time.perf_counter()
        try:
            stats = fn(*args, **kwargs)
        except Exception as e:
            self._flight.record_exception(e, step=label)
            raise
        finally:
            self._flight.step_end()
            elapsed = time.perf_counter() - start
            self._step_ms.labels(phase=phase).observe(elapsed * 1e3)
            tracing.add_complete("step:%s" % phase, start, elapsed)
            if phase == "train" and not self._first_step_done:
                self._first_step_done = True
                profiler.record_phase("first_step", elapsed)
        train = phase == "train"
        op = "train_segment" if train else "eval_segment"
        per_class = [stats] if train else list(stats.values())
        samples = sum(s["samples"] for s in per_class)
        if samples:
            self.trainer.note_sweep_cost(op, samples, train)
        self._book.observe_ms(op, elapsed)
        if train:
            self._book.record_step_mfu(op, elapsed)
        self._flight.observe_step(phase, elapsed, loss=self._last_batch[0],
                                  epoch=self._epoch_index)
        for s in per_class:
            self._flight.check_losses(s["losses"], epoch=self._epoch_index,
                                      phase=phase)
        return stats, elapsed

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
        stats, _ = self._timed_step("eval", self._eval_classes, testing,
                                    skips=skips)
        train_skip = skips.get(TRAIN)
        if not testing and train_skip is not None:
            stats[TRAIN], _ = self._timed_step("train", self._train_class,
                                               skip=train_skip)
            self._observe_grad_norms()
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

    def _observe_grad_norms(self):
        """The train sweep's gradient norms to the flight recorder's
        divergence detector (after the sweep's timing)."""
        norms = self.trainer.last_grad_norms
        if norms is not None:
            self._flight.observe_grad_norms(norms.float().cpu().numpy(),
                                            epoch=self._epoch_index)

    def _residency_times(self, times, waits):
        """The epoch's input-starvation and offload-overlap readings
        from the trainer's wait counters at the epoch's start."""
        trainer = self.trainer
        sweeps = times.get("eval_s", 0.0) + times.get("train_s", 0.0) + \
            times.get("sweeps_s", 0.0)
        if trainer.streaming:
            wait = trainer.input_wait_s - waits[0]
            times["input_wait_s"] = wait
            times["first_wait_s"] = trainer.first_wait_s
            times["starvation"] = min(1.0, wait / sweeps) if sweeps else 0.0
            self._starvation.labels(phase="epoch").set(times["starvation"])
            _log.info("epoch %d: input wait %.3f s, starvation %.3f",
                      times["epoch"], wait, times["starvation"])
        if trainer.offloaded:
            wait = trainer.offload_wait_s - waits[1]
            times["offload_wait_s"] = wait
            times["offload_overlap"] = max(0.0, 1.0 - wait / sweeps) \
                if sweeps else 0.0
            self._offload_overlap.labels(phase="epoch").set(
                times["offload_overlap"])
            _log.info("epoch %d: offload wait %.3f s, overlap %.3f",
                      times["epoch"], wait, times["offload_overlap"])

    def _epoch_end(self, services, stats, times, start):
        times["loss"] = {CLASS_NAMES[k]: s["loss"] for k, s in stats.items()}
        self._refresh_units()
        t = time.perf_counter()
        self._fire_services(services)
        times["services_s"] = time.perf_counter() - t
        times["wall_s"] = time.perf_counter() - start
        self.epoch_times.append(times)
        self._epoch_ms.observe(times["wall_s"] * 1e3)
        tracing.add_complete("epoch", start, times["wall_s"],
                             index=times["epoch"])
        self._m_loss.set(self._last_batch[0])
        samples = sum(s["samples"] for s in stats.values())
        if times["wall_s"] > 0:
            self._m_samples_per_s.set(samples / times["wall_s"])
        self._epoch_index += 1

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
                waits = (self.trainer.input_wait_s,
                         self.trainer.offload_wait_s)
                if loader.total_samples and \
                        loader._global_offset >= loader.total_samples:
                    # the eager loader's lazy epoch wrap on next serve
                    loader._finish_epoch()
                    loader.epoch_ended <<= False
                    loader.last_minibatch <<= False
                epoch_start = time.perf_counter()
                times = {"epoch": loader.epoch_number}
                testing = bool(decision.testing)
                stats, times["eval_s"] = self._timed_step(
                    "eval", self._eval_classes, testing)
                times["train_s"] = 0.0
                if not testing and loader.class_lengths[TRAIN]:
                    stats[TRAIN], times["train_s"] = self._timed_step(
                        "train", self._train_class)
                    self._observe_grad_norms()
                self._residency_times(times, waits)
                t = time.perf_counter()
                self._close_epoch(stats)
                times["decision_s"] = time.perf_counter() - t
                self._epoch_end(services, stats, times, epoch_start)
                epochs_done += 1
                samples_done += sum(s["samples"] for s in stats.values())
        except Exception as e:
            # the crash path: the black box is written before the
            # exception unwinds the run (the recorder rate-limits the
            # sweep's own dump)
            self._flight.record_exception(
                e, step="epoch %d" % self._epoch_index)
            raise
        finally:
            self.trainer.shutdown()
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
