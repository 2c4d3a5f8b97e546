"""The fused trainer (``veles_tpu/train/step.py`` ``FusedTrainer``).

Drives a model built by ``models.build.build_training`` over a
full-batch loader whose dataset sits on the device:

* ``_segment_indices``: a class's shuffled indices as an (n_batches,
  minibatch) matrix padded with -1, as in the JAX package;
* ``train_batch``: gather, forward (dropout masks by absolute layer
  index, the head's logits), the loss -- softmax over the padded batch
  with the loader's labels, or MSE over the valid rows with the loader's
  targets (``nn/evaluator.py``), plus the auxiliary loss of each layer
  that has one with a non-zero weight (the mixture of experts' load
  balance, over the batch's valid rows; it shapes the gradients, the
  reported loss stays the task's) -- ``backward()``, the global gradient
  norm, then the solver's update of each layer in order, all under the
  model policy's ``backends()`` (no TF32, no bf16 reductions in bf16,
  whatever the caller switched on);
* ``eval_class`` / ``train_class`` / ``run_epoch``: evaluation classes
  first (with the softmax confusion matrix summed over the sweep), then
  training, then the loader's shuffle; ``confusion_segment``: the
  confusion alone of a forward sweep over any index matrix (the TRAIN
  class's, for a workflow without a validation class);
* ``train(max_epochs, epoch_callback, initial_state, fail_iterations)``:
  epochs until ``max_epochs`` or until the decision's stop, with
  ``epoch_history``, ``best_metric`` and ``best_epoch`` kept on the
  trainer where the JAX trainer keeps them on its decision unit (a
  caller that drives a workflow's decision, as the elastic tier does,
  hands the decision's history list to the trainer and copies ``best_*``
  back: ``parallel/elastic.py``); ``pull_params`` / ``push_params`` as
  state dicts.

The elastic checkpoint seam, as in the JAX trainer: ``epoch_callback``
(the argument, or the attribute) fires after each epoch's bookkeeping
closes with ``(trainer, params, states)``, the trainer's live state at a
complete step boundary, which it only reads; :meth:`FusedTrainer.
checkpoint_records` lists that state as ``[(spec, leaf)]`` for
``snapshotter.save_snapshot_sharded``, in the JAX trainer's order and
specs, each leaf in the JAX layout (HWIO convolutions) so the units
restore it as they restore a snapshot's parameters. A leaf is a host
numpy array here; the SPMD trainers give this rank's blocks of it
(:class:`veles_tpu_torch.snapshotter.ShardedLeaf`).

Gradient norms, as the JAX trainer tracks them by default: the float32
global norm of each training batch's gradients, over every parameter of
every layer, gathered in ``last_grad_norms`` (one per batch of the last
sweep). An observation only: the update never reads it.

PyTorch runs eagerly, so where the JAX trainer compiles a ``lax.scan``
over a segment this one loops over its rows in Python, and parameters
and optimizer state stay on the device, updated in place.

Dropout: per epoch, the trainer draws one 64-bit seed from the first
dropout layer's stream (``prng.get(rand_name).philox_seed()``, as the
JAX trainer draws ``jax_key()``), and the mask of layer i at batch b
comes from the uniform source at (seed, b, i), as the JAX trainer folds
b and then i into its key. The default source is the Philox fill K7
(``ops/random.py``); any callable ``source(shape, seed, batch_index,
layer_index, device)`` returning float32 uniforms of ``shape`` may
replace it (the parity tests hand over JAX's own ``jax.random``
numbers this way).

Residency (``veles_tpu/train/step.py`` ``_setup_data_residency`` and
``_setup_model_residency``): the dataset is staged on the device when it
fits the budget (:func:`veles_tpu_torch.loader.prefetch.plan_residency`:
``stream``, ``VELES_STREAM``, ``VELES_DEVICE_BUDGET_MB``) and otherwise
*streamed*: each class sweep's index matrix is cut into shards of
``shard_batches`` minibatches, which worker threads gather on the host
into pinned buffers and copy to the device through a
:class:`~veles_tpu_torch.loader.prefetch.StagingRing` while the step
thread computes the shard before (``prefetch_depth``,
``prefetch_workers``, ``VELES_PREFETCH``). The model state stays on
the device unless it exceeds the budget or ``offload`` /
``VELES_OFFLOAD`` ask: then the parameters and solver state live on the
host (pinned) and each step walks layer groups through
:class:`~veles_tpu_torch.train.offload.OffloadEngine`. A streamed
dataset wins over offload. Batch indices, dropout seeds and fold order
are the resident sweep's, so a streamed or offloaded epoch gives the
resident in-core epoch's values. :meth:`FusedTrainer.shutdown` joins
every pipeline thread. The readings are attributes -- ``input_wait_s``
and ``first_wait_s`` (the step thread's wait for shards),
``shard_etl_ms`` / ``shard_h2d_ms`` (per shard of the last streamed
sweep) and ``offload_wait_s`` -- and, as in the JAX package, telemetry:
``veles_prefetch_etl_ms`` / ``veles_prefetch_h2d_ms`` with the
``prefetch:etl`` / ``prefetch:h2d`` spans of each shard, the
``offload_plan`` startup phase with the ``offload:plan`` and
``offload:pin`` spans. :meth:`run_epoch` publishes the live training
view (``veles_train_loss``, ``veles_train_samples_per_s`` and the step
MFU of its training sweep); :meth:`sweep_cost` gives the cost book a
sweep's analytic FLOPs and bytes
(:func:`veles_tpu_torch.models.build.sweep_cost`).

The seams a subclass overrides, as in the JAX trainer: ``_op_prefix``
(the cost-book rows of its sweeps), :meth:`FusedTrainer._per_sample`
(the per-sample values every cross-sample reduction reads: the loss,
the metrics and the confusion matrix, through
:meth:`FusedTrainer._loss_and_metrics` in training),
:meth:`FusedTrainer._dataset_device_bytes` (the dataset bytes one device
holds, which the residency plan compares with its budget),
:meth:`FusedTrainer._shard_placer` (a placement of the resident dataset
other than the loader's staged copy), :meth:`FusedTrainer._uniforms`
(the uniforms of a dropout mask) and :meth:`FusedTrainer.
_reduce_gradients`, the point between the backward pass and the solver
(the data-parallel trainers all-reduce there;
``veles_tpu_torch/parallel/dp.py``), with :meth:`FusedTrainer.
_reduce_gradient_list`, the same over one offloaded layer group's
gradients. The offload engine gathers, reduces the loss and the metrics
through the same seams, so an offloaded model trains under data
parallelism too.

Left out for later slices: the space-to-depth staging pack.
"""

import logging
import math
import time

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.convert import layer_params
from veles_tpu_torch.loader import prefetch
from veles_tpu_torch.loader.base import CLASS_NAMES, TEST, TRAIN, VALIDATION
from veles_tpu_torch.nn.dropout import DropoutForward
from veles_tpu_torch.nn.evaluator import (batch_confusion,
                                          mse_loss_and_metrics,
                                          softmax_loss_and_metrics)
from veles_tpu_torch.nn.optim import get_solver
from veles_tpu_torch.nn.precision import policy_of
from veles_tpu_torch.ops.random import dropout_uniforms
from veles_tpu_torch.telemetry import profiler, tracing
from veles_tpu_torch.telemetry.registry import get_registry

_log = logging.getLogger(__name__)


#: loss name -> (its function, the loader's truth it reads)
LOSSES = {"softmax": (softmax_loss_and_metrics, "labels"),
          "mse": (mse_loss_and_metrics, "targets")}


class FusedTrainer(object):
    """Trains ``model`` (an ``nn.Sequential`` of the port's modules)
    over ``loader`` with ``loss`` (``softmax`` or ``mse``) and
    ``solver``: a name or a rule of ``nn/optim.py`` for every module, or
    a sequence of them, one per module (each layer updated by its own
    rule, as the JAX trainer keeps one solver per layer).

    ``hypers`` holds one solver hyper-parameter dict per module, and
    ``states``, when given, the solver state of each (``{}`` for a
    module without weights; else the solver's fresh state).
    ``plain=True`` runs every kernel's plain version instead (the
    reference the kernels are held against on the card)."""

    #: prefix of the cost-book rows of this trainer's sweeps
    _op_prefix = ""

    def __init__(self, model, loader, hypers, solver="sgd", loss="softmax",
                 uniform_source=None, plain=False, states=None, device=None,
                 stream=None, prefetch_depth=None, prefetch_workers=None,
                 offload=None, offload_depth=None, offload_workers=None):
        if loss not in LOSSES:
            raise ValueError("loss must be one of %s, got %r"
                             % (sorted(LOSSES), loss))
        self.loss_kind = loss
        self._loss, truth = LOSSES[loss]
        if loader.TRUTH != truth:
            raise ValueError("the %s loss reads the loader's %s; %s gives "
                             "%s" % (loss, truth, type(loader).__name__,
                                     loader.TRUTH))
        self.model = model
        self.forwards = list(model)
        self.loader = loader
        self.hypers = list(hypers)
        if len(self.hypers) != len(self.forwards):
            raise ValueError("%d hyper-parameter dicts for %d layers" % (
                len(self.hypers), len(self.forwards)))
        per_layer = solver if isinstance(solver, (list, tuple)) else \
            [solver] * len(self.forwards)
        if len(per_layer) != len(self.forwards):
            raise ValueError("%d solvers for %d layers" % (
                len(per_layer), len(self.forwards)))
        #: each module's update rule
        self.solvers = [get_solver(name) for name in per_layer]
        self.uniform_source = uniform_source
        self.plain = plain
        #: the last training batch's norm, and the (n_batches,) float32
        #: norms of the last training sweep
        self.batch_norm = None
        self.last_grad_norms = None
        #: the decision's record: per-epoch stats, the best validation
        #: (or, without validation, training) metric and its epoch
        self.epoch_history = []
        self.best_metric = math.inf
        self.best_epoch = -1
        #: optional ``fn(trainer, params, states)`` fired after every
        #: closed epoch of :meth:`train`: the elastic checkpoint seam; it
        #: must not change the state it is given
        self.epoch_callback = None
        self.device = trainer_device(model, device)
        self.policy = policy_of(model)
        self.stream = stream
        self.prefetch_depth = prefetch_depth
        self.prefetch_workers = prefetch_workers
        self.offload = offload
        self.offload_depth = offload_depth
        self.offload_workers = offload_workers
        #: the step thread's cumulative wait for streamed shards, the
        #: wait for the first shard of the last sweep, and each shard's
        #: host ETL and copy-dispatch ms in the last streamed sweep
        self.input_wait_s = 0.0
        self.first_wait_s = None
        self.shard_etl_ms = []
        self.shard_h2d_ms = []
        #: (copy start, copy end, bytes) of each shard of the last
        #: streamed sweep (CUDA events; empty off the card)
        self.shard_copies = []
        self.streaming = False
        self.offloaded = False
        self._active_pipeline = None
        self._staging_ring = None
        self._offload_engine = None
        #: the resident dataset as this trainer placed it (None: the
        #: loader's staged copy)
        self._data_args = None
        self._setup_data_residency()
        self.params = [layer_params(m) for m in self.forwards]
        self._setup_model_residency(states)

    @property
    def solver(self):
        """The rule of every layer with weights when they share one, else
        None (see ``solvers``)."""
        rules = {rule for rule, p in zip(self.solvers, self.params) if p}
        return rules.pop() if len(rules) == 1 else None

    # -- residency ---------------------------------------------------------

    def _setup_data_residency(self):
        """Stage the dataset on the device when it fits the budget, else
        stream it from the loader's host copy through the staging ring
        (``veles_tpu/train/step.py`` ``_setup_data_residency``)."""
        loader = self.loader
        data, truth = loader.original_data, loader.truth()
        total = (data.numel() * data.element_size() +
                 truth.numel() * truth.element_size())
        self.streaming = prefetch.plan_residency(
            self._dataset_device_bytes(total), device=self.device,
            force=self.stream) == "streamed"
        if self.streaming and not hasattr(loader, "host_backing"):
            _log.warning("loader %s has no host backing: cannot stream; "
                         "the dataset stays resident",
                         type(loader).__name__)
            self.streaming = False
        if not self.streaming:
            place = self._shard_placer()
            if place is None:
                loader.stage(self.device)
            else:
                loader.release_staged()
                self._data_args = (place(data), place(truth))
            return
        loader.release_staged()
        mb = loader.max_minibatch_size
        self._sample = (tuple(data.shape[1:]), data.dtype,
                        tuple(truth.shape[1:]), truth.dtype)
        batch_bytes = mb * (
            int(numpy.prod(data.shape[1:], dtype=numpy.int64)) *
            data.element_size() +
            int(numpy.prod(truth.shape[1:], dtype=numpy.int64)) *
            truth.element_size())
        depth = (prefetch.default_depth() if self.prefetch_depth is None
                 else self.prefetch_depth)
        self._batches_per_shard = prefetch.shard_batches(
            batch_bytes, depth=depth,
            budget_bytes=prefetch.device_budget_bytes(self.device))
        #: device bytes of one full shard (rows, truth, local indices)
        self.shard_bytes = self._batches_per_shard * (batch_bytes + mb * 4)
        slots = max(1, depth) + 2
        self._staging_ring = prefetch.StagingRing(slots, self.device)
        self._host_ring = prefetch.HostRing(
            slots, pin=self.device.type == "cuda")

        _log.info("dataset streams out of core: %.0f MB over the device "
                  "budget; shards of %d minibatches (%.0f MB), prefetch "
                  "depth %d", total / 1e6, self._batches_per_shard,
                  self._batches_per_shard * batch_bytes / 1e6, depth)

    def _dataset_device_bytes(self, total_bytes):
        """The bytes of a ``total_bytes`` dataset that one device holds
        resident: all of them."""
        return total_bytes

    def _shard_placer(self):
        """``place(host tensor) -> device tensor`` for the resident
        dataset and its truth, or None: the loader stages them whole."""
        return None

    def _setup_model_residency(self, states):
        """Solver state beside the parameters, both on the device, or
        both on the host when the model state offloads
        (``veles_tpu/train/step.py`` ``_setup_model_residency``; a
        streamed dataset keeps the model in-core)."""
        from veles_tpu_torch.train import offload
        solvers = [rule if p else None
                   for rule, p in zip(self.solvers, self.params)]
        layer_bytes = offload.model_layer_bytes(self.forwards, solvers)
        decision = offload.plan_offload(sum(layer_bytes), device=self.device,
                                        force=self.offload)
        if decision == "offloaded" and self.streaming:
            _log.warning("offloaded model state needs a resident dataset: "
                         "the streamed input pipeline owns the staging "
                         "budget; the parameters stay in-core")
            decision = "resident"
        self.offloaded = decision == "offloaded"
        if self.offloaded:
            pin = self.device.type == "cuda"
            t0 = time.perf_counter()
            with torch.no_grad():
                for params in self.params:
                    for p in params.values():
                        p.data = offload.host_copy(p.data, pin)
            if states is not None:
                states = [offload.host_tree(s, pin) for s in states]
            tracing.add_complete("offload:pin", t0,
                                 time.perf_counter() - t0)
        elif any(p.device != self.device for params in self.params
                 for p in params.values()):
            raise ValueError("the model's parameters are not on %s; an "
                             "in-core trainer needs them there"
                             % self.device)
        self.states = list(states) if states is not None else [
            rule.init(p) if p else {}
            for rule, p in zip(self.solvers, self.params)]
        if not self.offloaded:
            return
        if states is None:
            pin = self.device.type == "cuda"
            self.states = [offload.host_tree(s, pin) for s in self.states]
        depth = (offload.offload_depth() if self.offload_depth is None
                 else max(0, self.offload_depth))
        with profiler.phase("offload_plan"), tracing.span("offload:plan"):
            plan = offload.OffloadPlan.build(
                layer_bytes, offload.group_budget_bytes(self.device, depth))
            self._offload_engine = offload.OffloadEngine(
                self, plan, depth=depth, workers=self.offload_workers)
        _log.info("model state offloads out of core: %.1f MB in %d layer "
                  "groups (%s), staging depth %d", plan.total_bytes / 1e6,
                  plan.n_groups, "/".join("%d-%d" % g for g in plan.groups),
                  depth)

    @property
    def offload_wait_s(self):
        """The step thread's cumulative wait for offloaded layer groups
        (0 in-core)."""
        engine = self._offload_engine
        return engine.wait_s if engine is not None else 0.0

    def shutdown(self):
        """Join any live prefetch pipeline, drop the staged shards and
        close the offload engine. Idempotent: the sweeps close their
        pipelines themselves; this is the backstop of a failed run."""
        pipe = self._active_pipeline
        if pipe is not None:
            pipe.close()
            self._active_pipeline = None
        if self._staging_ring is not None:
            self._staging_ring.clear()
        if self._offload_engine is not None:
            self._offload_engine.close()

    # -- forward and loss --------------------------------------------------

    def _forward(self, x, train, batch_index=0, seed=0, aux=None,
                 valid=None):
        """The chain; dropout masks only in training; the head yields
        logits (``apply_for_grad``). ``aux``, a list, collects the
        auxiliary loss of every layer whose ``aux_loss_weight`` is not 0,
        taken on its input with the batch's ``valid`` mask."""
        return self._forward_range(x, 0, len(self.forwards), train,
                                   batch_index, seed, aux, valid)

    def _forward_range(self, x, lo, hi, train, batch_index=0, seed=0,
                       aux=None, valid=None):
        """:meth:`_forward` through layers ``[lo, hi)`` only: the walk
        of offloaded layer groups. Dropout masks are drawn by the
        absolute layer index, so a walk gives the whole chain's."""
        last = len(self.forwards) - 1
        for i in range(lo, hi):
            module = self.forwards[i]
            if aux is not None and getattr(module, "aux_loss_weight", 0.0):
                aux.append(module.aux_loss(x, valid))
            if isinstance(module, DropoutForward):
                if train:
                    x = module.train_forward(x, self._uniforms(
                        x, seed, batch_index, i))
            elif i == last and hasattr(module, "logits"):
                x = module.logits(x, self.plain)
            elif self.plain:
                x = module.plain_forward(x)
            else:
                x = module(x)
        return x

    def _uniforms(self, x, seed, batch_index, i):
        """The uniforms of layer ``i``'s dropout mask over ``x``."""
        return dropout_uniforms(x.shape, seed, batch_index, i, x.device,
                                self.uniform_source, self.plain)

    def _dropout_seed(self):
        """This epoch's dropout seed, from the first dropout layer's
        stream; 0 without dropout (no stream is touched)."""
        for module in self.forwards:
            if isinstance(module, DropoutForward):
                return prng.get(module.rand_name).philox_seed()
        return 0

    def _gather(self, indices, data_args=None):
        """(x, truth, valid) of one minibatch: from the staged dataset,
        or from ``data_args`` (a streamed shard) by its local indices."""
        if data_args is None:
            if self._data_args is not None:
                return self.loader.gather_from(self._data_args, indices)
            return self.loader.gather(indices)
        return self.loader.gather_from(data_args, indices)

    def _per_sample(self, out, truth, valid):
        """The per-sample (output, truth, valid) every cross-sample
        reduction of a batch reads: this trainer's own."""
        return out, truth, valid

    def _loss_and_metrics(self, out, truth, valid):
        """(loss to differentiate, report loss, metric) of a batch's
        output, over :meth:`_per_sample`'s values."""
        return self._loss(*self._per_sample(out, truth, valid))

    def _reduce_gradients(self):
        """Between the backward pass and the solver: the gradients are
        this trainer's own."""

    def _reduce_gradient_list(self, grads):
        """:meth:`_reduce_gradients` over ``grads``, a list of gradient
        tensors (an offloaded layer group's, reduced in place before its
        update): this trainer's own."""

    def gradients(self, indices, batch_index, seed, data_args=None):
        """Loss and gradients of one minibatch (``indices`` on the
        device), without an update: (report_loss, metric) -- the metric
        the error count (softmax) or the summed per-row MSE -- with each
        parameter's ``.grad`` set. In-core only."""
        if self.offloaded:
            raise RuntimeError("an offloaded trainer's gradients live in "
                               "its layer-group walk (train_class)")
        with self.policy.backends():
            x, truth, valid = self._gather(indices, data_args)
            for params in self.params:
                for p in params.values():
                    p.grad = None
            aux = []
            out = self._forward(x, True, batch_index, seed, aux, valid)
            grad_loss, report, metric = self._loss_and_metrics(out, truth,
                                                               valid)
            for term in aux:
                grad_loss = grad_loss + term
            grad_loss.backward()
            self._reduce_gradients()
        return report, metric

    def grad_norm(self):
        """The float32 global norm of the gradients set by
        :meth:`gradients`: the norm of the per-tensor norms (one
        multi-tensor launch for those)."""
        grads = [p.grad for params in self.params for p in params.values()]
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))

    def train_batch(self, indices, batch_index, seed, data_args=None):
        """One step: gradients, their norm (``batch_norm``), then the
        solver over the layers in order. Returns (report_loss, metric)
        as device scalars."""
        with self.policy.backends():
            report, metric = self.gradients(indices, batch_index, seed,
                                            data_args)
            self.batch_norm = self.grad_norm()
            for rule, params, state, hp in zip(self.solvers, self.params,
                                               self.states, self.hypers):
                if params:
                    rule.update(
                        params, {k: p.grad for k, p in params.items()},
                        state, hp)
        return report, metric

    # -- class-level driving -----------------------------------------------

    def _segment_indices(self, klass, skip=0):
        """(n_batches, minibatch) int32 index matrix of a class, padded
        with -1 (the JAX trainer's, bit for bit)."""
        loader = self.loader
        ends = loader.class_end_offsets
        start = ends[klass] - loader.class_lengths[klass] + skip
        seg = numpy.asarray(loader.shuffled_indices[start:ends[klass]],
                            numpy.int32)
        mb = loader.max_minibatch_size
        n_batches = (len(seg) + mb - 1) // mb
        mat = numpy.full((max(n_batches, 1), mb), -1, numpy.int32)
        mat.reshape(-1)[:len(seg)] = seg
        return mat

    def _eval_rows(self, idx, out, data_args=None):
        """Forward-only over the rows of the device index matrix
        ``idx``: each row's report loss and metric appended to ``out``
        = [losses, metrics, confusion], the confusion counts (softmax)
        added to its third item."""
        losses, metrics = out[0], out[1]
        with torch.no_grad(), self.policy.backends():
            for row in idx:
                x, truth, valid = self._gather(row, data_args)
                logits, truth, valid = self._per_sample(
                    self._forward(x, False), truth, valid)
                _, report, metric = self._loss(logits, truth, valid)
                losses.append(report)
                metrics.append(metric)
                if self.loss_kind == "softmax":
                    counts = batch_confusion(logits, truth, valid)
                    out[2] = counts if out[2] is None else out[2] + counts

    def eval_class(self, klass, skip=0):
        """Forward-only sweep of one class: (losses, metrics, confusion)
        per minibatch as device tensors, the confusion matrix summed over
        the sweep (softmax only, else None)."""
        return self.eval_rows(self._segment_indices(klass, skip))

    def eval_rows(self, idx):
        """:meth:`eval_class` over the host index matrix ``idx`` (one
        minibatch a row, -1 padded), resident, streamed or offloaded."""
        out = [[], [], None]
        if self.offloaded:
            self._offload_engine.eval_segment(idx, out)
        elif self.streaming:
            self._stream_segment("eval", idx, lambda data, local, row0:
                                 self._eval_rows(local, out, data))
        else:
            self._eval_rows(torch.from_numpy(idx).to(self.device), out)
        return torch.stack(out[0]), torch.stack(out[1]), out[2]

    def confusion_segment(self, params, idx):
        """The confusion matrix (int32, true label x argmax) summed over
        a forward-only sweep of the host index matrix ``idx``, resident,
        streamed or offloaded (``veles_tpu/train/step.py``
        ``confusion_segment``). ``params``: None for the model's live
        parameters, or a list as :meth:`pull_params` gives it, loaded
        into the model first. A workflow without a validation class gets
        its confusion this way from the TRAIN class (the runner's
        ``confusion_from_train``)."""
        if self.loss_kind != "softmax":
            raise TypeError("confusion requires a softmax evaluator")
        if params is not None:
            with torch.no_grad():
                for layer, values in zip(self.params, params):
                    for k, p in layer.items():
                        p.copy_(values[k])
        return self.eval_rows(idx)[2]

    def _train_rows(self, idx, first, seed, out, data_args=None):
        """:meth:`train_batch` over the rows of the device index matrix
        ``idx``, batch indices from ``first``; losses, metrics and norms
        appended to the lists of ``out``."""
        for j, row in enumerate(idx):
            report, metric = self.train_batch(row, first + j, seed,
                                              data_args)
            out[0].append(report)
            out[1].append(metric)
            out[2].append(self.batch_norm)

    def train_class(self, skip=0):
        """One training sweep of the TRAIN class: (losses, metrics) per
        minibatch; the batches' gradient norms go to
        ``last_grad_norms``. Batch indices continue from ``skip``'s
        position in the epoch, as the JAX trainer's fold indices do."""
        return self.train_rows(self._segment_indices(TRAIN, skip),
                               skip // self.loader.max_minibatch_size,
                               self._dropout_seed())

    def train_rows(self, idx, first, seed):
        """:meth:`train_class` over the host index matrix ``idx``, batch
        indices from ``first``, dropout ``seed``: the segment jobs of a
        slave (``train/segment.py``)."""
        out = [[], [], []]
        if self.offloaded:
            self._offload_engine.train_segment(idx, first, seed, out)
        elif self.streaming:
            self._stream_segment("train", idx, lambda data, local, row0:
                                 self._train_rows(local, first + row0,
                                                  seed, out, data))
        else:
            self._train_rows(torch.from_numpy(idx).to(self.device), first,
                             seed, out)
        self.last_grad_norms = torch.stack(out[2])
        return torch.stack(out[0]), torch.stack(out[1])

    # -- streamed sweeps ---------------------------------------------------

    def _shard_bounds(self, n_rows):
        """[(row0, row1)] index-matrix row ranges, one per shard."""
        rows = max(1, min(self._batches_per_shard, n_rows))
        return [(r, min(r + rows, n_rows)) for r in range(0, n_rows, rows)]

    def _stream_segment(self, kind, idx, run_shard):
        """One class sweep shard by shard: worker threads gather shard
        N+k's rows into pinned host buffers and copy them (with the
        shard-local index matrix) through the staging ring while
        ``run_shard((data, truth), local_idx, row0)`` computes shard N
        on the step thread."""
        bounds = self._shard_bounds(idx.shape[0])
        ring, host = self._staging_ring, self._host_ring
        loader = self.loader
        dshape, ddtype, tshape, tdtype = self._sample
        etl_ms = [0.0] * len(bounds)
        h2d_ms = [0.0] * len(bounds)
        registry = get_registry()
        etl_hist = registry.histogram(
            "veles_prefetch_etl_ms", "Host ETL time per streamed shard")
        h2d_hist = registry.histogram(
            "veles_prefetch_h2d_ms",
            "Host->device transfer dispatch time per streamed shard")
        copies = [None] * len(bounds)

        def produce(i):
            row0, row1 = bounds[i]
            rows_idx = idx[row0:row1]
            n = rows_idx.size
            t0 = time.perf_counter()
            data, truth, local = host.buffers(i, [
                ((n,) + dshape, ddtype), ((n,) + tshape, tdtype),
                (rows_idx.shape, torch.int32)])
            loader.fill_indices(rows_idx, out=(data, truth))
            local.copy_(torch.from_numpy(prefetch.local_indices(rows_idx)))
            t1 = time.perf_counter()
            staged = ring.place((data, truth, local))
            host.guard(i, staged.ready)
            t2 = time.perf_counter()
            etl_ms[i] = (t1 - t0) * 1e3
            h2d_ms[i] = (t2 - t1) * 1e3
            etl_hist.observe(etl_ms[i])
            h2d_hist.observe(h2d_ms[i])
            tracing.add_complete("prefetch:etl", t0, t1 - t0, shard=i)
            tracing.add_complete("prefetch:h2d", t1, t2 - t1, shard=i)
            copies[i] = (staged.started, staged.ready, sum(
                t.numel() * t.element_size() for t in (data, truth, local)))
            return staged, row0

        pipe = prefetch.PrefetchPipeline(
            produce, len(bounds), depth=self.prefetch_depth,
            workers=self.prefetch_workers, name=kind)
        self._active_pipeline = pipe
        try:
            ring.reopen()
            pipe.start()
            for _ in bounds:
                (staged, row0), _ = pipe.get()
                data, truth, local = staged.wait()
                run_shard((data, truth), local, row0)
                ring.release(staged)
        finally:
            pipe.close()
            self._active_pipeline = None
            self.input_wait_s += pipe.wait_s
            self.first_wait_s = pipe.first_wait_s
            self.shard_etl_ms, self.shard_h2d_ms = etl_ms, h2d_ms
            self.shard_copies = [c for c in copies
                                 if c is not None and c[0] is not None]

    def run_epoch(self, epoch=None):
        """One epoch: evaluation classes in reference order, then
        training, then the loader's shuffle. Returns per-class stats
        (``confusion``, a numpy matrix, on softmax evaluation classes;
        ``rmse`` under MSE)."""
        loader = self.loader
        epoch = loader.epoch_number if epoch is None else epoch
        stats = {}
        for klass in (TEST, VALIDATION):
            if loader.class_lengths[klass]:
                losses, metrics, confusion = self.eval_class(klass)
                stats[CLASS_NAMES[klass]] = self._summarize(
                    losses, metrics, klass)
                if confusion is not None:
                    stats[CLASS_NAMES[klass]]["confusion"] = \
                        confusion.cpu().numpy()
        if loader.class_lengths[TRAIN]:
            t0 = time.perf_counter()
            stats[CLASS_NAMES[TRAIN]] = self._summarize(
                *self.train_class(), klass=TRAIN)
            # _summarize read the losses to the host: the elapsed time
            # covers the sweep
            self._publish_live(stats[CLASS_NAMES[TRAIN]],
                               time.perf_counter() - t0)
            loader.epoch_number = epoch + 1
            if loader.epoch_number <= loader.shuffle_limit:
                loader.shuffle()
        return stats

    def sweep_cost(self, samples, train):
        """(FLOPs, bytes) of a sweep over ``samples`` samples of this
        trainer's model, in minibatches of the loader's size."""
        from veles_tpu_torch.models.build import model_cost, sweep_cost
        if getattr(self, "_model_cost", None) is None:
            self._model_cost = model_cost(self.model)
        mb = self.loader.max_minibatch_size
        return sweep_cost(self._model_cost, samples, -(-samples // mb),
                          train)

    def note_sweep_cost(self, op, samples, train):
        """Note ``op``'s analytic cost in the cost book for a sweep of
        ``samples`` samples."""
        profiler.get_cost_book().note_cost(
            op, *self.sweep_cost(samples, train))

    def _publish_live(self, train_stats, elapsed_s):
        """The live training view for runs that drive :meth:`run_epoch`
        directly (the runner publishes the same families): the loss,
        samples/s and the train sweep's cost and step MFU."""
        registry = get_registry()
        registry.gauge(
            "veles_train_loss",
            "Last training batch loss").set(train_stats["loss"])
        if elapsed_s > 0:
            registry.gauge(
                "veles_train_samples_per_s",
                "Samples served per second over the last epoch").set(
                train_stats["samples"] / elapsed_s)
        op = self._op_prefix + "train_segment"
        self.note_sweep_cost(op, train_stats["samples"], True)
        profiler.get_cost_book().record_step_mfu(op, elapsed_s)

    def _summarize(self, losses, metrics, klass):
        n = self.loader.class_lengths[klass]
        metric_sum = float(metrics.sum())
        stats = {"samples": n, "metric": metric_sum,
                 "normalized": metric_sum / max(n, 1),
                 "loss": float(losses.float().mean()),
                 "losses": losses.float().cpu().numpy()}
        if self.loss_kind == "mse":
            stats["rmse"] = math.sqrt(stats["normalized"])
        return stats

    def train(self, max_epochs=None, epoch_callback=None, initial_state=None,
              fail_iterations=100):
        """Epochs from the loader's epoch number on, as the JAX trainer's
        ``train()`` runs them: after each, the validation metric (the
        training one without validation) updates ``best_metric`` and
        ``best_epoch`` when it falls, then ``epoch_callback`` (or the
        :attr:`epoch_callback` attribute) sees ``(self, params,
        states)``; the loop stops once ``max_epochs`` epochs are done, or
        when the epoch just finished is more than ``fail_iterations``
        past the best. ``initial_state``, ``(params, states)`` as
        :meth:`pull_params` gives them, is loaded first. Returns the
        history."""
        callback = (epoch_callback if epoch_callback is not None
                    else self.epoch_callback)
        if initial_state is not None:
            self.push_params(*initial_state)
        epoch = self.loader.epoch_number
        start = time.perf_counter()
        done = 0
        while True:
            stats = self.run_epoch(epoch)
            stats["epoch"] = epoch
            self.epoch_history.append(stats)
            done += 1
            key = ("validation" if self.loader.class_lengths[VALIDATION]
                   else "train")
            metric = stats[key]["normalized"]
            if metric < self.best_metric:
                self.best_metric = metric
                self.best_epoch = epoch
            _log.info("epoch %d: %s", epoch, "  ".join(
                "%s=%.4f" % (k, v["normalized"])
                for k, v in stats.items() if isinstance(v, dict)))
            if callback is not None:
                callback(self, self.params, self.states)
            epoch += 1
            if max_epochs is not None and epoch >= max_epochs:
                break
            if (epoch - 1) - self.best_epoch > fail_iterations:
                break
        _log.info("fused training: %d epochs in %.2fs", done,
                  time.perf_counter() - start)
        return self.epoch_history

    # -- parameter plumbing ------------------------------------------------

    def checkpoint_records(self, params, states):
        """``[(spec, leaf)]`` of the live ``params`` and ``states`` for a
        sharded checkpoint (``snapshotter.save_snapshot_sharded``), in the
        JAX trainer's deterministic order: forward index, then sorted
        parameter names, then each layer's solver state by sorted key
        paths. Specs are ``{"kind": "param", "forward": i, "name": n}``
        and ``{"kind": "opt", "forward": i, "path": [...]}``
        (``snapshotter._apply_record`` installs them); leaves are in the
        JAX layout (:meth:`_record_leaf`)."""
        records = []
        for i, layer in enumerate(params):
            for name in sorted(layer):
                records.append(({"kind": "param", "forward": i,
                                 "name": name},
                                self._record_leaf(i, name, layer[name])))

        def walk(i, node, path):
            if isinstance(node, dict):
                for key in sorted(node):
                    walk(i, node[key], path + [key])
                return
            records.append(({"kind": "opt", "forward": i, "path": path},
                            self._record_leaf(i, path[-1], node)))

        for i, state in enumerate(states):
            if state:
                walk(i, state, [])
        return records

    def _record_leaf(self, i, name, tensor):
        """One checkpoint leaf: the whole ``tensor`` (a parameter, or a
        solver state leaf kept per parameter ``name`` of layer ``i``, or a
        scalar) as a host array in the JAX layout."""
        return jax_layout(tensor.detach().float().cpu().numpy())

    def unit_states(self):
        """Each layer's solver state as the workflow's units hold it,
        once the modules hold this trainer's parameters whole: the
        modules are the trainer's parameters, so its own states."""
        return self.states

    def pull_params(self):
        """(params, states): copies of every layer's parameters and
        solver state as state dicts (``{}`` for layers without
        weights)."""
        params = [{k: p.detach().clone() for k, p in layer.items()}
                  for layer in self.params]
        states = [_clone_state(s) for s in self.states]
        return params, states

    def push_params(self, params, states):
        """Load ``params`` and ``states`` (as :meth:`pull_params` gives
        them) into the model and the solver."""
        with torch.no_grad():
            for layer, values in zip(self.params, params):
                for k, p in layer.items():
                    p.copy_(values[k])
        self.states = [_clone_state(s) for s in states]


def trainer_device(model, device=None):
    """The device a trainer of ``model`` runs on: ``device``, else the
    model's; a card with its index."""
    device = torch.device(device if device is not None
                          else next(model.parameters()).device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def jax_layout(array):
    """A C-contiguous copy of a host array in the JAX layout: a 4-D one
    OIHW -> HWIO, as ``convert.to_jax_layout`` lays parameters."""
    if array.ndim == 4:
        array = array.transpose(2, 3, 1, 0)
    return numpy.array(array, order="C")


def jax_index(index):
    """A block's index (a tuple of slices of the port's layout) in the
    JAX layout of :func:`jax_layout`."""
    if len(index) == 4:
        return (index[2], index[3], index[1], index[0])
    return tuple(index)


def _clone_state(state):
    if isinstance(state, dict):
        return {k: _clone_state(v) for k, v in state.items()}
    return state.detach().clone()
