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
  training, then the loader's shuffle;
* ``train(max_epochs, fail_iterations)``: epochs until ``max_epochs`` or
  until the decision's stop, with ``best_metric`` / ``best_epoch`` kept
  as the JAX trainer keeps them on its decision unit;
  ``pull_params`` / ``push_params`` as state dicts.

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

Left out for later slices: streaming and offload, the space-to-depth
staging pack and the cost-book harvest.
"""

import logging
import math
import time

import numpy
import torch

from veles_tpu_torch import prng
from veles_tpu_torch.convert import layer_params
from veles_tpu_torch.loader.base import CLASS_NAMES, TEST, TRAIN, VALIDATION
from veles_tpu_torch.nn.dropout import DropoutForward
from veles_tpu_torch.nn.evaluator import (batch_confusion,
                                          mse_loss_and_metrics,
                                          softmax_loss_and_metrics)
from veles_tpu_torch.nn.optim import get_solver
from veles_tpu_torch.nn.precision import policy_of
from veles_tpu_torch.ops.random import (dropout_offset, uniform_fill,
                                        uniform_fill_plain)

_log = logging.getLogger(__name__)


#: loss name -> (its function, the loader's truth it reads)
LOSSES = {"softmax": (softmax_loss_and_metrics, "labels"),
          "mse": (mse_loss_and_metrics, "targets")}


class FusedTrainer(object):
    """Trains ``model`` (an ``nn.Sequential`` of the port's modules)
    over ``loader`` with ``loss`` (``softmax`` or ``mse``) and
    ``solver`` (a name or a rule of ``nn/optim.py``).

    ``hypers`` holds one solver hyper-parameter dict per module, and
    ``states``, when given, the solver state of each (``{}`` for a
    module without weights; else the solver's fresh state).
    ``plain=True`` runs every kernel's plain version instead (the
    reference the kernels are held against on the card)."""

    def __init__(self, model, loader, hypers, solver="sgd", loss="softmax",
                 uniform_source=None, plain=False, states=None):
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
        self.solver = get_solver(solver)
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
        self.device = next(model.parameters()).device
        self.policy = policy_of(model)
        loader.stage(self.device)
        self.params = [layer_params(m) for m in self.forwards]
        self.states = list(states) if states is not None else [
            self.solver.init(p) if p else {} for p in self.params]

    # -- forward and loss --------------------------------------------------

    def _uniforms(self, shape, seed, batch_index, layer_index, device):
        """A dropout mask's uniforms: the uniform source's, or else K7
        (its plain version when ``plain``) at stream (seed, offset of
        batch and layer), filled as (shape[0], rest) and reshaped."""
        shape = tuple(shape)
        if self.uniform_source is not None:
            return self.uniform_source(shape, seed, batch_index,
                                       layer_index, device)
        fill = uniform_fill_plain if self.plain else uniform_fill
        return fill((shape[0], math.prod(shape[1:])), seed,
                    dropout_offset(batch_index, layer_index),
                    device=device).reshape(shape)

    def _forward(self, x, train, batch_index=0, seed=0, aux=None,
                 valid=None):
        """The chain; dropout masks only in training; the head yields
        logits (``apply_for_grad``). ``aux``, a list, collects the
        auxiliary loss of every layer whose ``aux_loss_weight`` is not 0,
        taken on its input with the batch's ``valid`` mask."""
        last = len(self.forwards) - 1
        for i, module in enumerate(self.forwards):
            if aux is not None and getattr(module, "aux_loss_weight", 0.0):
                aux.append(module.aux_loss(x, valid))
            if isinstance(module, DropoutForward):
                if train:
                    x = module.train_forward(x, self._uniforms(
                        x.shape, seed, batch_index, i, x.device))
            elif i == last and hasattr(module, "logits"):
                x = module.logits(x, self.plain)
            elif self.plain:
                x = module.plain_forward(x)
            else:
                x = module(x)
        return x

    def _dropout_seed(self):
        """This epoch's dropout seed, from the first dropout layer's
        stream; 0 without dropout (no stream is touched)."""
        for module in self.forwards:
            if isinstance(module, DropoutForward):
                return prng.get(module.rand_name).philox_seed()
        return 0

    def gradients(self, indices, batch_index, seed):
        """Loss and gradients of one minibatch (``indices`` on the
        device), without an update: (report_loss, metric) -- the metric
        the error count (softmax) or the summed per-row MSE -- with each
        parameter's ``.grad`` set."""
        with self.policy.backends():
            x, truth, valid = self.loader.gather(indices)
            for params in self.params:
                for p in params.values():
                    p.grad = None
            aux = []
            out = self._forward(x, True, batch_index, seed, aux, valid)
            grad_loss, report, metric = self._loss(out, truth, valid)
            for term in aux:
                grad_loss = grad_loss + term
            grad_loss.backward()
        return report, metric

    def grad_norm(self):
        """The float32 global norm of the gradients set by
        :meth:`gradients`: the norm of the per-tensor norms (one
        multi-tensor launch for those)."""
        grads = [p.grad for params in self.params for p in params.values()]
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))

    def train_batch(self, indices, batch_index, seed):
        """One step: gradients, their norm (``batch_norm``), then the
        solver over the layers in order. Returns (report_loss, metric)
        as device scalars."""
        with self.policy.backends():
            report, metric = self.gradients(indices, batch_index, seed)
            self.batch_norm = self.grad_norm()
            for params, state, hp in zip(self.params, self.states,
                                         self.hypers):
                if params:
                    self.solver.update(
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

    def eval_class(self, klass, skip=0):
        """Forward-only sweep of one class: (losses, metrics, confusion)
        per minibatch as device tensors, the confusion matrix summed over
        the sweep (softmax only, else None)."""
        idx = torch.from_numpy(self._segment_indices(klass, skip)).to(
            self.device)
        losses, metrics = [], []
        confusion = None
        with torch.no_grad(), self.policy.backends():
            for row in idx:
                x, truth, valid = self.loader.gather(row)
                out = self._forward(x, False)
                _, report, metric = self._loss(out, truth, valid)
                losses.append(report)
                metrics.append(metric)
                if self.loss_kind == "softmax":
                    counts = batch_confusion(out, truth, valid)
                    confusion = counts if confusion is None \
                        else confusion + counts
        return torch.stack(losses), torch.stack(metrics), confusion

    def train_class(self, skip=0):
        """One training sweep of the TRAIN class: (losses, metrics) per
        minibatch; the batches' gradient norms go to
        ``last_grad_norms``. Batch indices continue from ``skip``'s
        position in the epoch, as the JAX trainer's fold indices do."""
        idx = torch.from_numpy(self._segment_indices(TRAIN, skip)).to(
            self.device)
        seed = self._dropout_seed()
        first = skip // self.loader.max_minibatch_size
        losses, metrics, norms = [], [], []
        for j, row in enumerate(idx):
            report, metric = self.train_batch(row, first + j, seed)
            losses.append(report)
            metrics.append(metric)
            norms.append(self.batch_norm)
        self.last_grad_norms = torch.stack(norms)
        return torch.stack(losses), torch.stack(metrics)

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
            stats[CLASS_NAMES[TRAIN]] = self._summarize(
                *self.train_class(), klass=TRAIN)
            loader.epoch_number = epoch + 1
            if loader.epoch_number <= loader.shuffle_limit:
                loader.shuffle()
        return stats

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

    def train(self, max_epochs=None, fail_iterations=100):
        """Epochs from the loader's epoch number on, as the JAX trainer's
        ``train()`` runs them: after each, the validation metric (the
        training one without validation) updates ``best_metric`` and
        ``best_epoch`` when it falls; the loop stops once ``max_epochs``
        epochs are done, or when the epoch just finished is more than
        ``fail_iterations`` past the best. Returns the history."""
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
            epoch += 1
            if max_epochs is not None and epoch >= max_epochs:
                break
            if (epoch - 1) - self.best_epoch > fail_iterations:
                break
        _log.info("fused training: %d epochs in %.2fs", done,
                  time.perf_counter() - start)
        return self.epoch_history

    # -- parameter plumbing ------------------------------------------------

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


def _clone_state(state):
    if isinstance(state, dict):
        return {k: _clone_state(v) for k, v in state.items()}
    return state.detach().clone()
