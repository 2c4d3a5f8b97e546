"""The losses of the training step (``veles_tpu/nn/evaluator.py``
``EvaluatorSoftmax`` and ``EvaluatorMSE`` as the fused trainer computes
them, ``veles_tpu/train/step.py`` ``_loss_and_metrics``), and the
softmax confusion matrix.

The minibatch has a static size; a short tail is padded with rows whose
``valid`` is False. The two losses normalise their gradients
differently, as in the JAX package:

* softmax: ``grad_loss`` divides by the PADDED batch, so its gradient
  w.r.t. the logits is ``(p - onehot) * valid / batch``, the eager
  evaluator's seed, whatever the tail; ``report_loss``, the number shown
  to people, divides by the valid rows;
* MSE: ``grad_loss = 0.5 * sum(d^2) / n_valid`` over the masked
  difference d, whose gradient is the eager ``d / n_valid``; the metric
  is ``sum over rows of mean(d^2)`` (what ``DecisionMSE`` sums), reported
  over n_valid.

Every reduction runs in float32, whatever the policy left the output in.
"""

import torch


def softmax_loss_and_metrics(logits, labels, valid):
    """(grad_loss, report_loss, n_err) of ``logits`` (batch, ...) for
    integer ``labels`` (batch,) and boolean ``valid`` (batch,)."""
    out = logits.float()
    batch = out.shape[0]
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(out.reshape(batch, -1), dim=1)
    picked = logp.gather(1, safe[:, None])[:, 0]
    total = (picked * valid.to(torch.float32)).sum()
    n_valid = valid.sum().clamp(min=1).to(torch.float32)
    grad_loss = -total / batch
    report_loss = (-total / n_valid).detach()
    pred = logp.detach().argmax(dim=1)
    n_err = ((pred != safe) & valid).sum()
    return grad_loss, report_loss, n_err


def masked_difference(out, targets, valid):
    """``out - targets`` in float32 as (batch, features), zero on the
    rows whose ``valid`` is False."""
    batch = out.shape[0]
    diff = out.float().reshape(batch, -1) - targets.float().reshape(
        batch, -1)
    return diff * valid.to(torch.float32)[:, None]


def mse_loss_and_metrics(out, targets, valid):
    """(grad_loss, report_loss, metric) of ``out`` against ``targets``
    (same rows, any sample shape) with boolean ``valid`` (batch,)."""
    diff = masked_difference(out, targets, valid)
    n_valid = valid.sum().clamp(min=1).to(torch.float32)
    grad_loss = 0.5 * torch.sum(torch.square(diff)) / n_valid
    metric = torch.sum(torch.mean(torch.square(diff.detach()), dim=1))
    return grad_loss, metric / n_valid, metric


def mse_rmse(out, targets, valid):
    """``_mse_eval``'s RMSE of one minibatch: sqrt of the mean over the
    valid rows of each row's mean squared difference."""
    diff = masked_difference(out, targets, valid)
    n_valid = valid.sum().clamp(min=1).to(torch.float32)
    return torch.sqrt(torch.sum(torch.mean(torch.square(diff), dim=1)) /
                      n_valid)


def batch_confusion(out, labels, valid):
    """One minibatch's confusion counts, int32 (n_classes, n_classes):
    row = true label, column = argmax of ``out``; padded rows count
    nothing."""
    probs = out.reshape(out.shape[0], -1)
    n_classes = probs.shape[-1]
    pred = probs.argmax(dim=1)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    flat = safe * n_classes + pred
    counts = torch.zeros(n_classes * n_classes, dtype=torch.int32,
                         device=out.device)
    counts.index_add_(0, flat, valid.to(torch.int32))
    return counts.reshape(n_classes, n_classes)
