"""The softmax loss of the training step (``veles_tpu/nn/evaluator.py``
``EvaluatorSoftmax`` as the fused trainer computes it,
``veles_tpu/train/step.py`` ``_loss_and_metrics``).

The minibatch has a static size; a short tail is padded with rows whose
``valid`` is False. Two normalisations, on purpose:

* ``grad_loss``, the value differentiated, divides by the PADDED batch,
  so its gradient w.r.t. the logits is ``(p - onehot) * valid / batch``,
  the eager evaluator's seed, whatever the tail;
* ``report_loss``, the number shown to people, divides by the valid rows.

Every reduction runs in float32, whatever the policy left the logits in.
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
