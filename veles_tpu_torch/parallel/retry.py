"""The jittered exponential-backoff retry shape
(``veles_tpu/parallel/retry.py``).

One helper behind every reconnection loop of the control plane -- the
coordinator client's initial dial and mid-run re-handshake
(:mod:`veles_tpu_torch.parallel.coordinator`). Shared on purpose: the
fleet-wide properties (exponential growth so a dead endpoint is not
hammered, 50–150 % jitter so a restarting fleet never retries in
lockstep, a bounded budget so failure is eventually reported) must not
drift between callers.
"""

import random
import time


def backoff_delay(attempt, base_s=0.25, cap_s=10.0):
    """The fleet-wide backoff shape as a single number: the jittered
    sleep before retry ``attempt`` (0-based) — ``base_s * 2^attempt``
    capped at ``cap_s``, scaled to 50-150 % so a restarting fleet
    never retries in lockstep."""
    return min(base_s * 2 ** attempt, cap_s) * (0.5 + random.random())


def retry_with_backoff(attempt_fn, budget_s, *, base_s=0.25, cap_s=10.0,
                       retry_on=(ConnectionError, OSError),
                       give_up=None, describe="operation"):
    """Run ``attempt_fn`` until it succeeds, retrying ``retry_on``
    failures with exponential backoff (``base_s * 2^n`` capped at
    ``cap_s``, each sleep jittered to 50–150 %) inside a bounded
    ``budget_s``.

    ``give_up`` (optional callable ``exc -> bool``): a failure it
    answers True for aborts immediately instead of retrying (e.g. the
    caller was closed, or the error is a protocol rejection rather
    than a transport hiccup). Raises :class:`ConnectionError` naming
    ``describe`` when the budget is exhausted.
    """
    deadline = time.monotonic() + max(budget_s, 0.0)
    attempt = 0
    while True:
        try:
            return attempt_fn()
        except retry_on as e:
            attempt += 1
            remaining = deadline - time.monotonic()
            if remaining <= 0 or (give_up is not None and give_up(e)):
                raise ConnectionError(
                    "%s after %d attempt(s): %s"
                    % (describe, attempt, e)) from e
        sleep = backoff_delay(attempt - 1, base_s, cap_s)
        time.sleep(min(sleep, max(remaining, 0.0)))
