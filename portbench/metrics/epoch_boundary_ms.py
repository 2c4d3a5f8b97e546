"""``epoch_boundary_ms`` (ms, host clock; layer: trainer epoch): the
median over the window's epochs of the epoch's wall less its training
sweep's, the sweep timed from ``train_class`` to the end of the
trainer's read of its losses: the evaluation sweeps, the confusion
matrices' and losses' reads and the shuffle."""

import statistics


def read(run):
    if not run.sweep_s or len(run.sweep_s) != len(run.epochs):
        return None
    return 1e3 * statistics.median(
        e["wall_s"] - s for e, s in zip(run.epochs, run.sweep_s))
