"""``step_ms`` (ms, CUDA events; layer: train step): the device time
between events recorded before and after each ``train_batch`` call of
the window, summed over the window's training steps and divided by
their count."""


def read(run):
    if not run.step_ms:
        return None
    return sum(run.step_ms) / len(run.step_ms)
