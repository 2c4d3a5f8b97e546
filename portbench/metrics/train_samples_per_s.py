"""``train_samples_per_s`` (samples/s, host clock): the training samples
of the window's epochs over the window's seconds. The window is whole
epochs (evaluation sweeps, training sweep, shuffle) and ends at a
``torch.cuda.synchronize()``."""


def read(run):
    if not run.window_s:
        return None
    return run.samples / run.window_s
