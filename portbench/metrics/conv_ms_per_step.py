"""``conv_ms_per_step`` (ms, device trace; layer: model and solver): the
device time of the convolution kernels launched inside the profiled
epochs' training sweeps, over their training steps."""


def read(run):
    if not run.profile or not run.profiled_steps:
        return None
    seconds = run.profile["train_groups"].get("convolutions", 0.0)
    return 1e3 * seconds / run.profiled_steps if seconds else None
