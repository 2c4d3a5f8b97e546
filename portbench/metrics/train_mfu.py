"""``train_mfu`` (%; layer: train step, the whole step): the analytic
training FLOPs of the samples the window trained (``costs.
train_flops_per_sample`` of the configuration's layers) over the
window's seconds, over the dense peak of the precision the policy
computes in (``costs.PEAKS``: float32 67 TFLOP/s outside the tensor
cores, bf16 989 TFLOP/s; one H100 SXM's data sheet)."""


def read(run):
    if not run.window_s:
        return None
    return (100.0 * run.samples * run.flops_per_sample / run.window_s /
            run.peak_flops)
