"""``input_wait_ms_per_step`` (ms, program counter; layer: input
pipeline): the trainer's ``input_wait_s`` (the step thread's wait for
streamed shards) over the window, per training step. Nothing to read
where the dataset is resident."""


def read(run):
    if not run.streaming or not run.steps:
        return None
    return 1e3 * run.input_wait_s / run.steps
