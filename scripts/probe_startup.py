"""Where the start-up of one of ``chip_smoke.py``'s AlexNet-227 processes
goes (a phase 14 slave, a phase 15 rank, a phase 16 worker).

    python3 scripts/probe_startup.py

One process, stage by stage, host clock, the card synchronized at each
mark: ``import numpy``, ``import torch``, the CUDA context, the port's
imports, phase 9's workflow file built as the CLI builds it with ``-s
7``, initialized on the card (its synthetic dataset and weights), the
SPMD trainer over it, and two training steps (the first one's cuDNN and
cuBLAS set-up included). Prints ``MARKS`` with each stage's seconds
since the start and the card's name and power limit. Run it twice in one
call to see the second process find the libraries in the page cache.
Needs one CUDA card and the kernels built (``python3 chip_smoke.py`` or
``veles_tpu_torch.ops.build.build_all()``).
"""
import os
import sys
import tempfile
import time

T0 = time.perf_counter()
MARKS = []


def mark(name):
    MARKS.append((name, round(time.perf_counter() - T0, 3)))


def main():
    import numpy  # noqa: F401
    mark("numpy")
    import torch
    mark("torch")
    torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    mark("cuda init")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.config import root
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.ops.gemm_bench import card_line
    from veles_tpu_torch.parallel.gspmd import GSPMDTrainer
    from veles_tpu_torch.train.runner import trainer_for
    mark("port imports")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "alexnet_workflow.py")
        with open(path, "w") as f:
            f.write(chip_smoke.WORKFLOW_FILE)
        for item in ("root.smoke.epochs = 2",
                     "root.smoke.snapshots = %r" % tmp,
                     "root.common.disable.snapshotting = True"):
            exec(item, {"root": root})
        cli = Main()
        module = cli._load_model(path)
        cli._seed_random("7")
        made = {}

        def load(cls, **kwargs):
            made["wf"] = cls(DummyLauncher(), **kwargs)
            return made["wf"], False

        module.run(load, lambda **kwargs: None)
    mark("workflow built")
    wf = made["wf"]
    wf.initialize(device=torch.device("cuda"))
    torch.cuda.synchronize()
    mark("workflow initialized")
    trainer = trainer_for(wf, GSPMDTrainer)
    torch.cuda.synchronize()
    mark("trainer")
    idx = trainer._segment_indices(TRAIN)[:1]
    for step in (0, 1):
        trainer.train_rows(idx, step, 7)
        torch.cuda.synchronize()
        mark("step %d" % (step + 1))
    trainer.shutdown()
    print("MARKS (%s) %s" % (card_line(), MARKS), flush=True)


if __name__ == "__main__":
    main()
