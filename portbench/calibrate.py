"""The readings the limits of ``correct`` are set from, for one cell.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--faults unchanged,half_batch] \
        [--fault-seeds 7,8,9] [--out FILE]

In one process, at the cell's own sizes, through its driver's
``readings`` (``drivers/__init__.py``): for each seed of ``--seeds`` the
cell's system is set up exactly as a run's set-up does it and read
against the plain reference (the lower readings); for each seed of
``--control-seeds`` the control (the reference in the precision below
the cell's: TF32 for float32, float8 operands for bfloat16) is read
against the reference in the cell's precision (the upper readings); for
each fault of ``--faults`` (the driver's ``FAULTS``) and each of
``--fault-seeds`` the system is set up with the fault planted and read.
Prints one JSON line per reading and writes them all to ``--out``.
No window is run.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ints(text):
    return [int(v) for v in text.split(",") if v]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    if os.path.abspath(sys.path[0]) == os.path.join(ROOT, "portbench"):
        sys.path[0] = ROOT
    from portbench import run as runner
    runner.cache_environment(ROOT)
    import torch

    from portbench import spec
    cell = spec.load_cell(args.workload, root=ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    runner.build_kernels(device)
    found = []

    def emit(item):
        item["workload"] = cell.name
        found.append(item)
        print(json.dumps(item), flush=True)

    spec.load_driver(cell).readings(
        cell, device, args.seeds, args.control_seeds,
        [f for f in args.faults.split(",") if f], args.fault_seeds, emit)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(found, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
