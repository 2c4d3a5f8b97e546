#!/usr/bin/env python3
"""Where a master/slave run leaves the standalone run, on the card.

    python3 scripts/probe_delta_rounding.py [EPOCHS ...]

For each epoch count (default 1, 2 and 4), runs ``chip_smoke.py``'s
phase 9 file (AlexNet-227) twice in deterministic mode, each in
processes of its own: standalone, and as a master (no visible card)
with one non-pipelined slave on the card (segments of 8). Prints, per
parameter tensor, how many values of the master's final weights differ
from the standalone run's and by how much at most, beside the largest
weight and the largest change of that tensor, then fc7's difference as
a share of its change. A slave returns ``new - base`` and the master
adds it back: exact wherever the subtraction is, rounded where a weight
shrinks toward zero; the counts show how training carries those
roundings on. JSON to ``chiprun_out/probe_delta_rounding.json``.
"""

import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv):
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ.setdefault("VELES_DATASET_CACHE", "0")
    import numpy
    import torch
    if not torch.cuda.is_available():
        print("probe_delta_rounding: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from veles_tpu_torch.ops import build
    from veles_tpu_torch.ops.gemm_bench import card_line

    card = card_line()
    print(card)
    build.build_all()
    counts = [int(a) for a in argv] or [1, 2, 4]
    tmp = tempfile.mkdtemp(prefix="veles_probe_")
    path = os.path.join(tmp, "alexnet_workflow.py")
    with open(path, "w") as f:
        f.write(cs.WORKFLOW_FILE)
    quiet = ["root.smoke.snapshots=%r" % os.path.join(tmp, "snaps"),
             "root.common.disable.snapshotting=True"]
    det = dict(SMOKE_DETERMINISTIC="1")
    report = {"card": card, "runs": []}
    try:
        for epochs in counts:
            args = quiet + ["root.smoke.epochs=%d" % epochs, "-s", "7"]
            with cs.dist_legs(
                    cs.DistLeg("alone%d" % epochs, tmp, path, [
                        ("standalone", args, det)]),
                    cs.DistLeg("fleet%d" % epochs, tmp, path, [
                        ("master", args + ["--segment-size", "8"], {}),
                        ("slave", args + ["--no-pipeline"], det)])) \
                    as (alone, fleet):
                deadline = time.time() + cs.DIST_LEG_S
                reference, _ = alone.wait(deadline)
                master, _ = fleet.wait(deadline)
            want, got = alone.params(), fleet.params()
            init = alone.fc7_init()
            rows = {}
            for key in sorted(want):
                diff = numpy.abs(got[key] - want[key])
                rows[key] = {"differ": int((diff > 0).sum()),
                             "max_abs": float(diff.max()),
                             "max_weight": float(numpy.abs(want[key]).max()),
                             "size": int(want[key].size)}
                print("epochs %d %-10s %9d of %9d differ, max %.3g (largest "
                      "weight %.3g)" % (epochs, key, rows[key]["differ"],
                                         rows[key]["size"],
                                         rows[key]["max_abs"],
                                         rows[key]["max_weight"]))
            fc7 = "%d.weights" % reference["fc7"]
            share = float(numpy.abs(got[fc7] - want[fc7]).max() /
                          numpy.abs(want[fc7] - init).max())
            print("epochs %d: fc7 %.3g of its change; losses %s against %s"
                  % (epochs, share, cs.dist_epoch_losses(master["history"]),
                     reference["losses"]))
            report["runs"].append({"epochs": epochs, "tensors": rows,
                                   "fc7_share": share})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "probe_delta_rounding.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
