#!/usr/bin/env python3
"""Run the port's model-family entry points on the card.

    python3 scripts/probe_entry_points.py

``python -m veles_tpu_torch`` (-s 7) on ``veles_tpu_torch/models/
cifar.py`` (``CifarWorkflow``, its synthetic data) and ``samples.py``
(``WineWorkflow``), each until its decision stops it, and on a workflow
file whose ``run(load, main)`` loads ``MnistAEWorkflow`` over golden
digits 2000 + 500 for 3 epochs (the class needs a provider, as in the
JAX package); then the parity harness's ``train_fc``, ``train_conv``,
``train_ae``, ``train_som`` and ``train_cifar`` (2 epochs over golden
digits / objects 2000 + 500) and ``veles_tpu_torch.run(WineWorkflow,
max_epochs=5)``. Prints each one's exit code or value and wall seconds
(host clock), the CLI runs' first and last log lines and result files,
and writes them to ``chiprun_out/probe_entry_points.json``. Needs the
card: every entry point runs there unless asked for the CPU.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "chiprun_out")
AE_FILE = """
from veles_tpu_torch.datasets import golden_digits
from veles_tpu_torch.models.mnist_ae import MnistAEWorkflow


def run(load, main):
    load(MnistAEWorkflow, provider=golden_digits(2000, 500),
         learning_rate=0.001, momentum=0.9, max_epochs=3)
    main()
"""


def cli_runs(report):
    env = dict(os.environ, PYTHONPATH=REPO, VELES_DATASET_CACHE="0")
    ae_path = os.path.join(OUT, "mnist_ae_run.py")
    with open(ae_path, "w") as f:
        f.write(AE_FILE)
    for label, path in (
            ("cifar.py", "veles_tpu_torch/models/cifar.py"),
            ("samples.py", "veles_tpu_torch/models/samples.py"),
            ("mnist_ae via run(load, main)", ae_path)):
        result = os.path.join(OUT, "cli_%s.json" % label.split(".")[0])
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "veles_tpu_torch", path, "-s", "7",
             "--result-file", result], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        lines = [line for line in proc.stderr.splitlines()
                 if "epoch" in line or "stopping" in line or
                 "fused run" in line]
        report[label] = {"rc": proc.returncode, "wall_s": wall,
                         "log": lines[:3] + lines[-4:],
                         "result": json.load(open(result))
                         if os.path.exists(result) else None}
        print(label, json.dumps(report[label], default=str)[:1500],
              flush=True)
        if proc.returncode:
            print(proc.stderr[-3000:])


def harness_runs(report):
    sys.path.insert(0, REPO)
    import veles_tpu_torch
    from veles_tpu_torch.datasets import golden_digits, golden_objects
    from veles_tpu_torch.models import parity
    from veles_tpu_torch.models.samples import WineWorkflow
    digits = golden_digits(2000, 500)
    objects = golden_objects(2000, 500)
    for name, fn in (
            ("train_fc", lambda: parity.train_fc(digits, 2)),
            ("train_conv", lambda: parity.train_conv(digits, 2)),
            ("train_ae", lambda: parity.train_ae(digits, 2)),
            ("train_som", lambda: parity.train_som(digits, 2)),
            ("train_cifar", lambda: parity.train_cifar(objects, 2)),
            ("run(WineWorkflow)", lambda: [
                h["validation"]["normalized"] for h in veles_tpu_torch.run(
                    WineWorkflow, max_epochs=5).decision.epoch_history])):
        t = time.perf_counter()
        value = fn()
        report[name] = {"value": value, "wall_s": time.perf_counter() - t}
        print(name, json.dumps(report[name], default=str), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("probe_entry_points: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    report = {"device": torch.cuda.get_device_name(0)}
    cli_runs(report)
    harness_runs(report)
    print("device", report["device"])
    with open(os.path.join(OUT, "probe_entry_points.json"), "w") as f:
        json.dump(report, f, default=str, indent=1)
    return int(any(v.get("rc") for v in report.values()
                   if isinstance(v, dict)))


if __name__ == "__main__":
    sys.exit(main())
