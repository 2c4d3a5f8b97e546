"""A cell, a configuration, a traffic mix, a driver and a metric are
added as new files and entries of ``BENCHMARK.json``, with no file of
the benchmark edited."""

import hashlib
import json
import os
import shutil
import time

import torch

from conftest import ROOT, TINY


def _digests(top):
    out = {}
    for base, _, files in os.walk(top):
        for name in files:
            if name.endswith(".pyc"):
                continue
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, top)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


#: a driver of another kind of work than training: products of one
#: matrix, compared with float64's
DRIVER = """
import time

import torch


class Run(object):
    profile = None


def setup(cell, seed, device, phases, fault=None):
    gen = torch.Generator().manual_seed(seed)
    n = cell.traffic["size"]
    return {"x": torch.rand(n, n, generator=gen), "out": None}


def window(state, seconds, traced):
    run = Run()
    t0 = time.perf_counter()
    run.attempted = 0
    while time.perf_counter() - t0 < seconds:
        state["out"] = state["x"] @ state["x"]
        run.attempted += 1
    run.window_s = time.perf_counter() - t0
    run.failed = 0
    return run


def release(state):
    pass


def compare(state):
    x = state["x"].double()
    return {"product_gap": float((state["out"].double() - x @ x).abs()
                                 .max())}


def readings(cell, device, seeds, control_seeds, faults, fault_seeds, emit):
    pass
"""


def test_a_new_kind_of_work_is_a_new_driver(tmp_path):
    """A cell of a kind the training driver does not run arrives as a
    driver, a mix, a configuration, a cell's limits and a metric."""
    from portbench import run as runner
    from portbench import spec
    bench_dir = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(bench_dir)
    (bench_dir / "drivers" / "products.py").write_text(DRIVER)
    (bench_dir / "traffic" / "square-64.json").write_text(json.dumps(
        {"driver": "products", "size": 64}))
    (bench_dir / "configs" / "square.json").write_text("{}")
    (bench_dir / "workloads" / "square-products.json").write_text(
        json.dumps({"limits": {"product_gap": 1e-3}}))
    (bench_dir / "metrics" / "products_per_s.py").write_text(
        "def read(run):\n    return run.attempted / run.window_s\n")
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "square", "source": "a test",
                             "file": "portbench/configs/square.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "square-products",
                               "config": "square", "traffic": "square-64",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "products_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["square-products"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)

    cell = spec.load_cell("square-products", root=str(tmp_path),
                          bench_dir=str(bench_dir))
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "products_per_s"]
    run, peak, correct, shown = runner.execute(
        cell, 9, 0.2, False, torch.device("cpu"), time.perf_counter())
    out = runner.result_line(cell, run, peak, correct, shown, False, "cpu",
                             1)
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == {"setup_s", "products_per_s"}
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


def test_new_files_are_found_by_name(tmp_path):
    from portbench import run as runner
    from portbench import spec
    bench_dir = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(bench_dir)

    (bench_dir / "configs" / "tiny-new.json").write_text(json.dumps(TINY))
    (bench_dir / "traffic" / "tiny-mix.json").write_text(json.dumps(
        {"driver": "train", "policy": "float32", "residency": "resident",
         "minibatch": 32}))
    (bench_dir / "workloads" / "tiny-new-train.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1e-5, "eval_gap": 1e-5, "grad_gap": 1e-5,
                    "out_grad_gap": 1e-5, "change_gap": 1e-5,
                    "rows_gap": 0.0}}))
    (bench_dir / "metrics" / "epochs_in_window.py").write_text(
        "def read(run):\n    return float(len(run.epochs))\n")
    with open(tmp_path / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny-new", "source": "a test",
                             "file": "portbench/configs/tiny-new.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-new-train",
                               "config": "tiny-new", "traffic": "tiny-mix",
                               "chips": 1, "why": "a test"})
    for metric in bench["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"].append("tiny-new-train")
    bench["end_to_end"].append({"name": "epochs_in_window", "unit": "count",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny-new-train"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)

    cell = spec.load_cell("tiny-new-train", root=str(tmp_path),
                          bench_dir=str(bench_dir))
    assert cell.traffic["minibatch"] == 32
    assert cell.config["sample_shape"] == TINY["sample_shape"]
    names = [m["name"] for m in cell.end_to_end]
    assert names == ["train_samples_per_s", "setup_s", "epochs_in_window"]
    run, peak, correct, shown = runner.execute(
        cell, 9, 0.2, False, torch.device("cpu"), time.perf_counter())
    out = runner.result_line(cell, run, peak, correct, shown, False, "cpu",
                             1)
    assert out["correct"], out["check"]
    assert out["metrics"]["epochs_in_window"]["value"] >= 1
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before

    # the other cells do not report the new metric
    other = spec.load_cell(bench["workloads"][0]["name"], root=str(tmp_path),
                           bench_dir=str(bench_dir))
    assert "epochs_in_window" not in [m["name"] for m in other.end_to_end]
