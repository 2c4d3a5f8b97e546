"""The harness on the CPU at a tiny size: the result line, the
comparison with the plain reference, the planted faults, the arithmetic
and the checks that keep JAX and the CPU out of a run."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, benchmark, tiny_cell
from portbench import costs
from portbench import run as runner
from portbench.drivers import train

CPU = torch.device("cpu")
CELLS = [w["name"] for w in benchmark()["workloads"]]


def one_run(cell, traced, seed=2 ** 31 + 77, fault=None):
    run, peak, correct, shown = runner.execute(
        cell, seed, 0.3, traced, CPU, time.perf_counter(), fault)
    return runner.result_line(cell, run, peak, correct, shown, traced,
                              "cpu", 1)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    out = one_run(tiny_cell(), traced)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert ("breakdown" in keys) == traced
    assert keys[-2:] == ["setup", "check"]
    assert list(out["check"]) == ["loss_gap", "eval_gap", "grad_gap",
                                  "out_grad_gap", "change_gap", "rows_gap"]
    assert out["setup"]["compiled"] is False
    assert out["device"]["platform"] == "gpu"
    assert out["attempted"] > 0 and out["failed"] == 0
    names = set(out["metrics"])
    if traced:
        assert {"epoch_boundary_ms", "train_mfu"} <= names
        assert not names & {"train_samples_per_s", "setup_s"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    else:
        assert names == {"train_samples_per_s", "setup_s"}
    for metric in out["metrics"].values():
        assert metric["value"] > 0
    json.dumps(out)


@pytest.mark.parametrize("policy,dtype,residency", [
    ("float32", "float32", "resident"), ("float32", "bfloat16", "streamed"),
    ("bfloat16", "bfloat16", "resident")])
def test_port_agrees_with_reference(policy, dtype, residency):
    """The port's first steps against the plain reference on the CPU,
    where both run the plain versions of the kernels."""
    out = one_run(tiny_cell(policy, residency, dtype=dtype), False)
    assert out["correct"], out["check"]
    assert out["check"]["rows_gap"]["value"] == 0.0


@pytest.mark.parametrize("fault", train.FAULTS)
@pytest.mark.parametrize("cell_name", CELLS)
def test_planted_fault_is_not_correct(cell_name, fault):
    """A run whose timed path is broken underneath comes out not
    correct under each cell's own limits."""
    with open(os.path.join(ROOT, "portbench", "workloads",
                           cell_name + ".json")) as f:
        limits = json.load(f)["limits"]
    residency = "streamed" if "stream" in cell_name else "resident"
    cell = tiny_cell(residency=residency, limits=limits)
    assert not one_run(cell, False, fault=fault)["correct"]


def test_setup_records_a_shuffled_epoch():
    """Set-up's second epoch trains in the order of the loader's first
    shuffle, which the reference works out again, and the window starts
    after its epochs."""
    from portbench import inputs
    from portbench.reference import shuffle
    cell = tiny_cell()
    spec = cell.config["data"]
    state = train.setup(cell, 11, CPU, {})
    loader = state.trainer.loader
    epochs = len(train.SETUP_STEPS)
    assert loader.epoch_number == epochs
    orders = shuffle.train_orders(inputs.sub_seed(11, "shuffle"),
                                  spec["n_valid"], spec["n_train"],
                                  epochs + 1)
    assert orders[1].tolist() != orders[0].tolist()
    assert loader.shuffled_indices[spec["n_valid"]:].tolist() == \
        orders[epochs].tolist()
    mb = train.minibatch(cell)
    x, _ = state.recorder.rows[train.SETUP_STEPS[0]]
    assert torch.equal(x, loader.original_data[
        torch.from_numpy(orders[1][:mb]).long()])
    assert len(state.recorder.losses) == sum(train.SETUP_STEPS)
    assert len(state.recorder.eval_losses) == epochs
    train.release(state)


def test_training_flops():
    bench = benchmark()
    files = {c["name"]: c["file"] for c in bench["configs"]}
    with open(os.path.join(ROOT, files["alexnet227"])) as f:
        config = json.load(f)
    found = costs.train_flops_per_sample(config["layers"],
                                         config["sample_shape"])
    assert abs(found / 1e9 - 6.835) < 5e-4
    # cifar10_quick as the port's pooling runs it (floors: 32, 15, 7, 3),
    # the configuration of the cell kept for later (PERF.md)
    quick = [{"type": "conv_str", "n_kernels": 32, "kx": 5, "ky": 5,
              "padding": 2},
             {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": [2, 2]},
             {"type": "conv_str", "n_kernels": 32, "kx": 5, "ky": 5,
              "padding": 2},
             {"type": "avg_pooling", "kx": 3, "ky": 3, "sliding": [2, 2]},
             {"type": "conv_str", "n_kernels": 64, "kx": 5, "ky": 5,
              "padding": 2},
             {"type": "avg_pooling", "kx": 3, "ky": 3, "sliding": [2, 2]},
             {"type": "all2all", "output_sample_shape": 64},
             {"type": "softmax", "output_sample_shape": 10}]
    found = costs.train_flops_per_sample(quick, [32, 32, 3])
    assert abs(found / 1e6 - 64.6) < 0.05


def test_walk_matches_the_port_shapes():
    from veles_tpu_torch.models.build import build_model
    bench = benchmark()
    for entry in bench["configs"]:
        with open(os.path.join(ROOT, entry["file"])) as f:
            config = json.load(f)
        model = build_model(config["layers"], config["sample_shape"],
                            seed=1, device="cpu")
        walked = costs.walk(config["layers"], config["sample_shape"])
        for module, item in zip(model, walked):
            assert tuple(module.output_shape()) == tuple(item["out"])
            if "weights" in item:
                assert tuple(module.jax_weights_shape()) == item["weights"]


def test_kernel_bounds_are_positive():
    for kid, key in (("K1", (128, 9216, 4096, torch.float32, True)),
                     ("K3", ((128, 56, 56, 96), torch.float32)),
                     ("K4", ((128, 27, 27, 256), torch.bfloat16)),
                     ("K6", (401408, 96, torch.float32)),
                     ("K7", (128, 4096))):
        seconds, by = costs.kernel_bound_s(kid, key)
        assert seconds > 0 and by in ("ops", "bytes")
    # fc6 at M=128 in float32 is bound by its operations: 9.66 GFLOP
    seconds, by = costs.kernel_bound_s(
        "K1", (128, 9216, 4096, torch.float32, True))
    assert by == "ops" and abs(seconds - 2 * 128 * 9216 * 4096 / 67e12) \
        < 1e-12


def test_forbidden_names_compare_whole_top_level_names():
    names = ["veles_tpu_torch", "veles_tpu_torch.ops.gemm", "jaxtyping",
             "portbench.run", "veles_tpu", "veles_tpu.ops", "jax.numpy",
             "jaxlib", "flax.linen"]
    assert runner.forbidden_modules(names) == [
        "flax.linen", "jax.numpy", "jaxlib", "veles_tpu", "veles_tpu.ops"]


def test_a_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r); "
            "sys.path.insert(0, %r); from conftest import tiny_cell; "
            "from portbench import run; "
            "run.execute(tiny_cell(), 5, 0.2, True, torch.device('cpu'), "
            "time.perf_counter()); "
            "print(run.forbidden_modules(sys.modules))"
            % (ROOT, os.path.join(ROOT, "portbench", "tests")))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_fails_without_a_result():
    """On a machine without a card the run exits non-zero and prints
    nothing on standard output (this sandbox has none)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_checkout_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    gives no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    # past the card's check, the run needs the program, which is absent
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from portbench.drivers import train; train._port()"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert "veles_tpu_torch" in out.stderr
