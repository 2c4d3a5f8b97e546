"""Shared set-up of the benchmark's own tests (run them with ``python -m
pytest portbench/tests -q`` from the checkout's root; ``-m cuda`` on a
machine with a card)."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: a small configuration of every layer kind the cells run
TINY = {
    "name": "tiny", "source": "a small stack of the cells' layer kinds",
    "sample_shape": [19, 19, 3],
    "layers": [
        {"type": "conv_str", "n_kernels": 8, "kx": 5, "ky": 5,
         "sliding": [2, 2], "padding": 2},
        {"type": "norm", "k": 2.0, "n": 5, "alpha": 0.0001, "beta": 0.75},
        {"type": "max_pooling", "kx": 3, "ky": 3, "sliding": [2, 2]},
        {"type": "conv_str", "n_kernels": 8, "kx": 3, "ky": 3,
         "padding": 1},
        {"type": "avg_pooling", "kx": 2, "ky": 2, "sliding": [1, 1]},
        {"type": "all2all_str", "output_sample_shape": 32},
        {"type": "dropout", "dropout_ratio": 0.5},
        {"type": "all2all", "output_sample_shape": 16},
        {"type": "softmax", "output_sample_shape": 10}],
    "training": {"loss": "softmax", "solver": "sgd", "learning_rate": 0.01,
                 "momentum": 0.9, "weights_decay": 0.0005},
    "minibatch": 16, "precision": "float32",
    "data": {"n_train": 96, "n_valid": 16, "n_classes": 10,
             "dtype": "float32", "low": -1.0, "high": 1.0},
    "reduced": [], "departures": [], "assumed": []}

TRAFFIC = {"driver": "train", "policy": "float32", "residency": "resident",
           "minibatch": None}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def benchmark():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def tiny_cell(policy="float32", residency="resident", limits=None,
              dtype="float32"):
    """A :class:`portbench.spec.Cell` of :data:`TINY` reporting every
    metric of ``BENCHMARK.json``."""
    from portbench import spec
    config = copy.deepcopy(TINY)
    config["data"]["dtype"] = dtype
    traffic = dict(TRAFFIC, policy=policy, residency=residency)
    bench = benchmark()

    def readers(metrics):
        return [dict(m, reader=spec.load_reader(spec.BENCH_DIR, m["name"]))
                for m in metrics]

    limits = limits or {"loss_gap": 1e-5, "eval_gap": 1e-5,
                        "grad_gap": 1e-5, "out_grad_gap": 1e-5,
                        "change_gap": 1e-5, "rows_gap": 0.0}
    return spec.Cell({"name": "tiny", "config": "tiny", "traffic": "t",
                      "chips": 1}, config, traffic, limits,
                     readers(bench["end_to_end"]),
                     readers(bench["per_layer"]))
