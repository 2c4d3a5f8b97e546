"""GEMM-disciplines bench: the port of ``scripts/gemm_bench.py``'s
``main()``.

    python -m veles_tpu_torch.ops.gemm_bench                 # on the card
    python -m veles_tpu_torch.ops.gemm_bench --device cpu --small

At the reference's 1500^2 computing-power shape, AlexNet's fc6/fc7
forward and fc6 weight-gradient products and 4096^3, it times five
columns: level 0 (one float32 ``torch.matmul``), K2 (``linear_act``
without bias, ``csrc/gemm_bias_act.cu``), K5 (``kahan_gemm``,
``csrc/kahan_gemm.cu``), the plain Kahan loop (``kahan_matmul_plain``)
and level 2 (``pairwise_matmul``); and it reads each level's largest
error against a float64 product of the same operands, as an absolute
value and as a share of ``|a| @ |b|``. Inputs are uniform in [-0.5,
0.5) from numpy seed 0, as in the JAX bench. On the card, times are
CUDA events over back-to-back calls; on the CPU they are the host
clock. It prints a Markdown table with the card's name and power limit.
``--small`` divides every dimension by 16 (rounded up), for the CPU.

The JAX bench's ``--autotune`` is not ported: the port has no
autotuner.
"""

import argparse
import statistics
import subprocess
import sys
import time

import numpy
import torch

from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.ops.gemm import (gemm, kahan_gemm, kahan_matmul_plain,
                                      linear_act)

#: (name, (M, K, N)), the JAX bench's five shapes
SHAPES = (
    ("1500^2 (reference computing_power)", (1500, 1500, 1500)),
    ("AlexNet fc6 fwd (128x9216 @ 9216x4096)", (128, 9216, 4096)),
    ("AlexNet fc7 fwd (128x4096 @ 4096x4096)", (128, 4096, 4096)),
    ("AlexNet fc6 wgrad (9216x128 @ 128x4096)", (9216, 128, 4096)),
    ("4096^3 (tileable square)", (4096, 4096, 4096)),
)
#: the columns timed, in the table's order
COLUMNS = ("level0", "k2", "k5", "kahan_loop", "level2")
HEADINGS = {"level0": "level 0 matmul f32", "k2": "K2 linear_act",
            "k5": "K5 kahan_gemm", "kahan_loop": "plain Kahan loop",
            "level2": "level 2 pairwise"}
#: the products whose error against float64 is read
ERRORS = ("level0", "level1", "level2", "kahan_loop")


def hostile_input(rows=256, falling=False):
    """``tests/test_ops.py``'s hostile Kahan input: a (rows, 4096) with
    magnitudes over 8 decades along K (rising, or ``falling``) and
    alternating signs, b = ones (4096, 4). Returns float32 numpy (a, b)
    and the float64 product."""
    k = 4096
    rng = numpy.random.RandomState(42)
    a = (rng.rand(rows, k).astype(numpy.float32) *
         numpy.logspace(0, 8, k, dtype=numpy.float32))
    a[:, 1::2] *= -1
    if falling:
        a = numpy.ascontiguousarray(a[:, ::-1])
    b = numpy.ones((k, 4), numpy.float32)
    return a, b, a.astype(numpy.float64) @ b.astype(numpy.float64)


def small_shapes():
    """:data:`SHAPES` with every dimension divided by 16, rounded up."""
    return tuple((name, tuple(-(-d // 16) for d in dims))
                 for name, dims in SHAPES)


def card_line():
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, device, trials=3, per_trial=5, warmup=2):
    """Median over trials of the mean time of back-to-back calls: CUDA
    events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(trials):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_trial):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / per_trial)
    else:
        for _ in range(trials):
            t0 = time.perf_counter()
            for _ in range(per_trial):
                fn()
            times.append(1e3 * (time.perf_counter() - t0) / per_trial)
    return statistics.median(times)


def bench_shape(a, b, trials=3, per_trial=5):
    """{"ms": {column: ms}, "err": {product: max |x - ref|}, "share":
    {product: max |x - ref| / (|a| @ |b|)}} for one pair of operands."""
    device = a.device
    columns = {
        "level0": lambda: gemm(a, b, precision_level=0),
        "k2": lambda: linear_act(a, b, None, "linear", torch.float32),
        "k5": lambda: kahan_gemm(a, b),
        "kahan_loop": lambda: kahan_matmul_plain(a, b),
        "level2": lambda: gemm(a, b, precision_level=2),
    }
    ms = {name: time_ms(fn, device, trials, per_trial)
          for name, fn in columns.items()}
    ref = torch.matmul(a.double(), b.double())
    scale = torch.matmul(a.double().abs(), b.double().abs())
    products = {"level0": columns["level0"](),
                "level1": gemm(a, b, precision_level=1),
                "level2": columns["level2"](),
                "kahan_loop": columns["kahan_loop"]()}
    err, share = {}, {}
    for name in ERRORS:
        diff = (products[name].double() - ref).abs()
        err[name] = float(diff.max())
        share[name] = float((diff / scale.clamp(min=1e-300)).max())
    return {"ms": ms, "err": err, "share": share}


def gemm_bench(device=None, shapes=SHAPES, trials=3, per_trial=5):
    """One row per shape: {"name", "shape": (M, K, N), "ms", "err",
    "share"} (see :func:`bench_shape`)."""
    device = resolve_device(device)
    rng = numpy.random.RandomState(0)
    rows = []
    for name, (m, k, n) in shapes:
        a = torch.from_numpy(rng.rand(m, k).astype("f") - 0.5).to(device)
        b = torch.from_numpy(rng.rand(k, n).astype("f") - 0.5).to(device)
        row = {"name": name, "shape": (m, k, n)}
        row.update(bench_shape(a, b, trials, per_trial))
        rows.append(row)
        del a, b
    return rows


def format_table(rows, where):
    """The Markdown table: TFLOP/s (ms) per column, then the max |error|
    of levels 0, 1, 2 and the plain loop against float64."""
    lines = ["GEMM disciplines on %s" % where,
             "| shape | %s | max abs err vs float64: L0 / L1 (K5) / L2 / "
             "loop |" % " | ".join(HEADINGS[c] for c in COLUMNS),
             "|---|%s---|" % ("---|" * len(COLUMNS))]
    for row in rows:
        m, k, n = row["shape"]
        flops = 2.0 * m * n * k
        cells = ["%.1f TF/s (%.3f ms)" % (flops / (row["ms"][c] * 1e-3) /
                                          1e12, row["ms"][c])
                 for c in COLUMNS]
        lines.append("| %s | %s | %s |" % (
            row["name"], " | ".join(cells),
            " / ".join("%.3g" % row["err"][e] for e in ERRORS)))
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--small", action="store_true",
                        help="every dimension divided by 16, for the CPU")
    cli = parser.parse_args(argv)
    device = resolve_device(cli.device)
    rows = gemm_bench(device, small_shapes() if cli.small else SHAPES)
    where = ("%s, times by CUDA events" % card_line()
             if device.type == "cuda" else
             "the CPU, times by the host clock (not a device measurement)")
    print(format_table(rows, where))
    return 0


if __name__ == "__main__":
    sys.exit(main())
