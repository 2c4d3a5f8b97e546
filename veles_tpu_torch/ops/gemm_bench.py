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

    python -m veles_tpu_torch.ops.gemm_bench --autotune [--dtype float32]

is the port of the JAX bench's ``autotune_main``: in ``search`` mode
(unless ``VELES_AUTOTUNE`` says otherwise) it searches the split counts
of K1 at AlexNet's served fc6/fc7 (M = 1 and 16, strict relu, bias) and
of K1/K2 (``linear_plan``) and K5 (``gemm_plan`` level 1) at the
flagship products of batch 128 (fc6/fc7 forward, weight gradient and
input gradient), persists each winner in the card's autotune cache
(``VELES_AUTOTUNE_CACHE``) and prints a table: the default split count
and its ms, the best and its ms, by shape. Searching needs the card.
"""

import argparse
import json
import os
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


def flagship_shapes(batch=128, served=(1, 16)):
    """``(label, kernel, activation, bias, (M, K, N))`` of the searched
    products: the served fc6/fc7 forward at each ``served`` row count
    (K1: strict relu, bias), then fc6/fc7 at ``batch`` rows: forward
    (K1 and K5), weight gradient and input gradient (K2 and K5)."""
    fcs = (("fc6", 9216, 4096), ("fc7", 4096, 4096))
    out = [("%s served M=%d" % (name, m), "k1", "strict_relu", True,
            (m, fin, fout)) for m in served for name, fin, fout in fcs]
    for name, fin, fout in fcs:
        for label, shape in (("fwd", (batch, fin, fout)),
                             ("wgrad", (fin, batch, fout)),
                             ("dgrad", (batch, fout, fin))):
            if label == "fwd":
                out.append(("%s %s" % (name, label), "k1", "strict_relu",
                            True, shape))
            else:
                out.append(("%s %s" % (name, label), "k2", "linear", False,
                            shape))
            out.append(("%s %s" % (name, label), "k5", None, False, shape))
    return out


def autotune_rows(dtype=torch.float32, batch=128, device=None):
    """Search :func:`flagship_shapes` (see the module's docstring);
    one row a distinct key: {"label", "kernel", "shape": (M, K, N),
    "key", "default_splits", "default_ms", "best_splits", "best_ms",
    "config", "seconds"}."""
    from veles_tpu_torch.ops import autotune
    device = resolve_device(device)
    gemm_mod = sys.modules["veles_tpu_torch.ops.gemm"]
    rows, seen = [], set()
    for label, kernel, act, bias, (m, k, n) in flagship_shapes(batch):
        if kernel == "k5":
            bk = max(1, min(gemm_mod.KAHAN_BK, k))
            key = autotune._key("gemm_kahan", m=m, n=n, k=k, ta=0, tb=0,
                                bk=bk, dtype=autotune._dtype_name(dtype))
        else:
            key = autotune._key(
                "linear", m=m, n=n, k=k, dtype=autotune._dtype_name(dtype),
                act=act, out=autotune._dtype_name(dtype), bias=int(bias))
        if key in seen:
            continue
        seen.add(key)
        t0 = time.perf_counter()
        if kernel == "k5":
            impl, cfg = autotune.gemm_plan(m, n, k, dtype, level=1, bk=bk,
                                           device=device)
            default = gemm_mod.kahan_plan(m, n, k, bk, dtype).splits
            best = gemm_mod.kahan_plan(m, n, k, bk, dtype, True, (
                cfg or {}).get("splits")).splits
        else:
            impl, cfg = autotune.linear_plan(m, n, k, dtype, act, dtype,
                                             bias, device)
            default = gemm_mod.gemm_plan(m, n, k, dtype).splits
            best = gemm_mod.gemm_plan(m, n, k, dtype, True, (
                cfg or {}).get("splits")).splits
        entry = autotune.get_cache().get(key) or {}
        rows.append({"label": label, "kernel": kernel, "shape": (m, k, n),
                     "key": key, "impl": impl, "config": cfg,
                     "default_splits": default,
                     "default_ms": entry.get("baseline_ms"),
                     "best_splits": best, "best_ms": entry.get("best_ms"),
                     "candidates": entry.get("candidates"),
                     "seconds": time.perf_counter() - t0})
        print("autotune %s %s: %s %s (%.1f s)" % (
            label, kernel, impl, cfg, rows[-1]["seconds"]),
            file=sys.stderr, flush=True)
    return rows


def format_autotune(rows, where):
    """The per-shape table of :func:`autotune_rows`."""
    def ms(value):
        return "-" if value is None else "%.4f" % value

    lines = ["K split counts searched on %s" % where,
             "| shape | kernel | M x K x N | default splits (ms) | "
             "best splits (ms) | candidates |",
             "|---|---|---|---|---|---|"]
    for row in rows:
        lines.append("| %s | %s | %dx%dx%d | x%d (%s) | x%d (%s) | %s |" % (
            row["label"], row["kernel"].upper(), row["shape"][0],
            row["shape"][1], row["shape"][2], row["default_splits"],
            ms(row["default_ms"]), row["best_splits"], ms(row["best_ms"]),
            row["candidates"] or "-"))
    return "\n".join(lines)


def autotune_main(dtype="float32", batch=128, device=None):
    """``--autotune``: search, print the table and the tuner's summary."""
    os.environ.setdefault("VELES_AUTOTUNE", "search")
    from veles_tpu_torch.ops import autotune
    device = resolve_device(device)
    print("autotune: mode=%s device=%s cache=%s" % (
        autotune.mode(), autotune.device_kind(), autotune.cache_path()),
        file=sys.stderr, flush=True)
    rows = autotune_rows(getattr(torch, dtype), batch, device)
    print(format_autotune(rows, "%s, times by CUDA events" % card_line()
                          if device.type == "cuda" else
                          "the CPU: nothing measured (searching needs "
                          "the card)"))
    summary = autotune.summary()
    print("autotune summary: %s" % json.dumps({
        k: summary[k] for k in ("path", "mode", "device", "searches",
                                "hits", "misses")}))
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--small", action="store_true",
                        help="every dimension divided by 16, for the CPU")
    parser.add_argument("--autotune", action="store_true",
                        help="search the K split counts of K1/K2 and K5 "
                             "at the flagship shapes and persist the "
                             "winners in the card's autotune cache")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="operand dtype for --autotune")
    parser.add_argument("--batch", type=int, default=128,
                        help="batch rows of the --autotune products")
    cli = parser.parse_args(argv)
    if cli.autotune:
        return autotune_main(cli.dtype, cli.batch, cli.device)
    device = resolve_device(cli.device)
    rows = gemm_bench(device, small_shapes() if cli.small else SHAPES)
    where = ("%s, times by CUDA events" % card_line()
             if device.type == "cuda" else
             "the CPU, times by the host clock (not a device measurement)")
    print(format_table(rows, where))
    return 0


if __name__ == "__main__":
    sys.exit(main())
