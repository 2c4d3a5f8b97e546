#!/usr/bin/env python3
"""Sweep the port's LRN forward (K3) and uniform fill (K7) kernels on one
CUDA card.

    python3 scripts/probe_k3_k7.py [--out FILE.json]
    python3 scripts/probe_k3_k7.py --sass LIBRARY
    python3 scripts/probe_k3_k7.py --host TREE

K3 (``veles_tpu_torch/csrc/lrn_fwd.cu``): at the four training shapes
(batch 128 after conv1 and conv2, float32 and bf16), the vector form at
every channels-a-lane of ``FWD_CPTS`` whose row fits a warp, 2, 4, 8 and
16 blocks an SM, and both store flavours (the source built twice, with
``VELES_LRN_FWD_STREAMING_STORES`` 1 and 0), beside the general form.
Each configuration is held to the plain version within
``chip_smoke.LRN_TOL``, then timed back-to-back and cold (operands out
of L2), in two passes over the whole sweep; the plan's pick is marked.

K7 (``veles_tpu_torch/csrc/uniform_fill.cu``): 1, 2 and 4 counters a
thread (``VELES_UNIFORM_COUNTERS``) at the dropout masks' (128, 4096),
bit for bit against the plain version, timed the same, and the multiply
instructions of each build's SASS (``cuobjdump -sass``) per Philox
round; then the host time of one call (us) split: the wrapper
``uniform_fill``, its binding's ``fill`` called with ready arguments,
and ``torch.empty`` of the output from Python. ``ptxas -v``'s registers
and spills of every kernel are printed.

``--sass LIBRARY`` prints only the multiplies of an already built
library's SASS (an earlier commit's ``uniform_fill`` library, say).

``--host TREE`` imports ``veles_tpu_torch`` from the checkout ``TREE``
(this one or an earlier commit's), builds its kernels, and times the
two host-bound calls through its public wrappers: ``lrn_forward`` at
the serving buckets 1-8 after conv1 and conv2 (float32) and
``uniform_fill`` at (128, 4096). Each gets ``host_us``, the median over
9 batches of the mean host time of 50 calls that do not wait for the
card (a batch that the host's other work preempts moves the median
less than the mean), and back-to-back device ``ms``. One JSON line.
Run it for two trees in turns (A, B, B, A) in one chip call.

The variants are built with ``nvcc`` beside the package's own build
(``veles_tpu_torch/csrc/build/probe/``) and called through ctypes with
explicit plans; the card's name and power limit head the output.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SWEEP_BLOCKS_PER_SM = (2, 4, 8, 16)
COUNTERS = (1, 2, 4)
PASSES = 2
SHAPES = ((128, 56, 56, 96), (128, 27, 27, 256))
K, ALPHA, BETA, N = 2.0, 1e-4, 0.75, 5


def start_build(build, source, defines, out):
    cmd = [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v",
           *("-D%s" % d for d in defines), "-o", out,
           os.path.join(build.CSRC, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), cmd


def registers(log):
    """{kernel: (registers, spill stores)} from ``ptxas -v``."""
    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            found[name] = [None, int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found.setdefault(name, [None, 0])[0] = int(m.group(1))
    return {demangle(k): tuple(v) for k, v in found.items()}


def demangle(name):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if not tool:
        return name
    return subprocess.run([tool, name], capture_output=True,
                          text=True).stdout.strip() or name


def multiplies(build, library):
    """{instruction: count} of the multiply-adds and multiplies in a
    library's SASS (each probe library holds one kernel)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for op in re.findall(r"\b(IMAD(?:\.[A-Z0-9]+)*|IMUL(?:\.[A-Z0-9]+)*)\b",
                         sass):
        counts[op] = counts.get(op, 0) + 1
    return counts


def lrn_sweep(torch, build, fns, scratch):
    from veles_tpu_torch.ops.lrn import (BLOCKS_PER_SM, FORMS, FWD_CPTS,
                                         LRNPlan, lrn_forward_plain,
                                         lrn_fwd_plan, vector_plan)
    for fn in fns.values():  # veles_lrn_fwd's C arguments
        fn.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(2)
    device = torch.device("cuda", torch.cuda.current_device())
    cases = []
    for shape in SHAPES:
        x32 = torch.rand(*shape, device="cuda", generator=gen) * 40.0
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            rows, c = x.numel() // shape[-1], shape[-1]
            want = lrn_forward_plain(x, K, ALPHA, BETA, N)
            chosen = lrn_fwd_plan(rows, c, N, dtype)
            plans = [(vector_plan(rows, c, N, dtype, True, cpt, bps), bps,
                      streaming)
                     for cpt in FWD_CPTS[dtype]
                     for bps in SWEEP_BLOCKS_PER_SM
                     for streaming in (True, False)]
            plans = [p for p in plans if p[0] is not None]
            plans.append((LRNPlan("general", 1, 0, 0, -(-rows // 8)), None,
                          True))
            for plan, bps, streaming in plans:
                cases.append((shape, dtype, x, want, plan, bps, streaming,
                              plan == chosen and bps == BLOCKS_PER_SM
                              and not streaming))
    rows_out = {}
    for pass_ in range(PASSES):
        for shape, dtype, x, want, plan, bps, streaming, planned in cases:
            fn = fns[streaming]
            rows = x.numel() // shape[-1]

            def call(x=x, plan=plan, fn=fn, rows=rows):
                y = torch.empty_like(x)
                status = build.launch(
                    fn, device, x.data_ptr(), y.data_ptr(), rows,
                    shape[-1], K, ALPHA, BETA, N, 1,
                    int(dtype == torch.bfloat16), FORMS.index(plan.form),
                    plan.cpt, plan.lanes, plan.rows_per_warp, plan.blocks)
                build.check(status, "lrn_fwd probe")
                return y

            name = "%s %s" % ("x".join(map(str, shape)),
                              str(dtype).split(".")[-1])
            key = (name, plan.form, plan.cpt, bps, streaming)
            if pass_ == 0:
                got = call()
                torch.cuda.synchronize()
                err = chip_smoke.check_close(
                    "lrn_fwd probe %s" % (key,), got, want,
                    *chip_smoke.LRN_TOL[str(dtype).split(".")[-1]])
                rows_out[key] = {
                    "shape": name, "form": plan.form, "cpt": plan.cpt,
                    "lanes": plan.lanes, "rows_per_warp": plan.rows_per_warp,
                    "blocks_per_sm": bps, "blocks": plan.blocks,
                    "store": "stcs" if streaming else "plain",
                    "planned": planned, "max_abs_err": err, "ms": [],
                    "ms_cold": []}
            rows_out[key]["ms"].append(chip_smoke.device_ms(torch, call))
            rows_out[key]["ms_cold"].append(chip_smoke.cold_ms(
                torch, call, scratch))
    return list(rows_out.values())


def uniform_sweep(torch, build, fns, scratch):
    from veles_tpu_torch.ops.random import dropout_offset, uniform_fill_plain
    shape = (128, 4096)
    seed, offset = 0x243F6A8885A308D3, dropout_offset(3, 11)
    want = uniform_fill_plain(shape, seed, offset, device="cuda")
    device = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for counters, fn in fns.items():
        fn.argtypes = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint64,
                       ctypes.c_uint64, ctypes.c_float, ctypes.c_float,
                       ctypes.c_void_p)
        fn.restype = ctypes.c_int

        def call(fn=fn):
            y = torch.empty(shape, device="cuda")
            build.check(build.launch(fn, device, y.data_ptr(),
                                     shape[0] * shape[1], seed, offset, 0.0,
                                     1.0), "uniform_fill probe")
            return y

        got = call()
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        if differ:
            raise AssertionError("uniform_fill, %d counters a thread: %d "
                                 "values differ" % (counters, differ))
        out[counters] = {"counters_per_thread": counters, "differ": differ,
                         "ms": [], "ms_cold": []}
    for _ in range(PASSES):
        for counters, fn in fns.items():
            def call(fn=fn):
                y = torch.empty(shape, device="cuda")
                build.launch(fn, device, y.data_ptr(), shape[0] * shape[1],
                             seed, offset, 0.0, 1.0)
                return y
            out[counters]["ms"].append(chip_smoke.device_ms(torch, call))
            out[counters]["ms_cold"].append(chip_smoke.cold_ms(
                torch, call, scratch))
    return list(out.values())


def host_split(torch):
    """{part: host us a call} of K7 at (128, 4096), through
    ``chip_smoke.host_us``, each part twice, interleaved."""
    from veles_tpu_torch.ops import build
    from veles_tpu_torch.ops.random import dropout_offset, uniform_fill
    seed, offset = 0x243F6A8885A308D3, dropout_offset(3, 11)
    device = torch.empty(0, device="cuda").device
    fill = build.binding("uniform_fill", "veles_uniform_fill").fill
    handle = build.stream(device)[1]
    parts = {
        "wrapper": lambda: uniform_fill((128, 4096), seed, offset,
                                        device=device),
        "binding": lambda: fill(128, 4096, seed, offset, 0.0, 1.0, -1,
                                handle),
        "torch_empty": lambda: torch.empty(128, 4096, device=device)}
    out = {name: [] for name in parts}
    for _ in range(2):
        for name, fn in parts.items():
            out[name].append(chip_smoke.host_us(torch, fn))
    return out


HOST_BATCHES = 9


def host_ab(torch, tree):
    """{call: {"host_us", "ms"}} of ``--host``."""
    import statistics
    import time

    from veles_tpu_torch.ops import build
    from veles_tpu_torch.ops.lrn import lrn_forward
    from veles_tpu_torch.ops.random import dropout_offset, uniform_fill
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(2)
    device = torch.empty(0, device="cuda").device
    seed, offset = 0x243F6A8885A308D3, dropout_offset(3, 11)
    calls = {}
    for m in (1, 2, 4, 8):
        for side, c in ((56, 96), (27, 256)):
            x = torch.rand(m, side, side, c, device="cuda",
                           generator=gen) * 40.0
            calls["lrn_fwd %dx%dx%dx%d" % (m, side, side, c)] = \
                lambda x=x: lrn_forward(x)
    calls["uniform_fill 128x4096"] = lambda: uniform_fill(
        (128, 4096), seed, offset, device=device)
    out = {}
    for name, fn in calls.items():
        means = []
        for _ in range(HOST_BATCHES):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(chip_smoke.HOST_CALLS):
                fn()
            means.append(1e6 * (time.perf_counter() - t) /
                         chip_smoke.HOST_CALLS)
        torch.cuda.synchronize()
        out[name] = {"host_us": statistics.median(means),
                     "ms": chip_smoke.device_ms(torch, fn)}
    return {"tree": tree, "calls": out}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", metavar="FILE.json",
                        help="write the sweeps' JSON report there too")
    parser.add_argument("--sass", metavar="LIBRARY")
    parser.add_argument("--host", metavar="TREE")
    args = parser.parse_args()
    if args.host:
        sys.path.insert(0, os.path.abspath(args.host))
        import torch
        if not torch.cuda.is_available():
            print("probe: no CUDA device", file=sys.stderr)
            return 1
        print(json.dumps(host_ab(torch, args.host)))
        return 0
    from veles_tpu_torch.ops import build
    if args.sass:
        print("sass %s: %s" % (args.sass, multiplies(build, args.sass)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 1
    from veles_tpu_torch.ops.gemm_bench import card_line
    card = card_line()
    print(card)
    where = os.path.join(build.BUILD_DIR, "probe")
    os.makedirs(where, exist_ok=True)
    variants = {("lrn", s): ("lrn_fwd.cu",
                             ["VELES_LRN_FWD_STREAMING_STORES=%d" % s])
                for s in (1, 0)}
    variants.update({("uniform", c): ("uniform_fill.cu",
                                      ["VELES_UNIFORM_COUNTERS=%d" % c])
                     for c in COUNTERS})
    started = {}
    for key, (source, defines) in variants.items():
        out = os.path.join(where, "%s-%s.so" % key)
        started[key] = (out,) + start_build(build, source, defines, out)
    libs, report = {}, {"card": card, "registers": {}, "sass": {}}
    for key, (out, proc, cmd) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("%s failed:\n%s" % (" ".join(cmd), log))
        libs[key] = ctypes.CDLL(out)
        report["registers"]["%s-%s" % key] = registers(log)
        if key[0] == "uniform":
            report["sass"][key[1]] = multiplies(build, out)
    for key, regs in sorted(report["registers"].items()):
        for name, (n_regs, spills) in sorted(regs.items()):
            print("ptxas %s: %s: %s registers, %s bytes spilled" % (
                key, name, n_regs, spills))
    for counters, ops in sorted(report["sass"].items()):
        print("sass uniform_fill, %d counters a thread (%d Philox rounds "
              "unrolled): %s" % (counters, 10 * counters, ops))
    scratch = torch.empty(chip_smoke.COLD_SCRATCH_BYTES // 4, device="cuda")
    report["lrn_fwd"] = lrn_sweep(torch, build, {
        s == 1: libs[("lrn", s)].veles_lrn_fwd for s in (1, 0)}, scratch)
    for row in report["lrn_fwd"]:
        print("lrn_fwd %-22s %-7s cpt %2d lanes %2d rows/warp %d "
              "blocks/SM %-4s store %-5s ms %s cold %s%s" % (
                  row["shape"], row["form"], row["cpt"], row["lanes"],
                  row["rows_per_warp"], row["blocks_per_sm"], row["store"],
                  " ".join("%.4f" % v for v in row["ms"]),
                  " ".join("%.4f" % v for v in row["ms_cold"]),
                  "  <- plan" if row["planned"] else ""))
    report["uniform_fill"] = uniform_sweep(torch, build, {
        c: libs[("uniform", c)].veles_uniform_fill for c in COUNTERS},
        scratch)
    report["uniform_host_us"] = host_split(torch)
    print("uniform_fill host us a call: %s" % json.dumps(
        report["uniform_host_us"]))
    for row in report["uniform_fill"]:
        print("uniform_fill 128x4096 counters/thread %d: 0 values differ, "
              "ms %s cold %s" % (
                  row["counters_per_thread"],
                  " ".join("%.4f" % v for v in row["ms"]),
                  " ".join("%.4f" % v for v in row["ms_cold"])))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
