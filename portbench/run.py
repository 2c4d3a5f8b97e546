"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. The cell
is an entry of ``BENCHMARK.json``'s ``workloads``; everything it names
is found by name (``portbench/spec.py``). With ``--trace 0`` the result
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics. The last line of standard output is the result, one JSON
object; under ``setup`` it says whether this run built the port's
kernel libraries (a checkout's first run does) and the seconds of
set-up's parts. The numbers compared for ``correct`` end standard error
and the result, each beside its limit (``check``).

The run fails, and prints no result, where there is no card or fewer
than the cell asks for, and where ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``veles_tpu`` is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level module names the run may not load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "veles_tpu")


def forbidden_modules(names):
    """The loaded module names whose top-level name (before the first
    dot) is one of :data:`FORBIDDEN`."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def cache_environment(root):
    """Every build and kernel cache of the program at a fixed path inside
    the checkout (the kernels' own libraries go to the port's
    ``veles_tpu_torch/csrc/build/`` there)."""
    cache = os.path.join(root, ".portbench-cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(cache, "torch")
    os.environ["VELES_AUTOTUNE_CACHE"] = os.path.join(cache,
                                                      "autotune.json")
    os.environ["VELES_DATASET_CACHE"] = "0"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def build_kernels(device):
    """The port's CUDA kernel libraries, built where the checkout has
    none yet (``veles_tpu_torch.ops.build.build_all``: every source at
    once): (seconds, the sources this run compiled)."""
    if device.type != "cuda":
        return 0.0, []
    from veles_tpu_torch.ops import build
    t0 = time.perf_counter()
    seconds = build.build_all()
    return (time.perf_counter() - t0,
            sorted(name for name, s in seconds.items() if s > 0))


def read_metrics(run, metrics):
    """{name: {"value", "unit"}} of the metrics whose reader finds a
    number."""
    out = {}
    for metric in metrics:
        value = metric["reader"](run)
        if value is not None and math.isfinite(value):
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def breakdown(profile):
    return {"device_ops": [[k, v] for k, v in
                           profile["by_name"].most_common(10)],
            "idle_gaps": [[k, v] for k, v in
                          profile["idle_gaps"].most_common(10)]}


def result_line(cell, run, peak, correct, shown, traced, kind, count):
    """The result object: ``setup`` (whether this run compiled, the
    seconds of set-up's parts) before ``check``, which comes last."""
    metrics = cell.per_layer if traced else cell.end_to_end
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": read_metrics(run, metrics),
           "device": device}
    profile = getattr(run, "profile", None)
    if traced and profile:
        device["busy_s"] = profile["busy_s"]
        device["window_s"] = profile["window_s"]
        out["breakdown"] = breakdown(profile)
    out["setup"] = {"compiled": bool(run.compiled), "seconds": run.setup_s,
                    "phases": run.setup_phases}
    out["check"] = shown
    return out


def execute(cell, seed, seconds, traced, device, t_start, fault=None):
    """One run: (run, peak, correct, shown). ``run`` is the driver's,
    with ``setup_s``, ``setup_phases`` and ``compiled`` (the kernel
    sources this run built) set here; ``fault`` plants one of the
    driver's faults (for the benchmark's tests)."""
    import torch

    from portbench import checks, spec
    driver = spec.load_driver(cell)
    phases = {"imports_s": time.perf_counter() - t_start}
    phases["kernels_s"], compiled = build_kernels(device)
    state = driver.setup(cell, seed, device, phases, fault)
    setup_s = time.perf_counter() - t_start
    run = driver.window(state, seconds, traced)
    run.setup_s, run.setup_phases, run.compiled = setup_s, phases, compiled
    peak = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    driver.release(state)
    t0 = time.perf_counter()
    correct, shown = checks.verdict(driver.compare(state), cell.limits)
    summary = getattr(run, "summary", None)
    print("portbench: %s seed %d: set-up %.3f s (%s; compiled %s), %s, "
          "reference %.3f s" % (
              cell.name, seed, setup_s, ", ".join(
                  "%s %.3f" % kv for kv in phases.items()),
              ", ".join(compiled) or "nothing",
              summary() if summary else "window done",
              time.perf_counter() - t0), file=sys.stderr)
    return run, peak, correct and run.failed == 0, shown


def main(argv=None):
    args = parse(argv)
    # the checkout's root, not this script's directory, on the path
    if os.path.abspath(sys.path[0]) == os.path.join(ROOT, "portbench"):
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cache_environment(ROOT)
    import torch

    from portbench import spec
    cell = spec.load_cell(args.workload, root=ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print("portbench: the cell needs %d CUDA card(s); this machine has "
              "%s" % (cell.chips, torch.cuda.device_count()
                      if torch.cuda.is_available() else "none"),
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run, peak, correct, shown = execute(
        cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print("portbench: the run loaded %s" % ", ".join(loaded),
              file=sys.stderr)
        return 3
    out = result_line(cell, run, peak, correct, shown, bool(args.trace),
                      torch.cuda.get_device_name(0), cell.chips)
    for line in getattr(run, "report", list)():
        print(line)
    for name, item in shown.items():
        print("check %s %r limit %r" % (name, item["value"], item["limit"]),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
