"""The profiled sub-window, read from ``torch.profiler``'s trace.

:func:`summarize` reads the Chrome trace the profiler exports (every
kernel, copy and fill on the device; the host's operations, runtime
calls and the benchmark's own ``record_function`` ranges) and gives:

* ``window_s``: the wall of the ``portbench.profiled`` range, which
  ends at a ``torch.cuda.synchronize()``;
* ``busy_s``: the union of the intervals in which a kernel, a copy or a
  fill ran on the device;
* ``by_name``: device seconds by kernel name (shortened), the
  breakdown's ``device_ops``;
* ``idle_gaps``: idle seconds between device operations inside the
  window, by what the host was doing then: the benchmark's range on the
  step thread (``train_sweep``, ``eval_sweep``, else
  ``epoch_boundary``) and the innermost host operation under way on any
  thread (autograd launches the backward from a thread of its own);
* ``train_groups``: device seconds by group (:data:`GROUPS`, the rules
  of ``chip_smoke.py``'s ``device_time_split``) of the kernels launched,
  from any thread, while a ``portbench.train_sweep`` range of the step
  thread was open;
* ``hand``: device seconds of each hand-written kernel of the port
  (:data:`HAND_KERNELS`) over the whole window.
"""

import bisect
import collections
import json

#: kernel groups by substrings of the lower-cased kernel name, first
#: match wins (``chip_smoke.py`` ``device_time_split``'s rules)
GROUPS = (("K1 gemm_bias_act", ("gemm_bias_act",)),
          ("K3 lrn_fwd", ("lrn_fwd",)), ("K4 lrn_bwd", ("lrn_bwd",)),
          ("K6 column_reduce", ("column_sum_kernel",)),
          ("K7 uniform_fill", ("uniform_fill",)),
          ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                            "implicit", "fft", "flip_filter", "cf32",
                            "nchwtonhwc", "nhwctonchw")),
          ("library GEMMs", ("gemm", "gemv", "nvjet")),
          ("pooling", ("max_pool",)),
          ("elementwise", ("elementwise",)))

#: the port's hand-written kernels: id -> substrings of their kernel
#: names (every kernel a call launches, a split's reduce pass included)
HAND_KERNELS = {"K1": ("gemm_bias_act",), "K3": ("lrn_fwd",),
                "K4": ("lrn_bwd",), "K6": ("column_sum",),
                "K7": ("uniform_fill",)}

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def group_of(name):
    lower = name.lower()
    for group, marks in GROUPS:
        if any(mark in lower for mark in marks):
            return group
    return "other"


def short_name(name, width=100):
    """A kernel name without its argument list, cut to ``width``."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:width]


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(path):
    """The summary of the trace at ``path`` (see the module's
    docstring); None where the trace has no ``portbench.profiled``
    range."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    windows = [e for e in events if e.get("cat") == "user_annotation" and
               e.get("name") == "portbench.profiled"]
    if not windows:
        return None
    win = windows[0]
    w0, w1, tid = win["ts"], win["ts"] + win.get("dur", 0), win["tid"]
    device, runtime, host, sweeps = [], {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        e.setdefault("dur", 0)
        cat = e.get("cat")
        if cat in _DEVICE_CATS:
            device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                runtime[corr] = e
        if cat in _HOST_CATS:
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        if cat == "user_annotation" and e.get("tid") == tid and \
                e["name"] in ("portbench.train_sweep",
                              "portbench.eval_sweep"):
            sweeps.append((e["ts"], e["ts"] + e["dur"], e["name"][10:]))
    sweeps.sort()
    host.sort()
    starts = [h[0] for h in host]

    def sweep_at(ts):
        for s0, s1, kind in sweeps:
            if s0 <= ts <= s1:
                return kind
        return None

    by_name = collections.Counter()
    train_groups = collections.Counter()
    hand = collections.Counter()
    intervals = []
    for e in device:
        t0, t1 = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t1 <= t0:
            continue
        intervals.append((t0, t1))
        if e.get("cat") != "kernel":
            by_name[e.get("name", "copy")] += (t1 - t0) / 1e6
            continue
        seconds = e["dur"] / 1e6
        by_name[short_name(e["name"])] += seconds
        lower = e["name"].lower()
        for kid, marks in HAND_KERNELS.items():
            if any(mark in lower for mark in marks):
                hand[kid] += seconds
        launch = runtime.get(e.get("args", {}).get("correlation"))
        if launch is not None and sweep_at(launch["ts"]) == "train_sweep":
            train_groups[group_of(e["name"])] += seconds
    busy = _union(intervals)
    gaps = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        where = sweep_at(mid) or "epoch_boundary"
        i = bisect.bisect_right(starts, mid) - 1
        doing = "idle host"
        for j in range(i, max(i - 200, -1), -1):
            if host[j][1] >= mid:
                doing = host[j][2]
                break
        else:
            if i >= 0:
                doing = "after " + host[i][2]
        gaps["%s: %s" % (where, doing[:80])] += (g1 - g0) / 1e6
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "by_name": by_name, "idle_gaps": gaps,
            "train_groups": train_groups, "hand": hand}
