#!/usr/bin/env python3
"""Time a streamed shard's host gather and the prefetch overlap on one
card, with the gather as the port does it and with ``index_select``.

    python3 scripts/probe_etl_overlap.py [repeats]

Over ``chip_smoke.py``'s residency data (2048 + 256 AlexNet-227 samples,
bf16, ~712 MB) and its streamed plan (a 400 MB device budget, depth 2):

1. one shard's gather into a pinned buffer by
   :func:`veles_tpu_torch.loader.prefetch.take_rows` (numpy's take, one
   thread) and by ``torch.index_select`` (every intra-op thread), each
   alone and beside a busy Python thread, the median ms of ``repeats``
   (default 10) gathers;
2. phase 12's overlap check (a loader throttled by a shard's compute
   time, the streamed sweep at depth 0 and depth 2) with either gather,
   in the order depth 0, 2, 2, 0 for each: the step thread's input wait
   and the median shard ETL ms of each sweep.

Prints the card's name and power limit and the host's cores, and
writes the JSON to ``chiprun_out/probe_etl_overlap.json``.
"""

import json
import os
import statistics
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ.setdefault("VELES_DATASET_CACHE", "0")

import chip_smoke as cs  # noqa: E402


def index_select_rows(torch):
    def take(src, index, out):
        torch.index_select(src, 0, index, out=out)
    return take


def gather_ms(torch, prefetch, data, rows, repeats):
    """Median ms of one shard's gather by each method, alone and beside
    a Python thread that never sleeps."""
    index = torch.from_numpy(rows).long()
    out = torch.empty((len(rows),) + tuple(data.shape[1:]),
                      dtype=data.dtype, pin_memory=True)
    methods = {"take_rows": prefetch.take_rows,
               "index_select": index_select_rows(torch)}
    want = data.index_select(0, index)
    result = {}
    for name, take in methods.items():
        take(data, index, out)
        if not torch.equal(out.flatten().view(torch.uint8),
                           want.flatten().view(torch.uint8)):
            raise AssertionError("%s gathered other rows" % name)
        for beside in (False, True):
            stop = threading.Event()

            def busy():
                n = 0
                while not stop.is_set():
                    n += 1

            thread = threading.Thread(target=busy, daemon=True)
            if beside:
                thread.start()
            times = []
            for _ in range(repeats):
                t = time.perf_counter()
                take(data, index, out)
                times.append((time.perf_counter() - t) * 1e3)
            stop.set()
            if beside:
                thread.join()
            result["%s %s" % (name, "beside a busy thread" if beside
                              else "alone")] = statistics.median(times)
    return result


def main(repeats=10):
    import numpy
    import torch
    if not torch.cuda.is_available():
        print("probe_etl_overlap: no CUDA device", file=sys.stderr)
        return 1
    from veles_tpu_torch.loader import prefetch
    from veles_tpu_torch.ops.gemm_bench import card_line
    from veles_tpu_torch.train.step import FusedTrainer
    card = card_line()
    print(card, flush=True)
    out = {"card": card, "cpus": os.cpu_count(),
           "affinity": len(os.sched_getaffinity(0)),
           "torch_threads": torch.get_num_threads()}
    knobs = dict(VELES_STREAM=None, VELES_OFFLOAD="0", VELES_SHARD_MB=None,
                 VELES_ETL_THROTTLE_MS=None,
                 VELES_PREFETCH=str(cs.RESIDENCY_DEPTH),
                 VELES_DEVICE_BUDGET_MB=None)
    warned = []
    with cs.deterministic(torch, warned):
        data = cs.residency_data()
        # a shard's compute time, as phase 12 takes it: the resident
        # sweep's device time a minibatch
        with cs.env_set(**knobs):
            trainer = cs.residency_trainer(data)
        trainer.train_class()
        with cs.timed_method(torch, FusedTrainer, "train_class") as sweep:
            trainer.train_class()
        torch.cuda.synchronize()
        n_train = trainer._segment_indices(2).shape[0]
        step_ms = sweep[0][0].elapsed_time(sweep[0][1]) / n_train
        trainer.shutdown()
        del trainer
        torch.cuda.empty_cache()

        streamed = dict(knobs, VELES_DEVICE_BUDGET_MB=cs.RESIDENCY_BUDGET_MB)
        with cs.env_set(**streamed):
            trainer = cs.residency_trainer(data)
            if not trainer.streaming:
                raise AssertionError("the residency data did not stream")
            trainer.train_class()
            torch.cuda.synchronize()
        per_shard = trainer._batches_per_shard
        rows = numpy.random.RandomState(0).randint(
            0, data[0].shape[0], per_shard * trainer.loader.max_minibatch_size)
        out["gather_rows"] = len(rows)
        out["gather_mb"] = len(rows) * data[0][0].numel() * \
            data[0].element_size() / 1e6
        out["gather_ms"] = gather_ms(torch, prefetch, data[0], rows, repeats)
        print("gather of %d rows (%.1f MB): %s" % (
            len(rows), out["gather_mb"], json.dumps(out["gather_ms"])),
            flush=True)

        shard_ms = step_ms * per_shard
        out["etl_throttle_ms"] = shard_ms
        runs = []
        gathers = {"take_rows": prefetch.take_rows,
                   "index_select": index_select_rows(torch)}
        with cs.env_set(**dict(streamed,
                               VELES_ETL_THROTTLE_MS="%.1f" % shard_ms)):
            for depth in (0, cs.RESIDENCY_DEPTH, cs.RESIDENCY_DEPTH, 0):
                for name, take in gathers.items():
                    with cs.patched(prefetch, "take_rows", take):
                        trainer.prefetch_depth = depth
                        before = trainer.input_wait_s
                        t = time.perf_counter()
                        trainer.train_class()
                        torch.cuda.synchronize()
                        runs.append({
                            "gather": name, "depth": depth,
                            "input_wait_s": trainer.input_wait_s - before,
                            "sweep_s": time.perf_counter() - t,
                            "shard_etl_ms": statistics.median(
                                trainer.shard_etl_ms)})
                        print("overlap %s" % json.dumps(runs[-1]),
                              flush=True)
        trainer.shutdown()
    out["overlap"] = runs
    out["overlap_sums"] = {
        "%s depth %d" % (name, depth): sum(
            r["input_wait_s"] for r in runs
            if r["gather"] == name and r["depth"] == depth)
        for name in gathers for depth in (0, cs.RESIDENCY_DEPTH)}
    out["warned"] = warned
    print(json.dumps(out, default=str), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out",
                           "probe_etl_overlap.json"), "w") as f:
        json.dump(out, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main(*[int(a) for a in sys.argv[1:]]))
