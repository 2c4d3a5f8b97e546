#!/usr/bin/env python3
"""Time the residency phase's ring controls side by side on one card.

    python3 scripts/probe_ring_controls.py [runs]

Full-width AlexNet-227 over ``chip_smoke.py``'s residency data (2048 +
256 samples, bf16), deterministic, streamed one minibatch a shard at
depth 2: a resident 1-epoch run (the reference), the streamed ring as it
is, ``runs`` (default 3) runs of the one-slot held control that phase 12
ran before its depth-2 one (``HeldRefills`` below: one slot, the ring's
order taken out, the consumer held until the refill lands) and then its
depth-2 held control (``chip_smoke.depth2_held_controls``: two slots,
its unordered runs, then the ring as it is). Prints each run's values
differing from the reference and its seconds (host clock around the
run, which ends in a synchronize), the card's name and power limit, and
writes the JSON to ``chiprun_out/probe_ring_controls.json``. Needs the
card (CUDA stream memory operations through ``libcuda``).
"""

import contextlib
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ.setdefault("VELES_DATASET_CACHE", "0")

import chip_smoke as cs  # noqa: E402


class HeldRefills(object):
    """The ring control's order, by construction: the slot's next refill
    first, then the read of its previous occupant.

    The trainer's staging ring and host ring get one slot each (so shard
    k + 1 refills shard k's slot), and the ring's own order is taken out
    (``StagingRing._order_refill`` a no-op). Each placement writes the
    slot's fill count to a word of device memory on the ring's copy
    stream after its copies (``cuStreamWriteValue32``), and the
    consumer's stream waits, before its first use of a placement, until
    that word says the slot was filled again (``cuStreamWaitValue32``,
    greater or equal): shard k computes on shard k + 1's rows, every
    time. The refill needs only shard k's release on the host, right
    after its compute is enqueued, and allocates nothing (the one slot's
    buffers and the one pinned set exist from the first shard on). The
    last placement of a sweep is released when the sweep's pipeline
    closes, from a side stream. Two watchdogs: a thread releases every
    hold after ``cs.RING_HOLD_WATCHDOG_S`` (the control then fails), and
    ``faulthandler`` ends the process (no interpreter lock needed) a
    minute later, so the card is never left waiting. ``libcuda``'s
    stream memory operations on device memory, through ``ctypes``."""

    WAIT_GEQ = 0

    def __init__(self, torch, prefetch):
        import ctypes
        self.torch, self.prefetch = torch, prefetch
        libcuda = ctypes.CDLL("libcuda.so.1")
        self._wait = libcuda.cuStreamWaitValue32_v2
        self._write = libcuda.cuStreamWriteValue32_v2
        for fn in (self._wait, self._write):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
                           ctypes.c_uint]
            fn.restype = ctypes.c_int
        self.words = torch.zeros(64, dtype=torch.int32, device="cuda")
        self.side = torch.cuda.Stream()
        self.fills = {}
        self.holds = 0
        self.fired = False
        self._lock = threading.Lock()
        self._done = threading.Event()

    def _call(self, fn, stream, slot, value, flags):
        status = fn(stream.cuda_stream, self.words.data_ptr() + 4 * slot,
                    value, flags)
        if status:
            raise RuntimeError("%s: CUresult %d" % (fn.__name__, status))

    def _watchdog(self):
        if not self._done.wait(cs.RING_HOLD_WATCHDOG_S):
            self.fired = True
            self.release_all()

    def release_all(self):
        """Release every hold: each slot's word to one more fill."""
        with self._lock:
            for slot in sorted(self.fills):
                self.fills[slot] += 1
                self._call(self._write, self.side, slot, self.fills[slot], 0)

    @contextlib.contextmanager
    def installed(self):
        prefetch, holder = self.prefetch, self
        place, wait = prefetch.StagingRing.place, prefetch.Staged.wait
        close = prefetch.PrefetchPipeline.close

        def held_place(ring, host_tree, after=()):
            staged = place(ring, host_tree, after)
            if ring.reuse and ring.device.type == "cuda":
                with holder._lock:
                    n = holder.fills[staged.slot] = holder.fills.get(
                        staged.slot, 0) + 1
                    holder._call(holder._write, ring.copy_stream,
                                 staged.slot, n, 0)
                staged.hold_value = n + 1
            return staged

        def held_wait(staged):
            tree = wait(staged)
            value = getattr(staged, "hold_value", None)
            if value is not None:
                holder._call(holder._wait, holder.torch.cuda.current_stream(),
                             staged.slot, value, holder.WAIT_GEQ)
                holder.holds += 1
            return tree

        def releasing_close(pipe, *args, **kwargs):
            try:
                return close(pipe, *args, **kwargs)
            finally:
                holder.release_all()

        def one_slot(init):
            def init_one(self, slots, *args, **kwargs):
                init(self, 1, *args, **kwargs)
            return init_one

        import faulthandler
        faulthandler.dump_traceback_later(cs.RING_HOLD_WATCHDOG_S + 60,
                                          exit=True)
        watchdog = threading.Thread(target=self._watchdog, daemon=True)
        watchdog.start()
        try:
            with cs.patched(prefetch.StagingRing, "_order_refill",
                         lambda self, stream, event: None), \
                    cs.patched(prefetch.StagingRing, "__init__",
                            one_slot(prefetch.StagingRing.__init__)), \
                    cs.patched(prefetch.HostRing, "__init__",
                            one_slot(prefetch.HostRing.__init__)), \
                    cs.patched(prefetch.StagingRing, "place", held_place), \
                    cs.patched(prefetch.Staged, "wait", held_wait), \
                    cs.patched(prefetch.PrefetchPipeline, "close",
                            releasing_close):
                yield self
        finally:
            self.release_all()
            self._done.set()
            watchdog.join()
            self.torch.cuda.synchronize()
            faulthandler.cancel_dump_traceback_later()



def main(runs=3):
    import numpy
    import torch
    if not torch.cuda.is_available():
        print("probe_ring_controls: no CUDA device", file=sys.stderr)
        return 1
    from veles_tpu_torch.loader import prefetch
    from veles_tpu_torch.ops.gemm_bench import card_line
    card = card_line()
    print(card, flush=True)
    out, warned = {"card": card}, []
    knobs = dict(VELES_STREAM=None, VELES_OFFLOAD="0", VELES_SHARD_MB=None,
                 VELES_ETL_THROTTLE_MS=None,
                 VELES_PREFETCH=str(cs.RESIDENCY_DEPTH),
                 VELES_DEVICE_BUDGET_MB=None)
    with cs.deterministic(torch, warned):
        data = cs.residency_data()
        with cs.env_set(**knobs):
            resident = cs.residency_run(torch, data, 1)
        resident.pop("trainer").shutdown()

        def timed(label, context):
            t = time.perf_counter()
            with context:
                run = cs.residency_run(torch, data, 1)
            out.setdefault(label + "_s", []).append(time.perf_counter() - t)
            out.setdefault(label + "_differing", []).append(
                cs.state_differing(numpy, run["state"], resident["state"]))
            run["trainer"].shutdown()

        with cs.env_set(**dict(knobs,
                               VELES_DEVICE_BUDGET_MB=cs.RESIDENCY_BUDGET_MB,
                               VELES_SHARD_MB=cs.RING_SHARD_MB)):
            timed("streamed", contextlib.nullcontext())
            for _ in range(runs):
                held = HeldRefills(torch, prefetch)
                stack = contextlib.ExitStack()
                stack.enter_context(cs.env_set(VELES_PREFETCH_WORKERS="1"))
                stack.enter_context(held.installed())
                timed("one_slot_unordered", stack)
            out.update(cs.depth2_held_controls(torch, numpy, prefetch, data,
                                               resident))
    out["warned"] = warned
    print(json.dumps(out, default=str), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out",
                           "probe_ring_controls.json"), "w") as f:
        json.dump(out, f, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main(*[int(a) for a in sys.argv[1:]]))
