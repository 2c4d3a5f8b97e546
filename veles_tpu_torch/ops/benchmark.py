"""Device benchmark (``veles_tpu/ops/benchmark.py``): repeated square
GEMM timing. Gives the ``computing_power`` rating (1000 / dt of a
1500^2 GEMM chain in the reference) and the achieved TFLOP/s."""

import time

import torch

from veles_tpu_torch.device import resolve_device
from veles_tpu_torch.ops.gemm import full_float32


def gemm_benchmark(size=1500, repeats=5, dtype=torch.bfloat16, device=None):
    """Time ``repeats`` chained ``size`` x ``size`` products, each
    accumulated in float32 and cast back to ``dtype``; returns a dict
    with JAX's keys.

    The operands are standard normal from a torch generator seeded 0:
    the same seed as the JAX package, but not ``jax.random.normal``'s
    numbers, which torch cannot reproduce. On the card the chain is
    timed by CUDA events after a warm-up run, on the CPU by the host
    clock."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((size, size), generator=gen).to(device, dtype)
    b = torch.randn((size, size), generator=gen).to(device, dtype)

    def chain():
        x = a
        for _ in range(repeats):
            x = torch.matmul(x, b)
        return x

    with full_float32():
        chain()
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            chain()
            dt = time.perf_counter() - t0
    flops = 2.0 * size ** 3 * repeats
    return {
        "seconds": dt,
        "computing_power": 1000.0 * repeats / dt,
        "tflops": flops / dt / 1e12,
        "size": size,
        "dtype": str(dtype).replace("torch.", ""),
    }
