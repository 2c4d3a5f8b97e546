#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``veles_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Card: the ``nvidia-smi`` name and power limit, then one compiler per
   source under ``veles_tpu_torch/csrc`` (``nvcc`` for each kernel, the
   host compiler for K3's, K6's and K7's bindings), all started
   together, with the seconds each took, the bindings' on a line of
   their own.
2. Kernel phase: every kernel at the shapes the serving, training and
   GEMM-disciplines paths give it, held against its plain PyTorch
   version on the card within a stated tolerance (the Philox fill bit
   for bit), and timed (CUDA events) beside its plain version, one
   PyTorch library call computing the same function, and its bound
   (bytes over 3.35 TB/s or operations over the type's peak, H100 SXM).
   K1/K2 rows add the variant of ``csrc/gemm_bias_act.cu`` that ran and
   its K splits (``gemm_plan``), two calls held bitwise equal,
   ``ms_cold`` and ``library_ms_cold`` (one call at a time, 128 MB
   written before each, so its operands come from device memory) and
   ``host_us``, the wrapper's host time per call. K5 rows add the same
   (form and splits from ``kahan_plan``) and ``bound_ms_each``: the
   bytes, 2MNK on the CUDA cores and 3xTF32 on the tensor cores (or one
   bf16 product), the bound being the bytes or the lesser operations
   time, whichever is larger. K3, K4, K6 and K7 rows add ``ms_cold``
   and ``host_us`` beside their library call's same three
   (``library_ms_cold``, ``library_host_us``); K3, K4 and K6 rows the
   form their plan chose (``lrn_fwd_plan``, ``lrn_bwd_plan``,
   ``column_plan``, read from the counters), K6 rows two calls bitwise
   equal; the K3 and K7 rows the CPython binding they went through
   (checked: loaded, and the C function never resolved for ctypes).
   Split sweeps time K1 and K5 at several K split counts beside their
   plans' models.
3. Slice phase: full-width AlexNet-227 (float32, weights from numpy
   seed 42) behind ``ServingFrontend`` on 127.0.0.1 with one replica
   and max batch 64; concurrent single requests and one 64-row batch
   request over HTTP. Every reply is held against the same model run
   through the plain versions on the card, on its centred logits (see
   ``reply_mismatch``), and two broken controls must fail that check.
   The launch counts must show both kernels twice per forward, every
   launch at a form (shape, dtype, bias) the kernel phase checked,
   every K1 launch on a designed variant (stream, tiles, tensor_core),
   never the general one, and every K3 launch on its vector form; the
   same holds in phases 5 and 6.
4. Forward phase: device time of one forward through the kernels and
   through the plain versions at batch 1 and 64, and a
   ``torch.profiler`` table of device time by kernel for one 64-row
   forward.
5. Training phase: full-width AlexNet-227 trained by the port's
   ``FusedTrainer`` at ``bench.py``'s settings (batch 128, SGD momentum
   0.9, weight decay 5e-4, lr 0.01, softmax loss) over 512 training and
   128 validation samples of ``SyntheticImageLoader`` (bf16 storage).
   (a) Under float32, one step's loss and per-layer gradients through
   the kernels are held against the same step through the plain
   versions (same weights, batch and Philox bits, cuDNN deterministic);
   a zeroed fc7 bias gradient and the dropout masks of another seed
   must both fail that check. The backends check: the same step with
   TF32 and bf16 reduced-precision reductions switched on by the caller
   gives the loss and gradients of the step with them off, bit for bit
   (the trainer holds its policy's switches), and the step with the
   trainer's guard taken out must differ. (b) 5 epochs of ``run_epoch`` under
   float32 and then under bfloat16: per-epoch losses (all finite),
   device step ms by CUDA events, samples/s and model FLOP/s. (c) The
   launch counts: K1 and K3 twice per forward, K4, K6 and K7 at the
   model's LRN, bias and dropout counts per step, every launch at a
   checked form, every K3 and K4 launch on its vector form and every K6
   launch on a designed form. (d) A ``torch.profiler`` table and split of one
   training step's device time by kernel.
6. Disciplines phase: the GEMM-disciplines bench
   (``veles_tpu_torch.ops.gemm_bench``) at its five shapes, counted from
   0, and its table. (a) Level 1 (K5) is no less accurate against
   float64 than the plain Kahan loop (max |error| at most 1.05x at every
   shape). (b) On the hostile input of ``tests/test_ops.py`` (K 4096, 8
   decades, alternating signs; 256 rows), with the magnitudes falling
   along K, K5 with 64-deep blocks errs at least 2x less than K5 with
   one block (rising magnitudes are printed beside). (c) Levels 0, 1
   and 2 stay within a float32-sized error of float64, also with TF32
   switched on for the process, and a control (a plain matmul under
   TF32) must fail that limit. (d) Every K5 and K2 launch lands at a
   form the kernel phase checked, and every K5 launch of the bench ran
   the tensor-core (mma) form. Then the device rating, ``gemm_benchmark()`` at
   bf16 and at float32, with a ``torch.profiler`` table of the bf16
   chain's kernels and bf16 at 1536^2 (rows 16-byte aligned) beside.
7. Baseline phase: the BASELINE model family trained by the port at
   ``scripts/bench_all.py``'s sizes (golden digits 12000 + 2000, golden
   objects 10000 + 2000, generated from their seeds): mnist-fc
   (784-100-10, batch 500), mnist-conv (``CONV_LAYERS``, 250),
   cifar-quick (``CIFAR_LAYERS``, ``mean_disp``, 250) and mnist-ae
   (784-100-784 under MSE, 500), each under float32 and bfloat16_mixed.
   (1) Under float32, one step's loss and gradients through the kernels
   against the plain versions (cuDNN deterministic), with the first fc
   layer's bias gradient zeroed, and for the autoencoder the targets
   shifted by a row, as controls that must fail. (2) Three epochs counted
   from 0: per-epoch training loss, validation error (RMSE for the
   autoencoder) and confusion trace, all finite, the float32 loss
   falling; step ms by CUDA events (median of epochs 2-3), samples/s,
   the idle share against a profiled step, peak memory. (3) K1 and K6
   launches against the model's counts and by form, every launch at a
   form the kernel phase checked (K1 rows at the four BASELINE shapes in
   both dtypes, K6 rows at their eleven bias shapes); the bf16 launches
   at N or K = 100 run K1's general form and are recorded so. (4) On
   mnist-fc, an epoch each of AdaGrad, AdaDelta and Adam after the step
   check and a check of one update through the kernels against the plain
   versions. (5) The 8x8 SOM over the digits, three epochs at minibatch
   1024: its quantization error falls below the untrained codebook's,
   ms an update by CUDA events, no kernel of the port launched. (6) The
   samples of ``models/samples.py`` at their workflows' defaults, wine
   (13-10-3, batch 50), lines (a small conv net, 50) and kanji (100
   classes of glyph pairs, 20000 + 2000 samples, 100), run as (1)-(3).
8. Sequence phase: ``scripts/bench_all.py``'s attention (2 attention
   layers of 8 heads over (256, 256) samples, softmax over 8 classes)
   and moe (attention, 8-expert MoE, attention over (128, 256))
   configurations, ``SequenceProvider`` 4096 + 256, batch 64, weights
   from numpy seed 2468. (1) The attention model behind
   ``ServingFrontend`` (one replica, max batch 64): 3 rounds of 16
   concurrent single requests and one 64-row batch request, base64
   bodies; every reply held to the plain forward on the card by the
   centred-logit check, a reply swap and a zeroed head as controls that
   must fail it; p50/p95, the batch's samples/s, the device forward at
   batch 1 and 64. (2) The moe model served: each row of a 64-row batch
   request held to the same sample forwarded alone (batch-composition
   independence), the capacity pooled over the batch as the control that
   must fail, and a single request equal to its batch row. (3) Each
   configuration trained 3 epochs under float32 and bfloat16_mixed at lr
   0.01 (the workflow's 0.1 makes the loss climb at these widths, in the
   JAX package too) as (1)-(3) of the baseline phase: the float32 step
   check's controls are the first attention layer's bias gradient zeroed
   and, for moe, the busiest expert's up gradient zeroed; the MoE's
   routing flips between the kernel and plain forwards counted. K1 four
   times an attention layer a forward, K6 four times an attention layer
   and once for the head a step, every launch at a checked form (K1 rows
   at the projections' (batch * seq, 256, 256) for every served bucket,
   K6 rows at (16384, 256), (8192, 256) and (64, 8)) and every K1 launch
   of the phase on a designed variant.
9. Workflow phase: full-width AlexNet-227 through the port's CLI
   (``veles_tpu_torch.__main__.Main().run``) on a workflow file the
   phase writes: ``AlexNetWorkflow`` over ``SyntheticImageLoader`` (512 +
   128 samples, batch 128, SGD lr 0.01, momentum 0.9, wd 5e-4, float32,
   ``-s 7``), 4 epochs, a raw ``SnapshotterToFile`` every epoch into a
   temporary directory removed at the end. (1) The uninterrupted run:
   per-epoch losses (finite), validation n_err, the sweeps', decision's
   and snapshot's seconds against the steps' CUDA-event sum, each
   snapshot's size, step ms, samples/s, the result file's metrics, K1,
   K3, K4, K6 and K7 launches exactly the model's counts. (2) ``-w`` on
   the snapshot after 2 epochs in a cleared registry: the last two
   epochs' losses within 1e-5 relative and fc7's final weights within
   5e-2 of their change over those epochs; the same restore with its
   random streams dropped must fail that. (3) ``--test -w`` on the final
   snapshot: one forward-only epoch, no weight changed. (4)
   ``ModelStore.load`` of the snapshot directory behind
   ``ServingFrontend``, 16 concurrent requests and a 64-row batch
   checked as in phase 3. (5) Every launch of (1)-(4) at a checked form,
   every K1 launch on a designed variant, every K3, K4 and K6 launch on
   a designed form; the idle share from one profiled step. (6) A CLI run
   of the small AlexNet in a process of its own loads neither ``jax``
   nor any ``veles_tpu`` module.
10. The line before the last is ``{"kernels": [...], "not_ported":
   []}``; the last is ``{"ok": true, "device": {...}}``. Any failure
   raises and exits non-zero before them.
"""

import base64
import contextlib
import json
import math
import os
import statistics
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W); "tf32" is the
#: tensor cores' dense TF32 rate, half the sheet's 989 TFLOP/s quoted
#: with sparsity
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}

GEMM_SOURCE = "veles_tpu_torch/csrc/gemm_bias_act.cu"
LRN_SOURCE = "veles_tpu_torch/csrc/lrn_fwd.cu"
LRN_BINDING = "veles_tpu_torch/csrc/lrn_fwd_binding.cpp"
LRN_BWD_SOURCE = "veles_tpu_torch/csrc/lrn_bwd.cu"
REDUCE_SOURCE = "veles_tpu_torch/csrc/column_reduce.cu"
UNIFORM_SOURCE = "veles_tpu_torch/csrc/uniform_fill.cu"
UNIFORM_BINDING = "veles_tpu_torch/csrc/uniform_fill_binding.cpp"
KAHAN_SOURCE = "veles_tpu_torch/csrc/kahan_gemm.cu"
#: the TPU kernels' pallas_call sites
GEMM_BIAS_TPU = "veles_tpu/ops/gemm.py:414"
GEMM_TPU = "veles_tpu/ops/gemm.py:410"
LRN_TPU = "veles_tpu/ops/lrn.py:116"
LRN_BWD_TPU = "veles_tpu/ops/lrn.py:131"
KAHAN_TPU = "veles_tpu/ops/gemm.py:347"
REDUCE_TPU = "veles_tpu/ops/reduce.py:73"
UNIFORM_TPU = "veles_tpu/ops/random.py:82"

#: tolerances, kernel vs plain version on the same inputs
#: float32: both sum ~9216 products in float32 in different orders
#: (~1e-6 on O(1) sums); bf16 outputs: one bf16 ulp (2^-8 relative)
GEMM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
#: float32: rsqrt chain (few ulp) vs pow; bf16: one bf16 ulp. The
#: backward adds a second window sum: still a few ulp on dx ~ 1
LRN_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
#: column sums: reordering R float32 additions moves a sum by far less
#: than 1e-6 of its column's sum of magnitudes
REDUCE_REL_TOL = 1e-6
#: served probabilities vs the plain-version forward: float32 sums in
#: another order and cuDNN algorithms picked per batch size
PROBS_ATOL = 1e-5
#: served centred logits vs the plain forward's, as a share of their
#: input-dependent spread: a sound run reads ~1e-4 (probability error
#: ~2e-10 on p ~ 1e-3 against an input-dependent part of a few e-3); a
#: reply sent to the wrong request or a zeroed fc7 reads ~1
LOGIT_REL_TOL = 1e-2
#: the batch sizes the serving path runs: every power of two to 64
BUCKETS = (1, 2, 4, 8, 16, 32, 64)
#: the training path: bench.py's batch, 4 training batches and one
#: validation batch per epoch
TRAIN_BATCH = 128
TRAIN_SAMPLES = 512
TRAIN_EPOCHS = 5
#: every bias gradient of the training step, (rows, C) of the column sum
REDUCE_SHAPES = (("conv1", TRAIN_BATCH * 56 * 56, 96),
                 ("conv2", TRAIN_BATCH * 27 * 27, 256),
                 ("conv3/conv4", TRAIN_BATCH * 13 * 13, 384),
                 ("conv5", TRAIN_BATCH * 13 * 13, 256),
                 ("fc6/fc7", TRAIN_BATCH, 4096),
                 ("head", TRAIN_BATCH, 1000))
#: the BASELINE paths (``scripts/bench_all.py``'s data sizes and
#: minibatches): golden digits 12000 + 2000 and golden objects 10000 +
#: 2000, three epochs under each policy
BASELINE_DIGITS = (12000, 2000)
BASELINE_OBJECTS = (10000, 2000)
BASELINE_EPOCHS = 3
BASELINE_POLICIES = ("float32", "bfloat16_mixed")
BASELINE_SEED = 1234
#: the adaptive solvers' epoch on mnist-fc, at rates they train at
SOLVER_TRAINING = {"adagrad": {"learning_rate": 0.01},
                   "adadelta": {},
                   "adam": {"learning_rate": 0.001}}
#: the 8x8 SOM over the digits' 784 features, minibatch 1024
SOM_SIDE = 8
SOM_MINIBATCH = 1024
#: K1 on the BASELINE paths: (layer, M, K, N, epilogue), every one with
#: its bias, in float32 and bf16
BASELINE_GEMMS = (("mnist-fc/ae fc1", 500, 784, 100, "tanh"),
                  ("mnist-conv fc", 250, 512, 100, "relu"),
                  ("cifar-quick fc", 250, 576, 64, "linear"),
                  ("mnist-ae decoder", 500, 100, 784, "linear"),
                  ("wine fc1", 50, 13, 10, "tanh"),
                  ("lines fc", 50, 392, 32, "relu"),
                  ("kanji fc", 100, 1280, 128, "relu"))
#: every bias gradient of the BASELINE paths, (rows, C) of the column sum
BASELINE_REDUCE_SHAPES = (("mnist-fc/ae fc1", 500, 100),
                          ("mnist-fc head", 500, 10),
                          ("mnist-ae decoder", 500, 784),
                          ("mnist-conv conv1", 250 * 24 * 24, 16),
                          ("mnist-conv conv2", 250 * 8 * 8, 32),
                          ("mnist-conv fc", 250, 100),
                          ("mnist-conv/cifar head", 250, 10),
                          ("cifar-quick conv1", 250 * 32 * 32, 32),
                          ("cifar-quick conv2", 250 * 15 * 15, 32),
                          ("cifar-quick conv3", 250 * 7 * 7, 64),
                          ("cifar-quick fc", 250, 64),
                          ("wine fc1", 50, 10), ("wine head", 50, 3),
                          ("lines conv", 50 * 14 * 14, 8),
                          ("lines fc", 50, 32), ("lines head", 50, 4),
                          ("kanji conv1", 100 * 20 * 44, 16),
                          ("kanji conv2", 100 * 8 * 20, 32),
                          ("kanji fc", 100, 128), ("kanji head", 100, 100))
#: the sequence phase: ``scripts/bench_all.py``'s attention (2 attention
#: layers of 8 heads over (256, 256) samples) and moe (attention, 8
#: experts, attention over (128, 256)) configurations, 4096 + 256
#: samples, batch 64: the attention model served (one replica, max
#: batch 64), the moe model served for its batch-composition check, then
#: each trained 3 epochs under each policy
SEQUENCE_SEED = 2468
SEQUENCE_EPOCHS = 3
#: the phase trains at this rate: at these widths ``SequenceWorkflow``'s
#: default of 0.1, which ``bench_all.py`` keeps, makes the training loss
#: climb within an epoch, in the JAX package as in the port
#: (``tests/test_torch_sequence.py::test_bench_width_steps_match_jax``)
SEQUENCE_LEARNING_RATE = 0.01
SEQUENCE_POLICIES = ("float32", "bfloat16_mixed")
SEQUENCE_DIM = 256
SEQUENCE_LENGTHS = {"attention": 256, "moe": 128}
#: K1 on the sequence paths: each attention projection, (batch * seq)
#: rows by (256, 256), float32 (the layer never casts) with its bias and
#: the linear epilogue, at every served bucket of both models (which
#: includes their batches of 64)
SEQUENCE_GEMM_ROWS = tuple(sorted({b * seq for b in BUCKETS
                                   for seq in SEQUENCE_LENGTHS.values()}))
#: K6 on the sequence paths: the projections' bias gradients (four a
#: layer) and the head's
SEQUENCE_REDUCE_SHAPES = (("attention projections", 64 * 256, 256),
                          ("moe-model projections", 64 * 128, 256),
                          ("sequence head", 64, 8))
#: Philox4x32-10 per value: 10 rounds of 2 multiplies, 2 high
#: multiplies and 4 xors per counter, 18 key additions, over 4 values;
#: then shift, convert, scale and affine map
UNIFORM_OPS_PER_VALUE = 30
#: the step check: a layer's gradient through the kernels vs the plain
#: versions, as a share of its norm (float32, same Philox bits, cuDNN
#: deterministic). Summation order alone would give ~1e-6, but where
#: the LRN's kernel and plain outputs differ by an ulp on a near-tie of
#: a max-pool window the two paths route that window's gradient to
#: different elements, a full-size change: conv1's weight gradient read
#: 2.2e-3 on an H100 (the script counts the flipped windows). A zeroed
#: fc7 bias gradient reads 1, another seed's masks ~1
GRAD_SHARE_TOL = 1e-2
#: and the step's loss, relative
LOSS_REL_TOL = 1e-5
CHECK_SEED = 0x5EED
#: (a): level 1's max |error| against float64 at most this multiple of
#: the plain Kahan loop's, at every shape of the disciplines bench
KAHAN_ERR_RATIO = 1.05
#: (c): a float32 product's max |error| against float64 as a share of
#: |a| @ |b|, operands uniform in [-0.5, 0.5). Each float32 rounding is
#: at most 6e-8 of a partial sum no larger than |a| @ |b|, and a few of
#: them add up: even plain sequential float32 sums over millions of
#: outputs stay at a few 1e-7. TF32 rounds each operand to 10 mantissa
#: bits, ~5e-4 relative per product, and reads a few 1e-6 on a typical
#: output at K = 9216 and more at smaller K
FP32_SHARE_TOL = 2e-6
#: (b): on the hostile input with falling magnitudes one K-deep block
#: must err at least this many times more than 64-deep Kahan blocks (a
#: compensation that does nothing reads ~1)
HOSTILE_FALLING_GAIN = 2.0


def device_ms(torch, fn, trials=5, per_trial=10, warmup=3):
    """Median over trials of the mean device time of back-to-back
    calls, by CUDA events."""
    from veles_tpu_torch.ops.gemm_bench import time_ms
    return time_ms(fn, torch.device("cuda"), trials, per_trial, warmup)


def bound(nbytes, ops, dtype):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS[dtype] * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def check_close(name, got, want, atol, rtol):
    import torch
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("%s: non-finite output" % name)
    err = (got - want).abs()
    limit = atol + rtol * want.abs()
    if bool((err > limit).any()):
        raise AssertionError("%s: max |err| %.3g exceeds atol %g + rtol %g"
                             % (name, float(err.max()), atol, rtol))
    return float(err.max())


#: the cold timing: bytes written before each call (outside its events)
#: to push its operands out of the 50 MB L2, and a spin before the start
#: event long enough for the host to queue the call behind it
COLD_SCRATCH_BYTES = 128 << 20
COLD_SPIN_CYCLES = 400000
COLD_TRIALS = 10
#: calls timed on the host clock for ``host_us``
HOST_CALLS = 50


def cold_ms(torch, fn, scratch):
    """Median per-call device time (CUDA events) of ``fn`` with
    ``scratch`` overwritten before each call, outside the events: the
    time a call takes when its operands come from device memory, as in a
    real forward or step, where back-to-back calls may find up to 50 MB
    of them in L2."""
    fn()
    times = []
    for _ in range(COLD_TRIALS):
        scratch.fill_(1.0)
        torch.cuda._sleep(COLD_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(torch, fn):
    """The host time of one call (us), over back-to-back calls that do not
    wait for the card."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    us = 1e6 * (time.perf_counter() - t) / HOST_CALLS
    torch.cuda.synchronize()
    return us


def gemm_row(torch, scratch, name, x, w, bias, activation, dtype, library):
    """One K1/K2 row: the kernel against its plain version, the variant
    and split count it launched (read from the counters), two calls
    bitwise equal, and its times: warm (back-to-back), cold, host, beside
    the plain version's, the library call's and the bound."""
    from veles_tpu_torch.ops.gemm import (gemm_plan, linear_act,
                                          linear_act_plain)
    dt = getattr(torch, dtype)
    m, k = x.shape
    n = w.shape[1]
    variants = dict(linear_act.launches_by_variant)
    got = linear_act(x, w, bias, activation, dt)
    again = linear_act(x, w, bias, activation, dt)
    want = linear_act_plain(x, w, bias, activation, dt)
    torch.cuda.synchronize()
    ran = {v: c - variants.get(v, 0)
           for v, c in linear_act.launches_by_variant.items()
           if c != variants.get(v, 0)}
    if len(ran) != 1 or sum(ran.values()) != 2:
        raise AssertionError("gemm_bias_act %s: launches by variant %s"
                             % (name, ran))
    variant = next(iter(ran))
    plan = gemm_plan(m, n, k, x.dtype)
    if plan.form != variant:
        raise AssertionError("gemm_bias_act %s: ran %s, planned %s"
                             % (name, variant, plan.form))
    if not torch.equal(got, again):
        raise AssertionError("gemm_bias_act %s: two calls differ in %d "
                             "outputs" % (name, int((got != again).sum())))
    err = check_close("gemm_bias_act " + name, got, want, *GEMM_TOL[dtype])
    nbytes = (m * k + k * n + m * n) * x.element_size() + \
        (0 if bias is None else 4 * n)
    bms, by = bound(nbytes, 2 * m * n * k, dtype)

    def kernel():
        return linear_act(x, w, bias, activation, dt)

    return {
        "name": "gemm_bias_act", "shape": name,
        "_form": (m, k, n, dt, bias is not None),
        "route": "cuda", "source": GEMM_SOURCE,
        "replaces": GEMM_BIAS_TPU if bias is not None else GEMM_TPU,
        "variant": variant, "splits": plan.splits,
        "max_abs_err": err, "tolerance": list(GEMM_TOL[dtype]),
        "bitwise_repeatable": True,
        "ms": device_ms(torch, kernel),
        "ms_cold": cold_ms(torch, kernel, scratch),
        "host_us": host_us(torch, kernel),
        "plain_ms": device_ms(torch, lambda: linear_act_plain(
            x, w, bias, activation, dt)),
        "bound_ms": bms, "bound_by": by,
        "library_ms": device_ms(torch, library),
        "library_ms_cold": cold_ms(torch, library, scratch)}


def gemm_phase(torch):
    """K1 at the serving and training shapes of fc6/fc7 and K2 at the
    GEMM-disciplines bench's five shapes (:func:`gemm_row`). Library
    call: ``torch.addmm`` (bias cast to the operands' dtype) or
    ``torch.mm``, then the activation."""
    import torch.nn.functional as F

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    scratch = torch.empty(COLD_SCRATCH_BYTES // 4, device="cuda")
    for layer, k in (("fc6", 9216), ("fc7", 4096)):
        n = 4096
        w32 = (torch.rand(k, n, device="cuda", generator=gen) * 2 - 1) \
            / k ** 0.5
        b32 = torch.rand(n, device="cuda", generator=gen) * 0.2 - 0.1
        for m in BUCKETS + (TRAIN_BATCH,):
            x32 = torch.rand(m, k, device="cuda", generator=gen) * 2 - 1
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                x, w = x32.to(dt), w32.to(dt)
                for bias in (b32, None):
                    if not gemm_form_checked(m, dtype, bias is not None):
                        continue
                    lib_bias = None if bias is None else bias.to(dt)

                    def library(x=x, w=w, lib_bias=lib_bias):
                        y = torch.mm(x, w) if lib_bias is None else \
                            torch.addmm(lib_bias, x, w)
                        return F.relu(y)

                    rows.append(gemm_row(
                        torch, scratch, "%s M=%d %s %s" % (
                            layer, m, dtype,
                            "bias" if bias is not None else "no bias"),
                        x, w, bias, "strict_relu", dtype, library))
    # K1 on the BASELINE paths, with its bias and epilogue
    from veles_tpu_torch.nn.activation import ACTIVATIONS
    for layer, m, k, n, activation in BASELINE_GEMMS:
        w32 = (torch.rand(k, n, device="cuda", generator=gen) * 2 - 1) \
            / k ** 0.5
        b32 = torch.rand(n, device="cuda", generator=gen) * 0.2 - 0.1
        x32 = torch.rand(m, k, device="cuda", generator=gen) * 2 - 1
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x, w, lib_bias = x32.to(dt), w32.to(dt), b32.to(dt)

            def library(x=x, w=w, lib_bias=lib_bias, act=activation):
                return ACTIVATIONS[act](torch.addmm(lib_bias, x, w))

            rows.append(gemm_row(
                torch, scratch, "%s M=%d K=%d N=%d %s %s bias" % (
                    layer, m, k, n, activation, dtype),
                x, w, b32, activation, dtype, library))
    # K1 on the sequence paths: the attention projections
    k = n = SEQUENCE_DIM
    w = (torch.rand(k, n, device="cuda", generator=gen) * 2 - 1) / k ** 0.5
    b32 = torch.rand(n, device="cuda", generator=gen) * 0.2 - 0.1
    for m in SEQUENCE_GEMM_ROWS:
        x = torch.randn(m, k, device="cuda", generator=gen)
        rows.append(gemm_row(
            torch, scratch, "attention projection M=%d K=%d N=%d float32 "
            "bias" % (m, k, n), x, w, b32, "linear", "float32",
            lambda x=x: torch.addmm(b32, x, w)))
    del x, w
    # K2 on the GEMM-disciplines path: float32, no bias, linear
    from veles_tpu_torch.ops.gemm_bench import SHAPES
    for _, (m, k, n) in SHAPES:
        a = torch.rand(m, k, device="cuda", generator=gen) - 0.5
        b = torch.rand(k, n, device="cuda", generator=gen) - 0.5
        rows.append(gemm_row(
            torch, scratch, "%dx%d @ %dx%d float32 no bias" % (m, k, k, n),
            a, b, None, "linear", "float32",
            lambda a=a, b=b: torch.mm(a, b)))
        del a, b
    del scratch
    return rows


#: the split sweep: K1's shapes timed at each of these split counts and
#: at the plan's own
SWEEP_SPLITS = (1, 2, 4, 6, 8, 16)
SWEEP_SHAPES = (("fc6 M=1 float32", 1, 9216, 4096, "float32"),
                ("fc6 M=64 float32", 64, 9216, 4096, "float32"),
                ("fc6 M=128 float32", 128, 9216, 4096, "float32"),
                ("1500^3 float32", 1500, 1500, 1500, "float32"),
                ("fc6 M=128 bfloat16", 128, 9216, 4096, "bfloat16"))


def split_sweep(torch):
    """The evidence for ``gemm_plan``'s split counts: K1 (no bias,
    linear) timed back-to-back at each count of :data:`SWEEP_SPLITS` and
    at the plan's own, beside the plan's modelled time for the tiles
    form (``_tile_us``)."""
    from veles_tpu_torch.ops.gemm import _tile_us, gemm_plan, linear_act
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for name, m, k, n, dtype in SWEEP_SHAPES:
        dt = getattr(torch, dtype)
        x = (torch.rand(m, k, device="cuda", generator=gen) * 2 - 1).to(dt)
        w = ((torch.rand(k, n, device="cuda", generator=gen) * 2 - 1) /
             k ** 0.5).to(dt)
        chosen = gemm_plan(m, n, k, dt)
        row = {"shape": name, "form": chosen.form,
               "plan_splits": chosen.splits, "ms": {}, "model_us": {}}
        for want in sorted(set(SWEEP_SPLITS) | {chosen.splits}):
            plan = gemm_plan(m, n, k, dt, splits=want)
            if plan.splits in row["ms"]:
                continue
            row["ms"][plan.splits] = device_ms(torch, lambda: linear_act(
                x, w, None, "linear", dt, splits=want))
            if plan.form == "tiles":
                row["model_us"][plan.splits] = _tile_us(
                    m, n, k, plan.tile[0], plan.splits, plan.kchunk)
        print("split sweep %s (%s, plan %d): %s" % (
            name, chosen.form, chosen.splits, ", ".join(
                "%d: %.4f ms%s" % (sp, ms, "" if sp not in row["model_us"]
                                   else " (model %.1f us)" %
                                   row["model_us"][sp])
                for sp, ms in sorted(row["ms"].items()))))
        rows.append(row)
        del x, w
    return rows


def gemm_form_checked(m, dtype, has_bias):
    """Serving runs float32 with a bias at every bucket, and the other
    forms are checked at the end buckets; training runs float32 and
    bfloat16 with a bias at its batch."""
    if m == TRAIN_BATCH:
        return has_bias
    return m in (1, 64) or (dtype == "float32" and has_bias)


def lrn_phase(torch, scratch):
    """K3 at the serving and training shapes against its plain version,
    through its CPython binding (:func:`check_binding`), the form
    ``lrn_fwd_plan`` picked (read from the counters), timed back-to-back,
    cold and on the host beside ``F.local_response_norm``'s same
    three."""
    import torch.nn.functional as F

    from veles_tpu_torch.ops.lrn import (lrn_forward, lrn_forward_plain,
                                         lrn_fwd_plan)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    k, alpha, beta, n = 2.0, 1e-4, 0.75, 5
    for shape in [(m, 56, 56, 96) for m in BUCKETS + (TRAIN_BATCH,)] + \
            [(m, 27, 27, 256) for m in BUCKETS + (TRAIN_BATCH,)]:
        x32 = torch.rand(*shape, device="cuda", generator=gen) * 40.0
        # serving runs float32 at every bucket; bf16 at the full batch;
        # training both at its batch
        for dtype in ("float32", "bfloat16") if shape[0] in (
                64, TRAIN_BATCH) else ("float32",):
            x = x32.to(getattr(torch, dtype))
            variants = dict(lrn_forward.launches_by_variant)
            got = lrn_forward(x, k, alpha, beta, n)
            want = lrn_forward_plain(x, k, alpha, beta, n)
            torch.cuda.synchronize()
            name = "%s %s" % ("x".join(map(str, shape)), dtype)
            ran = launched_variants(lrn_forward, variants)
            plan = lrn_fwd_plan(x.numel() // shape[-1], shape[-1], n,
                                x.dtype)
            if ran != {plan.form: 1}:
                raise AssertionError("lrn_fwd %s: launches by variant %s, "
                                     "planned %s" % (name, ran, plan.form))
            check_binding("lrn_fwd", "veles_lrn_fwd")
            err = check_close("lrn_fwd " + name, got, want,
                              *LRN_TOL[dtype])
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            values = x.numel()
            # per value: square, n-1 adds, alpha/k, rsqrt chain, scale
            bms, by = bound(2 * values * x.element_size(),
                            values * (n + 7), "float32")

            def kernel(x=x):
                return lrn_forward(x, k, alpha, beta, n)

            # torch divides alpha by the window: pass alpha * n
            def library(x_nchw=x_nchw):
                return F.local_response_norm(x_nchw, n, alpha * n, beta, k)

            row = {
                "name": "lrn_fwd", "shape": name, "route": "cuda",
                "_form": (shape, x.dtype),
                "source": LRN_SOURCE, "replaces": LRN_TPU,
                "variant": plan.form, "cpt": plan.cpt,
                "call": "binding " + LRN_BINDING, "max_abs_err": err,
                "tolerance": list(LRN_TOL[dtype]),
                "plain_ms": device_ms(torch, lambda: lrn_forward_plain(
                    x, k, alpha, beta, n)),
                "bound_ms": bms, "bound_by": by}
            row.update(timings(torch, scratch, kernel, library))
            rows.append(row)
    return rows


def check_binding(name, symbol):
    """The wrapper of ``csrc/<name>.cu`` went through its CPython binding:
    the binding is loaded and the C function ``symbol`` was never
    resolved for a ctypes call."""
    from veles_tpu_torch.ops import build
    if name not in build._bindings or symbol in build._functions:
        raise AssertionError("%s did not go through its binding" % name)


def timings(torch, scratch, kernel, library):
    """A kernel's and its library call's times: back-to-back (``ms``),
    one call at a time with its operands out of L2 (``ms_cold``) and on
    the host (``host_us``)."""
    return {"ms": device_ms(torch, kernel),
            "ms_cold": cold_ms(torch, kernel, scratch),
            "host_us": host_us(torch, kernel),
            "library_ms": device_ms(torch, library),
            "library_ms_cold": cold_ms(torch, library, scratch),
            "library_host_us": host_us(torch, library)}


def lrn_bwd_phase(torch, scratch):
    """K4 at the training shapes in float32 and bf16 against its plain
    version, the form ``lrn_bwd_plan`` picked (read from the counters),
    timed as :func:`timings` beside autograd's backward of
    ``F.local_response_norm``."""
    import torch.nn.functional as F

    from veles_tpu_torch.ops.lrn import (lrn_backward, lrn_backward_plain,
                                         lrn_bwd_plan)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    k, alpha, beta, n = 2.0, 1e-4, 0.75, 5
    for shape in ((TRAIN_BATCH, 56, 56, 96), (TRAIN_BATCH, 27, 27, 256)):
        x32 = torch.rand(*shape, device="cuda", generator=gen) * 40.0
        g32 = torch.rand(*shape, device="cuda", generator=gen) * 2 - 1
        for dtype in ("float32", "bfloat16"):
            x, g = x32.to(getattr(torch, dtype)), g32.to(getattr(torch,
                                                                 dtype))
            variants = dict(lrn_backward.launches_by_variant)
            got = lrn_backward(x, g, k, alpha, beta, n)
            want = lrn_backward_plain(x, g, k, alpha, beta, n)
            torch.cuda.synchronize()
            name = "%s %s" % ("x".join(map(str, shape)), dtype)
            ran = launched_variants(lrn_backward, variants)
            plan = lrn_bwd_plan(x.numel() // shape[-1], shape[-1], n,
                                x.dtype)
            if ran != {plan.form: 1}:
                raise AssertionError("lrn_bwd %s: launches by variant %s, "
                                     "planned %s" % (name, ran, plan.form))
            err = check_close("lrn_bwd " + name, got, want, *LRN_TOL[dtype])
            # the library yardstick: autograd's backward of torch's LRN
            # on an NCHW copy (torch divides alpha by the window)
            x_nchw = x.permute(0, 3, 1, 2).contiguous().requires_grad_()
            y_nchw = F.local_response_norm(x_nchw, n, alpha * n, beta, k)
            g_nchw = g.permute(0, 3, 1, 2).contiguous()
            values = x.numel()
            # per value: square, two window sums of n, the power, the
            # quotient and the products of dx
            bms, by = bound(3 * values * x.element_size(),
                            values * (2 * n + 20), "float32")

            def kernel(x=x, g=g):
                return lrn_backward(x, g, k, alpha, beta, n)

            def library(x_nchw=x_nchw, y_nchw=y_nchw, g_nchw=g_nchw):
                return torch.autograd.grad(y_nchw, x_nchw, g_nchw,
                                           retain_graph=True)

            row = {
                "name": "lrn_bwd", "shape": name, "route": "cuda",
                "_form": (shape, x.dtype),
                "source": LRN_BWD_SOURCE, "replaces": LRN_BWD_TPU,
                "variant": plan.form,
                "max_abs_err": err, "tolerance": list(LRN_TOL[dtype]),
                "plain_ms": device_ms(torch, lambda: lrn_backward_plain(
                    x, g, k, alpha, beta, n)),
                "bound_ms": bms, "bound_by": by}
            row.update(timings(torch, scratch, kernel, library))
            rows.append(row)
            del x_nchw, y_nchw, g_nchw, kernel, library
    return rows


def reduce_phase(torch, scratch):
    """K6 at every bias gradient's shape of the training step against its
    plain version, two calls bitwise equal, the form ``column_plan``
    picked (read from the counters), timed as :func:`timings` beside
    ``torch.sum(x.float(), 0)``."""
    from veles_tpu_torch.ops.reduce import (column_plan, column_sum,
                                            column_sum_plain)
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(4)
    for layer, r, c in (REDUCE_SHAPES + BASELINE_REDUCE_SHAPES +
                        SEQUENCE_REDUCE_SHAPES):
        x = torch.randn(r, c, device="cuda", generator=gen) * 1e-3
        variants = dict(column_sum.launches_by_variant)
        got = column_sum(x)
        again = column_sum(x)
        want = column_sum_plain(x)
        torch.cuda.synchronize()
        name = "%s %dx%d float32" % (layer, r, c)
        plan = column_plan(r, c, x.dtype)
        ran = launched_variants(column_sum, variants)
        if ran != {plan.form: 2}:
            raise AssertionError("column_reduce %s: launches by variant %s, "
                                 "planned %s" % (name, ran, plan.form))
        if not torch.equal(got, again):
            raise AssertionError("column_reduce %s: two runs differ" % name)
        err = (got - want).abs()
        if not bool(torch.isfinite(got).all()) or bool(
                (err > REDUCE_REL_TOL * x.abs().sum(0)).any()):
            raise AssertionError(
                "column_reduce %s: max |err| %.3g beyond %g of the column's "
                "sum of |x|" % (name, float(err.max()), REDUCE_REL_TOL))
        bms, by = bound(4 * (r * c + c), r * c, "float32")

        def kernel(x=x):
            return column_sum(x)

        def library(x=x):
            return torch.sum(x.float(), 0)

        row = {
            "name": "column_reduce", "shape": name, "route": "cuda",
            "_form": (r, c, torch.float32),
            "source": REDUCE_SOURCE, "replaces": REDUCE_TPU,
            "variant": plan.form, "chunks": plan.chunks,
            "max_abs_err": float(err.max()),
            "tolerance": "%g of the column's sum of |x|, and bitwise "
                         "repeatable" % REDUCE_REL_TOL,
            "bitwise_repeatable": True,
            "plain_ms": device_ms(torch, lambda: column_sum_plain(x)),
            "bound_ms": bms, "bound_by": by}
        row.update(timings(torch, scratch, kernel, library))
        rows.append(row)
        del x, kernel, library
    return rows


def launched_variants(wrapper, before):
    """{form: launches} of ``wrapper`` since its counts were ``before``."""
    return {v: c - before.get(v, 0)
            for v, c in wrapper.launches_by_variant.items()
            if c != before.get(v, 0)}


def uniform_phase(torch, scratch):
    """K7 bit for bit against its plain version at the dropout masks'
    shape, through its CPython binding (:func:`check_binding`), timed
    back-to-back (``ms``, which reads the host when ``host_us`` exceeds
    the device time), one call at a time (``ms_cold``, the device's
    time) and on the host, beside ``torch.rand``'s same three."""
    from veles_tpu_torch.ops.random import (dropout_offset, uniform_fill,
                                            uniform_fill_plain)
    shape = (TRAIN_BATCH, 4096)
    seed, offset = 0x243F6A8885A308D3, dropout_offset(3, 11)
    got = uniform_fill(shape, seed, offset, device="cuda")
    want = uniform_fill_plain(shape, seed, offset, device="cuda")
    torch.cuda.synchronize()
    name = "%dx%d float32" % shape
    check_binding("uniform_fill", "veles_uniform_fill")
    if not torch.equal(got, want):
        raise AssertionError("uniform_fill %s: %d values differ from the "
                             "plain version's bits" % (
                                 name, int((got != want).sum())))
    gen = torch.Generator(device="cuda").manual_seed(5)
    values = shape[0] * shape[1]
    bms, by = bound(4 * values, values * UNIFORM_OPS_PER_VALUE, "float32")

    # as the trainer calls it: with a tensor's device, card index and all
    device = torch.empty(0, device="cuda").device

    def kernel():
        return uniform_fill(shape, seed, offset, device=device)

    def library():
        return torch.rand(shape, device="cuda", generator=gen)

    return [{
        "name": "uniform_fill", "shape": name, "route": "cuda",
        "_form": shape, "source": UNIFORM_SOURCE, "replaces": UNIFORM_TPU,
        "call": "binding " + UNIFORM_BINDING, "values_differ": 0,
        "max_abs_err": float((got - want).abs().max()),
        "tolerance": "bit-exact",
        "ms": device_ms(torch, kernel),
        "ms_cold": cold_ms(torch, kernel, scratch),
        "host_us": host_us(torch, kernel),
        "plain_ms": device_ms(torch, lambda: uniform_fill_plain(
            shape, seed, offset, device="cuda")),
        "bound_ms": bms, "bound_by": by,
        "library_ms": device_ms(torch, library),
        "library_ms_cold": cold_ms(torch, library, scratch),
        "library_host_us": host_us(torch, library)}]


def kahan_bound(m, k, n, bk, element_size):
    """K5's bound: the larger of the bytes time (operands read once, the
    float32 output written once) and the least operations time of a
    float32-accurate product. For float32 operands that is the lesser of
    2MNK plus 4 compensating operations per output and block on the CUDA
    cores, and 3xTF32's 3 * 2MNK on the tensor cores; for bf16 operands
    one bf16 product. Returns (ms, by, {the three times})."""
    ms_bytes = ((m * k + k * n) * element_size + 4 * m * n) / \
        HBM_BYTES_PER_S * 1e3
    if element_size == 2:
        ms_ops = 2 * m * n * k / PEAK_OPS["bfloat16"] * 1e3
        three = {"bytes": ms_bytes, "bf16_tensor_cores": ms_ops}
    else:
        simt = (2 * m * n * k + 4 * m * n * -(-k // bk)) / \
            PEAK_OPS["float32"] * 1e3
        tf32x3 = 3 * 2 * m * n * k / PEAK_OPS["tf32"] * 1e3
        ms_ops = min(simt, tf32x3)
        three = {"bytes": ms_bytes, "cuda_cores": simt,
                 "tf32x3_tensor_cores": tf32x3}
    if ms_bytes >= ms_ops:
        return ms_bytes, "bytes", three
    return ms_ops, "operations", three


def kahan_phase(torch, scratch):
    """K5 against ``kahan_matmul_plain`` with the same block depth
    (``min(512, K)``), at the disciplines bench's five shapes in float32
    and at fc6's forward with bf16 operands: the form and split count
    that ran (read from the counters, held against ``kahan_plan``), two
    calls bitwise equal, and its times warm, cold and on the host beside
    the plain loop's, the library call's and :func:`kahan_bound`.
    Library call: one float32 ``torch.matmul`` with TF32 off, the
    uncompensated product."""
    from veles_tpu_torch.ops.gemm import (KAHAN_BK, full_float32,
                                          kahan_gemm, kahan_matmul_plain,
                                          kahan_plan)
    from veles_tpu_torch.ops.gemm_bench import SHAPES
    cases = [(dims, "float32") for _, dims in SHAPES]
    cases.insert(2, (SHAPES[1][1], "bfloat16"))
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(6)
    for (m, k, n), dtype in cases:
        dt = getattr(torch, dtype)
        a = (torch.rand(m, k, device="cuda", generator=gen) - 0.5).to(dt)
        b = (torch.rand(k, n, device="cuda", generator=gen) - 0.5).to(dt)
        bk = min(KAHAN_BK, k)
        name = "%dx%d @ %dx%d %s bk=%d" % (m, k, k, n, dtype, bk)
        variants = dict(kahan_gemm.launches_by_variant)
        got = kahan_gemm(a, b, bk)
        again = kahan_gemm(a, b, bk)
        want = kahan_matmul_plain(a, b, bk)
        torch.cuda.synchronize()
        ran = {v: c - variants.get(v, 0)
               for v, c in kahan_gemm.launches_by_variant.items()
               if c != variants.get(v, 0)}
        plan = kahan_plan(m, n, k, bk, dt)
        if ran != {plan.form: 2}:
            raise AssertionError("kahan_gemm %s: launches by variant %s, "
                                 "planned %s" % (name, ran, plan.form))
        if not torch.equal(got, again):
            raise AssertionError("kahan_gemm %s: two calls differ in %d "
                                 "outputs" % (name,
                                              int((got != again).sum())))
        err = check_close("kahan_gemm " + name, got, want,
                          *GEMM_TOL["float32"])
        a32, b32 = a.float(), b.float()

        def library():
            with full_float32():
                return torch.matmul(a32, b32)

        def kernel():
            return kahan_gemm(a, b, bk)

        bms, by, three = kahan_bound(m, k, n, bk, a.element_size())
        rows.append({
            "name": "kahan_gemm", "shape": name,
            "_form": (m, k, n, dt, bk),
            "route": "cuda", "source": KAHAN_SOURCE, "replaces": KAHAN_TPU,
            "variant": plan.form, "splits": plan.splits,
            "max_abs_err": err, "tolerance": list(GEMM_TOL["float32"]),
            "bitwise_repeatable": True,
            "ms": device_ms(torch, kernel),
            "ms_cold": cold_ms(torch, kernel, scratch),
            "host_us": host_us(torch, kernel),
            "plain_ms": device_ms(torch, lambda: kahan_matmul_plain(
                a, b, bk)),
            "bound_ms": bms, "bound_by": by, "bound_ms_each": three,
            "library": "torch.matmul float32, TF32 off (uncompensated)",
            "library_ms": device_ms(torch, library),
            "library_ms_cold": cold_ms(torch, library, scratch)})
        del a, b, a32, b32, got, again, want
    return rows


#: the K5 split sweep: (name, m, k, n, dtype) at each of these counts and
#: the plan's own
KAHAN_SWEEP_SPLITS = (1, 2, 3, 4, 6, 9, 18)
KAHAN_SWEEP_SHAPES = (("fc6 fwd float32", 128, 9216, 4096, "float32"),
                      ("1500^3 float32", 1500, 1500, 1500, "float32"),
                      ("fc6 fwd bfloat16", 128, 9216, 4096, "bfloat16"))


def kahan_sweep(torch):
    """The evidence for ``kahan_plan``'s split counts: K5 at
    ``min(512, K)``-deep blocks timed back-to-back at each count of
    :data:`KAHAN_SWEEP_SPLITS` (cut to whole blocks) and at the plan's
    own, beside the plan's modelled time (``_kahan_us``)."""
    from veles_tpu_torch.ops.gemm import _kahan_us, kahan_gemm, kahan_plan
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for name, m, k, n, dtype in KAHAN_SWEEP_SHAPES:
        dt = getattr(torch, dtype)
        a = (torch.rand(m, k, device="cuda", generator=gen) - 0.5).to(dt)
        b = (torch.rand(k, n, device="cuda", generator=gen) - 0.5).to(dt)
        bk = min(512, k)
        chosen = kahan_plan(m, n, k, bk, dt)
        row = {"shape": name, "form": chosen.form,
               "plan_splits": chosen.splits, "ms": {}, "model_us": {}}
        for want in sorted(set(KAHAN_SWEEP_SPLITS) | {chosen.splits}):
            plan = kahan_plan(m, n, k, bk, dt, True, want)
            if plan.splits in row["ms"]:
                continue
            row["ms"][plan.splits] = device_ms(
                torch, lambda: kahan_gemm(a, b, bk, splits=want))
            row["model_us"][plan.splits] = _kahan_us(
                m, n, k, bk, dt, plan.blocks_per_split)
        print("kahan split sweep %s (plan %d): %s" % (
            name, chosen.splits, ", ".join(
                "%d: %.4f ms (model %.1f us)" % (sp, ms, row["model_us"][sp])
                for sp, ms in sorted(row["ms"].items()))))
        rows.append(row)
        del a, b
    return rows


def not_ported():
    """The TPU kernels without a Hopper counterpart: none is left."""
    return []


def error_share(torch, got, ref, scale):
    """max |got - ref| / (|a| @ |b|), in float64."""
    return float(((got.double() - ref).abs() / scale).max())


def hostile_check(torch):
    """(b): K5 with 64-deep Kahan blocks against K5 with one K-deep
    block on ``tests/test_ops.py``'s hostile input, at 256 rows (at its
    4 rows every method lands within 2 float32 ulps of the others, and
    the maximum cannot rank them), with magnitudes rising along K as
    there, and falling. Falling is the gate: each small block joins a
    large sum, and 64-deep blocks must be better by
    ``HOSTILE_FALLING_GAIN``. Rising is printed only: the kernel's
    16-deep sub-sums already take most of the compensation's gain, and
    both errors sit within a few float32 ulps of outputs ~4.9e8, so
    their ratio is rounding noise. The plain loop's errors are printed
    beside."""
    from veles_tpu_torch.ops.gemm import kahan_gemm, kahan_matmul_plain
    from veles_tpu_torch.ops.gemm_bench import hostile_input
    out = {}
    for order in ("rising", "falling"):
        a, b, exact = hostile_input(falling=order == "falling")
        exact = torch.from_numpy(exact).cuda()
        ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
        k = a.shape[1]

        def err(x):
            return float((x.double() - exact).abs().max())

        e = {"kernel_bk64": err(kahan_gemm(ta, tb, 64)),
             "kernel_one_block": err(kahan_gemm(ta, tb, k)),
             "plain_bk64": err(kahan_matmul_plain(ta, tb, 64)),
             "plain_one_block": err(kahan_matmul_plain(ta, tb, k))}
        e["one_block_over_bk64"] = e["kernel_one_block"] / max(
            e["kernel_bk64"], 1e-300)
        out[order] = e
    print("disciplines (b): hostile input, max |err| vs float64: %s" % out)
    gain = {order: e["one_block_over_bk64"] for order, e in out.items()}
    if gain["falling"] < HOSTILE_FALLING_GAIN:
        raise AssertionError(
            "hostile input: one K-deep block over 64-deep Kahan blocks %s "
            "(need >= %g falling)" % (gain, HOSTILE_FALLING_GAIN))
    return out


def tf32_check(torch):
    """(c) with TF32 on for the process: levels 0, 1 (K5, whose 3xTF32
    products would read ~5e-4 had they dropped to one TF32 product) and
    2 at fc6's forward shape still within ``FP32_SHARE_TOL``; the
    control, a plain matmul under the same switch, must exceed it."""
    from veles_tpu_torch.ops.gemm import gemm
    gen = torch.Generator(device="cuda").manual_seed(7)
    m, k, n = TRAIN_BATCH, 9216, 4096
    a = torch.rand(m, k, device="cuda", generator=gen) - 0.5
    b = torch.rand(k, n, device="cuda", generator=gen) - 0.5
    ref = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        got = {"level0": gemm(a, b, precision_level=0),
               "level1": gemm(a, b, precision_level=1),
               "level2": gemm(a, b, precision_level=2),
               "control_tf32_matmul": torch.matmul(a, b)}
        torch.cuda.synchronize()
    finally:
        matmul.allow_tf32 = saved
    shares = {key: error_share(torch, x, ref, scale)
              for key, x in got.items()}
    print("disciplines (c): with allow_tf32 on, error share of |a|@|b| "
          "vs float64: %s (limit %g; the control must exceed it)" % (
              shares, FP32_SHARE_TOL))
    if max(shares["level0"], shares["level1"],
           shares["level2"]) > FP32_SHARE_TOL:
        raise AssertionError("gemm() under allow_tf32 is not full float32: "
                             "%s" % shares)
    if shares["control_tf32_matmul"] <= FP32_SHARE_TOL:
        raise AssertionError("control: a TF32 matmul passes the float32 "
                             "limit (%s): the check cannot see TF32" % shares)
    return shares


def disciplines_phase(torch, numpy, card):
    """The GEMM-disciplines path with the counts from 0, then checks
    (a)-(c). Returns (result, launches_by_form)."""
    from veles_tpu_torch.ops.gemm_bench import format_table, gemm_bench
    reset_counts()
    t0 = time.perf_counter()
    rows = gemm_bench("cuda")
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    counts, by_form = read_counts()
    variants = gemm_variants()
    from veles_tpu_torch.ops.gemm import kahan_gemm
    kahan_variants = {v: c for v, c in kahan_gemm.launches_by_variant.items()
                      if c}
    print(format_table(rows, card + ", times by CUDA events"))
    if not (counts["kahan_gemm"] and counts["gemm_bias_act"]) or any(
            n for name, n in counts.items()
            if name not in ("kahan_gemm", "gemm_bias_act")):
        raise AssertionError("disciplines launch counts %s (expected K5 and "
                             "K2 only)" % counts)
    ratios, shares = {}, {}
    for row in rows:
        err = row["err"]
        ratios[row["name"]] = err["level1"] / max(err["kahan_loop"], 1e-300)
        shares[row["name"]] = {lv: row["share"][lv]
                               for lv in ("level0", "level1", "level2")}
    print("disciplines (a): level 1 / plain loop max |err| vs float64: %s "
          "(limit %g)" % (ratios, KAHAN_ERR_RATIO))
    if max(ratios.values()) > KAHAN_ERR_RATIO:
        raise AssertionError("level 1 (K5) less accurate than the plain "
                             "Kahan loop: %s" % ratios)
    print("disciplines (c): error share of |a|@|b| vs float64: %s (limit %g "
          "for levels 0, 1 and 2)" % (shares, FP32_SHARE_TOL))
    if max(max(s.values()) for s in shares.values()) > FP32_SHARE_TOL:
        raise AssertionError("a float32 level errs beyond float32: %s"
                             % shares)
    print("disciplines (d): kahan_gemm launches by variant %s"
          % kahan_variants)
    if set(kahan_variants) != {"mma"}:
        raise AssertionError("disciplines: kahan_gemm launches by variant %s "
                             "(all must be mma)" % kahan_variants)
    result = {"bench_s": bench_s, "launches": counts,
              "gemm_variants": variants, "kahan_variants": kahan_variants,
              "rows": rows,
              "level1_over_loop_err": ratios,
              "hostile": hostile_check(torch),
              "tf32": tf32_check(torch)}
    return result, by_form


def post(port, path, body):
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (port, path), data=body,
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        if resp.status != 200:
            raise AssertionError("HTTP %d from %s" % (resp.status, path))
        return json.loads(resp.read())


def slice_phase(torch, numpy):
    from veles_tpu_torch.models.alexnet import (ALEXNET_LAYERS,
                                                ALEXNET_SAMPLE_SHAPE)
    from veles_tpu_torch.serving.model_store import ServeableModel

    t0 = time.perf_counter()
    model = ServeableModel.from_layers(
        ALEXNET_LAYERS, ALEXNET_SAMPLE_SHAPE, seed=42, policy="float32",
        device="cuda", name="alexnet227")
    build_s = time.perf_counter() - t0
    print("slice: AlexNet-227 float32 built in %.2f s" % build_s)
    result, by_form = serve_alexnet(torch, numpy, model, "slice", rounds=3)
    return model, result, by_form


def serve_alexnet(torch, numpy, model, label, rounds):
    """AlexNet-227 ``model`` behind ``ServingFrontend`` (one replica, max
    batch 64): ``rounds`` of 16 concurrent single requests and one 64-row
    batch request over HTTP, every reply held to the plain forward on the
    card by the centred-logit check, with a reply swap and fc7's output
    zeroed as the controls that must fail it; K1 and K3 twice per
    forward, no training kernel. Returns (result, launches_by_form)."""
    from veles_tpu_torch.models.alexnet import ALEXNET_SAMPLE_SHAPE
    from veles_tpu_torch.models.build import plain_forward
    from veles_tpu_torch.nn.all2all import All2AllStrictRELU
    from veles_tpu_torch.serving.frontend import (ServingFrontend,
                                                  parse_payload)

    t0 = time.perf_counter()
    frontend = ServingFrontend(model, host="127.0.0.1", port=0,
                               replicas=1, max_batch_size=64,
                               batch_timeout_ms=5.0, max_queue=256,
                               response_timeout=300.0)
    warm_s = time.perf_counter() - t0
    print("%s: replica warmed (buckets %s) in %.2f s" % (
        label, frontend.pool.replicas[0].warmed_buckets, warm_s))
    rng = numpy.random.RandomState(0)
    n_single = 16
    singles = rng.uniform(-1, 1, (rounds, n_single) + ALEXNET_SAMPLE_SHAPE
                          ).astype(numpy.float32)
    batch = rng.uniform(-1, 1, (64,) + ALEXNET_SAMPLE_SHAPE).astype(
        numpy.float32)
    single_bodies = [[json.dumps({"input": s.tolist(), "codec": "list",
                                  "id": i}).encode()
                      for i, s in enumerate(r)] for r in singles]
    batch_body = b64_body(batch)
    # host cost of decoding one request body, the frontend's first step
    decode_ms = {}
    for key, body in (("decode_single_ms", single_bodies[0][0]),
                      ("decode_batch64_ms", batch_body)):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            data, error = parse_payload(json.loads(body))
            times.append(1e3 * (time.perf_counter() - t))
            if error is not None:
                raise AssertionError(error)
        decode_ms[key] = statistics.median(times)
    frontend.start()
    try:
        replica = frontend.pool.replicas[0]
        forwards0 = replica.batches_done
        reset_counts()
        latencies, replies, round_s = [], {}, []
        for r in range(rounds):
            got, lat, wall = concurrent_posts(frontend.port,
                                              single_bodies[r])
            replies.update({(r, i): reply for i, reply in enumerate(got)})
            latencies += lat
            round_s.append(wall)
        t = time.perf_counter()
        batch_reply = post(frontend.port, "/api/batch", batch_body)
        batch_s = time.perf_counter() - t
        counts, by_form = read_counts()
        variants = gemm_variants()
        lrn_forms = check_designed_forms(label, ("lrn_fwd",))
        forwards = replica.batches_done - forwards0
    finally:
        frontend.stop()
    k1, k3 = counts["gemm_bias_act"], counts["lrn_fwd"]
    if forwards < 1 or k1 != 2 * forwards or k3 != 2 * forwards or \
            counts["lrn_bwd"] or counts["column_reduce"] or \
            counts["uniform_fill"] or counts["kahan_gemm"]:
        raise AssertionError(
            "serving launch counts %s over %d forwards (expected "
            "gemm_bias_act and lrn_fwd 2 each per forward, no training "
            "kernel)" % (counts, forwards))
    print("%s: %d forwards served, gemm_bias_act launched %d times, "
          "lrn_fwd %d times (2 each per forward)" % (label, forwards, k1,
                                                     k3))

    # hold every reply against the plain-version forward on the card
    served = numpy.concatenate(
        [numpy.array([replies[(r, i)]["result"] for i in range(n_single)])
         for r in range(rounds)] + [numpy.array(batch_reply["results"])])
    inputs = numpy.concatenate([singles.reshape(
        (-1,) + ALEXNET_SAMPLE_SHAPE), batch])
    want = forward_rows(torch, numpy, lambda x: plain_forward(
        model.module, x), inputs)
    if served.shape != (len(inputs), 1000) or \
            not numpy.isfinite(served).all():
        raise AssertionError("replies: shape %s, finite %s" % (
            served.shape, numpy.isfinite(served).all()))
    err = float(numpy.abs(served - want).max())
    if err > PROBS_ATOL:
        raise AssertionError("served probabilities differ from the plain "
                             "forward by %.3g > %g" % (err, PROBS_ATOL))
    row_err = float(numpy.abs(served.sum(axis=1) - 1.0).max())
    if row_err > 1e-4:
        raise AssertionError("rows sum to 1 only within %.3g" % row_err)
    logit_err, spread = reply_mismatch(numpy, served, want)
    if logit_err > LOGIT_REL_TOL * spread:
        raise AssertionError(
            "served centred logits differ from the plain forward's by %.3g, "
            "%.3g of their input-dependent spread %.3g (limit %g)" % (
                logit_err, logit_err / spread, spread, LOGIT_REL_TOL))
    # controls that the same check must fail: two replies swapped, and
    # the kernel forward with fc7's output zeroed
    swapped = served.copy()
    swapped[[0, 1]] = served[[1, 0]]
    fc7 = [i for i, m in enumerate(model.module)
           if isinstance(m, All2AllStrictRELU)][-1]
    zeroed = forward_rows(torch, numpy, lambda x: forward_zeroing(
        model.module, x, fc7), inputs)
    controls = {}
    for control, bad in (("swapped", swapped), ("fc7_zeroed", zeroed)):
        bad_err, _ = reply_mismatch(numpy, bad, want)
        controls[control] = bad_err / spread
        if bad_err <= LOGIT_REL_TOL * spread:
            raise AssertionError(
                "control %s passes the reply check (%.3g of the spread): "
                "the check cannot see a wrong reply" % (
                    control, bad_err / spread))
    print("%s: %d replies match the plain-version forward: probabilities "
          "max |err| %.3g <= %g, rows sum to 1 within %.3g; centred logits "
          "max |err| %.3g = %.3g of their input-dependent spread %.3g "
          "(limit %g); controls read %s of the spread and fail" % (
              label, len(served), err, PROBS_ATOL, row_err, logit_err,
              logit_err / spread, spread, LOGIT_REL_TOL,
              ", ".join("%s %.3g" % kv for kv in sorted(controls.items()))))
    lat = sorted(latencies)
    result = {
        "requests": len(lat) + 1, "concurrent": n_single,
        "single_p50_ms": 1e3 * statistics.median(lat),
        "single_p95_ms": 1e3 * lat[min(len(lat) - 1,
                                       int(0.95 * len(lat)))],
        "single_samples_per_s": n_single * rounds / sum(round_s),
        "batch64_ms": 1e3 * batch_s,
        "batch64_samples_per_s": 64 / batch_s,
        "forwards": forwards, "gemm_variants": variants,
        "lrn_fwd_forms": lrn_forms["lrn_fwd"],
        "centred_logit_err": logit_err, "centred_logit_spread": spread,
        "control_swapped_share": controls["swapped"],
        "control_fc7_zeroed_share": controls["fc7_zeroed"],
    }
    result.update(decode_ms)
    return result, by_form


def forward_rows(torch, numpy, forward, inputs):
    """``forward`` over ``inputs`` in 64-row chunks on the card, as
    float32 numpy rows."""
    out = []
    with torch.inference_mode():
        for start in range(0, len(inputs), 64):
            x = torch.from_numpy(inputs[start:start + 64]).cuda()
            out.append(forward(x).float().cpu().numpy())
    return numpy.concatenate(out)


def forward_zeroing(model, x, index):
    """The kernel forward with module ``index``'s output set to 0."""
    for i, module in enumerate(model):
        x = module(x)
        if i == index:
            x = x.new_zeros(x.shape)
    return x


def reply_mismatch(numpy, probs, want):
    """(max |err|, spread) of the centred logits, log p minus its row
    mean, of ``probs`` against ``want``'s. Under the filler's small
    weights the 1000-class softmax is almost flat, so the part of a
    reply that depends on its input moves p by a few e-6 only; in log
    space that part is the logits' own, and the spread is its largest
    value: the largest deviation of a reply's centred logits from their
    mean over all replies."""
    def centred(p):
        z = numpy.log(numpy.asarray(p, numpy.float64))
        return z - z.mean(axis=1, keepdims=True)
    got, ref = centred(probs), centred(want)
    spread = float(numpy.abs(ref - ref.mean(axis=0, keepdims=True)).max())
    return float(numpy.abs(got - ref).max()), spread


def forward_phase(torch, model):
    """Device time of one forward through the kernels and through the
    plain versions, at batch 1 and 64; device time by kernel."""
    from veles_tpu_torch.models.build import plain_forward
    out = {}
    with torch.inference_mode():
        for b in (1, 64):
            x = torch.rand((b,) + model.sample_shape, device="cuda") * 2 - 1
            out["forward_b%d_ms" % b] = device_ms(
                torch, lambda: model.module(x), trials=3, per_trial=5)
            out["plain_forward_b%d_ms" % b] = device_ms(
                torch, lambda: plain_forward(model.module, x), trials=3,
                per_trial=5)
        from torch.profiler import ProfilerActivity, profile
        x = torch.rand((64,) + model.sample_shape, device="cuda")
        model.module(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.module(x)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=20))
    return out


def kernel_counters():
    """{kernel name: its wrapper}, each wrapper carrying ``launches``
    and ``launches_by_form``."""
    from veles_tpu_torch.ops.gemm import kahan_gemm, linear_act
    from veles_tpu_torch.ops.lrn import lrn_backward, lrn_forward
    from veles_tpu_torch.ops.random import uniform_fill
    from veles_tpu_torch.ops.reduce import column_sum
    return {"gemm_bias_act": linear_act, "lrn_fwd": lrn_forward,
            "lrn_bwd": lrn_backward, "column_reduce": column_sum,
            "uniform_fill": uniform_fill, "kahan_gemm": kahan_gemm}


def reset_counts():
    for fn in kernel_counters().values():
        fn.launches = 0
        fn.launches_by_form.clear()
    for fn in variant_counters().values():
        fn.launches_by_variant.clear()


def variant_counters():
    """{kernel name: its wrapper} for the kernels with more than one form,
    each wrapper carrying ``launches_by_variant``."""
    from veles_tpu_torch.ops.gemm import kahan_gemm, linear_act
    from veles_tpu_torch.ops.lrn import lrn_backward, lrn_forward
    from veles_tpu_torch.ops.reduce import column_sum
    return {"gemm_bias_act": linear_act, "kahan_gemm": kahan_gemm,
            "lrn_fwd": lrn_forward, "lrn_bwd": lrn_backward,
            "column_reduce": column_sum}


def read_counts():
    """({name: launches}, {name: {form: launches}})."""
    counters = kernel_counters()
    return ({name: fn.launches for name, fn in counters.items()},
            {name: dict(fn.launches_by_form)
             for name, fn in counters.items()})


def gemm_variants():
    """K1/K2 launches by variant since the last :func:`reset_counts`."""
    from veles_tpu_torch.ops.gemm import linear_act
    return dict(linear_act.launches_by_variant)


#: the designed forms of K3, K4 and K6; K3's and K4's ``general`` forms
#: are the shared-memory kernels, kept for shapes the vector forms do not
#: take
DESIGNED_FORMS = {"lrn_fwd": {"vector"}, "lrn_bwd": {"vector"},
                  "column_reduce": {"single", "chunked"}}


def check_designed_forms(phase, names=tuple(sorted(DESIGNED_FORMS))):
    """Every launch of ``phase`` (since the last :func:`reset_counts`)
    of each kernel of ``names`` (K3, K4 and K6 by default) ran a designed
    form, and each was launched; returns their counts by form."""
    counters = variant_counters()
    ran = {}
    for name in names:
        designed = DESIGNED_FORMS[name]
        ran[name] = {v: c for v, c in
                     counters[name].launches_by_variant.items() if c}
        off = {v: c for v, c in ran[name].items() if v not in designed}
        if off or not ran[name]:
            raise AssertionError("%s: %s launches by form %s (all must be "
                                 "%s)" % (phase, name, ran[name],
                                          sorted(designed)))
    print("%s: launches by form %s" % (phase, ran))
    return ran


def check_forms(phase, kernels, by_form):
    """Every launch of ``phase`` fell on a form the kernel phase
    checked."""
    for name, counts in sorted(by_form.items()):
        checked = {row["_form"] for row in kernels if row["name"] == name}
        missing = {form: n for form, n in counts.items()
                   if form not in checked}
        if missing:
            raise AssertionError(
                "%s: %d of %d %s launches at forms the kernel phase did not "
                "check: %s" % (phase, sum(missing.values()),
                               sum(counts.values()), name, missing))


def check_designed(phase, variants):
    """Every K1/K2 launch of ``phase`` ran one of the three designed forms
    of ``csrc/gemm_bias_act.cu``, never its general variant."""
    from veles_tpu_torch.ops.gemm import FORMS
    designed = set(FORMS) - {"general"}
    off = {v: c for v, c in variants.items() if v not in designed and c}
    if off or not sum(variants.values()):
        raise AssertionError("%s: gemm_bias_act launches by variant %s (all "
                             "must be %s)" % (phase, variants,
                                              sorted(designed)))
    print("%s: gemm_bias_act launches by variant %s" % (phase, variants))


def model_train_flops_per_sample(model):
    """``bench.py``'s accounting: 3x the forward FLOPs of the
    convolutions and the fully-connected layers (forward, data
    gradient, weight gradient); LRN, pooling, dropout and activations
    count nothing."""
    from veles_tpu_torch.nn.all2all import All2All
    from veles_tpu_torch.nn.conv import Conv
    total = 0.0
    for module in model:
        if isinstance(module, Conv):
            cout, cin, ky, kx = module.weights.shape
            h, w, _ = module.output_shape()
            total += 2.0 * h * w * ky * kx * cin * cout * 3.0
        elif isinstance(module, All2All):
            fin, fout = module.jax_weights_shape()
            total += 2.0 * fin * fout * 3.0
    return total


def gradient_copies(trainer):
    return [{k: p.grad.detach().clone() for k, p in layer.items()}
            for layer in trainer.params]


def gradient_shares(got, want):
    """{(layer, name): ||got - want|| / ||want||} over the layers'
    weight and bias gradients."""
    return {(i, k): float((g[k] - w[k]).norm() / w[k].norm())
            for i, (g, w) in enumerate(zip(got, want)) for k in w}


def step_check(torch, trainer, name, zeroed, reruns=()):
    """One float32 step's loss and per-layer gradients through the kernels
    against the same step through the plain versions (cuDNN
    deterministic), and the controls that must fail the same check: layer
    ``zeroed``'s bias gradient zeroed, and each ``(label, fn)`` of
    ``reruns``, where ``fn(run)`` takes the kernels' step again under a
    change (``run(plain=False, seed=CHECK_SEED)`` takes one step and
    returns its loss and gradients)."""
    from veles_tpu_torch.loader.base import TRAIN
    idx = torch.from_numpy(trainer._segment_indices(TRAIN)[0]).cuda()

    def run(plain=False, seed=CHECK_SEED):
        trainer.plain = plain
        loss, _ = trainer.gradients(idx, 0, seed)
        return float(loss), gradient_copies(trainer)

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        loss, got = run()
        want_loss, want = run(plain=True)
        reran = {label: fn(run)[1] for label, fn in reruns}
    finally:
        trainer.plain = False
        torch.backends.cudnn.deterministic = saved
        for layer in trainer.params:
            for p in layer.values():
                p.grad = None
    shares = gradient_shares(got, want)
    worst = max(shares.values())
    loss_err = abs(loss - want_loss) / abs(want_loss)
    if not all(torch.isfinite(t).all() for layer in got
               for t in layer.values()) or not math.isfinite(loss):
        raise AssertionError("%s step: non-finite loss or gradient" % name)
    if worst > GRAD_SHARE_TOL or loss_err > LOSS_REL_TOL:
        raise AssertionError(
            "%s step through the kernels differs from the plain versions: "
            "worst gradient share %.3g (limit %g) at %s, loss %.3g relative "
            "(limit %g)" % (name, worst, GRAD_SHARE_TOL,
                            max(shares, key=shares.get), loss_err,
                            LOSS_REL_TOL))
    broken = [dict(layer) for layer in got]
    broken[zeroed]["bias"] = torch.zeros_like(got[zeroed]["bias"])
    controls = {"layer_%d_bias_zeroed" % zeroed: max(gradient_shares(
        broken, want).values())}
    controls.update({label: max(gradient_shares(grads, want).values())
                     for label, grads in reran.items()})
    for label, share in controls.items():
        if share <= GRAD_SHARE_TOL:
            raise AssertionError(
                "%s control %s passes the step check (worst share %.3g): the "
                "check cannot see a wrong gradient" % (name, label, share))
    print("%s check: one float32 step through the kernels vs the plain "
          "versions: loss %.7f vs %.7f (%.3g relative, limit %g); gradient "
          "shares %s (limit %g); controls %s fail it" % (
              name, loss, want_loss, loss_err, LOSS_REL_TOL,
              ", ".join("%d.%s %.2g" % (i, k[0], v)
                        for (i, k), v in sorted(shares.items())),
              GRAD_SHARE_TOL,
              ", ".join("%s %.3g" % kv for kv in sorted(controls.items()))))
    return {"check_loss_rel_err": loss_err, "check_worst_grad_share": worst,
            "controls": controls}


def backends_check(torch, trainer):
    """One float32 step taken with TF32 and bf16 reduced-precision
    reductions switched on by the caller gives the loss and gradients of
    the step with them off, bit for bit (cuDNN deterministic): the
    trainer holds its policy's switches around the step. The control, the
    same step with the trainer's guard taken out, must differ."""
    import contextlib

    from veles_tpu_torch.loader.base import TRAIN
    idx = torch.from_numpy(trainer._segment_indices(TRAIN)[0]).cuda()
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    names = ((matmul, "allow_tf32"),
             (matmul, "allow_bf16_reduced_precision_reduction"),
             (cudnn, "allow_tf32"))
    saved = [getattr(o, a) for o, a in names]
    saved_deterministic = cudnn.deterministic
    policy = trainer.policy

    class Unguarded(object):
        def backends(self):
            return contextlib.nullcontext()

    runs = {}
    try:
        cudnn.deterministic = True
        for label, on, guard in (("off", False, policy), ("on", True, policy),
                                 ("control_unguarded", True, Unguarded())):
            for o, a in names:
                setattr(o, a, on)
            trainer.policy = guard
            loss, _ = trainer.gradients(idx, 0, CHECK_SEED)
            runs[label] = (float(loss), gradient_copies(trainer))
            if [getattr(o, a) for o, a in names] != [on] * len(names):
                raise AssertionError("backends check: the caller's switches "
                                     "were not restored")
    finally:
        trainer.policy = policy
        for (o, a), v in zip(names, saved):
            setattr(o, a, v)
        cudnn.deterministic = saved_deterministic
        for layer in trainer.params:
            for p in layer.values():
                p.grad = None

    def differing(label):
        return sum(int((g[k] != w[k]).sum()) for g, w in
                   zip(runs[label][1], runs["off"][1]) for k in w) + int(
            runs[label][0] != runs["off"][0])

    on, control = differing("on"), differing("control_unguarded")
    print("backends check: a float32 step with TF32 and bf16 reductions "
          "switched on by the caller differs from the step with them off in "
          "%d values (loss and gradients; must be 0); without the trainer's "
          "guard in %d (must be > 0)" % (on, control))
    if on:
        raise AssertionError("backends check: %d values of the step differ "
                             "with the caller's switches on" % on)
    if not control:
        raise AssertionError("backends control: the step without the guard "
                             "matches too: the check cannot see TF32")
    return {"backends_differing_values": on,
            "control_unguarded_differing_values": control}


def pool_flips(torch, trainer, idx):
    """{pool layer: windows whose argmax differs} between the forward
    through the kernels and through the plain versions, on the layers
    before the first dropout."""
    import torch.nn.functional as F

    from veles_tpu_torch.nn.dropout import DropoutForward
    from veles_tpu_torch.nn.pooling import MaxPooling
    x, _, _ = trainer.loader.gather(idx)
    flips = {}
    with torch.no_grad():
        a = b = x
        for i, module in enumerate(trainer.forwards):
            if isinstance(module, DropoutForward):
                break
            if isinstance(module, MaxPooling):
                picks = [F.max_pool2d(v.permute(0, 3, 1, 2).float(),
                                      (module.ky, module.kx), module.stride,
                                      return_indices=True)[1]
                         for v in (a, b)]
                flips[i] = "%d of %d" % (int((picks[0] != picks[1]).sum()),
                                         picks[0].numel())
            a, b = module(a), module.plain_forward(b)
    return flips


def device_time_split(torch, prof):
    """Device time (ms) of the profiled kernels by group: the port's
    five kernels, cuDNN's convolutions (FFT and layout helpers
    included), library GEMMs, pooling, elementwise kernels (casts,
    activations, dropout, the SGD update), the rest."""
    from torch.autograd import DeviceType
    groups = (("K1 gemm_bias_act", ("gemm_bias_act",)),
              ("K3 lrn_fwd", ("lrn_fwd",)), ("K4 lrn_bwd", ("lrn_bwd",)),
              ("K6 column_reduce", ("column_sum_kernel",)),
              ("K7 uniform_fill", ("uniform_fill",)),
              ("convolutions", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                                "implicit", "fft", "flip_filter", "cf32",
                                "nchwtonhwc", "nhwctonchw")),
              ("library GEMMs", ("gemm", "gemv", "nvjet")),
              ("pooling", ("max_pool",)),
              ("elementwise", ("elementwise",)))
    split = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        lower = evt.key.lower()
        group = next((g for g, marks in groups
                      if any(mark in lower for mark in marks)), "other")
        split[group] = split.get(group, 0.0) + us / 1e3
    return split


@contextlib.contextmanager
def timed_calls(torch, owner, attr):
    """Times each call of ``owner.attr`` by CUDA events while inside;
    yields the list of (start, end) events."""
    fn = getattr(owner, attr)
    timed = []

    def timed_fn(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args)
        end.record()
        timed.append((start, end))
        return out

    setattr(owner, attr, timed_fn)
    try:
        yield timed
    finally:
        delattr(owner, attr)


def profiled_step(torch, trainer):
    """(profile, wall ms) of one training step after a warm one."""
    from torch.profiler import ProfilerActivity, profile

    from veles_tpu_torch.loader.base import TRAIN
    idx = torch.from_numpy(trainer._segment_indices(TRAIN)[0]).cuda()
    trainer.train_batch(idx, 0, CHECK_SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.train_batch(idx, 0, CHECK_SEED)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    return prof, wall_ms


def training_phase(torch, policy, check):
    """Full-width AlexNet-227 trained on the card under ``policy``:
    (a) the step check when ``check``, (b) ``TRAIN_EPOCHS`` epochs,
    (c) launch counts, (d) one profiled step. Returns (result,
    launches_by_form)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.base import TRAIN, VALIDATION
    from veles_tpu_torch.models.alexnet import (ALEXNET_LAYERS,
                                                ALEXNET_SAMPLE_SHAPE,
                                                ALEXNET_TRAINING,
                                                SyntheticImageLoader)
    from veles_tpu_torch.models.build import build_training
    from veles_tpu_torch.nn.all2all import (All2All, All2AllSoftmax,
                                            All2AllStrictRELU)
    from veles_tpu_torch.nn.dropout import DropoutForward
    from veles_tpu_torch.nn.normalization import LRNormalizerForward

    prng.get().seed(42)
    prng.get("loader").seed(43)
    t0 = time.perf_counter()
    loader = SyntheticImageLoader(
        n_train=TRAIN_SAMPLES, n_valid=TRAIN_BATCH,
        side=ALEXNET_SAMPLE_SHAPE[0], n_classes=1000,
        minibatch_size=TRAIN_BATCH, dtype="bfloat16")
    trainer = build_training(ALEXNET_LAYERS, ALEXNET_SAMPLE_SHAPE, loader,
                             seed=42, policy=policy, device="cuda",
                             **ALEXNET_TRAINING)
    torch.cuda.synchronize()
    result = {"policy": policy, "build_s": time.perf_counter() - t0}
    if check:
        fc7 = [i for i, m in enumerate(trainer.forwards)
               if isinstance(m, All2AllStrictRELU)][-1]
        result.update(step_check(torch, trainer, "train", fc7, (
            ("other_seed", lambda run: run(seed=CHECK_SEED + 1)),)))
        idx = torch.from_numpy(trainer._segment_indices(TRAIN)[0]).cuda()
        result["check_pool_argmax_flips"] = pool_flips(torch, trainer, idx)
        print("train check: max-pool windows whose argmax differs between "
              "the two forwards: %s" % result["check_pool_argmax_flips"])
        result.update(backends_check(torch, trainer))

    # (b) the main path, counted from 0
    losses, epoch_s = [], []
    reset_counts()
    with timed_calls(torch, trainer, "train_batch") as steps_timed:
        for _ in range(TRAIN_EPOCHS):
            t = time.perf_counter()
            stats = trainer.run_epoch()
            torch.cuda.synchronize()
            epoch_s.append(time.perf_counter() - t)
            losses.append((stats["train"]["loss"],
                           stats["validation"]["loss"]))
        counts, by_form = read_counts()
        variants = gemm_variants()
        forms = check_designed_forms("training " + policy)
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise AssertionError("%s training: non-finite loss %s" % (
            policy, losses))
    # (c) launches per step and per forward, from the model itself
    per_epoch_steps = len(trainer._segment_indices(TRAIN))
    steps = TRAIN_EPOCHS * per_epoch_steps
    forwards = steps + TRAIN_EPOCHS * len(trainer._segment_indices(
        VALIDATION))
    n_fc = sum(isinstance(m, All2All) and not isinstance(m, All2AllSoftmax)
               for m in trainer.forwards)
    expected = {
        "gemm_bias_act": n_fc * forwards,
        "lrn_fwd": sum(isinstance(m, LRNormalizerForward)
                       for m in trainer.forwards) * forwards,
        "lrn_bwd": sum(isinstance(m, LRNormalizerForward)
                       for m in trainer.forwards) * steps,
        "column_reduce": sum(bool(p.get("bias") is not None)
                             for p in trainer.params) * steps,
        "uniform_fill": sum(isinstance(m, DropoutForward)
                            for m in trainer.forwards) * steps,
        "kahan_gemm": 0}
    if counts != expected:
        raise AssertionError("%s training launch counts %s, expected %s "
                             "over %d steps and %d forwards" % (
                                 policy, counts, expected, steps, forwards))
    step_ms = [s.elapsed_time(e) for s, e in steps_timed]
    steady = step_ms[per_epoch_steps:]
    flops = model_train_flops_per_sample(trainer.model)
    step_p50 = statistics.median(steady)
    result.update({
        "epochs": TRAIN_EPOCHS, "steps": steps, "forwards": forwards,
        "gemm_variants": variants, "lrn_fwd_forms": forms["lrn_fwd"],
        "lrn_bwd_forms": forms["lrn_bwd"],
        "column_reduce_forms": forms["column_reduce"],
        "train_loss_per_epoch": [v[0] for v in losses],
        "validation_loss_per_epoch": [v[1] for v in losses],
        "loss_falls": losses[-1][0] < losses[0][0],
        "epoch_s": epoch_s,
        "step_ms_p50": step_p50, "step_ms_min": min(steady),
        "step_ms_max": max(steady), "first_step_ms": step_ms[0],
        "samples_per_s_device": TRAIN_BATCH / step_p50 * 1e3,
        "samples_per_s_epoch": (TRAIN_SAMPLES + TRAIN_BATCH) /
        statistics.median(epoch_s[1:]),
        "model_gflop_per_sample": flops / 1e9,
        "model_tflop_per_s": TRAIN_BATCH / step_p50 * 1e3 * flops / 1e12,
        "launches_per_step": {name: n // steps for name, n in
                              expected.items()
                              if name in ("lrn_bwd", "column_reduce",
                                          "uniform_fill")},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    print("train %s: loss per epoch (train) %s, (validation) %s; launches "
          "%s over %d steps and %d forwards" % (
              policy, " ".join("%.4f" % v[0] for v in losses),
              " ".join("%.4f" % v[1] for v in losses), counts, steps,
              forwards))

    # (d) one profiled step, after the counted run
    prof, wall_ms = profiled_step(torch, trainer)
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=25))
    split = device_time_split(torch, prof)
    busy = sum(split.values())
    # the profiler slows the host, so the idle share is read against
    # the unprofiled steps' median as well as the profiled step's wall
    result.update({"profiled_step_wall_ms": wall_ms,
                   "profiled_step_device_ms": busy,
                   "device_idle_share": max(0.0, 1.0 - busy / step_p50),
                   "device_idle_share_profiled": max(0.0,
                                                     1.0 - busy / wall_ms),
                   "device_ms_by_group": split})
    return result, by_form


def baseline_paths():
    """[(name, layers, sample shape, loader factory, build_training
    keywords)] of the BASELINE training paths at ``bench_all.py``'s
    sizes, and the digits provider (the SOM's data)."""
    from veles_tpu_torch.datasets import golden_digits, golden_objects
    from veles_tpu_torch.models.cifar import (CIFAR_LAYERS,
                                              CIFAR_SAMPLE_SHAPE,
                                              CIFAR_TRAINING, CifarLoader)
    from veles_tpu_torch.models.mnist import (MNIST_LAYERS,
                                              MNIST_SAMPLE_SHAPE,
                                              MNIST_TRAINING, MnistLoader)
    from veles_tpu_torch.models.mnist_ae import (AutoencoderLoader,
                                                 autoencoder_layers)
    from veles_tpu_torch.models import samples
    from veles_tpu_torch.models.parity import CONV_LAYERS
    digits = golden_digits(*BASELINE_DIGITS)
    objects = golden_objects(*BASELINE_OBJECTS)
    # the samples at their workflows' defaults, each drawn once
    sample_paths = []
    for sample, provider in (
            (samples.kanji, samples.KanjiProvider(n_train=20000,
                                                  n_valid=2000)),
            (samples.lines, samples.LinesProvider()),
            (samples.wine, samples.WineProvider())):
        provider = Frozen(provider)
        spec = sample(provider)
        sample_paths.append((sample.__name__, spec.layers, spec.sample_shape,
                             lambda sample=sample, provider=provider:
                             sample(provider).loader, spec.training))
    return [
        ("mnist-fc", MNIST_LAYERS, MNIST_SAMPLE_SHAPE,
         lambda: MnistLoader(provider=digits, minibatch_size=500),
         dict(MNIST_TRAINING)),
        # StandardWorkflow's defaults: lr 0.01, no momentum
        ("mnist-conv", CONV_LAYERS, (28, 28, 1),
         lambda: MnistLoader(provider=digits, flatten=False,
                             minibatch_size=250), {}),
        ("cifar-quick", CIFAR_LAYERS, CIFAR_SAMPLE_SHAPE,
         lambda: CifarLoader(provider=objects, minibatch_size=250),
         dict(CIFAR_TRAINING)),
        ("mnist-ae", autoencoder_layers(784, 100), MNIST_SAMPLE_SHAPE,
         lambda: AutoencoderLoader(provider=digits, minibatch_size=500),
         {"learning_rate": 0.001, "loss": "mse"}),
    ] + sample_paths, digits


class Frozen(object):
    """A provider's arrays drawn once and handed out on every call; its
    other attributes (``sample_shape``, ``side``) read through."""

    def __init__(self, provider):
        self.provider = provider
        self.data = provider()

    def __getattr__(self, name):
        return getattr(self.provider, name)

    def __call__(self):
        return self.data


def baseline_trainer(spec, policy, solver="sgd", **hyper):
    """The port's trainer of one BASELINE path on the card, weights and
    shuffles from :data:`BASELINE_SEED`."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models.build import build_training
    _, layers, sample, loader, keywords = spec
    prng.get().seed(BASELINE_SEED)
    prng.get("loader").seed(BASELINE_SEED + 1)
    keywords = dict(keywords, **hyper)
    return build_training(layers, sample, loader(), seed=BASELINE_SEED,
                          policy=policy, device="cuda", solver=solver,
                          **keywords)


def first_fc(trainer):
    """Index of the first fully-connected layer that is not the head."""
    from veles_tpu_torch.nn.all2all import All2All, All2AllSoftmax
    return next(i for i, m in enumerate(trainer.forwards)
                if isinstance(m, All2All) and
                not isinstance(m, All2AllSoftmax))


def shifted_targets(trainer):
    """A rerun for :func:`step_check`: the step with the staged targets
    shifted by one row."""
    def rerun(run):
        staged = trainer.loader._staged_
        trainer.loader._staged_ = (staged[0], staged[1].roll(1, 0))
        try:
            return run()
        finally:
            trainer.loader._staged_ = staged
    return rerun


def update_check(torch, trainer, name):
    """A solver's step through the kernels against the plain versions
    from the same weights and state: each parameter's update within
    :data:`GRAD_SHARE_TOL` of its norm. The trainer is left as it was."""
    from veles_tpu_torch.loader.base import TRAIN
    idx = torch.from_numpy(trainer._segment_indices(TRAIN)[0]).cuda()
    params, states = trainer.pull_params()
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    moved = {}
    try:
        for plain in (False, True):
            trainer.push_params(params, states)
            trainer.plain = plain
            trainer.train_batch(idx, 0, CHECK_SEED)
            moved[plain] = [{k: p.detach() - params[i][k]
                             for k, p in layer.items()}
                            for i, layer in enumerate(trainer.params)]
    finally:
        trainer.plain = False
        torch.backends.cudnn.deterministic = saved
        trainer.push_params(params, states)
    shares = gradient_shares(moved[False], moved[True])
    worst = max(shares.values())
    print("%s update check: step through the kernels vs the plain versions, "
          "update shares %s (limit %g)" % (
              name, ", ".join("%d.%s %.2g" % (i, k[0], v)
                              for (i, k), v in sorted(shares.items())),
              GRAD_SHARE_TOL))
    if not math.isfinite(worst) or worst > GRAD_SHARE_TOL:
        raise AssertionError("%s update through the kernels differs from the "
                             "plain versions: worst share %.3g" % (
                                 name, worst))
    return {"check_worst_update_share": worst}


def baseline_run(torch, trainer, name, policy, epochs):
    """(2) and (3): ``epochs`` epochs of the path counted from 0, each
    train step timed by CUDA events; the per-epoch numbers, the launch
    counts against the model's, launches by form; then one profiled step
    for the idle share. Returns (result, launches_by_form)."""
    from veles_tpu_torch.loader.base import TRAIN, VALIDATION
    torch.cuda.reset_peak_memory_stats()
    per_epoch = []
    reset_counts()
    with timed_calls(torch, trainer, "train_batch") as steps_timed:
        for _ in range(epochs):
            t = time.perf_counter()
            stats = trainer.run_epoch()
            torch.cuda.synchronize()
            valid = stats["validation"]
            per_epoch.append({
                "seconds": time.perf_counter() - t,
                "train_loss": stats["train"]["loss"],
                "validation": valid.get("rmse", valid["normalized"]),
                "confusion_trace": int(valid["confusion"].trace())
                if "confusion" in valid else None,
                "grad_norm_last": float(trainer.last_grad_norms[-1])})
        counts, by_form = read_counts()
        forms = {name: {v: c for v, c in
                        variant_counters()[name].launches_by_variant.items()
                        if c} for name in ("gemm_bias_act", "column_reduce")}
    metric = "rmse" if trainer.loss_kind == "mse" else "error"
    values = [v for e in per_epoch for v in (e["train_loss"],
                                             e["validation"],
                                             e["grad_norm_last"])]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("%s %s: non-finite epoch values %s" % (
            name, policy, per_epoch))
    falls = per_epoch[-1]["train_loss"] < per_epoch[0]["train_loss"]
    if policy == "float32" and epochs > 1 and not falls:
        raise AssertionError("%s float32: the training loss did not fall: "
                             "%s" % (name, [e["train_loss"]
                                            for e in per_epoch]))
    steps_a_epoch = len(trainer._segment_indices(TRAIN))
    steps = epochs * steps_a_epoch
    forwards = steps + epochs * len(trainer._segment_indices(VALIDATION))
    expected = dict.fromkeys(kernel_counters(), 0)
    expected["gemm_bias_act"] = forwards * gemm_launches_a_forward(
        trainer.forwards)
    expected["column_reduce"] = steps * sum(
        len(p["bias"]) if p["bias"].dim() == 2 else 1
        for p in trainer.params if p.get("bias") is not None)
    if counts != expected:
        raise AssertionError("%s %s launch counts %s, expected %s over %d "
                             "steps and %d forwards" % (
                                 name, policy, counts, expected, steps,
                                 forwards))
    step_ms = [s.elapsed_time(e) for s, e in steps_timed]
    steady = step_ms[steps_a_epoch:] if epochs > 1 else step_ms
    step_p50 = statistics.median(steady)
    batch = trainer.loader.max_minibatch_size
    prof, wall_ms = profiled_step(torch, trainer)
    split = device_time_split(torch, prof)
    busy = sum(split.values())
    result = {
        "path": name, "policy": policy, "epochs": epochs, "steps": steps,
        "forwards": forwards, "launches": counts,
        "launches_by_form": forms, "per_epoch": per_epoch,
        "validation_metric": metric, "loss_falls": falls,
        "step_ms_p50": step_p50, "step_ms_min": min(steady),
        "step_ms_max": max(steady), "first_step_ms": step_ms[0],
        "samples_per_s_device": batch / step_p50 * 1e3,
        "samples_per_s_epoch": trainer.loader.class_lengths[TRAIN] /
        statistics.median(e["seconds"] for e in per_epoch[1:] or per_epoch),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profiled_step_device_ms": busy, "profiled_step_wall_ms": wall_ms,
        "device_idle_share": max(0.0, 1.0 - busy / step_p50),
        "device_ms_by_group": split}
    print("baseline %s %s: train loss %s, validation %s %s, confusion trace "
          "%s; step %.3f ms (p50), %.0f samples/s, idle share %.2f, peak "
          "%.3f GB; launches by form %s" % (
              name, policy, " ".join("%.4f" % e["train_loss"]
                                     for e in per_epoch), metric,
              " ".join("%.4f" % e["validation"] for e in per_epoch),
              [e["confusion_trace"] for e in per_epoch], step_p50,
              result["samples_per_s_device"], result["device_idle_share"],
              result["peak_memory_gb"], forms))
    return result, by_form


def gemm_launches_a_forward(modules):
    """K1 launches of one forward: one for each fully-connected layer but
    the softmax head (whose logits are a plain product), four for each
    attention layer (its projections)."""
    from veles_tpu_torch.nn.all2all import All2All, All2AllSoftmax
    from veles_tpu_torch.nn.attention import MultiHeadAttentionForward
    return sum(4 if isinstance(m, MultiHeadAttentionForward) else
               int(isinstance(m, All2All) and
                   not isinstance(m, All2AllSoftmax)) for m in modules)


def som_run(torch, digits):
    """(5): the 8x8 SOM over the digits, three epochs on the card; its
    quantization error must fall below the untrained codebook's, and no
    kernel of the port is launched (its two products are plain)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models.mnist import MnistLoader
    from veles_tpu_torch.nn.kohonen import KohonenTrainer, som_quality
    from veles_tpu_torch.train.som import SOMRunner
    prng.get().seed(BASELINE_SEED)
    prng.get("loader").seed(BASELINE_SEED + 1)
    loader = MnistLoader(provider=digits, minibatch_size=SOM_MINIBATCH)
    trainer = KohonenTrainer(784, SOM_SIDE, SOM_SIDE, device="cuda")
    runner = SOMRunner(trainer, loader)
    train = loader._staged_[0][loader.class_lengths[1]:]
    before = som_quality(trainer.weights, SOM_SIDE, SOM_SIDE, train)
    reset_counts()
    with timed_calls(torch, trainer, "step") as timed:
        seconds = [runner.run_epoch() for _ in range(BASELINE_EPOCHS)]
        counts, _ = read_counts()
    after = som_quality(trainer.weights, SOM_SIDE, SOM_SIDE, train)
    update_ms = [s.elapsed_time(e) for s, e in timed]
    result = {"epochs": BASELINE_EPOCHS, "updates": trainer.time,
              "minibatch": SOM_MINIBATCH, "epoch_s": seconds,
              "update_ms_p50": statistics.median(update_ms),
              "update_ms_min": min(update_ms),
              "untrained": before, "trained": after, "launches": counts}
    print("baseline som: quantization error %.4f -> %.4f, topographic error "
          "%.4f -> %.4f, %.4f ms per update (p50) over %d updates" % (
              before["quantization_error"], after["quantization_error"],
              before["topographic_error"], after["topographic_error"],
              result["update_ms_p50"], trainer.time))
    if any(counts.values()):
        raise AssertionError("som: port kernels launched %s" % counts)
    if not (math.isfinite(after["quantization_error"]) and
            after["quantization_error"] < before["quantization_error"]):
        raise AssertionError("som: quantization error %s did not fall below "
                             "the untrained codebook's %s" % (after, before))
    return result


def baseline_phase(torch, kernels):
    """The BASELINE model family on the card: each training path under
    each policy (float32 first, with the step check), its launches at
    checked forms, an epoch of each adaptive solver on mnist-fc with its
    step and update checks, and the SOM. Returns (results,
    [launches_by_form of each counted run])."""
    t0 = time.perf_counter()
    paths, digits = baseline_paths()
    results, phases = {"data_s": None}, []
    for spec in paths:
        name = spec[0]
        for policy in BASELINE_POLICIES:
            trainer = baseline_trainer(spec, policy)
            if results["data_s"] is None:
                results["data_s"] = time.perf_counter() - t0
            result = {}
            if policy == "float32":
                reruns = ((("targets_shifted", shifted_targets(trainer)),)
                          if trainer.loss_kind == "mse" else ())
                result.update(step_check(torch, trainer, name,
                                         first_fc(trainer), reruns))
            run, by_form = baseline_run(torch, trainer, name, policy,
                                        BASELINE_EPOCHS)
            result.update(run)
            check_forms("baseline %s %s" % (name, policy), kernels, by_form)
            phases.append(by_form)
            results["%s %s" % (name, policy)] = result
            del trainer
            torch.cuda.empty_cache()
    fc = paths[0]
    for solver, hyper in sorted(SOLVER_TRAINING.items()):
        trainer = baseline_trainer(fc, "float32", solver, **hyper)
        label = "mnist-fc %s" % solver
        result = step_check(torch, trainer, label, first_fc(trainer))
        result.update(update_check(torch, trainer, label))
        run, by_form = baseline_run(torch, trainer, label, "float32", 1)
        result.update(run)
        check_forms("baseline " + label, kernels, by_form)
        phases.append(by_form)
        results[label] = result
        del trainer
    results["som"] = som_run(torch, digits)
    results["phase_s"] = time.perf_counter() - t0
    return results, phases


def b64_body(array, **extra):
    """A base64 request body for ``array``, a float32 numpy array."""
    return json.dumps(dict(extra, input=base64.b64encode(
        array.tobytes()).decode(), codec="base64", shape=list(array.shape),
        type="float32")).encode()


def concurrent_posts(port, bodies):
    """POST ``bodies`` to ``/api`` from one thread each, all at once:
    (replies in order, latencies in s, wall s)."""
    replies, latencies, errors = {}, [], []

    def ask(i):
        try:
            t = time.perf_counter()
            replies[i] = post(port, "/api", bodies[i])
            latencies.append(time.perf_counter() - t)
        except Exception as e:  # re-raised below, in the caller
            errors.append(e)

    threads = [threading.Thread(target=ask, args=(i,))
               for i in range(len(bodies))]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t
    if errors:
        raise errors[0]
    if len(replies) != len(bodies):
        raise AssertionError("%d replies of %d" % (len(replies),
                                                   len(bodies)))
    return [replies[i] for i in range(len(bodies))], latencies, wall


def check_replies(numpy, label, served, want, controls):
    """The centred-logit check of ``served`` against ``want`` (see
    :func:`reply_mismatch`), and every ``(name, rows)`` of ``controls``
    must fail it. Returns (error, spread, {control: share})."""
    if served.shape != want.shape or not numpy.isfinite(served).all():
        raise AssertionError("%s: replies of shape %s, finite %s, expected "
                             "%s" % (label, served.shape,
                                     numpy.isfinite(served).all(),
                                     want.shape))
    err, spread = reply_mismatch(numpy, served, want)
    if err > LOGIT_REL_TOL * spread:
        raise AssertionError(
            "%s: centred logits differ by %.3g, %.3g of their "
            "input-dependent spread %.3g (limit %g)" % (
                label, err, err / spread, spread, LOGIT_REL_TOL))
    shares = {}
    for name, bad in controls:
        shares[name] = reply_mismatch(numpy, bad, want)[0] / spread
        if shares[name] <= LOGIT_REL_TOL:
            raise AssertionError(
                "%s control %s passes the reply check (%.3g of the spread): "
                "the check cannot see a wrong reply" % (label, name,
                                                        shares[name]))
    print("%s: %d replies match, centred logits max |err| %.3g = %.3g of "
          "their spread %.3g (limit %g); controls %s fail it" % (
              label, len(served), err, err / spread, spread, LOGIT_REL_TOL,
              ", ".join("%s %.3g" % kv for kv in sorted(shares.items()))))
    return err, spread, shares


def serving_counts(label, forwards, per_forward):
    """The launch counts of a served sequence model since the last
    :func:`reset_counts`: K1 ``per_forward`` times a forward, nothing
    else. Returns ({name: launches}, launches_by_form)."""
    counts, by_form = read_counts()
    expected = dict.fromkeys(kernel_counters(), 0)
    expected["gemm_bias_act"] = per_forward * forwards
    if forwards < 1 or counts != expected:
        raise AssertionError("%s launch counts %s over %d forwards, "
                             "expected %s" % (label, counts, forwards,
                                              expected))
    return counts, by_form


@contextlib.contextmanager
def serving(model):
    from veles_tpu_torch.serving.frontend import ServingFrontend
    frontend = ServingFrontend(model, host="127.0.0.1", port=0, replicas=1,
                               max_batch_size=64, batch_timeout_ms=5.0,
                               max_queue=256, response_timeout=300.0)
    frontend.start()
    try:
        yield frontend
    finally:
        frontend.stop()


def sequence_serving(torch, numpy, provider):
    """The attention model behind ``ServingFrontend``: 3 rounds of 16
    concurrent single requests and one 64-row batch request, base64
    bodies of the provider's validation samples; every reply held to the
    plain-version forward on the card (:func:`check_replies`) with a
    reply swap and a zeroed head as controls; K1 eight times a forward,
    every launch on a designed variant. Returns (result,
    launches_by_form)."""
    from veles_tpu_torch.models.build import plain_forward
    from veles_tpu_torch.models.samples import sequence_bench
    from veles_tpu_torch.serving.model_store import ServeableModel
    spec = sequence_bench(False, provider)
    t0 = time.perf_counter()
    model = ServeableModel.from_layers(
        spec.layers, spec.sample_shape, seed=SEQUENCE_SEED, policy="float32",
        device="cuda", name="attention")
    valid = provider()[2]
    n_single, rounds = 16, 3
    singles = valid[:n_single * rounds]
    batch = valid[n_single * rounds:n_single * rounds + 64]
    bodies = [b64_body(x, id=i) for i, x in enumerate(singles)]
    batch_body = b64_body(batch)
    with serving(model) as frontend:
        warm_s = time.perf_counter() - t0
        replica = frontend.pool.replicas[0]
        forwards0 = replica.batches_done
        reset_counts()
        replies, latencies, round_s = [], [], []
        for r in range(rounds):
            got, lat, wall = concurrent_posts(
                frontend.port, bodies[r * n_single:(r + 1) * n_single])
            replies += got
            latencies += lat
            round_s.append(wall)
        t = time.perf_counter()
        batch_reply = post(frontend.port, "/api/batch", batch_body)
        batch_s = time.perf_counter() - t
        forwards = replica.batches_done - forwards0
        counts, by_form = serving_counts(
            "sequence serving", forwards,
            gemm_launches_a_forward(model.module))
        variants = gemm_variants()
    check_designed("sequence serving", variants)
    if [r["id"] for r in replies] != list(range(len(singles))):
        raise AssertionError("sequence serving: replies out of order")
    served = numpy.array([r["result"] for r in replies] +
                         batch_reply["results"])
    inputs = numpy.concatenate([singles, batch])
    want = forward_rows(torch, numpy, lambda x: plain_forward(
        model.module, x), inputs)
    swapped = served.copy()
    swapped[[0, 1]] = served[[1, 0]]
    head = model.module[-1]
    saved = head.weights.detach().clone()
    with torch.no_grad():
        head.weights.zero_()
    try:
        zeroed = forward_rows(torch, numpy, model.module, inputs)
    finally:
        with torch.no_grad():
            head.weights.copy_(saved)
    err, spread, controls = check_replies(
        numpy, "sequence serving", served, want,
        (("swapped", swapped), ("head_zeroed", zeroed)))
    lat = sorted(latencies)
    result = {
        "model": "attention 2L seq=256 d=256 h=8, 8 classes",
        "build_and_warm_s": warm_s, "requests": len(lat) + 1,
        "concurrent": n_single,
        "single_p50_ms": 1e3 * statistics.median(lat),
        "single_p95_ms": 1e3 * lat[min(len(lat) - 1,
                                       int(0.95 * len(lat)))],
        "single_samples_per_s": len(lat) / sum(round_s),
        "batch64_ms": 1e3 * batch_s, "batch64_samples_per_s": 64 / batch_s,
        "forwards": forwards, "launches": counts, "gemm_variants": variants,
        "centred_logit_err": err, "centred_logit_spread": spread,
        "control_shares": controls}
    with torch.inference_mode():
        for b in (1, 64):
            x = torch.from_numpy(valid[:b]).cuda()
            result["forward_b%d_ms" % b] = device_ms(
                torch, lambda: model.module(x), trials=3, per_trial=5)
            result["plain_forward_b%d_ms" % b] = device_ms(
                torch, lambda: plain_forward(model.module, x), trials=3,
                per_trial=5)
    print("sequence serving: %d forwards, K1 %d launches by variant %s; "
          "single p50 %.1f ms, p95 %.1f ms; batch of 64 in %.1f ms (%.0f "
          "samples/s); device forward %.4f ms at 1, %.4f at 64" % (
              forwards, counts["gemm_bias_act"], variants,
              result["single_p50_ms"], result["single_p95_ms"],
              result["batch64_ms"], result["batch64_samples_per_s"],
              result["forward_b1_ms"], result["forward_b64_ms"]))
    del model
    return result, by_form


def pooled_forward(torch, model, x):
    """The kernel forward with the MoE layer's capacity pooled over the
    whole batch instead of each sample: what a batch-dependent router
    would serve."""
    from veles_tpu_torch.nn.moe import MoEForward
    from veles_tpu_torch.parallel.ep import moe_ffn_dense
    for module in model:
        if isinstance(module, MoEForward):
            y = moe_ffn_dense(x.reshape(1, -1, x.shape[-1]), module.weights,
                              module.up, module.down,
                              module.capacity_factor).reshape(x.shape)
            x = (y + x).to(x.dtype)
        else:
            x = module(x)
    return x


def moe_serving(torch, numpy, provider):
    """The moe model behind ``ServingFrontend``: one 64-row batch request
    and one single request of its first row. Each served row is held to
    the same sample forwarded alone on the card (batch-composition
    independence), with the capacity pooled over the batch as the
    control that must fail; the batch also to the plain forward.
    Returns (result, launches_by_form)."""
    from veles_tpu_torch.models.build import plain_forward
    from veles_tpu_torch.models.samples import sequence_bench
    from veles_tpu_torch.serving.model_store import ServeableModel
    spec = sequence_bench(True, provider)
    model = ServeableModel.from_layers(
        spec.layers, spec.sample_shape, seed=SEQUENCE_SEED, policy="float32",
        device="cuda", name="moe")
    batch = provider()[2][:64]
    with serving(model) as frontend:
        replica = frontend.pool.replicas[0]
        forwards0 = replica.batches_done
        reset_counts()
        batch_reply = post(frontend.port, "/api/batch", b64_body(batch))
        single = post(frontend.port, "/api", b64_body(batch[0], id=0))
        forwards = replica.batches_done - forwards0
        counts, by_form = serving_counts(
            "moe serving", forwards, gemm_launches_a_forward(model.module))
        variants = gemm_variants()
    check_designed("moe serving", variants)
    served = numpy.array(batch_reply["results"])
    alone = numpy.concatenate([forward_rows(
        torch, numpy, model.module, batch[i:i + 1]) for i in range(64)])
    want = forward_rows(torch, numpy, lambda x: plain_forward(
        model.module, x), batch)
    pooled = forward_rows(torch, numpy, lambda x: pooled_forward(
        torch, model.module, x), batch)
    err, spread, controls = check_replies(
        numpy, "moe serving, rows vs each sample alone", served, alone,
        (("capacity_pooled_over_the_batch", pooled),))
    plain_err, _, _ = check_replies(numpy, "moe serving, vs the plain "
                                    "forward", served, want, ())
    single_err = float(numpy.abs(numpy.array(single["result"]) -
                                 served[0]).max())
    if single_err > PROBS_ATOL:
        raise AssertionError("moe serving: the single reply differs from "
                             "its batch row by %.3g" % single_err)
    del model
    return {"model": "attention + 8-expert MoE + attention, seq=128 d=256",
            "forwards": forwards, "launches": counts,
            "gemm_variants": variants, "alone_centred_logit_err": err,
            "centred_logit_spread": spread, "control_shares": controls,
            "plain_centred_logit_err": plain_err,
            "single_vs_batch_row_err": single_err}, by_form


def expert_zeroed(trainer):
    """A rerun for :func:`step_check`: the kernels' step with the up
    gradient of the MoE layer's busiest expert (the largest gradient)
    zeroed."""
    from veles_tpu_torch.nn.moe import MoEForward
    index = next(i for i, m in enumerate(trainer.forwards)
                 if isinstance(m, MoEForward))

    def rerun(run):
        loss, grads = run()
        up = grads[index]["up"]
        up[int(up.flatten(1).norm(dim=1).argmax())] = 0.0
        return loss, grads
    return rerun


def routing_flips(torch, trainer):
    """Tokens of the first training batch whose expert differs between
    the forward through the kernels and through the plain versions."""
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.nn.moe import MoEForward
    from veles_tpu_torch.parallel.ep import router_probs
    idx = torch.from_numpy(trainer._segment_indices(TRAIN)[0]).cuda()
    x, _, _ = trainer.loader.gather(idx)
    with torch.no_grad():
        a = b = x
        for module in trainer.forwards:
            if isinstance(module, MoEForward):
                picks = [router_probs(v, module.weights).argmax(-1)
                         for v in (a, b)]
                return "%d of %d" % (int((picks[0] != picks[1]).sum()),
                                     picks[0].numel())
            a, b = module(a), module.plain_forward(b)
    return None


def sequence_phase(torch, numpy, kernels):
    """The sequence models on the card: the attention model served, the
    moe model's served rows against each sample alone, then each
    configuration trained under each policy (float32 first, with the step
    check and its controls: the first attention layer's bias gradient
    zeroed, and for moe the busiest expert's up gradient zeroed), its
    launches counted and at checked forms, every K1 launch on a designed
    variant. Returns (results, [launches_by_form of each counted
    run])."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models.build import build_training
    from veles_tpu_torch.models.samples import (sequence_bench,
                                                sequence_bench_provider)
    t0 = time.perf_counter()
    providers = {name: Frozen(sequence_bench_provider(name == "moe"))
                 for name in SEQUENCE_LENGTHS}
    results, phases = {"data_s": time.perf_counter() - t0}, []
    for label, serve, provider in (
            ("serving attention float32", sequence_serving,
             providers["attention"]),
            ("serving moe float32", moe_serving, providers["moe"])):
        results[label], by_form = serve(torch, numpy, provider)
        check_forms("sequence " + label, kernels, by_form)
        phases.append(by_form)
        torch.cuda.empty_cache()
    for name in sorted(SEQUENCE_LENGTHS):
        for policy in SEQUENCE_POLICIES:
            spec = sequence_bench(name == "moe", providers[name])
            prng.get().seed(SEQUENCE_SEED)
            prng.get("loader").seed(SEQUENCE_SEED + 1)
            trainer = build_training(
                spec.layers, spec.sample_shape, spec.loader,
                seed=SEQUENCE_SEED, policy=policy, device="cuda",
                **dict(spec.training, learning_rate=SEQUENCE_LEARNING_RATE))
            result = {}
            if policy == "float32":
                reruns = ()
                if name == "moe":
                    result["routing_flips_kernels_vs_plain"] = \
                        routing_flips(torch, trainer)
                    reruns = (("busiest_expert_up_zeroed",
                               expert_zeroed(trainer)),)
                result.update(step_check(torch, trainer, name, 0, reruns))
            run, by_form = baseline_run(torch, trainer, name, policy,
                                        SEQUENCE_EPOCHS)
            result.update(run)
            label = "sequence %s %s" % (name, policy)
            check_forms(label, kernels, by_form)
            check_designed(label, run["launches_by_form"]["gemm_bias_act"])
            phases.append(by_form)
            results["%s %s" % (name, policy)] = result
            del trainer
            torch.cuda.empty_cache()
    results["phase_s"] = time.perf_counter() - t0
    return results, phases


#: the workflow phase: AlexNetWorkflow at full width through the CLI
WORKFLOW_EPOCHS = 4
#: the snapshot the resumed run starts from: the one after 2 epochs
WORKFLOW_RESUME_SNAPSHOT = "wf.1.pickle"
#: the resumed run against the uninterrupted one: each epoch loss within
#: this relative distance, and fc7's final weights within this share of
#: their change over the resumed epochs. cuDNN's convolution backward
#: (and maybe the pooling's) adds in an order that varies between runs
#: (K1, K4, K6 and K7 are bitwise repeatable): a resume read 0.0068 of
#: the change on the H100, the control without the registry 0.63
WORKFLOW_LOSS_REL_TOL = 1e-5
WORKFLOW_UPDATE_SHARE_TOL = 5e-2

WORKFLOW_FILE = """
from veles_tpu_torch.config import root
from veles_tpu_torch.models.alexnet import (ALEXNET_LAYERS,
                                            AlexNetWorkflow,
                                            SyntheticImageLoader)
from veles_tpu_torch.snapshotter import SnapshotterToFile


def run(load, main):
    wf, restored = load(
        AlexNetWorkflow,
        loader_factory=lambda wf: SyntheticImageLoader(
            workflow=wf, n_train=%d, n_valid=%d, minibatch_size=%d),
        layers=ALEXNET_LAYERS, max_epochs=%d, learning_rate=0.01,
        momentum=0.9, weights_decay=5e-4)
    if not restored:
        snap = SnapshotterToFile(wf, compression="", time_interval=0,
                                 name="snapshotter")
        snap.link_from(wf.decision)
        snap.gate_skip = ~wf.loader.epoch_ended
    for unit in wf:
        if isinstance(unit, SnapshotterToFile):
            unit.directory = root.smoke.snapshots
    main()
""" % (TRAIN_SAMPLES, TRAIN_BATCH, TRAIN_BATCH, WORKFLOW_EPOCHS)

#: the import check's workflow: one epoch of the small AlexNet
SMALL_WORKFLOW_FILE = """
from veles_tpu_torch.models.alexnet import (AlexNetWorkflow,
                                            SyntheticImageLoader,
                                            small_alexnet_layers)


def run(load, main):
    load(AlexNetWorkflow, layers=small_alexnet_layers(10), max_epochs=1,
         loader_factory=lambda wf: SyntheticImageLoader(
             workflow=wf, n_train=256, n_valid=64, side=64, n_classes=10,
             minibatch_size=64))
    main()
"""

#: the import check, in a process of its own: the CLI on that file
IMPORT_CHECK = """
import sys
from veles_tpu_torch.__main__ import main
assert main([sys.argv[1], "-s", "7"]) == 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "veles_tpu" or m.startswith("veles_tpu."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


@contextlib.contextmanager
def timed_method(torch, cls, attr):
    """Times each call of ``cls.attr`` (on every instance) by CUDA events
    while inside; yields the list of (start, end) events."""
    fn = getattr(cls, attr)
    timed = []

    def timed_fn(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(self, *args)
        end.record()
        timed.append((start, end))
        return out

    setattr(cls, attr, timed_fn)
    try:
        yield timed
    finally:
        setattr(cls, attr, fn)


def merge_forms(*all_forms):
    """{kernel: {form: launches}} summed over several reads."""
    out = {}
    for forms in all_forms:
        for name, counts in forms.items():
            mine = out.setdefault(name, {})
            for form, n in counts.items():
                mine[form] = mine.get(form, 0) + n
    return out


def workflow_cli(*args):
    """``veles_tpu_torch.__main__.Main().run(args)``, which must exit 0;
    returns the ``Main``."""
    from veles_tpu_torch.__main__ import Main
    main = Main()
    code = main.run(list(args))
    if code != 0:
        raise AssertionError("python -m veles_tpu_torch %s exited %d"
                             % (" ".join(args), code))
    return main


def resume_gap(numpy, got, want, before):
    """(largest relative loss difference over the resumed epochs, fc7's
    largest weight difference as a share of its largest change over those
    epochs) between a resumed run ``got`` and the uninterrupted ``want``,
    each (per-epoch {class: loss}, fc7 weights); ``before`` is fc7 at the
    snapshot."""
    loss_rel = max(abs(g[k] - w[k]) / abs(w[k])
                   for g, w in zip(got[0], want[0]) for k in w)
    share = float(numpy.abs(got[1] - want[1]).max() /
                  numpy.abs(want[1] - before).max())
    return loss_rel, share


def workflow_phase(torch, numpy, kernels):
    """AlexNet-227 at full width through ``python -m veles_tpu_torch``
    (``AlexNetWorkflow`` over ``SyntheticImageLoader``, float32, seed 7):
    (1) an uninterrupted run of 4 epochs, snapshotted raw every epoch;
    (2) a run resumed with ``-w`` from the snapshot after 2 epochs in a
    cleared registry, held to (1) on the last two epochs' losses and
    fc7's final weights, and the same restore with its random streams
    dropped as the control that must fail that; (3) ``--test -w`` on the
    final snapshot: one forward-only epoch, no weight changed; (4) the
    snapshot directory served (``ModelStore.load``) and its replies
    checked as the slice phase checks them; (5) every K1/K3/K4/K6/K7
    launch of (1)-(4) at a checked, designed form, (1)'s counts exact;
    (6) a CLI run of the small AlexNet in a process of its own loads no
    JAX. The snapshots live in a temporary directory removed at the end.
    Returns (result, [launches_by_form])."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="veles_workflow_")
    try:
        return _workflow_phase(torch, numpy, kernels, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _workflow_phase(torch, numpy, kernels, tmp):
    import subprocess

    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.convert import layer_params
    from veles_tpu_torch.launcher import Launcher
    from veles_tpu_torch.loader.base import TRAIN, VALIDATION
    from veles_tpu_torch.nn.units import All2AllStrictRELU
    from veles_tpu_torch.serving.model_store import ModelStore
    from veles_tpu_torch.snapshotter import SnapshotterToFile, load_workflow
    from veles_tpu_torch.train.step import FusedTrainer

    path = os.path.join(tmp, "alexnet_workflow.py")
    with open(path, "w") as f:
        f.write(WORKFLOW_FILE)
    dirs = {k: os.path.join(tmp, k) for k in ("snapshots", "resumed",
                                              "control")}
    result = {}

    def where(key):
        return "root.smoke.snapshots=%r" % dirs[key]

    def params_of(wf):
        return [{k: p.detach().cpu().clone() for k, p in
                 layer_params(f.module).items()} for f in wf.forwards]

    # (1) uninterrupted
    results_file = os.path.join(tmp, "results.json")
    prng._generators.clear()
    reset_counts()
    with timed_method(torch, FusedTrainer, "train_batch") as steps_timed:
        t = time.perf_counter()
        main1 = workflow_cli(path, "-s", "7", "--precision", "float32",
                             "--result-file", results_file,
                             where("snapshots"))
        torch.cuda.synchronize()
        result["run_s"] = time.perf_counter() - t
    counts = read_counts()[0]
    wf1 = main1.workflow
    runner1 = main1.launcher.runner
    trainer1 = runner1.trainer
    times = runner1.epoch_times
    per_epoch = len(trainer1._segment_indices(TRAIN))
    steps = WORKFLOW_EPOCHS * per_epoch
    forwards = steps + WORKFLOW_EPOCHS * len(
        trainer1._segment_indices(VALIDATION))
    kinds = [type(m).__name__ for m in trainer1.forwards]
    n_lrn = kinds.count("LRNormalizerForward")
    expected = {"gemm_bias_act": kinds.count("All2AllStrictRELU") *
                forwards, "lrn_fwd": n_lrn * forwards,
                "lrn_bwd": n_lrn * steps,
                "column_reduce": sum("bias" in p for p in trainer1.params)
                * steps,
                "uniform_fill": kinds.count("DropoutForward") * steps,
                "kahan_gemm": 0}
    if counts != expected:
        raise AssertionError("workflow run launch counts %s, expected %s "
                             "over %d steps and %d forwards" % (
                                 counts, expected, steps, forwards))
    losses = [t["loss"] for t in times]
    if len(times) != WORKFLOW_EPOCHS or not all(
            math.isfinite(v) for loss in losses for v in loss.values()):
        raise AssertionError("workflow run: epochs %d, losses %s"
                             % (len(times), losses))
    with open(results_file) as f:
        gathered = json.load(f)
    if gathered.get("epochs") != WORKFLOW_EPOCHS or \
            "best_n_err_pt" not in gathered or "best_epoch" not in gathered:
        raise AssertionError("result file %s" % gathered)
    snapshotter = [u for u in wf1 if isinstance(u, SnapshotterToFile)][0]
    step_ms = [a.elapsed_time(b) for a, b in steps_timed]
    history = wf1.decision.epoch_history
    table = []
    for i, t in enumerate(times):
        export_s, nbytes = snapshotter.exports[i]
        row = dict(t, steps_ms_sum=sum(step_ms[i * per_epoch:
                                               (i + 1) * per_epoch]),
                   validation_n_err=history[i]["validation"]["metric"],
                   snapshot_mib=nbytes / 1048576.0,
                   snapshot_export_s=export_s)
        table.append(row)
        print("workflow epoch %d: loss train %.6f validation %.6f, "
              "validation n_err %d; eval %.4f s, train %.4f s (steps' sum "
              "%.3f ms), decision %.6f s, snapshot %.1f MiB in %.3f s of "
              "services %.3f s, wall %.4f s" % (
                  t["epoch"], t["loss"]["train"], t["loss"]["validation"],
                  row["validation_n_err"], t["eval_s"], t["train_s"],
                  row["steps_ms_sum"], t["decision_s"], row["snapshot_mib"],
                  export_s, t["services_s"], t["wall_s"]))
    steady = step_ms[per_epoch:]
    step_p50 = statistics.median(steady)
    fc7 = [i for i, f in enumerate(wf1.forwards)
           if isinstance(f, All2AllStrictRELU)][-1]
    final = params_of(wf1)
    result.update({
        "epochs": table, "result_file": gathered,
        "step_ms_p50": step_p50, "step_ms_min": min(steady),
        "step_ms_max": max(steady), "first_step_ms": step_ms[0],
        "samples_per_s_device": TRAIN_BATCH / step_p50 * 1e3,
        "samples_per_s_epoch": (TRAIN_SAMPLES + TRAIN_BATCH) /
        statistics.median(t["wall_s"] for t in times[1:]),
        "launches": counts})

    # (2) resumed, and the control without the registry
    resume_from = os.path.join(dirs["snapshots"], WORKFLOW_RESUME_SNAPSHOT)
    t = time.perf_counter()
    before = load_workflow(resume_from)
    result["snapshot_load_s"] = time.perf_counter() - t
    fc7_before = before.forwards[fc7]._params["weights"]
    del before
    want = ([t["loss"] for t in times[2:]], final[fc7]["weights"].numpy())
    prng._generators.clear()
    main2 = workflow_cli(path, "-w", resume_from, where("resumed"))
    got = ([t["loss"] for t in main2.launcher.runner.epoch_times],
           main2.workflow.forwards[fc7].weights.detach().cpu().numpy())
    if len(got[0]) != WORKFLOW_EPOCHS - 2:
        raise AssertionError("resumed run trained %d epochs" % len(got[0]))
    loss_rel, share = resume_gap(numpy, got, want, fc7_before)
    print("workflow resume: losses within %.3g relative (limit %g), fc7 "
          "within %.3g of its change (limit %g)" % (
              loss_rel, WORKFLOW_LOSS_REL_TOL, share,
              WORKFLOW_UPDATE_SHARE_TOL))
    if loss_rel > WORKFLOW_LOSS_REL_TOL or share > WORKFLOW_UPDATE_SHARE_TOL:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    del main2
    prng._generators.clear()
    control = load_workflow(resume_from)
    prng._generators.clear()
    launcher = Launcher()
    control.workflow = launcher
    for unit in control:
        if isinstance(unit, SnapshotterToFile):
            unit.directory = dirs["control"]
    launcher.initialize()
    launcher.run()
    bad = ([t["loss"] for t in launcher.runner.epoch_times],
           control.forwards[fc7].weights.detach().cpu().numpy())
    control_loss_rel, control_share = resume_gap(numpy, bad, want,
                                                 fc7_before)
    print("workflow resume control (random registry dropped): losses "
          "%.3g relative, fc7 %.3g of its change" % (control_loss_rel,
                                                     control_share))
    if control_loss_rel <= WORKFLOW_LOSS_REL_TOL and \
            control_share <= WORKFLOW_UPDATE_SHARE_TOL:
        raise AssertionError("the control passes the resume check")
    del control, launcher
    torch.cuda.empty_cache()
    result.update({"resume_loss_rel": loss_rel, "resume_fc7_share": share,
                   "control_loss_rel": control_loss_rel,
                   "control_fc7_share": control_share})

    # (3) --test on the final snapshot
    root.common.disable.snapshotting = True
    try:
        main3 = workflow_cli(path, "--test", "-w", os.path.join(
            dirs["snapshots"], "wf.%d.pickle" % (WORKFLOW_EPOCHS - 1)),
            where("control"))
    finally:
        root.common.disable.snapshotting = False
    tested = main3.workflow.decision.epoch_history
    changed = sum(not torch.equal(a[k], b[k]) for a, b in zip(
        params_of(main3.workflow), final) for k in b)
    if len(tested) != WORKFLOW_EPOCHS + 1 or changed or \
            tested[-1]["train"]["samples"] != TRAIN_SAMPLES:
        raise AssertionError("--test: %d epochs, %d tensors changed"
                             % (len(tested), changed))
    result["test_n_err"] = {k: tested[-1][k]["metric"]
                            for k in ("validation", "train")}
    print("workflow --test: one forward-only epoch, n_err %s, no weight "
          "changed" % result["test_n_err"])
    del main3
    torch.cuda.empty_cache()
    forms_train = read_counts()[1]
    variants_train = gemm_variants()
    designed = check_designed_forms("workflow runs")

    # (4) the snapshot directory served
    t = time.perf_counter()
    model = ModelStore().load(dirs["snapshots"])
    result["serve_load_s"] = time.perf_counter() - t
    result["serving"], forms_serving = serve_alexnet(
        torch, numpy, model, "workflow serving", rounds=1)
    variants = merge_forms({"v": variants_train},
                           {"v": gemm_variants()})["v"]
    del model

    # (5) every launch at a checked, designed form
    forms = merge_forms(forms_train, forms_serving)
    check_forms("workflow", kernels, forms)
    check_designed("workflow", variants)
    result.update({"gemm_variants": variants, "designed_forms": designed})

    # the idle share, from one profiled step of the trained workflow
    prof, wall_ms = profiled_step(torch, trainer1)
    split = device_time_split(torch, prof)
    busy = sum(split.values())
    result.update({"profiled_step_wall_ms": wall_ms,
                   "profiled_step_device_ms": busy,
                   "device_idle_share": max(0.0, 1.0 - busy / step_p50),
                   "device_ms_by_group": split})
    del main1, wf1, runner1, trainer1
    torch.cuda.empty_cache()

    # (6) no JAX on the CLI's path
    small = os.path.join(tmp, "small_alexnet.py")
    with open(small, "w") as f:
        f.write(SMALL_WORKFLOW_FILE)
    check = subprocess.run(
        [sys.executable, "-c", IMPORT_CHECK, small],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=tmp,
        capture_output=True, text=True, timeout=600)
    if check.returncode != 0 or "LOADED []" not in check.stdout:
        raise AssertionError("import check: %s%s" % (
            check.stdout, check.stderr[-4000:]))
    result["import_check"] = "LOADED []"
    print("workflow import check: a CLI run of the small AlexNet on the "
          "card loaded neither jax nor veles_tpu")
    return result, [forms]


def rating_phase(torch):
    """``gemm_benchmark()`` at bf16 and float32 (1500^2, the rating),
    bf16 at 1536^2 (3072-byte rows, 16-byte aligned, where 1500's
    3000-byte rows are not), and a ``torch.profiler`` table of one bf16
    ``gemm_benchmark()`` call (a warm-up chain and the timed chain):
    each kernel's name and device time per launch, to hold the events'
    ms per product against the device's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from veles_tpu_torch.ops.benchmark import gemm_benchmark
    rating = {dtype: gemm_benchmark(dtype=getattr(torch, dtype))
              for dtype in ("bfloat16", "float32")}
    rating["bfloat16_1536"] = gemm_benchmark(size=1536)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = gemm_benchmark()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                    row_limit=12))
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        kernels[evt.key] = {"launches": evt.count,
                            "device_us_per_launch": us / max(evt.count, 1)}
    # gemm_benchmark's default chain: 5 products
    rating["bfloat16_profile"] = {
        "kernels": kernels,
        "events_ms_per_product": 1e3 * profiled["seconds"] / 5}
    return rating


def main():
    import numpy
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import veles_tpu_torch  # noqa: F401  (fails outside a checkout)
    from veles_tpu_torch.nn.precision import get_policy
    from veles_tpu_torch.ops import build
    from veles_tpu_torch.ops.gemm_bench import card_line

    card = card_line()
    print(card)
    print("torch %s, CUDA %s, device %s" % (
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0)))
    t0 = time.perf_counter()
    seconds = build.build_all()
    print("build: %s (all in parallel, %.1f s wall)" % (
        ", ".join("%s %.1f s" % kv for kv in sorted(seconds.items())),
        time.perf_counter() - t0))
    print("build: CPython bindings %s" % ", ".join(
        "%s %.1f s" % kv for kv in sorted(seconds.items())
        if kv[0].endswith("_binding.cpp")))
    get_policy("float32").configure_backends()

    kernels = gemm_phase(torch)
    scratch = torch.empty(COLD_SCRATCH_BYTES // 4, device="cuda")
    kernels += (lrn_phase(torch, scratch) + lrn_bwd_phase(torch, scratch) +
                reduce_phase(torch, scratch) +
                uniform_phase(torch, scratch) + kahan_phase(torch, scratch))
    del scratch
    for row in kernels:
        print("kernel %-14s %-32s err %.3g  %.4f ms  plain %.4f  "
              "library %.4f  bound %.4f (%s)%s%s" % (
                  row["name"], row["shape"], row["max_abs_err"], row["ms"],
                  row["plain_ms"], row["library_ms"], row["bound_ms"],
                  row["bound_by"], "" if "variant" not in row else
                  "  %s%s" % (row["variant"], " x%d" % row["splits"]
                              if "splits" in row else ""),
                  "" if "ms_cold" not in row else
                  ", cold %.4f (library %.4f), host %.1f us" % (
                      row["ms_cold"], row["library_ms_cold"],
                      row["host_us"])))

    print("split sweep (%s): %s" % (card, json.dumps(split_sweep(torch))))
    print("kahan split sweep (%s): %s" % (card,
                                          json.dumps(kahan_sweep(torch))))

    model, served, serving_forms = slice_phase(torch, numpy)
    check_forms("serving", kernels, serving_forms)
    check_designed("serving", served["gemm_variants"])
    served.update(forward_phase(torch, model))
    print("serving (%s): %s" % (card, json.dumps(served)))
    del model

    phases = [serving_forms]
    trained = []
    for policy, check in (("float32", True), ("bfloat16", False)):
        result, forms = training_phase(torch, policy, check)
        check_forms("training " + policy, kernels, forms)
        check_designed("training " + policy, result["gemm_variants"])
        phases.append(forms)
        trained.append(result)
        print("training (%s): %s" % (card, json.dumps(result)))
    get_policy("float32").configure_backends()

    disciplines, forms = disciplines_phase(torch, numpy, card)
    check_forms("disciplines", kernels, forms)
    check_designed("disciplines", disciplines["gemm_variants"])
    phases.append(forms)
    print("disciplines (%s): %s" % (card, json.dumps(disciplines)))
    print("device rating (%s): %s" % (card, json.dumps(rating_phase(torch))))

    baseline, forms = baseline_phase(torch, kernels)
    phases.extend(forms)
    print("baseline (%s): %s" % (card, json.dumps(baseline, default=str)))

    sequence, forms = sequence_phase(torch, numpy, kernels)
    phases.extend(forms)
    print("sequence (%s): %s" % (card, json.dumps(sequence, default=str)))

    workflow, forms = workflow_phase(torch, numpy, kernels)
    phases.extend(forms)
    print("workflow (%s): %s" % (card, json.dumps(workflow, default=str)))

    for row in kernels:
        form = row.pop("_form")
        row["launches"] = sum(forms.get(row["name"], {}).get(form, 0)
                              for forms in phases)
    print(card)
    print(json.dumps({"kernels": kernels, "not_ported": not_ported()}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
