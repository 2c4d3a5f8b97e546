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
   objects 10000 + 2000, each data set drawn once): mnist-fc
   (784-100-10, batch 500) and mnist-conv (``CONV_LAYERS``, 250) built
   from their layers, cifar-quick (``CifarWorkflow``: ``CIFAR_LAYERS``,
   ``mean_disp``, 250) and mnist-ae (``MnistAEWorkflow``: 784-100-784
   under MSE, 500) through their workflow classes at ``bench_all.py``'s
   constructor arguments, initialized on the card with their layers
   under the policy (``set_policy``) and trained by
   ``train.runner.trainer_for``; each under float32 and bfloat16_mixed,
   weights and shuffles from seed 1234.
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
   versions; then mnist-fc with a solver a layer (fc1 SGD, the head
   Adam): one float32 epoch through the fused trainer and one through
   the eager unit graph from the same weights and shuffle, every
   parameter and solver state within the mixed bounds
   (``MIXED_ATOL``...), K1 and K6 launched the step's counts by both,
   and the fused trainer with SGD on both layers as the control that
   must fail the bounds. (5) The 8x8 SOM over the digits, three epochs
   at minibatch 1024: its quantization error falls below the untrained
   codebook's, ms an update by CUDA events, no kernel of the port
   launched. (6) The
   samples of ``models/samples.py`` through their workflow classes at
   their defaults, ``WineWorkflow`` (13-10-3, batch 50),
   ``LinesWorkflow`` (a small conv net, 50) and ``KanjiWorkflow`` (100
   classes of glyph pairs, 20000 + 2000 samples, 100), run as (1)-(3).
8. Sequence phase: ``scripts/bench_all.py``'s attention (2 attention
   layers of 8 heads over (256, 256) samples, softmax over 8 classes)
   and moe (attention, 8-expert MoE, attention over (128, 256))
   configurations, ``SequenceProvider`` 4096 + 256, batch 64. (1) The
   attention model (weights from numpy seed 2468) behind
   ``ServingFrontend`` (one replica, max batch 64): 3 rounds of 16
   concurrent single requests and one 64-row batch request, base64
   bodies; every reply held to the plain forward on the card by the
   centred-logit check, a reply swap and a zeroed head as controls that
   must fail it; p50/p95, the batch's samples/s, the device forward at
   batch 1 and 64. (2) The moe model served: each row of a 64-row batch
   request held to the same sample forwarded alone (batch-composition
   independence), the capacity pooled over the batch as the control that
   must fail, and a single request equal to its batch row. (3) Each
   configuration built as ``SequenceWorkflow`` with ``bench_all.py``'s
   constructor arguments (``heads=8``, ``moe``, ``n_experts=8``, batch
   64) and trained by ``trainer_for`` 3 epochs under float32 and
   bfloat16_mixed, streams from seed 2468, at lr 0.01 (the workflow's
   0.1 makes the loss climb at these widths, in the JAX package too) as
   (1)-(3) of the baseline phase: the float32 step
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
   random streams dropped must fail that. In deterministic mode (cuDNN
   deterministic, its benchmark off, ``torch.use_deterministic_
   algorithms`` with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the
   first cuBLAS call) a second uninterrupted run and the same resume
   differ from a first one in 0 values of the losses and of every
   parameter, and the ops without a deterministic version are listed.
   (3) ``--test -w`` on the final
   snapshot: one forward-only epoch, no weight changed. (4)
   ``ModelStore.load`` of the snapshot directory behind
   ``ServingFrontend``, 16 concurrent requests and a 64-row batch
   checked as in phase 3. (5) Every launch of (1)-(4) at a checked form,
   every K1 launch on a designed variant, every K3, K4 and K6 launch on
   a designed form; the idle share from one profiled step. (6) A CLI run
   of the small AlexNet in a process of its own loads neither ``jax``
   nor any ``veles_tpu`` module.
10. Eager phase: ``python -m veles_tpu_torch --eager`` on the workflow
   phase's file, 2 epochs in deterministic mode, a raw snapshot every
   epoch. (1) Held to the fused CLI run of the same file and seed: each
   epoch loss within 1e-6 relative and fc7's final weights within 1e-3
   of their change (the values that differ counted); the same eager run
   with fc7's gradient unit gated off must fail that. (2) K1, K3, K4, K6
   and K7 launched exactly the unit graph's counts, the fused run's, at
   checked forms, K1 on designed variants, K3, K4 and K6 on designed
   forms. (3) The eager step's device ms (CUDA events from one loop
   iteration to the next) and host ms beside the fused step's, the idle
   share of one profiled eager step, the launches per step. (4) The
   eager snapshot after epoch 0 resumed fused (``-w``) to the eager
   run's end, 0 values differing.
11. Export and serve phase: the eager AlexNet written to a ``.tar``
   package from the card's tensors, every array member its unit's
   parameters in the JAX layout bit for bit, and refused by
   ``ModelStore.load`` (``ModelLoadError``: convolutions); mnist-fc
   (784-100-10, batch 500, golden digits 12000 + 2000, ``-s 1234``)
   trained one eager epoch on the card (its K1 and K6 counts exact) and
   exported; the ``serve`` command's arguments (``serving.frontend.
   serve``, in this process so that launches count) on the mnist-fc
   package and on the eager AlexNet's snapshot directory, each checked
   as the slice phase checks (16 concurrent single requests and a
   64-row batch, the centred-logit check and its two controls, K1 at
   checked forms on designed variants; p50/p95 and samples/s); the
   port refuses none of the JAX command's flags.
12. Residency phase (out of core), deterministic mode: full-width
   AlexNet-227 at ``bench.py``'s settings over ``SyntheticImageLoader``
   2048 + 256 samples in bf16 (712 MB). (1) Resident in-core, 2 epochs:
   the reference. (2) Streamed: ``VELES_DEVICE_BUDGET_MB=400`` makes the
   planner stream (2 minibatches a shard, 8 training shards, the plan
   printed); 0 values differ from (1) (losses, validation errors,
   confusion, parameters), the same launches, the peak allocated bytes
   at most (1)'s less the dataset plus the ring's slots and a slack; a
   throttled loader (``VELES_ETL_THROTTLE_MS`` of a shard's compute)
   waits less at depth 2 than at depth 0 (two sweeps each, in the order
   0, 2, 2, 0, their waits summed); the ring as it is under a
   ``torch.cuda._sleep`` before each shard's first use (0 values); a
   control that must differ: shard k fed shard k-1's rows; and the
   depth-2 held control (``HeldRefill``: CUDA stream memory operations,
   one minibatch a shard, two slots): the consumer's stream held before
   the first training shard until its slot's refill (shard 2) lands,
   released from a side stream after 0.5 s where none does. Once with a
   ring that refills without the consumer's event: it must differ (the
   held shard computes on shard 2's rows) with no fallback; once with
   the ring as it is: 0 values differing, its one hold released by the
   fallback (its refill waits for the held read). (3)
   Offloaded: ``VELES_OFFLOAD=1``,
   ``VELES_OFFLOAD_GROUP_MB=150``: the plan's 4 groups, 0 values differ
   from (1), launches as derived from the plan (the forwards of groups
   0..G-2 again in each backward walk), the peak below (1)'s less fc6's
   state plus the largest group; control: fc6's writeback skipped.
   Step ms by CUDA events, input and upload waits, starvation, overlap,
   H2D and D2H GB/s. (4) A streamed and an offloaded epoch in a process
   of their own load no JAX. (5) ``ChannelsWorkflow`` through the CLI
   for 3 epochs when Pillow imports (the line says which): the loss
   falls, K1 and K6 at the model's counts.
13. Observability phase: the telemetry plane and the full serving
   engine on the card. (1) alexnet-train-traced-f32: ``python -m
   veles_tpu_torch --trace-out`` on phase 9's file, 3 epochs, snapshotted:
   the trace loads with 3 ``step:train``, ``step:eval`` and ``epoch``
   spans and no unit spans but the snapshotter's (one eager epoch's trace
   has every forward unit's); ``veles_step_mfu`` in (0, 1] and within 1%
   of this script's reckoning (``model_cost``'s FLOPs a sample x the
   sweep's samples / the runner's ``train_s`` / 989 TFLOP/s);
   ``veles_step_ms{phase="train"}``'s p50 within 5% of the runner's
   median sweep; the launches exactly the untraced run's derived counts;
   the memory profile written. (2) alexnet-stream-traced: one streamed
   epoch (``VELES_STREAM=1``, the 400 MB budget) with the ``prefetch:*``
   spans and ``veles_input_starvation_fraction`` equal to the runner's
   starvation, and one offloaded epoch (150 MB groups) with
   ``offload:h2d`` / ``offload:d2h`` spans for every group of the plan and
   the ``offload:<dir>/g<k>`` cost rows. (3) The flight recorder: 2 epochs
   with a NaN written into one staged training row after epoch 0 write
   one record a detector (non-finite loss, non-finite gradient norm),
   the first naming epoch 1 and the row's batch, with log lines and
   spans; the same run
   without the NaN writes none. (4) Tracing's cost: 11 epochs with
   tracing flipped at each epoch's end, the median train sweep of 5
   traced against 5 untraced: AlexNet-227 at most 2%, mnist-fc reported.
   (5) alexnet-serve-full-f32: ``serve`` with every flag (``--model
   alexnet=<the traced run's snapshots> --model mnist=<mnist-fc's
   package>``, ``--cache-mb 64``, two ``--tenant``s, ``--min-replicas 1
   --max-replicas 2``, ``--web-status`` at a local stub, ``--trace-out``):
   on each route 16 concurrent singles (from a client process of their
   own, each with an ``X-Request-Id``) and a 64-row batch, checked as the
   slice phase checks, K1 and K3 at the forwards' counts; the server's
   latency p50 within 20% of the clients' over 16 sequential requests
   (the concurrent round's reported beside); the 16 bodies again: bit for
   bit, 16 cache hits, no K1 or K3 launch; a swap answered by the new
   model, while a cache keyed by the content alone serves a stale row
   (the control); a burst of new rows submitted to the AlexNet route's
   engine under a cut admission bound (through HTTP the queue never
   builds: the card outruns the frontend) scales it to 2 replicas, the
   new one warmed on the card while the first serves, every admitted row
   answered, then back to 1 (reaction time printed); ``/metrics``
   (Prometheus lines, the
   serving, op, HBM families), ``/profile.json`` (``serve_forward:b64``
   with FLOPs, bytes, p50, bound, utilization <= 1.05), ``/alerts.json``,
   ``/history.json`` and a status POST with the JAX payload's keys; the
   trace's ``http:*`` spans carry the request ids, and the attribution
   (``http:<endpoint>`` p50 against ``serve_forward`` p50) is printed.
   (6) ``serve`` with every flag and a traced CLI epoch in a process of
   their own load no JAX.
14. Distributed phase: master/slave training on phase 9's file through
   the CLI (``-l`` / ``-m``), each process of its own, the master with
   no visible card (``CUDA_VISIBLE_DEVICES`` empty; it reports CUDA
   uninitialized and no dataset staged), the slaves on the card; no
   process loads ``jax``, ``ml_dtypes`` or ``veles_tpu``. (1) One slave,
   ``--segment-size 8 --no-pipeline``, deterministic, 4 epochs, against
   the deterministic standalone run of the same file and seed, a
   process of its own too, run beside it: each epoch's loss within 1e-6 relative, fc7
   within 5e-2 of its change (the workflow phase's bound for runs that
   are not bitwise: additive deltas round where a weight shrinks toward
   zero), the values that differ printed; the master dropping fc7's
   deltas must fail it.
   (2) Two pipelined slaves, ``--segment-size 2``, float32 deltas, 4
   epochs: every epoch exactly 512 training and 128 validation samples,
   a finite falling loss, both slaves did jobs, their summed K1, K3,
   K4, K6 and K7 launches (each slave writes its counters on exit) the
   counts the minibatches the master served give (the pipelines' run
   past the last epoch included, and printed), at checked and designed
   forms.
   (3) A slave killed by the chaos stream on its 8th job (mid-epoch 1,
   ``--segment-size 1 --no-pipeline``, deterministic, momentum 0, a
   replacement finishing the run) against the unfaulted run: the curve
   and every parameter bit for bit, ``veles_jobs_requeued_total
   {reason="dead"}`` risen. (4) ``--exchange-dtype bfloat16`` trains 2
   epochs; with (1)'s full pushes and (2)'s float32 deltas, the bytes a
   job each way. (5) Per job, the slaves' decode, compute, encode and
   shared-memory ms and their waits, the master's encode and decode ms,
   and the fleet's samples/s beside the standalone sweeps'.
15. SPMD phase: the port's ``torch.distributed`` tier on the card, every
   world's ranks processes of their own sharing the one H100 (gloo with
   CUDA tensors; a world of one rank NCCL), no rank loading ``jax``,
   ``ml_dtypes`` or ``veles_tpu``. (1) ``--gspmd 1x1`` on phase 9's
   AlexNet-227 file, 2 epochs, deterministic: NCCL, and every loss and
   parameter bit for bit the standalone deterministic run's (a process
   of its own too; the two run beside each other). (2) ``--gspmd
   2x1`` through the multi-process flags
   (``--jax-coordinator``, ``--jax-processes``, ``--jax-process-id``, one
   process a rank, meeting at a file store) and (3) ``--gspmd 1x2``
   (rank 0 starting rank 1 itself, at its TCP store): each epoch's
   losses within 1e-5 relative, every parameter tensor within 5e-2 of
   its change, and each run's control with the gradient collectives
   skipped beyond that (both controls at once, their ranks started
   through the flags). (4) The attention model at ``bench_all.py``'s
   widths (2 layers, seq 256, dim 256, 8 heads, batch 64, lr 0.01; 640
   + 128 samples) with ``use_ring`` ``ring`` and ``ulysses`` at 2 ranks:
   the forward within 1e-5 of the unsharded forward's largest value,
   one epoch's losses within 1e-6 relative and every parameter within
   5e-2 of its change of the unsharded epoch's, and a control whose
   sharded backward drops a term (the reverse ring's dK/dV carry,
   Ulysses's other ranks' parts) beyond that. (5) The moe model (8
   experts, seq 128) with ``use_experts`` at 8 ranks: the layer within
   1e-5 of ``moe_ffn_reference(n_shards=8)`` on the card, then 4
   training steps alike on every rank, their losses within 1e-5
   relative and the parameters within 5e-2 of their change of the same
   steps with that per-shard routing in one process, and a control
   without the router gradient's sum over the ranks beyond that. The
   sequence, expert and pipeline worlds run through
   ``tests/torch_world.py``, loaded by path. (6) A 2-stage
   ``pipeline_apply`` and one ``pipeline_train_step`` within 1e-5 of the
   sequential run. Every K1, K3, K4, K6 and K7 launch of every rank at
   a form the kernel phase checked (the phase's new forms: K1 at the
   tensor-parallel half widths, K4 and K6 at the half batch and half
   widths). Printed, not gated: each world's backend, start-up time and
   collectives staged through the host, each run's samples/s and step
   ms by CUDA events, ``veles_gspmd_step_ms`` and ``veles_reshard_ms``;
   the whole result to ``chiprun_out/spmd.json``.
16. Elastic phase: the port's elastic tier (``parallel/elastic.py``) on
   phase 9's AlexNet-227 file (``-s 7``, 2 epochs, deterministic mode),
   every run's workers processes of their own on the card, each
   ``ELASTIC_WORKER`` (``run_elastic_training`` on the file's workflow;
   generations raw), the supervisors ``python -m veles_tpu_torch.
   parallel.elastic supervise`` at an in-process ``RendezvousServer``.
   The references: the worker alone (one rank, no supervisor) and a
   supervised ``2x1`` world uninterrupted. (A) Rank 1 SIGKILLs itself
   at the first epoch boundary, before that epoch's generation commits:
   its supervisor (crash budget 0) leaves, the survivor's kills its
   worker (out of the gloo collective its peer left), the world
   re-forms at 1 from the generation-initial checkpoint written at
   world 2 (``part0`` and ``part1``), and the run's history and final
   parameters equal the one-rank run's in every value; generation >= 1,
   world 1, a lost participant counted, and the port's
   ``spmd_participant_lost`` alert firing. (B) Rank 1 dies at the second
   epoch boundary, after the first epoch's generation committed: the
   survivor restores that generation, the first epoch equals the 2x1
   run's to the bit, and the final parameters are within 5e-2 of their
   change of the 2x1 run's. (C) A ``1x2`` world's generation restored
   at ``1x1`` here: every parameter the world's gathered whole to the
   bit. Controls that must fail: a generation without its manifest and
   one with ``part1`` truncated do not load, and ``restore_latest``
   falls back past each; leg A's generation restored without the random
   registry differs from the one-rank run. Every K1, K3, K4, K6 and K7
   launch of every worker at a checked form, each kernel launched in
   every run. Printed, not gated: each worker's generation, world,
   start-up s, samples/s a training sweep, step ms by CUDA events, each
   generation it cut (MiB pickled, s, MiB on disk) and what it restored;
   the re-form (``veles_spmd_recovery_ms{reform}`` of the server),
   respawn (the supervisors', through the rendezvous's federated view)
   and restore (the workers') latencies; the whole result to
   ``chiprun_out/elastic.json``.
17. Meta-workflows and the gang scheduler: every job AlexNet-227 at
   full width, 1 epoch of 512 + 128 samples, deterministic (the job's
   workflow file switches the modes on under ``SMOKE_DETERMINISTIC=1``),
   on the card, in a process of its own or a warm worker. The file is
   phase 9's with its learning rate read from ``root.meta.lr`` (``Tune(0.01, 0.002, 0.05)`` in the genetics
   config), ``publish_output`` on, the loader never reshuffling, and a
   snapshotter only for the ensembles. (A) ``python -m veles_tpu_torch
   --optimize 2:3 -s 7`` (4 evaluations in one warm worker): every
   fitness finite, one worker pid, the card's allocated bytes after the
   last job at most the first's plus 64 MiB, each job launching K1, K3,
   K4, K6 and K7; the best chromosome re-run cold (``python -m
   veles_tpu_torch``, its argv) equals the warm results in every value,
   and the control (the job in a warm worker under another seed)
   differs. (B) ``ScheduledGeneticsOptimizer`` over ``Scheduler(3,
   preempt=False)``, each chromosome a cold job, three on the card at
   once, from (A)'s seed and stream: the best fitness and its overrides
   (A)'s bit for bit, every job ``DONE`` under tenant ``genetics``,
   ``veles_sched_jobs_total`` published. (C) ``--ensemble-train 2:0.8``
   then ``--ensemble-test``: two snapshots ``wf_m0``/``wf_m1`` in one
   directory, each member's test pass 128 + int(0.8 x 512) rows, fc7
   differing between members, each member's test equal to a cold ``-w
   <snapshot> --test`` run in every value, ``EnsembleLoader`` on the
   card stacking the members' ``Output`` to the bit, the aggregate
   ``aggregate_metrics`` of the members. (D) ``python -m
   veles_tpu_torch sched serve --pool 1 --state-dir``: tenant a's
   preemptible job (phase 16's worker, 2 epochs) submitted through
   ``sched submit``, held (SIGSTOP) once its first generation committed,
   preempted by tenant b's interactive 1-epoch job, resumed from its
   generation; the scheduler then killed while a's second grant runs and
   restarted on the same state directory: it adopts a's gang (same
   pid), a ends ``DONE``; a's history and final parameters equal phase
   16's one-rank run of the worker in every value, its resumed worker
   restored a generation, the journal reads submit, grant, preempt,
   grant, ``veles_sched_preemptions_total`` is 1, ``sched status`` read
   through the CLI. Every launch of every job at a checked form (a warm
   worker's replies, the file a cold job's workflow file writes under
   ``SMOKE_KERNEL_REPORT``, the
   elastic worker's report). (A)'s cold re-run starts beside its
   control, (C)'s cold tests beside the CLI's tests, (A) then (C) in one
   thread beside (D) then (B). Printed, not gated: each evaluation's wall
   and samples/s, the warm worker's start-up, each generation's wall,
   queue waits, preempt-to-resume s, the adoption latency; the whole
   result to ``chiprun_out/meta.json``.
   Phases 14, 15, 16, 17 and 22 run beside each other (``beside``: a
   thread each, waiting on its own processes), so their times are read
   under each other's load; a line gives every phase's seconds.
18. Service phase: queue-fed serving, the URI snapshot stores and the
   autotuner, after 14-17 (serially, so the timing is quiet). At the
   script's start the autotuner is pointed at a fresh empty cache
   (``VELES_AUTOTUNE=cache``), so every phase and process before this
   one plans by default; a line checks that every K1/K2 and K5 launch
   so far (the split sweeps' left out) ran at its plan's own split
   count. (1) ``python -m veles_tpu_torch.ops.gemm_bench --autotune``
   in a process of its own into a cache of the phase
   (``VELES_AUTOTUNE_BUDGET_S`` 0.5 a key): K1 at the served fc6/fc7
   (M = 1 and 16), K1/K2 and K5 at the flagship products of batch 128;
   its table printed beside the split sweeps' times of the shapes both
   measured; every entry's split count on the card held to the plain
   version at the kernel phase's tolerances; a fresh read of the file
   in ``cache`` mode gives every plan as persisted with 0 searches.
   (2) Phase 9's file cut to 128 + 64 samples through the CLI (``-s 7``,
   one epoch, the default cache), its ``SnapshotterToFile`` export and
   a ``SnapshotterToDB`` export (raw), restored through ``import_``
   from ``sqlite://db#key``, ``sqlite://db`` (the newest row) and
   ``http://`` off a local ``http.server``: 0 parameter values differ
   each time; a missing key and a body cut to half its Content-Length
   must fail; the MiB, each export's and restore's seconds and
   ``SQLITE_LIMIT_LENGTH`` printed. (3) The restored forward units
   behind ``RestfulLoader`` -> ``RESTfulAPI`` on the card, the phase's
   cache in ``cache`` mode: ``minibatch_size`` 1 and 16 (``batch_size``
   linked), each 2 rounds of 16 concurrent single requests (list codec,
   then base64), every reply held to the plain forward by the
   centred-logit check with a swapped pair and a zeroed fc7 as the
   controls; K1 and K3 twice a forward, every K1 launch at its cache
   entry's split count; a hand-written entry for fc7 at M = 1 at a
   count neither the default nor the tuned one: 4 requests launch at
   it and pass the check. p50 / p95 and forwards per round printed.
   (4) The same units behind ``SocketFedLoader``: a producer sends 8
   samples and one of the wrong shape (an error ack), then ``finish``,
   which ends the workflow; the rows held to the plain forward. The
   whole result to ``chiprun_out/service.json``.
19. Observers phase: the run's observers watch a full-width AlexNet-227
   CLI run, after phase 18 (serially). A ``web_status`` dashboard in
   this process; ``python -m veles_tpu_torch <file> -s 7 --web-status
   --result-file R`` in a process of its own on phase 9's AlexNet-227
   cut to 128 training samples and no validation class (so the
   confusion comes from ``FusedTrainer.confusion_segment``), 2 epochs,
   deterministic, a raw snapshot each epoch, ``add_plotters()``, a
   ``Publisher`` after the plots (markdown where jinja2 imports, pdf
   where matplotlib does), ``root.common.disable.plotting=False`` and
   the dashboard's address as overrides. The script subscribes to the
   run's graphics server (the run writes its endpoint and waits for its
   renderers; a ``graphics_client --mode png`` too where matplotlib
   imports; a line says which legs run only in the CPU tests). (a) Every
   epoch-curve snapshot on the wire holds the result file's history, 0
   values differing. (b) The last confusion snapshot sums to 128 and
   equals, 0 cells differing, the confusion recomputed here from the
   last snapshot through ``confusion_segment`` on the card
   (deterministic); with the truth shifted by one row (each label + 1)
   it must differ, and with fc8's classes rolled by one (weight rows and
   bias) it must differ too and come back with the weights restored.
   (c) That sweep equals numpy's matrix of the same forward's argmaxes,
   every row's top-two logit gap above 0; the classes predicted are
   printed (one under the filler's flat softmax: (b) then holds one
   column).
   (d) Those logits through K1 and K3 pass the centred-logit check
   against the plain versions, a swap and a zeroed fc7 failing it. The
   dashboard lists the run (mode ``standalone``, the unit count of
   ``graph_description()`` of the same file built here), its session's
   logs hold the publisher's record and its events the workflow's
   ``run`` begin and end; the last snapshot served through
   ``ServingFrontend`` with ``report_to`` the dashboard answers 8 single
   requests that pass the centred-logit check, and the dashboard's
   serving block counts them (its QPS over the metrics' window). The
   markdown report holds every value of the result file (where
   matplotlib imports: each plotter's PNG and the PDF are not empty);
   ``compare_snapshots``'s ``main()`` reads 0 for the last snapshot
   against itself and a nonzero change for every trained layer of epoch
   2 against epoch 1. The run's launches (its ``SMOKE_KERNEL_REPORT``)
   and the sweep's and the serving's at checked forms. Printed, not
   gated: the run's wall and start-up, each epoch's wall, train,
   confusion and services seconds, the graphics server's snapshots sent
   and dropped and each one's bytes, the dashboard's requests, the
   report's bytes; the whole result to ``chiprun_out/observers.json``.
20. Services phase: the services' remainder on a full-width AlexNet-227
   CLI run, after phase 19, in this process (``Main().run``), -s 7,
   deterministic. The class files are ``SyntheticImageLoader``'s
   generator pickled (128 training and 64 validation samples of
   227x227x3, minibatch 64, 2 epochs). Run H reads them through
   ``HDFSLoader`` from a WebHDFS stub on loopback and carries an
   ``Avatar`` (SERVICE, after the decision) of fc7's weights and bias and
   the loader's epoch number, its ``AvatarServer``, a ``RemoteAvatar``
   service pulling after it each epoch, a ``Shell`` (no ``-i``: a no-op)
   and a ``Manhole``; ``install_stack_dump_handler()`` is installed. Run
   D reads them through a ``Downloader`` of a ``.tar`` over ``http://``
   ahead of ``PicklesLoader``. (a) H and D: 0 values differing in their
   histories and final parameters; controls: a changed training label
   in the stub moves one loaded label, an archive without a promised
   file raises ``FileNotFoundError``, an unreachable namenode and none
   raise the gated ``RuntimeError``. (b) Every pull equals the Avatar's
   copy of its epoch, the last the final fc7 (0 values), revisions one
   apart, epoch 1's pull differing from the final fc7 (the control), a
   second ``RemoteAvatar`` after the run at the last revision. (c) Run H
   exported with a manifest (``alexnet227`` 1.0), uploaded by
   ``update_forge`` to a ``ForgeServer`` with a token, 1.1 through
   ``forge.client.main``; list and details show both; 1.0 fetched
   byte-equal, served (``ServeableModel.from_package(..., full=True)``
   behind ``ServingFrontend``): 8 singles and a 64-row batch pass the
   centred-logit check against the plain forward of run H's weights,
   a swap and a zeroed fc7 failing it; refused: an upload without the
   token (nothing stored), the same version again, a delete through GET;
   after a delete, ``/fetch`` answers 404. (d) A Manhole client reads
   fc7's bias sum on the card equal to the script's own; ``SIGUSR1``
   prints a dump naming ``MainThread``; ``debug_deadlocks()`` is empty;
   a ``-i`` launcher is interactive. (e) ``KohonenWorkflow.run()``
   (eager, on the card) and its ``make_fused_runner()`` from the same
   seeds over ``som_run``'s digits and 8x8 map, 2 epochs: 0 codebook
   values differ, the quantization error falls below the untrained
   codebook's, no kernel launched. (f) Runs H and D launch K1, K3, K4,
   K6 and K7 at exactly the fused run's counts, the serving K1 and K3,
   every launch at a checked form. Printed, not gated: the runs' walls,
   the forge's upload, fetch and load seconds, the package's MiB, the
   Avatar's publish ms and bytes, p50 / p95 of the 8 requests, whether
   IPython imports; the whole result to ``chiprun_out/services.json``.
21. Family phase: a workflow file whose ``GoldenCifar`` subclasses
   ``CifarWorkflow`` over golden objects 10000 + 2000 (drawn once in the
   file's module) at its default minibatch of 100, 1 epoch,
   deterministic, through the CLI in this process (``Main().run``, -s
   7). (a) ``veles_tpu_torch.run(GoldenCifar)`` from the same seeds: 0
   values differing (each epoch's errors and class losses, every
   parameter); ``run()`` seeded with 8 is the control that must differ
   (the first epoch's order does not depend on the loader's stream, so
   the loader seed alone would change no value in one epoch). (b) The CLI run, ``run()`` and the control
   each launch K1 and K6 at exactly the model's counts, every launch at
   a checked form (the kernel phase's K1 100x576x64 linear and
   100x784x100 tanh float32 rows and K6 rows at 102400x32, 22500x32,
   4900x64, 100x64, 100x10 and 100x100). (c) The parity harness's
   ``train_cifar`` on the same objects and ``train_fc`` on golden digits
   1000 + 500, one epoch each: their best validation errors reported.
   Printed, not gated: each run's wall and launches.
22. Installed phase: the port as a user on a card host installs it,
   beside phases 14-17. The package, ``pyproject.toml``, ``README.md``
   and ``deploy/torch/`` copied out of the tree into a temporary
   directory; ``deploy/torch/deploy.sh --target PREFIX`` there (pip
   offline, ``--no-deps``, into a temporary prefix; then ``python -m
   veles_tpu_torch.ops.build`` from outside the tree). (1) The prefix's
   ``csrc/`` is the tree's byte for byte, and every library the build
   lists was built into the prefix's ``csrc/build/`` during the phase
   (its seconds printed by source). (2) The installed ``veles-tpu-torch``
   (only the prefix on ``PYTHONPATH``, run from outside the tree) trains
   phase 9's file as phase 15's standalone run does (``-s 7``, 2
   epochs, deterministic) with a raw snapshot each epoch: its history
   and every parameter 0 values differing from that run; the same from
   ``-s 8`` (no snapshots) must differ; both imported
   ``veles_tpu_torch`` and ``csrc/`` from the prefix, loaded only the
   prefix's libraries and no ``jax``, ``ml_dtypes`` or ``veles_tpu``
   module; the run's K1, K3, K4, K6 and K7 launches by form equal the
   standalone run's, the control's too at checked and designed forms.
   (3) The installed ``veles-tpu-torch-serve`` on the run's snapshots:
   16 concurrent single requests (list codec) and one 64-row base64
   batch held by the centred-logit check to the plain forward of the
   run's final weights (the snapshot loaded here equal to the run's
   parameters), a reply swap and a zeroed fc7 as the controls; p50 / p95
   and the batch's rows/s printed. (4) The installed
   ``veles-tpu-torch-web-status`` and ``-forge-server`` each answer a
   GET; ``veles-tpu-torch-compare-snapshots`` reads 0 for the last
   snapshot against a copy. The whole result to
   ``chiprun_out/installed.json``.
23. The line before the last is ``{"kernels": [...], "not_ported":
   []}``; the last is ``{"ok": true, "device": {...}}``. Any failure
   raises and exits non-zero before them.
"""

import base64
import collections
import contextlib
import gc
import json
import math
import os
import statistics
import sys
import threading
import time
import urllib.error
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
#: mnist-fc with fc1 on SGD and the head on Adam (one solver a layer),
#: one float32 epoch fused and eager at the rate and decay of
#: ``tests/test_torch_solvers_mixed.py``
MIXED_SOLVERS = ("sgd", "adam")
MIXED_TRAINING = {"learning_rate": 0.01, "weights_decay": 1e-3}
#: their agreement, as that test's: the SGD layer's parameters and state
#: within MIXED_ATOL; the Adam head's with at most MIXED_ADAM_SHARE of
#: its elements past MIXED_ATOL and the whole within MIXED_ADAM_NORM of
#: its norm (Adam's step has the size of the rate wherever a gradient
#: cancels to rounding noise)
MIXED_ATOL = 1e-6
MIXED_ADAM_SHARE = 1e-3
MIXED_ADAM_NORM = 1e-5
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
#: phase 21's runs: ``CifarWorkflow`` at its default minibatch of 100 and
#: ``train_fc``'s 784-100-10 at the harness's 100 (K1 in float32 only:
#: the runs' policy), their bias gradients at that batch
FAMILY_GEMMS = (("cifar-quick fc", 100, 576, 64, "linear"),
                ("mnist-fc fc1", 100, 784, 100, "tanh"))
FAMILY_REDUCE_SHAPES = (("cifar-quick conv1 b100", 100 * 32 * 32, 32),
                        ("cifar-quick conv2 b100", 100 * 15 * 15, 32),
                        ("cifar-quick conv3 b100", 100 * 7 * 7, 64),
                        ("cifar-quick fc b100", 100, 64),
                        ("cifar-quick/mnist-fc head b100", 100, 10),
                        ("mnist-fc fc1 b100", 100, 100))
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
#: phase 15's forms of K1, K4 and K6 that no earlier path launches:
#: AlexNet-227 trained by ``--gspmd 2x1`` (each rank half the batch) and
#: ``--gspmd 1x2`` (the column layers' half widths; fc6 the row layer,
#: K1 without its bias). K1 and K3 at the half batch are the serving
#: rows' M = 64, K7 draws the whole batch's mask: both checked already.
SPMD_HALF = TRAIN_BATCH // 2
SPMD_GEMMS = (("fc6 row", TRAIN_BATCH, 9216 // 2, 4096, False),
              ("fc7 column", TRAIN_BATCH, 4096, 4096 // 2, True))
SPMD_LRN_BWD_SHAPES = ((SPMD_HALF, 56, 56, 96), (SPMD_HALF, 27, 27, 256))
SPMD_REDUCE_SHAPES = (("2x1 conv1", SPMD_HALF * 56 * 56, 96),
                      ("2x1 conv2", SPMD_HALF * 27 * 27, 256),
                      ("2x1 conv3/conv4", SPMD_HALF * 13 * 13, 384),
                      ("2x1 conv5", SPMD_HALF * 13 * 13, 256),
                      ("2x1 fc6/fc7", SPMD_HALF, 4096),
                      ("2x1 head", SPMD_HALF, 1000),
                      ("1x2 conv1", TRAIN_BATCH * 56 * 56, 96 // 2),
                      ("1x2 conv3", TRAIN_BATCH * 13 * 13, 384 // 2),
                      ("1x2 conv5", TRAIN_BATCH * 13 * 13, 256 // 2),
                      ("1x2 fc7", TRAIN_BATCH, 4096 // 2))
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
    for (layer, m, k, n, activation), dtypes in (
            [(g, ("float32", "bfloat16")) for g in BASELINE_GEMMS] +
            [(g, ("float32",)) for g in FAMILY_GEMMS]):
        w32 = (torch.rand(k, n, device="cuda", generator=gen) * 2 - 1) \
            / k ** 0.5
        b32 = torch.rand(n, device="cuda", generator=gen) * 0.2 - 0.1
        x32 = torch.rand(m, k, device="cuda", generator=gen) * 2 - 1
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            x, w, lib_bias = x32.to(dt), w32.to(dt), b32.to(dt)

            def library(x=x, w=w, lib_bias=lib_bias, act=activation):
                return ACTIVATIONS[act](torch.addmm(lib_bias, x, w))

            rows.append(gemm_row(
                torch, scratch, "%s M=%d K=%d N=%d %s %s bias" % (
                    layer, m, k, n, activation, dtype),
                x, w, b32, activation, dtype, library))
    # K1 on the mnist-fc package served at every bucket
    w = (torch.rand(784, 100, device="cuda", generator=gen) * 2 - 1) / 28.0
    b32 = torch.rand(100, device="cuda", generator=gen) * 0.2 - 0.1
    for m in BUCKETS:
        x = torch.rand(m, 784, device="cuda", generator=gen) * 2 - 1
        rows.append(gemm_row(
            torch, scratch, "mnist-fc served M=%d K=784 N=100 tanh float32 "
            "bias" % m, x, w, b32, "tanh", "float32",
            lambda x=x: torch.tanh(torch.addmm(b32, x, w))))
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
    # K1 on the SPMD tier's tensor-parallel half widths (phase 15)
    for layer, m, k, n, has_bias in SPMD_GEMMS:
        w = (torch.rand(k, n, device="cuda", generator=gen) * 2 - 1) \
            / k ** 0.5
        b32 = torch.rand(n, device="cuda", generator=gen) * 0.2 - 0.1
        x = torch.rand(m, k, device="cuda", generator=gen) * 2 - 1
        bias = b32 if has_bias else None
        activation = "strict_relu" if has_bias else "linear"

        def library(x=x, w=w, bias=bias):
            return F.relu(torch.addmm(bias, x, w)) if bias is not None \
                else torch.mm(x, w)

        rows.append(gemm_row(
            torch, scratch, "%s M=%d K=%d N=%d float32 %s" % (
                layer, m, k, n, "bias" if has_bias else "no bias"),
            x, w, bias, activation, "float32", library))
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
    for shape in ((TRAIN_BATCH, 56, 56, 96), (TRAIN_BATCH, 27, 27, 256)) \
            + SPMD_LRN_BWD_SHAPES:
        x32 = torch.rand(*shape, device="cuda", generator=gen) * 40.0
        g32 = torch.rand(*shape, device="cuda", generator=gen) * 2 - 1
        # the data-parallel half batch trains float32 only
        for dtype in ("float32",) if shape in SPMD_LRN_BWD_SHAPES else (
                "float32", "bfloat16"):
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
                        FAMILY_REDUCE_SHAPES + SEQUENCE_REDUCE_SHAPES +
                        SPMD_REDUCE_SHAPES):
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
    shapes (the training batch's and phase 20's), through its CPython
    binding (:func:`check_binding`), timed back-to-back (``ms``, which
    reads the host when ``host_us`` exceeds the device time), one call at
    a time (``ms_cold``, the device's time) and on the host, beside
    ``torch.rand``'s same three."""
    from veles_tpu_torch.ops.random import (dropout_offset, uniform_fill,
                                            uniform_fill_plain)
    rows = []
    for shape in ((TRAIN_BATCH, 4096), (SERVICES_BATCH, 4096)):
        seed, offset = 0x243F6A8885A308D3, dropout_offset(3, 11)
        got = uniform_fill(shape, seed, offset, device="cuda")
        want = uniform_fill_plain(shape, seed, offset, device="cuda")
        torch.cuda.synchronize()
        name = "%dx%d float32" % shape
        if not torch.equal(got, want):
            raise AssertionError("uniform_fill %s: %d values differ from "
                                 "the plain version's bits" % (
                                     name, int((got != want).sum())))
        gen = torch.Generator(device="cuda").manual_seed(5)
        values = shape[0] * shape[1]
        bms, by = bound(4 * values, values * UNIFORM_OPS_PER_VALUE,
                        "float32")

        # as the trainer calls it: with a tensor's device, card index and
        # all
        device = torch.empty(0, device="cuda").device

        def kernel():
            return uniform_fill(shape, seed, offset, device=device)

        def library():
            return torch.rand(shape, device="cuda", generator=gen)

        rows.append({
            "name": "uniform_fill", "shape": name, "route": "cuda",
            "_form": shape, "source": UNIFORM_SOURCE,
            "replaces": UNIFORM_TPU, "call": "binding " + UNIFORM_BINDING,
            "values_differ": 0,
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
            "library_host_us": host_us(torch, library)})
    check_binding("uniform_fill", "veles_uniform_fill")
    return rows


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
    batch 64), checked by :func:`serve_checked`. Returns (result,
    launches_by_form)."""
    from veles_tpu_torch.serving.frontend import ServingFrontend

    t0 = time.perf_counter()
    frontend = ServingFrontend(model, host="127.0.0.1", port=0,
                               replicas=1, max_batch_size=64,
                               batch_timeout_ms=5.0, max_queue=256,
                               response_timeout=300.0)
    warm_s = time.perf_counter() - t0
    print("%s: replica warmed (buckets %s) in %.2f s" % (
        label, frontend.pool.replicas[0].warmed_buckets, warm_s))
    return serve_checked(torch, numpy, frontend.start(), label, rounds)


def serve_checked(torch, numpy, frontend, label, rounds):
    """A started frontend's model (its All2All and LRN layers through K1
    and K3) checked over HTTP: ``rounds`` of 16 concurrent single
    requests and one 64-row batch request, every reply held to the plain
    forward on the card by the centred-logit check, with a reply swap
    and the last K1 layer's output zeroed as the controls that must fail
    it; K1 and K3 once per such layer per forward, no training kernel.
    Stops the frontend. Returns (result, launches_by_form)."""
    from veles_tpu_torch.models.build import plain_forward
    from veles_tpu_torch.nn.all2all import All2AllSoftmax
    from veles_tpu_torch.serving.frontend import parse_payload

    model = frontend.model
    sample_shape = tuple(model.sample_shape)
    kinds = [type(m).__name__ for m in model.module]
    k1_layers = [i for i, m in enumerate(model.module)
                 if type(m).__name__.startswith("All2All") and
                 not isinstance(m, All2AllSoftmax)]
    per_forward = {"gemm_bias_act": len(k1_layers),
                   "lrn_fwd": kinds.count("LRNormalizerForward")}
    rng = numpy.random.RandomState(0)
    n_single = 16
    singles = rng.uniform(-1, 1, (rounds, n_single) + sample_shape
                          ).astype(numpy.float32)
    batch = rng.uniform(-1, 1, (64,) + sample_shape).astype(
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
        lrn_forms = check_designed_forms(label, ("lrn_fwd",)) \
            if per_forward["lrn_fwd"] else {"lrn_fwd": {}}
        forwards = replica.batches_done - forwards0
    finally:
        frontend.stop()
    want_counts = dict({k: n * forwards for k, n in per_forward.items()},
                       lrn_bwd=0, column_reduce=0, uniform_fill=0,
                       kahan_gemm=0)
    if forwards < 1 or counts != want_counts:
        raise AssertionError(
            "serving launch counts %s over %d forwards (expected %s: %s "
            "per forward, no training kernel)" % (
                counts, forwards, want_counts, per_forward))
    print("%s: %d forwards served, gemm_bias_act launched %d times, "
          "lrn_fwd %d times (%s per forward)" % (
              label, forwards, counts["gemm_bias_act"], counts["lrn_fwd"],
              per_forward))

    # hold every reply against the plain-version forward on the card
    served = numpy.concatenate(
        [numpy.array([replies[(r, i)]["result"] for i in range(n_single)])
         for r in range(rounds)] + [numpy.array(batch_reply["results"])])
    inputs = numpy.concatenate([singles.reshape((-1,) + sample_shape),
                                batch])
    want = forward_rows(torch, numpy, lambda x: plain_forward(
        model.module, x), inputs)
    if served.shape != want.shape or not numpy.isfinite(served).all():
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
    # the kernel forward with the last K1 layer's output (AlexNet's fc7)
    # zeroed
    swapped = served.copy()
    swapped[[0, 1]] = served[[1, 0]]
    zeroed = forward_rows(torch, numpy, lambda x: forward_zeroing(
        model.module, x, k1_layers[-1]), inputs)
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
    count nothing (:func:`veles_tpu_torch.models.build.model_cost`, the
    cost book's source)."""
    from veles_tpu_torch.models.build import model_cost
    return model_cost(model)["train_flops"]


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
    """[(name, build)] of the BASELINE training paths at ``bench_all.py``'s
    sizes, ``build(policy, solver="sgd", **hyper)`` giving the path's
    trainer on the card (:func:`baseline_trainer`), and the digits
    provider (the SOM's data). mnist-fc and mnist-conv are built from
    their layers (``build_training``); cifar-quick, mnist-ae, wine,
    lines and kanji through their workflow classes, with
    ``bench_all.py``'s constructor arguments (:func:`workflow_trainer`)."""
    from veles_tpu_torch.datasets import golden_digits, golden_objects
    from veles_tpu_torch.models.cifar import CifarWorkflow
    from veles_tpu_torch.models.mnist import (MNIST_LAYERS,
                                              MNIST_SAMPLE_SHAPE,
                                              MNIST_TRAINING, MnistLoader)
    from veles_tpu_torch.models.mnist_ae import MnistAEWorkflow
    from veles_tpu_torch.models import samples
    from veles_tpu_torch.models.parity import CONV_LAYERS
    # each data set drawn once
    digits = Frozen(golden_digits(*BASELINE_DIGITS))
    objects = Frozen(golden_objects(*BASELINE_OBJECTS))
    kanji = Frozen(samples.KanjiProvider(n_train=20000, n_valid=2000))
    lines = Frozen(samples.LinesProvider())
    wine = Frozen(samples.WineProvider())

    def layered(layers, sample, loader, keywords):
        return lambda policy, solver="sgd", **hyper: baseline_trainer(
            layers, sample, loader, dict(keywords, **hyper), policy, solver)

    def classed(factory):
        return lambda policy, solver="sgd", **hyper: workflow_trainer(
            lambda launcher: factory(launcher, solver=solver, **hyper),
            policy, BASELINE_SEED)

    return [
        ("mnist-fc", layered(
            MNIST_LAYERS, MNIST_SAMPLE_SHAPE,
            lambda: MnistLoader(provider=digits, minibatch_size=500),
            MNIST_TRAINING)),
        # StandardWorkflow's defaults: lr 0.01, no momentum
        ("mnist-conv", layered(
            CONV_LAYERS, (28, 28, 1),
            lambda: MnistLoader(provider=digits, flatten=False,
                                minibatch_size=250), {})),
        ("cifar-quick", classed(lambda launcher, **kw: CifarWorkflow(
            launcher, provider=objects, minibatch_size=250, **kw))),
        ("mnist-ae", classed(lambda launcher, **kw: MnistAEWorkflow(
            launcher, provider=digits, bottleneck=100, minibatch_size=500,
            learning_rate=0.001, **kw))),
        ("kanji", classed(lambda launcher, **kw: samples.KanjiWorkflow(
            launcher, provider=kanji, **kw))),
        ("lines", classed(lambda launcher, **kw: samples.LinesWorkflow(
            launcher, provider=lines, **kw))),
        ("wine", classed(lambda launcher, **kw: samples.WineWorkflow(
            launcher, provider=wine, **kw))),
    ], digits


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


def baseline_trainer(layers, sample, loader, keywords, policy, solver):
    """The port's trainer of a BASELINE path built from its layers on the
    card, weights and shuffles from :data:`BASELINE_SEED`."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models.build import build_training
    prng.get().seed(BASELINE_SEED)
    prng.get("loader").seed(BASELINE_SEED + 1)
    return build_training(layers, sample, loader(), seed=BASELINE_SEED,
                          policy=policy, device="cuda", solver=solver,
                          **keywords)


def workflow_trainer(factory, policy, seed):
    """``train.runner.trainer_for`` of the workflow ``factory(launcher)``
    builds, initialized on the card with its layers under ``policy``
    (``nn.precision.set_policy``, unpinned after), its streams seeded
    from ``seed`` (the weights' from ``seed``, the loader's from ``seed
    + 1``)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.nn.precision import set_policy
    from veles_tpu_torch.train.runner import trainer_for
    prng.get().seed(seed)
    prng.get("loader").seed(seed + 1)
    set_policy(policy)
    try:
        wf = factory(DummyLauncher())
        wf.initialize(device="cuda")
    finally:
        set_policy(None)
    return trainer_for(wf)


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
    from veles_tpu_torch.nn.kohonen import SOMCodebook, som_quality
    from veles_tpu_torch.train.som import SOMRunner
    prng.get().seed(BASELINE_SEED)
    prng.get("loader").seed(BASELINE_SEED + 1)
    loader = MnistLoader(provider=digits, minibatch_size=SOM_MINIBATCH)
    trainer = SOMCodebook(784, SOM_SIDE, SOM_SIDE, device="cuda")
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


def mixed_workflow(torch, digits, solvers):
    """mnist-fc as a ``StandardWorkflow`` on the card, weights and
    shuffles from :data:`BASELINE_SEED`, each layer's gradient unit on
    its solver of ``solvers``, one epoch."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mnist import MNIST_LAYERS, MnistLoader
    from veles_tpu_torch.standard_workflow import StandardWorkflow
    prng.get().seed(BASELINE_SEED)
    prng.get("loader").seed(BASELINE_SEED + 1)
    wf = StandardWorkflow(
        DummyLauncher(), loader=lambda w: MnistLoader(
            workflow=w, provider=digits, minibatch_size=500),
        layers=MNIST_LAYERS, loss="softmax", max_epochs=1, **MIXED_TRAINING)
    gd_of = {id(gd.forward): gd for gd in wf.gds}
    for fwd, solver in zip(wf.forwards, solvers):
        gd_of[id(fwd)].solver_name = solver
    wf.initialize(device="cuda")
    return wf


def mixed_state(wf):
    """[(solver, {name: tensor})] of each layer: its parameters and its
    gradient unit's solver state, flattened."""
    from veles_tpu_torch.convert import layer_params
    gd_of = {id(gd.forward): gd for gd in wf.gds}
    out = []
    for fwd in wf.forwards:
        gd = gd_of[id(fwd)]
        flat = {"param." + k: p.detach()
                for k, p in layer_params(fwd.module).items()}

        def walk(prefix, node):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(prefix + "." + k, v)
            else:
                flat[prefix] = node.detach().reshape(-1)
        walk("state", gd.opt_state or {})
        out.append((gd.solver_name, flat))
    return out


def mixed_mismatch(torch, got, want, params_only=False):
    """The worst breach of the mixed bounds (<= 1 passes) of ``got``
    against ``want`` (:func:`mixed_state`), and the max |difference|;
    the parameters alone with ``params_only``, else every state too
    (the two must hold the same)."""
    worst, max_abs = 0.0, 0.0
    for (solver, a), (_, b) in zip(got, want):
        keys = [k for k in b if k.startswith("param.")] if params_only \
            else sorted(b)
        if not params_only and sorted(a) != keys:
            raise AssertionError("mixed solvers: states %s against %s" % (
                sorted(a), keys))
        for k in keys:
            d = (a[k].float() - b[k].float()).abs()
            max_abs = max(max_abs, float(d.max()))
            if solver != "adam":
                worst = max(worst, float(d.max()) / MIXED_ATOL)
                continue
            share = float((d > MIXED_ATOL).float().mean())
            norm = float(torch.linalg.vector_norm(d)) / max(
                float(torch.linalg.vector_norm(b[k].float())), 1e-30)
            worst = max(worst, share / MIXED_ADAM_SHARE,
                        norm / MIXED_ADAM_NORM)
    return worst, max_abs


def mixed_solver_run(torch, digits):
    """mnist-fc with fc1 on SGD and the head on Adam, one float32 epoch
    through the fused trainer (one solver a layer) and through the eager
    unit graph from the same weights and shuffle: every parameter and
    solver state within the mixed bounds, K1 and K6 launched the same
    counts by both (the step's: one K1 a forward, one K6 a bias a
    step); the fused trainer with SGD on both layers is the control that
    must fail the bounds. Returns (result, the fused run's launches by
    form)."""
    from veles_tpu_torch.loader.base import TRAIN, VALIDATION
    from veles_tpu_torch.train.runner import FusedRunner, fused_compatible
    t0 = time.perf_counter()
    runs = {}
    for mode, solvers in (("fused", MIXED_SOLVERS), ("eager", MIXED_SOLVERS),
                          ("control", ("sgd", "sgd"))):
        wf = mixed_workflow(torch, digits, solvers)
        reset_counts()
        t = time.perf_counter()
        if mode == "eager":
            wf.run()
        else:
            reason = fused_compatible(wf)
            if reason is not None:
                raise AssertionError("mixed solvers: the fused path refuses "
                                     "the workflow: %s" % reason)
            runner = FusedRunner(wf)
            got = [rule.name for rule in runner.trainer.solvers]
            if tuple(got) != solvers:
                raise AssertionError("mixed solvers: the trainer runs %s, "
                                     "the workflow asks %s" % (got, solvers))
            runner.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts, by_form = read_counts()
        runs[mode] = {"seconds": seconds, "launches": counts,
                      "by_form": by_form, "state": mixed_state(wf),
                      "history": wf.decision.epoch_history}
        if mode == "fused":
            steps = len(runner.trainer._segment_indices(TRAIN))
            forwards = steps + len(runner.trainer._segment_indices(
                VALIDATION))
        del wf
    expected = dict.fromkeys(kernel_counters(), 0)
    expected["gemm_bias_act"] = forwards
    expected["column_reduce"] = 2 * steps
    for mode in ("fused", "eager"):
        if runs[mode]["launches"] != expected:
            raise AssertionError("mixed solvers %s: launches %s, expected %s "
                                 "over %d steps and %d forwards" % (
                                     mode, runs[mode]["launches"], expected,
                                     steps, forwards))
    worst, max_abs = mixed_mismatch(torch, runs["fused"]["state"],
                                    runs["eager"]["state"])
    control, _ = mixed_mismatch(torch, runs["control"]["state"],
                                runs["eager"]["state"], params_only=True)
    errors = {m: [{k: e[k]["normalized"] for k in ("train", "validation")}
                  for e in runs[m]["history"]] for m in ("fused", "eager")}
    result = {
        "solvers": list(MIXED_SOLVERS), "steps": steps,
        "forwards": forwards, "launches": runs["fused"]["launches"],
        "eager_launches": runs["eager"]["launches"],
        "fused_s": runs["fused"]["seconds"],
        "eager_s": runs["eager"]["seconds"],
        "worst_bound_share": worst, "max_abs_diff": max_abs,
        "control_bound_share": control, "error_rates": errors,
        "leg_s": time.perf_counter() - t0}
    print("mnist-fc mixed solvers %s: fused vs eager epoch, worst %.3g of "
          "the bounds (max |diff| %.3g), the one-solver control %.3g; "
          "error rates %s; K1 %d, K6 %d launches each; fused %.3f s, "
          "eager %.3f s, leg %.3f s" % (
              "/".join(MIXED_SOLVERS), worst, max_abs, control, errors,
              expected["gemm_bias_act"], expected["column_reduce"],
              result["fused_s"], result["eager_s"], result["leg_s"]))
    if not worst <= 1.0:
        raise AssertionError("mixed solvers: the fused epoch differs from "
                             "the eager one by %.3g of the bounds" % worst)
    if control <= 1.0:
        raise AssertionError("mixed solvers: the one-solver control passes "
                             "the bounds (%.3g): the check cannot see a "
                             "wrong solver" % control)
    return result, runs["fused"]["by_form"]


def baseline_phase(torch, kernels):
    """The BASELINE model family on the card: each training path under
    each policy (float32 first, with the step check), its launches at
    checked forms, an epoch of each adaptive solver on mnist-fc with its
    step and update checks, mnist-fc with a solver a layer fused against
    eager (:func:`mixed_solver_run`), and the SOM. Returns (results,
    [launches_by_form of each counted run])."""
    t0 = time.perf_counter()
    paths, digits = baseline_paths()
    results, phases = {"data_s": None}, []
    for name, build in paths:
        for policy in BASELINE_POLICIES:
            trainer = build(policy)
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
            gc.collect()
            torch.cuda.empty_cache()
    fc = paths[0][1]
    for solver, hyper in sorted(SOLVER_TRAINING.items()):
        trainer = fc("float32", solver, **hyper)
        label = "mnist-fc %s" % solver
        result = step_check(torch, trainer, label, first_fc(trainer))
        result.update(update_check(torch, trainer, label))
        run, by_form = baseline_run(torch, trainer, label, "float32", 1)
        result.update(run)
        check_forms("baseline " + label, kernels, by_form)
        phases.append(by_form)
        results[label] = result
        del trainer
    results["mnist-fc mixed solvers"], by_form = mixed_solver_run(
        torch, digits)
    check_forms("baseline mnist-fc mixed solvers", kernels, by_form)
    phases.append(by_form)
    results["som"] = som_run(torch, digits)
    results["phase_s"] = time.perf_counter() - t0
    return results, phases


def b64_body(array, **extra):
    """A base64 request body for ``array``, a float32 numpy array."""
    return json.dumps(dict(extra, input=base64.b64encode(
        array.tobytes()).decode(), codec="base64", shape=list(array.shape),
        type="float32")).encode()


def concurrent_posts(port, bodies, path="/api"):
    """POST ``bodies`` to ``path`` from one thread each, all at once:
    (replies in order, latencies in s, wall s)."""
    replies, latencies, errors = {}, [], []

    def ask(i):
        try:
            t = time.perf_counter()
            replies[i] = post(port, path, bodies[i])
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
    from veles_tpu_torch.models.samples import (SequenceWorkflow,
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
            # bench_all.py's constructor arguments, at the phase's rate
            trainer = workflow_trainer(
                lambda launcher, name=name: SequenceWorkflow(
                    launcher, provider=providers[name], minibatch_size=64,
                    heads=8, moe=name == "moe", n_experts=8,
                    learning_rate=SEQUENCE_LEARNING_RATE),
                policy, SEQUENCE_SEED)
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
            gc.collect()
            torch.cuda.empty_cache()
    results["phase_s"] = time.perf_counter() - t0
    return results, phases


#: the workflow phase: AlexNetWorkflow at full width through the CLI
WORKFLOW_EPOCHS = 4
#: the snapshot the resumed run starts from: the one after 2 epochs
WORKFLOW_RESUME_SNAPSHOT = "wf.1.pickle"
#: the resumed run against the uninterrupted one in PyTorch's default
#: mode: each epoch loss within this relative distance, and fc7's final
#: weights within this share of their change over the resumed epochs
#: (a resume read 0.0068 of the change on the H100, the control without
#: the registry 0.63)
WORKFLOW_LOSS_REL_TOL = 1e-5
WORKFLOW_UPDATE_SHARE_TOL = 5e-2
#: the same resume, and a second uninterrupted run, in deterministic mode
#: (cuDNN deterministic, its benchmark off, ``torch.
#: use_deterministic_algorithms``, cuBLAS's workspace fixed): values of
#: the losses and of every parameter tensor that may differ from the
#: first uninterrupted run's
WORKFLOW_DETERMINISTIC_DIFFERING = 0

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
        layers=ALEXNET_LAYERS, max_epochs=root.smoke.get("epochs", %d),
        learning_rate=0.01, momentum=root.smoke.get("momentum", 0.9),
        weights_decay=5e-4)
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
def timed_method(torch, cls, attr, host=None):
    """Times each call of ``cls.attr`` (on every instance) by CUDA events
    while inside; yields the list of (start, end) events. ``host``, a
    list, gets each call's host milliseconds."""
    fn = getattr(cls, attr)
    timed = []

    def timed_fn(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        out = fn(self, *args)
        end.record()
        if host is not None:
            host.append(1e3 * (time.perf_counter() - t))
        timed.append((start, end))
        return out

    setattr(cls, attr, timed_fn)
    try:
        yield timed
    finally:
        setattr(cls, attr, fn)


@contextlib.contextmanager
def deterministic(torch, warned):
    """cuDNN deterministic with its benchmark off and
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` while
    inside (cuBLAS's workspace is fixed by ``CUBLAS_WORKSPACE_CONFIG``,
    set before the first cuBLAS call); the first line of each warning
    about an op without a deterministic version goes to ``warned``."""
    import warnings
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
    for w in caught:
        text = str(w.message)
        if "deterministic" in text and text.splitlines()[0] not in warned:
            warned.append(text.splitlines()[0])


def run_state(wf, losses):
    """(per-epoch {class: loss}, every parameter as a CPU tensor) of a
    finished run."""
    from veles_tpu_torch.convert import layer_params
    return (losses, [{k: p.detach().cpu().clone() for k, p in
                      layer_params(f.module).items()} for f in wf.forwards])


def values_differing(got, want):
    """How many loss values and parameter values of the run state ``got``
    differ from ``want``'s (:func:`run_state`); runs of different
    lengths raise."""
    if len(got[0]) != len(want[0]) or len(got[1]) != len(want[1]):
        raise AssertionError("runs of %d and %d epochs" % (len(got[0]),
                                                           len(want[0])))
    n = sum(g[k] != w[k] for g, w in zip(got[0], want[0]) for k in w)
    for g, w in zip(got[1], want[1]):
        for k in w:
            n += int((g[k] != w[k]).sum())
    return int(n)


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
                                              "control", "det")}
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

    # (2d) deterministic mode: the uninterrupted run twice and the resume
    warned = []
    states = {}
    with deterministic(torch, warned):
        for key, args in (
                ("first", ("-s", "7", where("det"))),
                ("second", ("-s", "7", where("control"))),
                ("resumed", ("-w", os.path.join(
                    dirs["det"], WORKFLOW_RESUME_SNAPSHOT),
                    where("control")))):
            prng._generators.clear()
            root.common.disable.snapshotting = key != "first"
            try:
                main = workflow_cli(path, *args)
            finally:
                root.common.disable.snapshotting = False
            states[key] = run_state(main.workflow, [
                t["loss"] for t in main.launcher.runner.epoch_times])
            del main
            torch.cuda.empty_cache()
    first = states["first"]
    det = {"second": values_differing(states["second"], first),
           "resumed": values_differing(states["resumed"],
                                       (first[0][2:], first[1]))}
    print("workflow deterministic mode: a second uninterrupted run "
          "differs in %d values, the resumed run in %d (limit %d); ops "
          "without a deterministic version: %s" % (
              det["second"], det["resumed"],
              WORKFLOW_DETERMINISTIC_DIFFERING, warned or "none"))
    if max(det.values()) > WORKFLOW_DETERMINISTIC_DIFFERING:
        raise AssertionError("deterministic runs differ: %s" % det)
    result.update({"deterministic_differing": det,
                   "deterministic_warned_ops": warned})
    del states, first

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


#: the eager phase: ``--eager`` on the workflow phase's file
EAGER_EPOCHS = 2
#: the eager run against the fused run of the same file and seed, both
#: in deterministic mode: each epoch loss within this relative distance
#: and fc7's final weights within this share of their change over the
#: run; fc7's gradient unit gated off must exceed it
EAGER_LOSS_REL_TOL = 1e-6
EAGER_UPDATE_SHARE_TOL = 1e-3
#: the training iteration of the eager run profiled: the last but one
#: (the last of each epoch also runs the epoch's snapshot)
EAGER_PROFILED = -2

#: the export phase's mnist-fc: ``MnistWorkflow`` 784-100-10 over the
#: BASELINE digits, batch 500, one eager epoch
MNIST_FC_FILE = """
from veles_tpu_torch.datasets import golden_digits
from veles_tpu_torch.models.mnist import MnistWorkflow


def run(load, main):
    load(MnistWorkflow, provider=golden_digits(%d, %d), layers=(100,),
         minibatch_size=500, max_epochs=1)
    main()
""" % BASELINE_DIGITS


class EagerSteps(object):
    """While inside, marks each eager loop iteration (each
    ``Repeater.run``) with a CUDA event and the host clock, and whether
    the minibatch it serves is a training one; the training iteration
    ``profiled`` (an index into them) runs under ``torch.profiler``.
    ``steps()`` gives [(device ms, host ms)] of every training
    iteration, in order."""

    def __init__(self, torch, profiled):
        self.torch = torch
        self.profiled = profiled
        self.marks = []
        self.prof = None

    def _mark(self, loader):
        torch = self.torch
        if self.prof is not None and self.prof_open:
            torch.cuda.synchronize()
            self.prof.stop()
            self.prof_open = False
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        train = None
        if loader is not None:
            offset = loader._global_offset
            if offset >= loader.total_samples:
                offset = 0
            from veles_tpu_torch.loader.base import VALIDATION
            train = loader.class_end_offsets[VALIDATION] <= offset < \
                loader.total_samples
            if train and sum(m[2] for m in self.marks) == self.profiled:
                from torch.profiler import ProfilerActivity, profile
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof_open = True
                torch.cuda.synchronize()
                self.profiled_mark = len(self.marks)
                self.prof.start()
        self.marks.append((event, time.perf_counter(), bool(train)))

    def __enter__(self):
        from veles_tpu_torch.plumbing import Repeater
        self.run = Repeater.run
        steps = self

        def marked(repeater):
            steps._mark(repeater.workflow.loader)
            return steps.run(repeater)

        Repeater.run = marked
        self.prof_open = False
        self.profiled_mark = None
        return self

    def __exit__(self, *exc):
        from veles_tpu_torch.plumbing import Repeater
        Repeater.run = self.run
        self._mark(None)
        self.torch.cuda.synchronize()

    def steps(self):
        out = []
        for i, (event, host, train) in enumerate(self.marks[:-1]):
            if train:
                nxt = self.marks[i + 1]
                out.append((event.elapsed_time(nxt[0]),
                            1e3 * (nxt[1] - host)))
        return out

    def profiled_ms(self):
        """(wall ms, device ms) of the profiled iteration."""
        i = self.profiled_mark
        return (1e3 * (self.marks[i + 1][1] - self.marks[i][1]),
                self.marks[i][0].elapsed_time(self.marks[i + 1][0]))


@contextlib.contextmanager
def evaluator_losses():
    """While inside, each eager softmax evaluator's minibatch loss, as
    (epoch, class, loss); yields the list."""
    from veles_tpu_torch.nn.units import EvaluatorSoftmax
    compute = EvaluatorSoftmax.compute
    seen = []

    def recording(self):
        compute(self)
        loader = self.workflow.loader
        seen.append((loader.epoch_number, loader.minibatch_class, self.loss))

    EvaluatorSoftmax.compute = recording
    try:
        yield seen
    finally:
        EvaluatorSoftmax.compute = compute


def epoch_losses(torch, seen, device):
    """[{class name: mean minibatch loss}] by epoch of
    :func:`evaluator_losses`' records, the mean taken as
    ``FusedRunner.epoch_times`` takes it: of the float32 losses, on the
    run's device."""
    from veles_tpu_torch.loader.base import CLASS_NAMES
    out = {}
    for epoch, klass, loss in seen:
        out.setdefault(epoch, {}).setdefault(CLASS_NAMES[klass], []).append(
            loss)
    return [{k: float(torch.tensor(v, dtype=torch.float32,
                                   device=device).mean())
             for k, v in out[e].items()} for e in sorted(out)]


def eager_export_phases(torch, numpy, kernels):
    """The eager phase, then the export and serve phase over its trained
    workflow; their temporary directory removed at the end. Returns
    ((eager result, export result), [launches_by_form])."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="veles_eager_")
    try:
        eager, forms, main = eager_phase(torch, numpy, kernels, tmp)
        served, more = export_phase(torch, numpy, kernels, tmp, main)
        return (eager, served), forms + more
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def eager_phase(torch, numpy, kernels, tmp):
    """``python -m veles_tpu_torch --eager`` on the workflow phase's
    AlexNet-227 file (512 + 128 samples, batch 128, 2 epochs, float32,
    ``-s 7``) in deterministic mode, snapshotted every epoch: (1) held to
    the fused CLI run of the same file, each epoch loss within 1e-6
    relative and fc7 within 1e-3 of its change (bitwise reported), and
    the same eager run with fc7's gradient unit gated off (its
    ``err_input`` zeros, as the JAX unit's) must exceed that; (2) K1,
    K3, K4, K6 and K7 launched exactly the unit graph's counts (the
    fused step's: no recompute), at checked forms; (3) the eager step's
    device ms (CUDA events) and host ms beside the fused step's, the
    idle share of one profiled eager step, launches per step; (4) the
    snapshot after epoch 0 resumed fused (``-w``) to the eager run's end
    at the deterministic bound. Returns (result, [launches_by_form], the
    eager run's ``Main``)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.loader.base import TRAIN, VALIDATION
    from veles_tpu_torch.mutable import Bool
    from veles_tpu_torch.nn.units import All2AllStrictRELU
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    from veles_tpu_torch.train.step import FusedTrainer

    path = os.path.join(tmp, "alexnet_workflow.py")
    with open(path, "w") as f:
        f.write(WORKFLOW_FILE)
    epochs = "root.smoke.epochs=%d" % EAGER_EPOCHS

    def where(key):
        return "root.smoke.snapshots=%r" % os.path.join(tmp, key)

    def cli(*args, snapshots=False):
        prng._generators.clear()
        root.common.disable.snapshotting = not snapshots
        try:
            return workflow_cli(path, "-s", "7", epochs, *args)
        finally:
            root.common.disable.snapshotting = False

    result = {}
    warned = []
    initial = cli("--dry-run", "init", where("none")).workflow
    fc7 = [i for i, f in enumerate(initial.forwards)
           if isinstance(f, All2AllStrictRELU)][-1]
    before = initial.forwards[fc7].weights.detach().cpu().clone()
    del initial
    with deterministic(torch, warned):
        # the fused reference
        reset_counts()
        fused_host = []
        with timed_method(torch, FusedTrainer, "train_batch",
                          host=fused_host) as fused_timed:
            fused = cli(where("none"))
            torch.cuda.synchronize()
        fused_counts = read_counts()[0]
        runner = fused.launcher.runner
        per_epoch = len(runner.trainer._segment_indices(TRAIN))
        forwards = per_epoch + len(runner.trainer._segment_indices(
            VALIDATION))
        want = run_state(fused.workflow,
                         [t["loss"] for t in runner.epoch_times])
        fused_steps = [(a.elapsed_time(b), h) for (a, b), h in zip(
            fused_timed, fused_host)][1:]
        del fused, runner
        torch.cuda.empty_cache()
        # the eager run, snapshotted every epoch
        steps_total = EAGER_EPOCHS * per_epoch
        reset_counts()
        t = time.perf_counter()
        with evaluator_losses() as seen, EagerSteps(
                torch, EAGER_PROFILED % steps_total) as steps:
            eager = cli("--eager", where("eager"), snapshots=True)
        result["run_s"] = time.perf_counter() - t
        counts, forms = read_counts()
        variants = gemm_variants()
        designed = check_designed_forms("eager run")
        if eager.launcher.run_mode_used != "eager":
            raise AssertionError("--eager ran %s"
                                 % eager.launcher.run_mode_used)
        got = run_state(eager.workflow, epoch_losses(
            torch, seen, eager.workflow.device))
        # the control: fc7's gradient unit gated off
        control = cli("--eager", "--dry-run", "init", where("none"))
        wf = control.workflow
        (gd,) = [g for g in wf.gds if g.forward is wf.forwards[fc7]]
        gd.gate_skip = Bool(True)
        gd.err_input = torch.zeros(gd.err_input.shape, device=wf.device)
        root.common.disable.snapshotting = True
        try:
            with evaluator_losses() as control_seen:
                control.launcher.run()
        finally:
            root.common.disable.snapshotting = False
        bad = run_state(wf, epoch_losses(torch, control_seen, wf.device))
        del control, wf, gd
        torch.cuda.empty_cache()
        # the eager snapshot after epoch 0, resumed fused
        resumed = cli("-w", os.path.join(tmp, "eager", "wf.0.pickle"),
                      where("none"))
        resumed_state = run_state(resumed.workflow, [
            t["loss"] for t in resumed.launcher.runner.epoch_times])
        del resumed
        torch.cuda.empty_cache()
    (snapshotter,) = [u for u in eager.workflow
                      if isinstance(u, SnapshotterToFile)]
    kinds = [type(f).__name__ for f in eager.workflow.forwards]
    n_lrn = kinds.count("LRNormalizerForward")
    expected = {"gemm_bias_act": kinds.count("All2AllStrictRELU") *
                forwards * EAGER_EPOCHS,
                "lrn_fwd": n_lrn * forwards * EAGER_EPOCHS,
                "lrn_bwd": n_lrn * steps_total,
                "column_reduce": sum(f.bias is not None for f in
                                     eager.workflow.forwards) * steps_total,
                "uniform_fill": kinds.count("DropoutForward") * steps_total,
                "kahan_gemm": 0}
    print("eager: launch counts %s, expected %s (the fused run's %s)" % (
        counts, expected, fused_counts))
    if counts != expected or fused_counts != expected:
        raise AssertionError("eager launch counts %s, fused %s, expected "
                             "%s" % (counts, fused_counts, expected))
    check_forms("eager", kernels, forms)
    check_designed("eager", variants)
    def losses_fc7(state):
        return state[0], state[1][fc7]["weights"].numpy()

    loss_rel, share = resume_gap(numpy, losses_fc7(got), losses_fc7(want),
                                 before.numpy())
    bitwise = values_differing(got, want)
    bad_rel, bad_share = resume_gap(numpy, losses_fc7(bad),
                                    losses_fc7(want), before.numpy())
    resume_differing = values_differing(resumed_state,
                                        (got[0][1:], got[1]))
    print("eager vs fused (deterministic): losses within %.3g relative "
          "(limit %g), fc7 within %.3g of its change (limit %g), %d "
          "values differ; control (fc7's GD gated off) %.3g / %.3g; the "
          "eager snapshot resumed fused differs in %d values (limit %d); "
          "ops without a deterministic version: %s" % (
              loss_rel, EAGER_LOSS_REL_TOL, share, EAGER_UPDATE_SHARE_TOL,
              bitwise, bad_rel, bad_share, resume_differing,
              WORKFLOW_DETERMINISTIC_DIFFERING, warned or "none"))
    if loss_rel > EAGER_LOSS_REL_TOL or share > EAGER_UPDATE_SHARE_TOL:
        raise AssertionError("the eager run differs from the fused one")
    if bad_rel <= EAGER_LOSS_REL_TOL and bad_share <= EAGER_UPDATE_SHARE_TOL:
        raise AssertionError("the control passes the eager check")
    if resume_differing > WORKFLOW_DETERMINISTIC_DIFFERING:
        raise AssertionError("the eager snapshot resumed fused differs")
    # steady steps: not the first, not the profiled one, not an epoch's
    # last (it also runs the epoch's snapshot)
    eager_steps = steps.steps()
    profiled = EAGER_PROFILED % steps_total
    steady = [step for j, step in enumerate(eager_steps)
              if j and j != profiled and (j + 1) % per_epoch]
    wall_ms, device_ms = steps.profiled_ms()
    split = device_time_split(torch, steps.prof)
    busy = sum(split.values())
    eager_p50 = statistics.median(d for d, _ in steady)
    result.update({
        "losses": got[0], "fused_losses": want[0],
        "loss_rel": loss_rel, "fc7_share": share,
        "values_differing": bitwise, "control_loss_rel": bad_rel,
        "control_fc7_share": bad_share,
        "snapshot_resumed_fused_differing": resume_differing,
        "deterministic_warned_ops": warned, "launches": counts,
        "launches_per_step": {k: v / steps_total for k, v in
                              counts.items()},
        "step_device_ms_p50": eager_p50,
        "step_host_ms_p50": statistics.median(h for _, h in steady),
        "step_device_ms": [d for d, _ in eager_steps],
        "step_host_ms": [h for _, h in eager_steps],
        "fused_step_device_ms_p50": statistics.median(
            d for d, _ in fused_steps),
        "fused_step_host_ms_p50": statistics.median(
            h for _, h in fused_steps),
        "profiled_step_wall_ms": wall_ms,
        "profiled_step_events_ms": device_ms,
        "profiled_step_device_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / eager_p50),
        "device_ms_by_group": split, "gemm_variants": variants,
        "designed_forms": designed,
        "snapshot_export_s": [sec for sec, _ in snapshotter.exports]})
    print("eager step: device %.3f ms, host %.3f ms (fused %.3f / %.3f "
          "ms); idle %.1f%% of a profiled step" % (
              result["step_device_ms_p50"], result["step_host_ms_p50"],
              result["fused_step_device_ms_p50"],
              result["fused_step_host_ms_p50"],
              100 * result["device_idle_share"]))
    return result, [forms], eager


def export_phase(torch, numpy, kernels, tmp, eager):
    """Export and serve: (1) the eager-trained AlexNet to a ``.tar``
    package from the card's tensors, every array member equal to its
    unit's parameters in the JAX layout bit for bit, and
    ``ModelStore.load`` of it refused (``ModelLoadError``: the
    convolutions); (2) mnist-fc (784-100-10, batch 500, golden digits
    12000 + 2000, ``-s 1234``) trained one eager epoch on the card and
    exported; (3) ``python -m veles_tpu_torch serve``'s arguments
    (:func:`veles_tpu_torch.serving.frontend.serve`, in this process so
    that its launches count) on the mnist-fc package and on the eager
    AlexNet's snapshot directory: 16 concurrent single requests and one
    64-row batch each, checked as the slice phase checks them, every K1
    launch at a checked form and on a designed variant; (4) the port
    refuses no flag of the JAX command (``REFUSED_FLAGS`` is empty).
    Returns (result, [launches_by_form])."""
    from veles_tpu_torch.convert import layer_params, to_jax_layout
    from veles_tpu_torch.serving.frontend import REFUSED_FLAGS, serve
    from veles_tpu_torch.serving.model_store import (ModelLoadError,
                                                     ModelStore,
                                                     _read_package)
    result = {}
    wf = eager.workflow
    package = os.path.join(tmp, "alexnet.tar")
    t = time.perf_counter()
    wf.package_export(package)
    result["alexnet_export_s"] = time.perf_counter() - t
    contents, members = _read_package(package)
    checked = 0
    for unit, entry in zip(wf.forwards, contents["workflow"]["units"]):
        for key, value in to_jax_layout(layer_params(unit.module)).items():
            member = members[entry["data"][key]]
            if member.shape != value.shape or \
                    member.tobytes() != value.tobytes():
                raise AssertionError("package member %s of %s differs"
                                     % (key, unit.name))
            checked += 1
    try:
        ModelStore().load(package)
    except ModelLoadError as e:
        result["alexnet_package_refused"] = str(e)
    else:
        raise AssertionError("ModelStore.load served a conv package")
    print("export: AlexNet package %.1f MiB, %d arrays equal to the "
          "card's parameters bit for bit; ModelStore.load refuses it: %s"
          % (os.path.getsize(package) / 1048576.0, checked,
             result["alexnet_package_refused"]))
    del eager, wf
    torch.cuda.empty_cache()

    mnist = os.path.join(tmp, "mnist_fc.py")
    with open(mnist, "w") as f:
        f.write(MNIST_FC_FILE)
    from veles_tpu_torch import prng
    prng._generators.clear()
    reset_counts()
    t = time.perf_counter()
    main = workflow_cli(mnist, "-s", str(BASELINE_SEED), "--eager")
    result["mnist_fc_epoch_s"] = time.perf_counter() - t
    counts = read_counts()[0]
    loader = main.workflow.loader
    steps = -(-loader.class_lengths[2] // loader.max_minibatch_size)
    forwards = steps + -(-loader.class_lengths[1] //
                         loader.max_minibatch_size)
    want = {"gemm_bias_act": forwards, "lrn_fwd": 0, "lrn_bwd": 0,
            "column_reduce": 2 * steps, "uniform_fill": 0,
            "kahan_gemm": 0}
    if counts != want:
        raise AssertionError("mnist-fc eager launch counts %s, expected "
                             "%s" % (counts, want))
    history = main.workflow.decision.epoch_history
    result["mnist_fc_history"] = history
    pkg = os.path.join(tmp, "mnist_fc.tar")
    main.workflow.package_export(pkg)
    del main
    print("export: mnist-fc one eager epoch on the card (%s), launches %s;"
          " exported" % (history, counts))
    forms = []
    for label, artifact in (("mnist-fc package", pkg),
                            ("alexnet snapshot", os.path.join(tmp,
                                                              "eager"))):
        frontend = serve(["--model", artifact, "--host", "127.0.0.1",
                          "--port", "0", "--max-batch-size", "64",
                          "--response-timeout", "300"])
        served, by_form = serve_checked(torch, numpy, frontend,
                                        "serve CLI " + label, rounds=1)
        check_forms("serve CLI " + label, kernels, by_form)
        check_designed("serve CLI " + label, served["gemm_variants"])
        result[label] = served
        forms.append(by_form)
        del frontend
        torch.cuda.empty_cache()
    if REFUSED_FLAGS:
        raise AssertionError("serve refuses %s" % sorted(REFUSED_FLAGS))
    return result, forms


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


# -- phase 12: out-of-core training (streamed dataset, offloaded model) ------

#: the phase's data: ``SyntheticImageLoader`` of 2048 + 256 samples in
#: bf16 storage (~712 MB), trained at ``bench.py``'s settings
RESIDENCY_SAMPLES = (2048, 256)
RESIDENCY_EPOCHS = 2
#: the device budget that makes the planner stream that dataset
RESIDENCY_BUDGET_MB = "400"
RESIDENCY_DEPTH = 2
#: the offload run's group target, and the groups it must give:
#: conv1-pool5; fc6; fc6's dropout, fc7 and fc7's dropout; the head
OFFLOAD_GROUP_MB = "150"
OFFLOAD_GROUPS = [(0, 10), (10, 11), (11, 14), (14, 15)]
#: a ``torch.cuda._sleep`` before each shard's first use (~600 ms at the
#: H100's ~1.98 GHz) in the check of the ring as it is, so the device
#: falls behind the host: its ordered refills must still wait for the
#: reads. The controls run shards of one minibatch (``VELES_SHARD_MB``):
#: at depth 2 a slot is refilled two shards after its read was enqueued,
#: inside the host's lead over the card (bounded by the launch queue,
#: ~1024 launches). (The unordered refill under the sleep alone
#: corrupted 12-14 values in three runs and none in a fourth on the
#: H100: whether the refill landed first depended on the host's lead;
#: :class:`HeldRefill` orders it.)
RING_SLEEP_CYCLES = 1200000000
RING_SHARD_MB = "40"
#: the depth-2 held control (:class:`HeldRefill`): its runs with the
#: unordered refill, each of which must differ from the resident run
#: with no fallback (one such run and the ring as it is take less card
#: time than the three runs of the one-slot control they replaced; two
#: took more: ``scripts/probe_ring_controls.py``); the seconds after
#: which a hold that no refill ended is released (the ring as it is: its
#: refill waits for the held read; an unordered refill lands within tens
#: of milliseconds of the hold); the seconds after which the watchdog
#: releases a hold (the control then fails)
RING_HELD_UNORDERED_RUNS = 1
RING_FALLBACK_S = 0.5
RING_HOLD_WATCHDOG_S = 120.0
#: slack of the streamed and offloaded peak-memory bounds: the
#: allocator's 2 MiB rounding of each block and the small tensors of a
#: sweep (index matrices, losses, norms)
PEAK_SLACK_BYTES = 64 << 20

RESIDENCY_IMPORT_CHECK = """
import sys
import torch
from veles_tpu_torch.models.alexnet import (SyntheticImageLoader,
                                            small_alexnet_layers)
from veles_tpu_torch.models.build import build_training
for kw in ({"stream": True}, {"offload": True}):
    loader = SyntheticImageLoader(n_train=64, n_valid=32, side=32,
                                  n_classes=10, minibatch_size=16)
    t = build_training(small_alexnet_layers(10), (32, 32, 3), loader,
                       seed=0, device="cuda", learning_rate=0.01,
                       momentum=0.9, **kw)
    assert t.streaming or t.offloaded
    stats = t.run_epoch(0)
    t.shutdown()
    assert stats["train"]["loss"] == stats["train"]["loss"]
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "veles_tpu" or m.startswith("veles_tpu."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


#: the channels cell: ``ChannelsWorkflow`` through the CLI on a tree that
#: ``generate_channels_dataset`` renders (its defaults: 6 channels, 30 +
#: 7 logos each, 32x32)
CHANNELS_EPOCHS = 3
CHANNELS_FILE = """
from veles_tpu_torch.config import root
from veles_tpu_torch.models.samples import (ChannelsWorkflow,
                                            generate_channels_dataset)


def run(load, main):
    train, valid = generate_channels_dataset(root.smoke.channels)
    load(ChannelsWorkflow, train_paths=train, validation_paths=valid,
         max_epochs=%d)
    main()
""" % CHANNELS_EPOCHS


def channels_cell(torch, tmp):
    """``python -m veles_tpu_torch`` on a ``ChannelsWorkflow`` file, 3
    epochs: the loss falls, K1 and K6 launch at the model's counts.
    None when Pillow does not import."""
    try:
        import PIL  # noqa: F401
    except ImportError:
        return None
    from veles_tpu_torch.loader.base import TRAIN, VALIDATION
    from veles_tpu_torch.nn.all2all import All2All
    path = os.path.join(tmp, "channels_workflow.py")
    with open(path, "w") as f:
        f.write(CHANNELS_FILE)
    reset_counts()
    t = time.perf_counter()
    main = workflow_cli(path, "-s", "11", "root.smoke.channels=%r"
                        % os.path.join(tmp, "channels"))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    counts = read_counts()[0]
    trainer = main.launcher.runner.trainer
    steps = CHANNELS_EPOCHS * len(trainer._segment_indices(TRAIN))
    forwards = steps + CHANNELS_EPOCHS * len(
        trainer._segment_indices(VALIDATION))
    want = {"gemm_bias_act": forwards * sum(
                isinstance(m, All2All) for m in trainer.forwards[:-1]),
            "column_reduce": steps * sum("bias" in p
                                         for p in trainer.params)}
    got = {name: counts[name] for name in want}
    losses = [t["loss"]["train"] for t in main.launcher.runner.epoch_times]
    if got != want or not losses[-1] < losses[0]:
        raise AssertionError("channels: launches %s (want %s), train "
                             "losses %s" % (got, want, losses))
    return {"losses": losses, "launches": got, "run_s": run_s,
            "samples": list(trainer.loader.class_lengths)}


@contextlib.contextmanager
def env_set(**values):
    """``os.environ`` with ``values`` set (None removes) while inside."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def patched(owner, attr, value):
    saved = getattr(owner, attr)
    setattr(owner, attr, value)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def residency_data():
    """The phase's dataset, generated once: (data, labels, class
    lengths) as ``SyntheticImageLoader`` makes them."""
    from veles_tpu_torch.models.alexnet import (ALEXNET_SAMPLE_SHAPE,
                                                SyntheticImageLoader)
    n_train, n_valid = RESIDENCY_SAMPLES
    loader = SyntheticImageLoader(
        n_train=n_train, n_valid=n_valid, side=ALEXNET_SAMPLE_SHAPE[0],
        n_classes=1000, minibatch_size=TRAIN_BATCH, dtype="bfloat16")
    loader.load_dataset()
    return loader.original_data, loader.original_labels, \
        list(loader.class_lengths)


def residency_trainer(data, **residency):
    """Full-width AlexNet-227 over the phase's dataset at ``bench.py``'s
    settings, its streams seeded as every run of the phase seeds them."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models.alexnet import (ALEXNET_LAYERS,
                                                ALEXNET_SAMPLE_SHAPE,
                                                ALEXNET_TRAINING,
                                                SyntheticImageLoader)
    from veles_tpu_torch.models.build import build_training
    prng.get().seed(42)
    prng.get("loader").seed(43)
    loader = SyntheticImageLoader(
        n_train=RESIDENCY_SAMPLES[0], n_valid=RESIDENCY_SAMPLES[1],
        side=ALEXNET_SAMPLE_SHAPE[0], n_classes=1000,
        minibatch_size=TRAIN_BATCH, dtype="bfloat16")
    loader.original_data, loader.original_labels, loader.class_lengths = \
        data[0], data[1], list(data[2])
    return build_training(ALEXNET_LAYERS, ALEXNET_SAMPLE_SHAPE, loader,
                          seed=42, device="cuda", **dict(ALEXNET_TRAINING,
                                                         **residency))


class HeldRefill(object):
    """The ring control at depth 2 with two slots (the staging ring's
    and the host ring's): the consumer's stream held before its first
    use of the first training shard until that slot's refill (shard 2)
    lands, else released after RING_FALLBACK_S.

    Each placement writes the slot's fill count to a word of device
    memory on the ring's copy stream after its copies
    (``cuStreamWriteValue32``). The first placement of a training sweep
    is held: before its first use the consumer's stream waits until the
    word says the slot was filled again (``cuStreamWaitValue32``, greater
    or equal). A ring that refills without the consumer's event (the
    control's patched ``_order_refill``) lands that refill during the
    hold, so the shard computes on the refill's rows in every run. The
    ring as it is makes the refill wait for the held read, so it cannot
    land: a watcher thread releases the hold from a side stream
    RING_FALLBACK_S after the hold was enqueued (``fallbacks``), and the
    shard computes on its own rows. The watcher stops early where the
    refill's event (recorded on the copy stream after the word) completes
    first. The refill needs only the held shard's release on the host
    (its compute enqueued), so the step thread waits on the host, before
    its use of the next shard, until the hold is resolved: the host's
    lead over the held card stays one shard, inside the launch queue
    (with four slots and a lead of three shards the step thread stopped
    inside a launch, and the side stream's release never took effect).
    Two watchdogs: a thread releases the hold after
    RING_HOLD_WATCHDOG_S (the control then fails), and ``faulthandler``
    ends the process (no interpreter lock needed) a minute later, so the
    card is never left waiting. ``libcuda``'s stream memory operations
    on device memory, through ``ctypes``."""

    WAIT_GEQ = 0

    def __init__(self, torch, prefetch, trainer_cls):
        import ctypes
        self.torch, self.prefetch = torch, prefetch
        self.trainer_cls = trainer_cls
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
        self.kind = None
        self.hold = None        # (slot, value) of the held placement
        self.held_item = None   # its index in the sweep
        self.landed = None      # the refill's event
        self.resolved = threading.Event()
        self.holds = self.fallbacks = 0
        self.landed_s = None    # the refill's landing after the hold
        self.fired = False
        self._item = 0
        self._lock = threading.Lock()
        self._done = threading.Event()

    def _call(self, fn, stream, slot, value, flags):
        status = fn(stream.cuda_stream, self.words.data_ptr() + 4 * slot,
                    value, flags)
        if status:
            raise RuntimeError("%s: CUresult %d" % (fn.__name__, status))

    def _watch(self):
        start = time.monotonic()
        while time.monotonic() < start + RING_FALLBACK_S:
            landed = self.landed
            if landed is not None and landed.query():
                self.landed_s = time.monotonic() - start
                self.resolved.set()
                return
            time.sleep(0.001)
        self.release_all(fallback=True)

    def _watchdog(self):
        if not self._done.wait(RING_HOLD_WATCHDOG_S):
            self.fired = True
            self.release_all()

    def release_all(self, fallback=False):
        """Release the hold, if one is pending: its word to the value it
        waits for, from the side stream."""
        with self._lock:
            if self.hold is not None and not self.resolved.is_set():
                slot, value = self.hold
                self._call(self._write, self.side, slot, value, 0)
                self.fallbacks += int(fallback)
                self.resolved.set()

    @contextlib.contextmanager
    def installed(self):
        prefetch, holder = self.prefetch, self
        place, wait = prefetch.StagingRing.place, prefetch.Staged.wait
        close = prefetch.PrefetchPipeline.close
        segment = self.trainer_cls._stream_segment

        def held_place(ring, host_tree, after=()):
            staged = place(ring, host_tree, after)
            if ring.reuse and ring.device.type == "cuda":
                with holder._lock:
                    n = holder.fills[staged.slot] = holder.fills.get(
                        staged.slot, 0) + 1
                    holder._call(holder._write, ring.copy_stream,
                                 staged.slot, n, 0)
                    if holder.hold is None and holder.kind == "train":
                        holder.hold = (staged.slot, n + 1)
                        staged.hold_value = n + 1
                    elif holder.hold == (staged.slot, n):
                        landed = holder.torch.cuda.Event()
                        landed.record(ring.copy_stream)
                        holder.landed = landed
            return staged

        def held_wait(staged):
            tree = wait(staged)
            value = getattr(staged, "hold_value", None)
            if value is not None:
                holder._call(holder._wait, holder.torch.cuda.current_stream(),
                             staged.slot, value, holder.WAIT_GEQ)
                holder.holds += 1
                holder.held_item = holder._item
                threading.Thread(target=holder._watch, daemon=True).start()
            elif holder.held_item is not None and holder._item == \
                    holder.held_item + 1:
                # the refill was placed, or can be, once the held shard
                # was released: wait for the hold's end here
                if not holder.resolved.wait(RING_HOLD_WATCHDOG_S):
                    raise AssertionError("residency: the held shard was "
                                         "never released")
            holder._item += 1
            return tree

        def releasing_close(pipe, *args, **kwargs):
            try:
                return close(pipe, *args, **kwargs)
            finally:
                holder.release_all()

        def kind_segment(trainer, kind, *args, **kwargs):
            holder.kind, holder._item = kind, 0
            try:
                return segment(trainer, kind, *args, **kwargs)
            finally:
                holder.kind = None

        def two_slots(init):
            def init_two(self, slots, *args, **kwargs):
                init(self, 2, *args, **kwargs)
            return init_two

        import faulthandler
        faulthandler.dump_traceback_later(RING_HOLD_WATCHDOG_S + 60,
                                          exit=True)
        watchdog = threading.Thread(target=self._watchdog, daemon=True)
        watchdog.start()
        try:
            with patched(prefetch.StagingRing, "__init__",
                         two_slots(prefetch.StagingRing.__init__)), \
                    patched(prefetch.HostRing, "__init__",
                            two_slots(prefetch.HostRing.__init__)), \
                    patched(prefetch.StagingRing, "place", held_place), \
                    patched(prefetch.Staged, "wait", held_wait), \
                    patched(prefetch.PrefetchPipeline, "close",
                            releasing_close), \
                    patched(self.trainer_cls, "_stream_segment",
                            kind_segment):
                yield self
        finally:
            self.release_all()
            self._done.set()
            watchdog.join()
            self.torch.cuda.synchronize()
            faulthandler.cancel_dump_traceback_later()


def depth2_held_controls(torch, numpy, prefetch, data, resident):
    """:class:`HeldRefill` at the phase's depth 2 with two slots (one
    minibatch a shard, one producer): RING_HELD_UNORDERED_RUNS runs with
    the ring's order
    taken out (``StagingRing._order_refill`` a no-op), each of which must
    differ from ``resident``, then one run of the ring as it is, which
    must not; each run's holds, fallbacks and seconds. Returns the
    readings."""
    from veles_tpu_torch.train.step import FusedTrainer
    out = {"held2_unordered": [], "held2_unordered_fallbacks": [],
           "held2_landed_s": [], "held2_s": []}

    def held_run(unordered):
        held = HeldRefill(torch, prefetch, FusedTrainer)
        order = (lambda self, stream, event: None) if unordered else \
            prefetch.StagingRing._order_refill
        t = time.perf_counter()
        with env_set(VELES_PREFETCH_WORKERS="1"), \
                patched(prefetch.StagingRing, "_order_refill", order), \
                held.installed():
            run = residency_run(torch, data, 1)
        out["held2_s"].append(time.perf_counter() - t)
        if held.fired:
            raise AssertionError("residency: the depth-2 held control's "
                                 "watchdog released its hold")
        differing = state_differing(numpy, run["state"], resident["state"])
        run["trainer"].shutdown()
        return differing, held

    for _ in range(RING_HELD_UNORDERED_RUNS):
        differing, held = held_run(True)
        out["held2_unordered"].append(differing)
        out["held2_unordered_fallbacks"].append(held.fallbacks)
        out["held2_landed_s"].append(held.landed_s)
        if held.holds != 1:
            raise AssertionError("residency: the depth-2 held control "
                                 "held %d shards" % held.holds)
    differing, held = held_run(False)
    out.update({"held2_ring_as_is": differing,
                "held2_ring_as_is_fallbacks": held.fallbacks})
    print("residency: depth-2 held control %s" % out)
    if not all(out["held2_unordered"]) or differing or \
            any(out["held2_unordered_fallbacks"]) or held.fallbacks != 1:
        raise AssertionError("residency: the depth-2 held control %s" % out)
    return out

def residency_run(torch, data, epochs, **residency):
    """``epochs`` epochs of :func:`residency_trainer` from a clean
    allocator: the run's state (per epoch: validation and training
    losses, validation errors and confusion; every parameter), its peak
    allocated bytes over the epochs, the training sweeps' device ms by
    CUDA events, the launches, and the trainer."""
    from veles_tpu_torch.convert import layer_params
    from veles_tpu_torch.train.step import FusedTrainer
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    trainer = residency_trainer(data, **residency)
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    epochs_out = []
    with timed_method(torch, FusedTrainer, "train_class") as sweeps:
        for epoch in range(epochs):
            stats = trainer.run_epoch(epoch)
            epochs_out.append({
                "validation": stats["validation"]["losses"],
                "train": stats["train"]["losses"],
                "n_err": stats["validation"]["metric"],
                "confusion": stats["validation"]["confusion"]})
    torch.cuda.synchronize()
    counts, forms = read_counts()
    run = {"state": (epochs_out, [{k: p.detach().cpu().clone()
                                   for k, p in layer_params(m).items()}
                                  for m in trainer.forwards]),
           "peak": torch.cuda.max_memory_allocated() - base,
           "built": built,
           "sweep_ms": [s.elapsed_time(e) for s, e in sweeps],
           "counts": counts, "forms": forms,
           "variants": gemm_variants(), "trainer": trainer}
    run["designed"] = check_designed_forms(
        "residency " + ("streamed" if trainer.streaming else
                        "offloaded" if trainer.offloaded else "resident"))
    return run


def state_differing(numpy, got, want):
    """Values of the run state ``got`` that differ from ``want``'s, over
    ``got``'s epochs (losses, validation errors, confusion counts,
    parameters: the parameters only when the runs are as long)."""
    n = 0
    for g, w in zip(got[0], want[0]):
        for key in ("validation", "train", "confusion"):
            n += int((numpy.asarray(g[key]) != numpy.asarray(w[key])).sum())
        n += int(g["n_err"] != w["n_err"])
    if len(got[0]) == len(want[0]):
        for g, w in zip(got[1], want[1]):
            for k in w:
                n += int((g[k] != w[k]).sum())
    return n


def copy_rate(torch, copies):
    """GB/s of (start, end, bytes) copies timed by CUDA events."""
    ms = sum(s.elapsed_time(e) for s, e, _ in copies)
    return sum(c[2] for c in copies) / ms / 1e6 if ms else None


def residency_phase(torch, numpy, kernels):
    """Phase 12 (see the module docstring). Returns (result, the
    launches by form of the streamed and offloaded runs)."""
    warned = []
    with tempfile_dir() as tmp:
        with deterministic(torch, warned):
            result, forms = _residency_phase(torch, numpy, kernels, tmp)
    if warned:
        raise AssertionError("residency: ops without a deterministic "
                             "version: %s" % warned)
    return result, forms


@contextlib.contextmanager
def tempfile_dir():
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="veles-residency-")
    try:
        yield tmp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _residency_phase(torch, numpy, kernels, tmp):
    import subprocess
    from veles_tpu_torch.loader import prefetch
    from veles_tpu_torch.nn.all2all import All2All
    from veles_tpu_torch.nn.dropout import DropoutForward
    from veles_tpu_torch.nn.normalization import LRNormalizerForward
    from veles_tpu_torch.train.offload import OffloadEngine
    t0 = time.perf_counter()
    data = residency_data()
    dataset_bytes = (data[0].numel() * data[0].element_size() +
                     data[1].numel() * data[1].element_size())
    result = {"dataset_mb": dataset_bytes / 1e6,
              "data_s": time.perf_counter() - t0}
    knobs = dict(VELES_STREAM=None, VELES_OFFLOAD=None,
                 VELES_SHARD_MB=None, VELES_ETL_THROTTLE_MS=None,
                 VELES_PREFETCH=str(RESIDENCY_DEPTH),
                 VELES_DEVICE_BUDGET_MB=None)

    # -- resident, in-core: the reference of both residencies
    with env_set(**dict(knobs, VELES_OFFLOAD="0")):
        resident = residency_run(torch, data, RESIDENCY_EPOCHS)
    trainer = resident.pop("trainer")
    assert not trainer.streaming and not trainer.offloaded
    fc6 = next(m for m in trainer.forwards if isinstance(m, All2All))
    fc6_state = 2 * sum(p.numel() * p.element_size()
                        for p in (fc6.weights, fc6.bias))
    del fc6
    n_train = trainer._segment_indices(2).shape[0]
    trainer.shutdown()
    del trainer
    step = resident["sweep_ms"][-1] / n_train
    result["resident"] = {"peak_mb": resident["peak"] / 1e6,
                          "built_mb": resident["built"] / 1e6,
                          "step_ms": step, "counts": resident["counts"]}

    # -- streamed: the planner chooses it under the budget
    streamed_knobs = dict(knobs, VELES_DEVICE_BUDGET_MB=RESIDENCY_BUDGET_MB,
                          VELES_OFFLOAD="0")
    with env_set(**streamed_knobs):
        streamed = residency_run(torch, data, RESIDENCY_EPOCHS)
    trainer = streamed.pop("trainer")
    if not trainer.streaming:
        raise AssertionError("residency: a %.0f MB dataset under a %s MB "
                             "budget did not stream" % (
                                 dataset_bytes / 1e6, RESIDENCY_BUDGET_MB))
    bounds = trainer._shard_bounds(n_train)
    shard_bytes = trainer.shard_bytes
    plan = {"batches_per_shard": trainer._batches_per_shard,
            "train_shards": len(bounds), "shard_mb": shard_bytes / 1e6,
            "slots": trainer._staging_ring.slots}
    print("residency: streamed plan %s" % json.dumps(plan))
    differing = state_differing(numpy, streamed["state"], resident["state"])
    if differing:
        raise AssertionError("residency: the streamed run differs from the "
                             "resident one in %d values" % differing)
    if streamed["counts"] != resident["counts"]:
        raise AssertionError("residency: streamed launches %s, resident %s"
                             % (streamed["counts"], resident["counts"]))
    limit = (resident["peak"] - dataset_bytes +
             trainer._staging_ring.slots * shard_bytes + PEAK_SLACK_BYTES)
    print("residency: peaks (MB) resident %.1f (built %.1f), streamed %.1f "
          "(built %.1f), bound %.1f" % (
              resident["peak"] / 1e6, resident["built"] / 1e6,
              streamed["peak"] / 1e6, streamed["built"] / 1e6, limit / 1e6))
    if streamed["peak"] > limit:
        raise AssertionError("residency: streamed peak %.1f MB over its "
                             "bound %.1f MB" % (streamed["peak"] / 1e6,
                                                limit / 1e6))
    sweeps_s = sum(streamed["sweep_ms"]) / 1e3
    result["streamed"] = {
        "plan": plan, "differing": differing,
        "peak_mb": streamed["peak"] / 1e6, "peak_bound_mb": limit / 1e6,
        "built_mb": streamed["built"] / 1e6,
        "step_ms": streamed["sweep_ms"][-1] / n_train,
        "input_wait_s": trainer.input_wait_s,
        "first_wait_s": trainer.first_wait_s,
        "starvation": trainer.input_wait_s / sweeps_s,
        "shard_etl_ms": statistics.median(trainer.shard_etl_ms),
        "h2d_gb_s": copy_rate(torch, trainer.shard_copies)}
    check_forms("residency streamed", kernels, streamed["forms"])
    check_designed("residency streamed", streamed["variants"])

    # the overlap: a slow loader (a shard's compute time a shard) waits
    # less at depth 2 than inline, over two sweeps at each depth in the
    # order 0, 2, 2, 0 (a drift of the shared host's load falls on both)
    shard_ms = step * trainer._batches_per_shard
    waits = {0: [], RESIDENCY_DEPTH: []}
    etl = {0: [], RESIDENCY_DEPTH: []}
    with env_set(**dict(streamed_knobs,
                        VELES_ETL_THROTTLE_MS="%.1f" % shard_ms)):
        for depth in (0, RESIDENCY_DEPTH, RESIDENCY_DEPTH, 0):
            trainer.prefetch_depth = depth
            before = trainer.input_wait_s
            trainer.train_class()
            torch.cuda.synchronize()
            waits[depth].append(trainer.input_wait_s - before)
            etl[depth].append(statistics.median(trainer.shard_etl_ms))
    trainer.shutdown()
    del trainer
    result["streamed"]["throttle"] = {"etl_ms": shard_ms,
                                      "input_wait_s": waits,
                                      "shard_etl_ms": etl}
    print("residency: under a %.1f ms ETL input waits (s) %s, shard ETL "
          "medians (ms, throttle included) %s" % (shard_ms, waits, etl))
    if not sum(waits[RESIDENCY_DEPTH]) < sum(waits[0]):
        raise AssertionError("residency: under a %.1f ms ETL depth %d "
                             "waited %s s, depth 0 %s s" % (
                                 shard_ms, RESIDENCY_DEPTH,
                                 waits[RESIDENCY_DEPTH], waits[0]))

    # controls: shard k fed shard k-1's rows; the ring as it is under a
    # sleep before each shard's first use; the depth-2 held control
    # (:class:`HeldRefill`): once with a ring that refills without the
    # consumer's event, once with the ring as it is
    def shifted(real):
        prev = [None]

        def fill(indices, kind=None, out=None):
            use = prev[0] if prev[0] is not None and \
                prev[0].shape == indices.shape else indices
            prev[0] = numpy.array(indices)
            return real(use, kind, out)
        return fill

    wait = prefetch.Staged.wait

    def slow_wait(self):
        tree = wait(self)
        torch.cuda._sleep(RING_SLEEP_CYCLES)
        return tree

    controls = {}
    from veles_tpu_torch.loader.fullbatch import FullBatchLoader
    with env_set(**dict(streamed_knobs, VELES_SHARD_MB=RING_SHARD_MB)):
        real_fill = FullBatchLoader.fill_indices

        def shifted_method(self, indices, kind=None, out=None,
                           _state={}):
            fill = _state.setdefault(id(self), shifted(
                lambda i, k, o: real_fill(self, i, k, o)))
            return fill(indices, kind, out)

        with patched(FullBatchLoader, "fill_indices", shifted_method):
            run = residency_run(torch, data, 1)
        controls["previous_shard_rows"] = state_differing(
            numpy, run["state"], resident["state"])
        run["trainer"].shutdown()
        del run
        with patched(prefetch.Staged, "wait", slow_wait):
            run = residency_run(torch, data, 1)
            controls["sleep_ring_as_is"] = state_differing(
                numpy, run["state"], resident["state"])
            run["trainer"].shutdown()
            del run
        controls.update(depth2_held_controls(torch, numpy, prefetch, data,
                                             resident))
    result["streamed"]["controls"] = controls
    print("residency: streamed controls (values differing) %s" % controls)
    if controls["sleep_ring_as_is"]:
        raise AssertionError("residency: the ring under the sleep differs "
                             "in %d values" % controls["sleep_ring_as_is"])
    if not controls["previous_shard_rows"]:
        raise AssertionError("residency: a control passed: %s" % controls)

    # -- offloaded: the same model and data, resident, model state on
    # the host walked in the planned groups
    offload_knobs = dict(knobs, VELES_OFFLOAD="1",
                         VELES_OFFLOAD_GROUP_MB=OFFLOAD_GROUP_MB)
    with env_set(**offload_knobs):
        offloaded = residency_run(torch, data, RESIDENCY_EPOCHS)
    trainer = offloaded.pop("trainer")
    engine = trainer._offload_engine
    if not trainer.offloaded or engine.plan.groups != OFFLOAD_GROUPS:
        raise AssertionError("residency: offload plan %s, want %s" % (
            engine and engine.plan.groups, OFFLOAD_GROUPS))
    plan = {"groups": engine.plan.groups,
            "group_mb": [b / 1e6 for b in engine.plan.group_bytes],
            "depth": engine.depth, "slots": engine._ring.slots}
    print("residency: offload plan %s" % json.dumps(plan))
    differing = state_differing(numpy, offloaded["state"], resident["state"])
    if differing:
        raise AssertionError("residency: the offloaded run differs from "
                             "the in-core one in %d values" % differing)
    # the forwards of groups 0..G-2 run again inside the backward walk
    remat = {"gemm_bias_act": 0, "lrn_fwd": 0, "uniform_fill": 0}
    for lo, hi in engine.plan.groups[:-1]:
        for m in trainer.forwards[lo:hi]:
            if isinstance(m, All2All):
                remat["gemm_bias_act"] += 1
            elif isinstance(m, LRNormalizerForward):
                remat["lrn_fwd"] += 1
            elif isinstance(m, DropoutForward):
                remat["uniform_fill"] += 1
    steps = RESIDENCY_EPOCHS * n_train
    want = {name: n + steps * remat.get(name, 0)
            for name, n in resident["counts"].items()}
    if offloaded["counts"] != want:
        raise AssertionError("residency: offloaded launches %s, derived %s"
                             % (offloaded["counts"], want))
    limit = (resident["peak"] - fc6_state + max(engine.plan.group_bytes) +
             PEAK_SLACK_BYTES)
    print("residency: peaks (MB) offloaded %.1f (built %.1f), bound %.1f"
          % (offloaded["peak"] / 1e6, offloaded["built"] / 1e6,
             limit / 1e6))
    if offloaded["peak"] > limit:
        raise AssertionError("residency: offloaded peak %.1f MB over its "
                             "bound %.1f MB" % (offloaded["peak"] / 1e6,
                                                limit / 1e6))
    h2d = [t[:3] for t in engine.transfers if t[3] == "h2d"]
    d2h = [t[:3] for t in engine.transfers if t[3] == "d2h"]
    result["offloaded"] = {
        "plan": plan, "differing": differing,
        "peak_mb": offloaded["peak"] / 1e6, "peak_bound_mb": limit / 1e6,
        "built_mb": offloaded["built"] / 1e6,
        "saving_mb": (resident["peak"] - offloaded["peak"]) / 1e6,
        "step_ms": offloaded["sweep_ms"][-1] / n_train,
        "offload_wait_s": trainer.offload_wait_s,
        "overlap": dict(engine.overlap),
        "h2d_gb_s": copy_rate(torch, h2d), "d2h_gb_s": copy_rate(torch, d2h),
        "bytes_a_step_gb": (sum(t[2] for t in h2d) +
                            sum(t[2] for t in d2h)) / n_train / 1e9,
        "counts": offloaded["counts"], "remat_a_step": remat}
    check_forms("residency offloaded", kernels, offloaded["forms"])
    check_designed("residency offloaded", offloaded["variants"])
    trainer.shutdown()
    del trainer

    # control: one group's writeback skipped
    real_copy = OffloadEngine._copy_back

    def skip_fc6(self, g, masters, leaves):
        if g != 1:
            real_copy(self, g, masters, leaves)

    with env_set(**offload_knobs), patched(OffloadEngine, "_copy_back",
                                           skip_fc6):
        run = residency_run(torch, data, 1)
    result["offloaded"]["control_skipped_writeback"] = state_differing(
        numpy, run["state"], resident["state"])
    run["trainer"].shutdown()
    del run
    if not result["offloaded"]["control_skipped_writeback"]:
        raise AssertionError("residency: skipping fc6's writeback changed "
                             "nothing")

    # a streamed and an offloaded epoch in a process of their own load
    # neither jax nor the JAX package
    path = os.path.join(tmp, "residency_import.py")
    with open(path, "w") as f:
        f.write(RESIDENCY_IMPORT_CHECK)
    env = dict(os.environ, PYTHONPATH=REPO, VELES_OFFLOAD_GROUP_MB="0.05",
               VELES_SHARD_MB="0.5")
    proc = subprocess.run([sys.executable, path], cwd=tmp, env=env,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 or "LOADED []" not in proc.stdout:
        raise AssertionError("residency import check: %s %s" % (
            proc.stdout[-2000:], proc.stderr[-2000:]))
    result["import_check"] = "LOADED []"
    channels = channels_cell(torch, tmp)
    result["channels"] = channels if channels is not None else \
        "absent: Pillow does not import"
    print("residency: channels-f32 %s" % json.dumps(result["channels"]))
    result["phase_s"] = time.perf_counter() - t0
    return result, [streamed["forms"], offloaded["forms"]]


# -- phase 13: the observability plane and the full serving engine ---------

#: epochs of the traced AlexNet-227 run (phase 9's file): odd, so that
#: the step histogram's p50 is the median of the runner's sweeps
OBSERVE_EPOCHS = 3
#: the step MFU against this script's own reckoning, and the step
#: histogram's p50 against the runner's train sweeps (relative)
MFU_REL_TOL = 0.01
STEP_MS_REL_TOL = 0.05
#: tracing's cost on AlexNet-227's float32 train sweep: the medians of
#: five traced and five untraced epochs, interleaved (the JAX package's
#: bar, ``docs/PERF.md``)
TRACE_OVERHEAD_LIMIT = 0.02
OVERHEAD_PAIRS = 5
#: /metrics.json's latency p50 against the clients' (relative)
LATENCY_P50_REL_TOL = 0.2
#: /profile.json's utilization of serve_forward:b64 against the spec
UTILIZATION_LIMIT = 1.05
#: the burst on the AlexNet route: BURST_THREADS threads submit new
#: rows to its engine as fast as they can for BURST_S seconds, with the
#: route's admission bound cut to BURST_CAPACITY samples, so that the
#: queue fills and sheds (the card serves a forward faster than HTTP
#: can feed it: through the frontend the queue never builds), against
#: the autoscaler's queue bar and breach window
BURST_THREADS = 4
BURST_CAPACITY = 24
BURST_S = 3.0
BURST_UP_QUEUE = 4.0
BURST_UP_FOR_S = 0.5
#: the drained-back autoscaler's idle window and cooldown (s)
DRAIN_IDLE_S = 1.0
DRAIN_TIMEOUT_S = 60.0
#: the JAX package's status payload (``veles_tpu/serving/frontend.py``
#: ``_StatusReporter._payload``)
STATUS_KEYS = {"id", "name", "mode", "master", "time", "units", "stopped",
               "serving"}
#: one line of the Prometheus text exposition (``tests/test_telemetry.py``)
PROM_LINE = (r'^(?:# (?:HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+|'
             r'[a-zA-Z_:][a-zA-Z0-9_:]*'
             r'(?:\{[a-zA-Z0-9_]+="(?:[^"\\]|\\.)*"'
             r'(?:,[a-zA-Z0-9_]+="(?:[^"\\]|\\.)*")*\})?'
             r' -?[0-9.]+(?:[eE][+-]?[0-9]+)?|[^ ]+ (?:nan|inf|-inf))$')

#: phase 9's AlexNet run with one service unit more: ``root.smoke.
#: overhead`` flips tracing at each epoch's end (epoch 0 untraced, then
#: on, off, ...), ``root.smoke.poison`` writes a NaN into one training
#: row of the staged dataset after epoch 0; no snapshotter
SERVICE_FILE = """
import math
from veles_tpu_torch.config import root
from veles_tpu_torch.datasets import golden_digits
from veles_tpu_torch.loader.base import VALIDATION
from veles_tpu_torch.models.alexnet import (ALEXNET_LAYERS,
                                            AlexNetWorkflow,
                                            SyntheticImageLoader)
from veles_tpu_torch.models.mnist import MnistWorkflow
from veles_tpu_torch.telemetry import tracing
from veles_tpu_torch.units import Unit


class EpochService(Unit):
    hide_from_registry = True
    view_group = "SERVICE"

    def initialize(self, **kwargs):
        self.traced = []
        self.poisoned = None

    def run(self):
        loader = self.workflow.loader
        if root.smoke.get("overhead", False):
            self.traced.append(tracing.enabled())
            if tracing.enabled():
                tracing.disable()
            else:
                tracing.enable()
        if root.smoke.get("poison", False) and self.poisoned is None:
            start = loader.class_end_offsets[VALIDATION]
            self.poisoned = int(loader.shuffled_indices[start])
            # the staged copy on the card is what the sweeps read
            loader._staged_[0][self.poisoned] = math.nan


def run(load, main):
    if root.smoke.get("mnist", False):
        wf, _ = load(MnistWorkflow, provider=golden_digits(%d, %d),
                     layers=(100,), minibatch_size=500,
                     max_epochs=root.smoke.epochs)
    else:
        wf, _ = load(
            AlexNetWorkflow,
            loader_factory=lambda wf: SyntheticImageLoader(
                workflow=wf, n_train=%d, n_valid=%d, minibatch_size=%d),
            layers=ALEXNET_LAYERS, max_epochs=root.smoke.epochs,
            learning_rate=0.01, momentum=0.9, weights_decay=5e-4)
    service = EpochService(wf, name="epoch_service")
    service.link_from(wf.decision)
    service.gate_skip = ~wf.loader.epoch_ended
    main()
""" % (BASELINE_DIGITS + (TRAIN_SAMPLES, TRAIN_BATCH, TRAIN_BATCH))

#: the import check of phase 13, in a process of its own: ``serve``
#: with every flag on a small package, then a traced CLI epoch
OBSERVE_IMPORT_CHECK = """
import json, sys, threading, time, urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from veles_tpu_torch.__main__ import main
from veles_tpu_torch.serving.frontend import serve

out, package, workflow = sys.argv[1:4]
posts = []


class Stub(BaseHTTPRequestHandler):
    def do_POST(self):
        posts.append(self.rfile.read(int(self.headers["Content-Length"])))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *args):
        pass


stub = ThreadingHTTPServer(("127.0.0.1", 0), Stub)
threading.Thread(target=stub.serve_forever, daemon=True).start()
fe = serve(["--model", "a=" + package, "--model", "b=" + package,
            "--host", "127.0.0.1", "--port", "0", "--cache-mb", "8",
            "--cache-ttl-s", "60", "--tenant", "interactive:4:interactive",
            "--tenant", "batch:1:batch", "--min-replicas", "1",
            "--max-replicas", "2", "--max-batch-size", "8",
            "--web-status", "127.0.0.1:%d" % stub.server_address[1],
            "--trace-out", out + "/serve.json"])
req = urllib.request.Request(
    "http://127.0.0.1:%d/api/b" % fe.port,
    data=json.dumps({"input": [0.5] * 784, "codec": "list"}).encode(),
    headers={"Content-Type": "application/json", "X-Tenant": "batch"})
json.loads(urllib.request.urlopen(req, timeout=120).read())["result"]
deadline = time.time() + 30
while not posts and time.time() < deadline:
    time.sleep(0.05)
fe.stop()
stub.shutdown()
assert posts, "no status POST"
assert main([workflow, "-s", "7", "--trace-out", out + "/train.json"]) == 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "veles_tpu" or m.startswith("veles_tpu."))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def span_table(path):
    """The events of a dumped Chrome trace (it must load), by name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    table = collections.defaultdict(list)
    for e in events:
        table[e["name"]].append(e)
    return table


def expected_training_counts(trainer, epochs, testing=False):
    """K1/K3/K4/K6/K7 launches of ``epochs`` epochs of a trainer's run
    (the workflow phase's derivation): K1 and K3 per forward, K4 and K7
    per step at the model's counts, K6 per step per bias."""
    from veles_tpu_torch.loader.base import TRAIN, VALIDATION
    per_epoch = len(trainer._segment_indices(TRAIN))
    steps = 0 if testing else epochs * per_epoch
    forwards = steps + epochs * len(trainer._segment_indices(VALIDATION))
    return launch_counts(trainer, forwards, steps)


def launch_counts(trainer, forwards, steps):
    """K1/K3/K4/K6/K7 launches of ``forwards`` minibatch forwards of
    which ``steps`` trained, on a trainer's model."""
    kinds = [type(m).__name__ for m in trainer.forwards]
    n_lrn = kinds.count("LRNormalizerForward")
    k1 = sum(k.startswith("All2All") and k != "All2AllSoftmax"
             for k in kinds)
    return {"gemm_bias_act": k1 * forwards, "lrn_fwd": n_lrn * forwards,
            "lrn_bwd": n_lrn * steps,
            "column_reduce": sum("bias" in p for p in trainer.params) *
            steps,
            "uniform_fill": kinds.count("DropoutForward") * steps,
            "kahan_gemm": 0}


def reset_series(*names):
    """Drop every series of the named registry families: the readings
    that follow are this run's alone."""
    from veles_tpu_torch.telemetry.registry import get_registry
    for name in names:
        family = get_registry().get(name)
        if family is not None:
            family.reset()


def traced_training(torch, numpy, tmp, card):
    """alexnet-train-traced-f32: ``python -m veles_tpu_torch --trace-out``
    on phase 9's file, 2 epochs (snapshotted into ``tmp/snapshots``,
    which the serving cell serves), then one eager epoch traced.
    Returns (result, launches_by_form)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models.build import model_cost
    from veles_tpu_torch.telemetry import profiler
    from veles_tpu_torch.telemetry.registry import get_registry
    path = os.path.join(tmp, "alexnet_workflow.py")
    with open(path, "w") as f:
        f.write(WORKFLOW_FILE)
    trace = os.path.join(tmp, "train.trace.json")
    prng._generators.clear()
    reset_counts()
    reset_series("veles_step_ms", "veles_op_ms", "veles_epoch_ms")
    main = workflow_cli(path, "-s", "7", "--precision", "float32",
                        "--trace-out", trace,
                        "root.smoke.snapshots=%r" % os.path.join(
                            tmp, "snapshots"),
                        "root.smoke.epochs=%d" % OBSERVE_EPOCHS)
    counts, by_form = read_counts()
    runner = main.launcher.runner
    trainer = runner.trainer
    want = expected_training_counts(trainer, OBSERVE_EPOCHS)
    if counts != want:
        raise AssertionError("traced training launch counts %s, expected %s"
                             " (the untraced run's)" % (counts, want))
    check_designed("traced training", gemm_variants())
    forms = check_designed_forms("traced training")
    spans = span_table(trace)
    names = {n: len(v) for n, v in spans.items()}
    for name, n in (("step:train", OBSERVE_EPOCHS),
                    ("step:eval", OBSERVE_EPOCHS), ("epoch", OBSERVE_EPOCHS)):
        if names.get(name) != n:
            raise AssertionError("traced training: %d %s spans, expected %d"
                                 % (names.get(name, 0), name, n))
    # the fused step stands in for every unit it covers: only the
    # epoch-boundary services (the snapshotter) run as units
    units = sorted(n for n in names if n.startswith("unit:"))
    if units != ["unit:snapshotter"]:
        raise AssertionError("fused run traced unit spans %s" % units)
    memprof = trace + ".memprof"
    if not os.path.getsize(memprof):
        raise AssertionError("empty memory profile %s" % memprof)
    reg = get_registry()
    mfu = reg.get("veles_step_mfu").value
    train_s = [t["train_s"] for t in runner.epoch_times]
    samples = trainer.loader.class_lengths[2]
    flops = model_cost(trainer.model)["train_flops"]
    mine = flops * samples / train_s[-1] / PEAK_OPS["bfloat16"]
    if not 0.0 < mfu <= 1.0 or abs(mfu - mine) > MFU_REL_TOL * mine:
        raise AssertionError("veles_step_mfu %.6g, this script's reckoning "
                             "%.6g (%.4g FLOP x %d samples / %.6f s / "
                             "%.4g)" % (mfu, mine, flops, samples,
                                        train_s[-1], PEAK_OPS["bfloat16"]))
    step = reg.get("veles_step_ms").labels(phase="train")
    step_p50 = step.percentile(50)
    wall_p50 = 1e3 * statistics.median(train_s)
    if step.count != OBSERVE_EPOCHS or \
            abs(step_p50 - wall_p50) > STEP_MS_REL_TOL * wall_p50:
        raise AssertionError("veles_step_ms{phase=train}: %d samples, p50 "
                             "%.4f ms against the runner's %.4f" % (
                                 step.count, step_p50, wall_p50))
    book = {row["op"]: row for row in
            profiler.get_cost_book().report()["ops"]}
    result = {"step_mfu": mfu, "step_mfu_reckoned": mine,
              "train_flops_per_sample": flops,
              "train_s": train_s, "step_ms_p50": step_p50,
              "train_segment": book["train_segment"],
              "eval_segment": book["eval_segment"],
              "memprof_mib": os.path.getsize(memprof) / 1048576.0,
              "trace_spans": len(sum(spans.values(), []))}
    print("traced training (%s): veles_step_mfu %.4f (reckoned %.4f: "
          "%.4g FLOP/sample x %d / %.4f s / %.0f TFLOP/s bf16), step p50 "
          "%.3f ms against %.3f; spans %s; memory profile %.1f MiB" % (
              card, mfu, mine, flops, samples, train_s[-1],
              PEAK_OPS["bfloat16"] / 1e12, step_p50, wall_p50,
              {n: names[n] for n in ("step:train", "step:eval", "epoch")},
              result["memprof_mib"]))
    del main, runner, trainer
    torch.cuda.empty_cache()

    # the eager path: unit spans, one epoch
    eager_trace = os.path.join(tmp, "eager.trace.json")
    prng._generators.clear()
    reset_counts()
    main = workflow_cli(path, "-s", "7", "--precision", "float32",
                        "--eager", "--trace-out", eager_trace,
                        "root.smoke.snapshots=%r" % os.path.join(
                            tmp, "eager_snapshots"), "root.smoke.epochs=1")
    more = read_counts()[1]
    spans = span_table(eager_trace)
    units = {n: len(v) for n, v in spans.items() if n.startswith("unit:")}
    forwards = ["unit:%s" % f.name for f in main.workflow.forwards]
    if [f for f in forwards if f not in units] or \
            "workflow:%s" % main.workflow.name not in spans:
        raise AssertionError("eager traced run: unit spans %s, workflow "
                             "span %s" % (units, sorted(
                                 n for n in spans if n.startswith("wf"))))
    result["eager_unit_spans"] = units
    print("traced eager epoch: %d unit:* spans over %d units" % (
        sum(units.values()), len(units)))
    del main
    torch.cuda.empty_cache()
    return result, [by_form, more]


def overhead_run(torch, tmp, name, mnist=False):
    """The service file run through the CLI with tracing flipped at each
    epoch's end: (traced train sweeps s, untraced s, launches by epoch
    kind). Epoch 0 (untraced) is the warm-up and left out."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.telemetry import tracing
    path = os.path.join(tmp, "service_workflow.py")
    with open(path, "w") as f:
        f.write(SERVICE_FILE)
    prng._generators.clear()
    reset_counts()
    try:
        main = workflow_cli(path, "-s", "7", "--precision", "float32",
                            "root.smoke.overhead=True",
                            "root.smoke.poison=False",
                            "root.smoke.mnist=%r" % mnist,
                            "root.smoke.epochs=%d" % (2 * OVERHEAD_PAIRS + 1))
    finally:
        tracing.disable()
    service = [u for u in main.workflow if u.name == "epoch_service"][0]
    times = main.launcher.runner.epoch_times
    counts = read_counts()[0]
    want = expected_training_counts(main.launcher.runner.trainer,
                                    2 * OVERHEAD_PAIRS + 1)
    if counts != want:
        raise AssertionError("%s: launch counts %s, expected %s" % (
            name, counts, want))
    on = [t["train_s"] for t, traced in zip(times, service.traced)
          if traced]
    off = [t["train_s"] for t, traced in zip(times[1:], service.traced[1:])
           if not traced]
    if len(on) != OVERHEAD_PAIRS or len(off) != OVERHEAD_PAIRS:
        raise AssertionError("%s: %d traced and %d untraced epochs" % (
            name, len(on), len(off)))
    del main
    torch.cuda.empty_cache()
    return on, off


def overhead_cell(torch, tmp, card):
    """Tracing's cost: AlexNet-227 f32 gated, mnist-fc reported."""
    result = {}
    for name, mnist in (("alexnet227", False), ("mnist_fc", True)):
        on, off = overhead_run(torch, tmp, name, mnist)
        share = statistics.median(on) / statistics.median(off) - 1.0
        result[name] = {"traced_train_s": on, "untraced_train_s": off,
                        "overhead": share}
        print("tracing overhead (%s) %s: median train sweep %.4f ms traced,"
              " %.4f untraced: %+.2f%%%s" % (
                  card, name, 1e3 * statistics.median(on),
                  1e3 * statistics.median(off), 100 * share,
                  "" if mnist else " (limit %.0f%%)" %
                  (100 * TRACE_OVERHEAD_LIMIT)))
        if not mnist and abs(share) > TRACE_OVERHEAD_LIMIT:
            raise AssertionError("tracing costs AlexNet-227's sweep %+.2f%%"
                                 " (limit %.0f%%)" % (
                                     100 * share, 100 * TRACE_OVERHEAD_LIMIT))
    return result


def residency_traced(torch, tmp):
    """alexnet-stream-traced: one streamed epoch (the residency phase's
    400 MB budget) and one offloaded epoch (its 150 MB groups) of phase
    9's file through the CLI with ``--trace-out``. Returns (result,
    launches_by_form)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.telemetry import profiler
    from veles_tpu_torch.telemetry.registry import get_registry
    path = os.path.join(tmp, "alexnet_workflow.py")
    result, forms = {}, []
    for kind, env in (("streamed", {"VELES_STREAM": "1",
                                    "VELES_DEVICE_BUDGET_MB":
                                    RESIDENCY_BUDGET_MB}),
                      ("offloaded", {"VELES_OFFLOAD": "1",
                                     "VELES_OFFLOAD_GROUP_MB":
                                     OFFLOAD_GROUP_MB})):
        trace = os.path.join(tmp, "%s.trace.json" % kind)
        prng._generators.clear()
        reset_counts()
        with env_set(**env):
            main = workflow_cli(path, "-s", "7", "--precision", "float32",
                                "--trace-out", trace,
                                "root.smoke.snapshots=%r" % os.path.join(
                                    tmp, kind), "root.smoke.epochs=1")
        forms.append(read_counts()[1])
        runner = main.launcher.runner
        trainer = runner.trainer
        spans = span_table(trace)
        times = runner.epoch_times[-1]
        row = {"epoch": times}
        if kind == "streamed":
            if not trainer.streaming:
                raise AssertionError("the streamed cell did not stream")
            need = ("prefetch:produce", "prefetch:wait", "prefetch:etl",
                    "prefetch:h2d")
            gauge = get_registry().get(
                "veles_input_starvation_fraction").labels(
                phase="epoch").value
            if gauge != times["starvation"]:
                raise AssertionError("veles_input_starvation_fraction %r, "
                                     "the runner's starvation %r" % (
                                         gauge, times["starvation"]))
            row["starvation"] = gauge
        else:
            if not trainer.offloaded:
                raise AssertionError("the offloaded cell did not offload")
            need = ("offload:h2d", "offload:d2h", "offload:plan",
                    "offload:pin")
            groups = set(range(trainer._offload_engine.plan.n_groups))
            seen = {d: {e["args"]["group"] for e in spans["offload:" + d]}
                    for d in ("h2d", "d2h")}
            if seen["h2d"] != groups or seen["d2h"] != groups:
                raise AssertionError("offload spans by group %s, the plan's "
                                     "groups %s" % (seen, sorted(groups)))
            book = {r["op"]: r for r in
                    profiler.get_cost_book().report()["ops"]}
            row["groups"] = {
                "g%d" % g: {d: {k: book["offload:%s/g%d" % (d, g)][k]
                                for k in ("bytes", "calls", "p50_ms",
                                          "achieved_gbps")}
                            for d in ("h2d", "d2h")} for g in groups}
            row["overlap"] = get_registry().get(
                "veles_offload_compute_overlap_fraction").labels(
                phase="epoch").value
        missing = [n for n in need if not spans.get(n)]
        if missing:
            raise AssertionError("%s traced epoch lacks spans %s" % (
                kind, missing))
        row["spans"] = {n: len(spans[n]) for n in need}
        result[kind] = row
        print("traced %s epoch: spans %s%s" % (
            kind, row["spans"], " starvation %.4f" % row["starvation"]
            if kind == "streamed" else
            " every group %s, overlap %.4f" % (sorted(row["groups"]),
                                               row["overlap"])))
        del main, runner, trainer
        torch.cuda.empty_cache()
    return result, forms


def flight_cell(torch, tmp):
    """The flight recorder: the service file's AlexNet run, 2 epochs, with
    a NaN written into one training row after epoch 0, and without.
    Returns (result, launches_by_form of the clean run)."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.loader.base import VALIDATION
    from veles_tpu_torch.telemetry import flight, tracing
    path = os.path.join(tmp, "service_workflow.py")
    with open(path, "w") as f:
        f.write(SERVICE_FILE)
    result = {}
    for poison in (False, True):
        out = os.path.join(tmp, "flight_%s" % ("nan" if poison else "clean"))
        flight.reset_recorder()
        prng._generators.clear()
        reset_counts()
        with env_set(VELES_FLIGHT_DIR=out):
            try:
                tracing.enable()
                main = workflow_cli(path, "-s", "7", "--precision",
                                    "float32", "root.smoke.epochs=2",
                                    "root.smoke.overhead=False",
                                    "root.smoke.mnist=False",
                                    "root.smoke.poison=%r" % poison)
            finally:
                tracing.disable()
                flight.reset_recorder()
        records = sorted(os.listdir(out)) if os.path.isdir(out) else []
        if not poison:
            forms = read_counts()[1]
            if records:
                raise AssertionError("the clean run wrote flight records %s"
                                     % records)
            result["clean_records"] = 0
            continue
        loader = main.workflow.loader
        service = [u for u in main.workflow if u.name == "epoch_service"][0]
        start = loader.class_end_offsets[VALIDATION]
        train = list(loader.shuffled_indices[start:])
        batch = train.index(service.poisoned) // loader.max_minibatch_size
        # one record a detector: the first written names the row's
        # batch. Which detector trips first depends on the card: its
        # max-pooling drops a NaN (fmax), so the forward's loss may stay
        # finite while the conv1 weight gradient goes NaN
        records = sorted((r for r in records if r.endswith(".json")),
                         key=lambda r: int(r[:-len(".json")].rsplit(
                             "-", 1)[1]))
        loaded = [flight.load_record(os.path.join(out, r))
                  for r in records]
        reasons = [r["reason"] for r in loaded]
        first = loaded[0]["context"] if loaded else {}
        if not loaded or len(set(reasons)) != len(reasons) or \
                not set(reasons) <= {"non_finite_loss",
                                     "non_finite_grad_norm"} or \
                (first.get("epoch"), first.get("batch")) != (1, batch) or \
                any(r["context"]["epoch"] != 1 for r in loaded) or \
                not loaded[0]["log_tail"] or not loaded[0]["spans"]:
            raise AssertionError(
                "the NaN row %d sits in epoch 1's batch %d; the records %s "
                "name %s" % (service.poisoned, batch, reasons,
                             [r["context"] for r in loaded]))
        result.update(nan_records=reasons, nan_context=first,
                      log_lines=len(loaded[0]["log_tail"]),
                      spans=len(loaded[0]["spans"]))
        print("flight: the NaN row %d (epoch 1, batch %d) wrote %s, the "
              "first naming epoch %s batch %s with %d log lines and %d "
              "spans; the clean run none" % (
                  service.poisoned, batch, reasons, first["epoch"],
                  first["batch"], len(loaded[0]["log_tail"]),
                  len(loaded[0]["spans"])))
        del main
    torch.cuda.empty_cache()
    return result, forms


class StatusStub(object):
    """A local HTTP server recording the bodies POSTed to it."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        posts = self.posts = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                posts.append((self.path, json.loads(self.rfile.read(
                    int(self.headers["Content-Length"])))))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def address(self):
        return "127.0.0.1:%d" % self.server.server_address[1]

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def get_url(port, path):
    with urllib.request.urlopen("http://127.0.0.1:%d%s" % (port, path),
                                timeout=120) as resp:
        if resp.status != 200:
            raise AssertionError("HTTP %d from %s" % (resp.status, path))
        return resp.read()


def route_replicas(entry):
    return {id(r): r.batches_done for r in entry.pool.replicas}


def route_forwards(entry, before):
    return sum(r.batches_done - before.get(id(r), 0)
               for r in entry.pool.replicas)


#: the clients of a round in a process of their own: the server's
#: latency is held to what they see, without their threads contending
#: with the server's for one interpreter
CLIENTS = """
import json, sys, threading, time, urllib.request
port, path, bodies_file, mode = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                 sys.argv[4])
with open(bodies_file) as f:
    bodies = json.load(f)
replies, latencies, errors = {}, {}, []
# the first urlopen imports and builds the opener: not a request's time
urllib.request.urlopen("http://127.0.0.1:%d/healthz" % port,
                       timeout=600).read()


def ask(i, body, rid):
    try:
        req = urllib.request.Request(
            "http://127.0.0.1:%d%s" % (port, path), data=body.encode(),
            headers={"Content-Type": "application/json",
                     "X-Request-Id": rid}, method="POST")
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as resp:
            replies[i] = json.loads(resp.read())["result"]
        latencies[i] = time.perf_counter() - t
    except Exception as e:
        errors.append(repr(e))


t = time.perf_counter()
if mode == "sequential":
    for i, (b, rid) in enumerate(bodies):
        ask(i, b, rid)
else:
    threads = [threading.Thread(target=ask, args=(i, b, rid))
               for i, (b, rid) in enumerate(bodies)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
wall = time.perf_counter() - t
json.dump({"replies": [replies.get(i) for i in range(len(bodies))],
           "latencies": [latencies.get(i) for i in range(len(bodies))],
           "wall": wall, "errors": errors}, sys.stdout)
"""


def process_posts(port, path, bodies, ids, sequential=False):
    """POST ``bodies`` (bytes), each with its ``X-Request-Id`` of ``ids``,
    all at once from client threads of a process of its own (one after
    another with ``sequential``): (replies, latencies s, wall s)."""
    import subprocess
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".json",
                                     delete=False) as f:
        json.dump([[b.decode(), rid] for b, rid in zip(bodies, ids)], f)
    try:
        proc = subprocess.run([sys.executable, "-c", CLIENTS, str(port),
                               path, f.name, "sequential" if sequential
                               else "concurrent"], capture_output=True,
                              text=True, timeout=900)
    finally:
        os.remove(f.name)
    if proc.returncode != 0:
        raise AssertionError("clients exited %d: %s" % (
            proc.returncode, proc.stderr[-2000:]))
    out = json.loads(proc.stdout)
    if out["errors"] or None in out["replies"]:
        raise AssertionError("clients: %s" % out["errors"][:3])
    return out["replies"], out["latencies"], out["wall"]


def route_post(numpy, frontend, route, rng, ids):
    """16 concurrent single requests (list codec, ``X-Request-Id``s
    ``ids``) and one 64-row batch (base64) on ``route``. Returns (the
    round's numbers, single bodies, inputs, served rows)."""
    model = frontend.entries[route].model
    shape = tuple(model.sample_shape)
    singles = rng.uniform(-1, 1, (16,) + shape).astype(numpy.float32)
    batch = rng.uniform(-1, 1, (64,) + shape).astype(numpy.float32)
    bodies = [json.dumps({"input": s.tolist(), "codec": "list"}).encode()
              for s in singles]
    path = "/api/" + route
    replies, latencies, wall = process_posts(frontend.port, path, bodies,
                                             ids)
    t = time.perf_counter()
    batch_reply = post(frontend.port, path + "/batch", b64_body(batch))
    batch_s = time.perf_counter() - t
    lat = sorted(latencies)
    return ({"single_p50_ms": 1e3 * statistics.median(lat),
             "single_p95_ms": 1e3 * lat[min(len(lat) - 1,
                                            int(0.95 * len(lat)))],
             "singles_wall_s": wall, "batch64_ms": 1e3 * batch_s},
            bodies, numpy.concatenate([singles, batch]),
            numpy.array(replies + batch_reply["results"]))


def route_check(torch, numpy, frontend, route, inputs, served):
    """Every served row of ``route`` held to its model's plain forward by
    the centred-logit check, with a reply swap and the last K1 layer's
    output zeroed (the kernel forward) as controls that must fail it.
    Returns the check's numbers and the kernels a forward launches."""
    from veles_tpu_torch.models.build import plain_forward
    from veles_tpu_torch.nn.all2all import All2AllSoftmax
    model = frontend.entries[route].model
    want = forward_rows(torch, numpy, lambda x: plain_forward(
        model.module, x), inputs)
    k1 = [i for i, m in enumerate(model.module)
          if type(m).__name__.startswith("All2All") and
          not isinstance(m, All2AllSoftmax)]
    swapped = served.copy()
    swapped[[0, 1]] = served[[1, 0]]
    zeroed = forward_rows(torch, numpy, lambda x: forward_zeroing(
        model.module, x, k1[-1]), inputs)
    err, spread, shares = check_replies(
        numpy, "observability %s" % route, served, want,
        [("swapped", swapped), ("last_k1_zeroed", zeroed)])
    return {"centred_logit_err": err, "spread": spread,
            "control_shares": shares, "k1_per_forward": len(k1),
            "k3_per_forward": [type(m).__name__ for m in model.module
                               ].count("LRNormalizerForward")}


def serving_cell(torch, numpy, kernels, tmp, card):
    """alexnet-serve-full-f32 (see the module docstring). Returns (result,
    [launches_by_form])."""
    import re
    from veles_tpu_torch import prng
    from veles_tpu_torch.serving.cache import ResultCache
    from veles_tpu_torch.serving.frontend import REFUSED_FLAGS, serve
    from veles_tpu_torch.telemetry import profiler
    if REFUSED_FLAGS:
        raise AssertionError("serve refuses %s" % sorted(REFUSED_FLAGS))
    # the mnist-fc route: one eager epoch on the card, exported
    mnist = os.path.join(tmp, "mnist_fc.py")
    with open(mnist, "w") as f:
        f.write(MNIST_FC_FILE)
    prng._generators.clear()
    main = workflow_cli(mnist, "-s", str(BASELINE_SEED), "--eager")
    package = os.path.join(tmp, "mnist_fc.tar")
    main.workflow.package_export(package)
    del main
    torch.cuda.empty_cache()
    stub = StatusStub()
    trace = os.path.join(tmp, "serve.trace.json")
    profiler.reset_phases()
    reset_series("veles_serving_latency_ms", "veles_op_ms")
    t0 = time.perf_counter()
    frontend = serve([
        "--model", "alexnet=" + os.path.join(tmp, "snapshots"),
        "--model", "mnist=" + package, "--host", "127.0.0.1", "--port",
        "0", "--max-batch-size", "64", "--response-timeout", "300",
        "--cache-mb", "64", "--tenant", "interactive:4:interactive",
        "--tenant", "batch:1:batch", "--min-replicas", "1",
        "--max-replicas", "2", "--web-status", stub.address,
        "--trace-out", trace])
    result = {"start_s": time.perf_counter() - t0,
              "replica_warmup_ms": profiler.phase_report().get(
                  "replica_warmup")}
    alex, mn = frontend.entries["alexnet"], frontend.entries["mnist"]
    # no scaling until the burst: the rounds below count their forwards
    for entry in (alex, mn):
        entry.autoscaler.up_for_s = 1e9
    forms = []
    try:
        # (1) routing
        reset_counts()
        before = {r: route_replicas(frontend.entries[r])
                  for r in ("alexnet", "mnist")}
        rng = numpy.random.RandomState(13)
        rounds, bodies, served = {}, {}, {}
        for route in ("alexnet", "mnist"):
            ids = ["%s-%d" % (route, i) for i in range(16)]
            rounds[route], bodies[route], inputs, served[route] = \
                route_post(numpy, frontend, route, rng, ids)
            served[route] = (inputs, served[route])
        counts, by_form = read_counts()
        forwards = {r: route_forwards(frontend.entries[r], before[r])
                    for r in before}
        for route in ("alexnet", "mnist"):   # the checks launch kernels
            rounds[route].update(route_check(torch, numpy, frontend, route,
                                             *served[route]))
        alex_first = served["alexnet"][1][:16].tolist()
        want = dict.fromkeys(kernel_counters(), 0)
        want["gemm_bias_act"] = sum(rounds[r]["k1_per_forward"] *
                                    forwards[r] for r in forwards)
        want["lrn_fwd"] = sum(rounds[r]["k3_per_forward"] * forwards[r]
                              for r in forwards)
        if counts != want:
            raise AssertionError("served rounds launch counts %s over "
                                 "forwards %s, expected %s" % (
                                     counts, forwards, want))
        check_forms("observability serving", kernels, by_form)
        check_designed("observability serving", gemm_variants())
        check_designed_forms("observability serving", ("lrn_fwd",))
        forms.append(by_form)
        result.update(routes=rounds, forwards=forwards,
                      latency=latency_check(numpy, frontend, rng, rounds))
        print("observability serving: routes %s; forwards %s, launches %s"
              % ({r: "%.1f ms p50, batch %.1f ms" % (
                  v["single_p50_ms"], v["batch64_ms"])
                  for r, v in rounds.items()}, forwards, counts))

        # (2) the cache: the same 16 bodies again on the AlexNet route
        hits0 = alex.cache.stats()["hits"]
        reset_counts()
        replies, _, _ = concurrent_posts(frontend.port, bodies["alexnet"],
                                         path="/api/alexnet")
        counts = read_counts()[0]
        hits = alex.cache.stats()["hits"] - hits0
        if [r["result"] for r in replies] != alex_first or hits != 16 or \
                counts["gemm_bias_act"] or counts["lrn_fwd"]:
            raise AssertionError(
                "cache round: replies equal %s, %d hits, launches %s" % (
                    [r["result"] for r in replies] == alex_first, hits,
                    counts))
        result["cache"] = alex.cache.stats()
        print("observability cache: 16 repeated bodies answered bit for "
              "bit by %d hits, K1 %d and K3 %d launches" % (
                  hits, counts["gemm_bias_act"], counts["lrn_fwd"]))

        # (3) a swap invalidates; a cache keyed without the version
        #     (the control) serves a stale row after it
        result["swap"] = swap_check(torch, numpy, frontend, package,
                                    ResultCache)

        # (4) the autoscaler: a burst up to 2 replicas, drained to 1
        result["autoscale"] = burst(numpy, frontend, alex)

        # (5) the endpoints
        result["endpoints"] = endpoints_check(numpy, frontend, stub, re)
        result["status_posts"] = len(stub.posts)
    finally:
        frontend.stop()                  # writes the trace files
        stub.close()
    result["attribution"] = attribution(trace)
    if not os.path.getsize(trace + ".memprof"):
        raise AssertionError("empty memory profile")
    del frontend, alex, mn
    torch.cuda.empty_cache()
    return result, forms


def latency_p50(port):
    """veles_serving_latency_ms{endpoint="/api"}'s p50 as /metrics
    renders it, and /metrics.json's p50 of the same endpoint."""
    prom = get_url(port, "/metrics").decode()
    quantile = [float(line.split()[-1]) for line in prom.splitlines()
                if line.startswith('veles_serving_latency_ms{endpoint='
                                   '"/api",quantile="0.5"}')]
    stats = json.loads(get_url(port, "/metrics.json"))
    return (quantile[0] if quantile else None,
            stats["endpoints"]["/api"]["p50_ms"])


def latency_check(numpy, frontend, rng, rounds):
    """The server's latency clock against the clients': 16 new list-codec
    requests on the AlexNet route one after another from the client
    process, the registry's p50 (reset before them) within
    LATENCY_P50_REL_TOL of the clients'. Beside it, the 16 concurrent
    requests of the routing round: the server's p50 then (both
    renderings) against the clients' -- the part of a request the
    server's clock does not see under concurrency, reported."""
    registry_p50, json_p50 = latency_p50(frontend.port)
    concurrent = {"client_p50_ms": rounds["alexnet"]["single_p50_ms"],
                  "registry_p50_ms": registry_p50,
                  "metrics_json_p50_ms": json_p50}
    reset_series("veles_serving_latency_ms")
    shape = tuple(frontend.entries["alexnet"].model.sample_shape)
    bodies = [json.dumps({"input": s.tolist(), "codec": "list"}).encode()
              for s in rng.uniform(-1, 1, (16,) + shape).astype(
                  numpy.float32)]
    _, latencies, _ = process_posts(frontend.port, "/api/alexnet", bodies,
                                    ["seq-%d" % i for i in range(16)],
                                    sequential=True)
    client = 1e3 * statistics.median(latencies)
    server = latency_p50(frontend.port)[0]
    if server is None or abs(server - client) > LATENCY_P50_REL_TOL * client:
        raise AssertionError("veles_serving_latency_ms p50 %s ms against the"
                             " clients' %.3f (sequential requests)" % (
                                 server, client))
    out = {"sequential": {"client_p50_ms": client,
                          "registry_p50_ms": server},
           "concurrent": concurrent}
    print("observability latency: sequential requests p50 %.2f ms at the "
          "server, %.2f at the clients; 16 concurrent: %.2f (/metrics.json "
          "%.2f) against the clients' %.2f" % (
              server, client, registry_p50, json_p50,
              concurrent["client_p50_ms"]))
    return out


def swap_check(torch, numpy, frontend, package, cache_cls):
    """On the mnist route: after ``swap_model`` to perturbed weights, a
    repeated body is answered by the new model (the real cache); with a
    cache keyed by the content alone (no model version, no invalidation)
    the same swap serves the old, stale row, which the same check must
    refuse."""
    from veles_tpu_torch.serving.model_store import ServeableModel

    class VersionBlind(cache_cls):
        """Keyed by the content alone: no model version in the key, no
        invalidation on a swap."""

        @staticmethod
        def key_for(sample, name, version):
            return cache_cls.key_for(sample, name, 0)

        def invalidate(self):
            return 0

    entry = frontend.entries["mnist"]
    x = numpy.random.RandomState(21).rand(1, 784).astype(numpy.float32)
    body = json.dumps({"input": x[0].tolist(), "codec": "list"}).encode()
    out = {}
    for step, (label, cache) in enumerate((
            ("versioned", entry.cache),
            ("version_blind", VersionBlind(max_bytes=1 << 20,
                                           model="control")))):
        saved = entry.cache
        entry.cache = entry.engine.cache = cache
        try:
            before = post(frontend.port, "/api/mnist", body)["result"]
            again = post(frontend.port, "/api/mnist", body)["result"]
            model = ServeableModel.from_package(package, device="cuda")
            with torch.no_grad():
                noise = numpy.random.RandomState(step)
                for p in model.module.parameters():
                    p.add_(torch.from_numpy(noise.normal(
                        0.0, 0.05, tuple(p.shape))).to(p))
            frontend.swap_model(model, name="mnist")
            after = post(frontend.port, "/api/mnist", body)["result"]
        finally:
            entry.cache = entry.engine.cache = saved
        fresh = model(x)[0]
        err = float(numpy.abs(numpy.asarray(after) - fresh).max())
        moved = float(numpy.abs(numpy.asarray(before) - fresh).max())
        out[label] = {"err": err, "moved": moved, "repeat_equal":
                      again == before}
        stale = err > 1e-5
        if stale != (label == "version_blind") or moved <= 1e-5 or \
                again != before:
            raise AssertionError("swap %s: reply %.3g from the new model "
                                 "(the swap moved it %.3g), repeat equal %s"
                                 % (label, err, moved, again == before))
    print("observability swap: the versioned cache answers the new model "
          "(err %.3g), the version-blind control serves the stale row "
          "(err %.3g of a %.3g move) and fails" % (
              out["versioned"]["err"], out["version_blind"]["err"],
              out["version_blind"]["moved"]))
    return out


def burst(numpy, frontend, entry):
    """BURST_THREADS threads submit new rows (no cache hit) to the
    AlexNet route's engine for BURST_S seconds, its admission bound cut
    to BURST_CAPACITY: the autoscaler (queue bar BURST_UP_QUEUE a
    replica, breach window BURST_UP_FOR_S, shedding counts as pressure)
    grows the pool to 2, the new replica warmed on the card before it
    serves while the first one serves; every admitted row is answered, a
    finite row of the model's width; then, idle, the pool drains back
    to 1."""
    from veles_tpu_torch.serving.engine import EngineOverloaded
    from veles_tpu_torch.telemetry import profiler
    from veles_tpu_torch.telemetry.registry import get_registry
    scaler, engine = entry.autoscaler, entry.engine
    warm0 = profiler.phase_report().get("replica_warmup", 0.0)
    scaler.up_queue_per_replica = BURST_UP_QUEUE
    scaler.up_for_s = BURST_UP_FOR_S
    scaler.down_idle_for_s = 1e9
    capacity = entry.admission.capacity
    entry.admission.capacity = BURST_CAPACITY
    base = numpy.random.RandomState(5).uniform(
        -1, 1, (BURST_THREADS,) + tuple(entry.model.sample_shape)).astype(
        numpy.float32)
    futures, shed, errors = [], [0] * BURST_THREADS, []
    stop = time.time() + BURST_S

    def feeder(i):
        row, k = base[i].copy(), 0
        while time.time() < stop:
            # a first pixel unique to the row: never a cache hit
            row[0, 0, 0] = -1.0 + 2e-7 * (i * 10000000 + k)
            k += 1
            try:
                futures.append(engine.submit(row.copy()))
            except EngineOverloaded:
                shed[i] += 1
                time.sleep(0.001)
            except Exception as e:  # re-raised below
                errors.append(e)
                return

    t0 = time.time()
    threads = [threading.Thread(target=feeder, args=(i,))
               for i in range(BURST_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    entry.admission.capacity = capacity
    rows = [f.result(timeout=300) for f in futures]
    burst_s = time.time() - t0
    width = rows[0].shape if rows else None
    if errors or not rows or any(r.shape != width or
                                 not numpy.isfinite(r).all() for r in rows):
        raise AssertionError("burst: errors %s, %d rows" % (errors[:3],
                                                            len(rows)))
    ups = [t for t in scaler.transitions if t[1] == "up"]
    if entry.pool.size() != 2 or not ups:
        raise AssertionError("burst: the pool has %d replicas, transitions "
                             "%s (%d rows answered, %d shed)" % (
                                 entry.pool.size(), scaler.transitions,
                                 len(rows), sum(shed)))
    warmed = profiler.phase_report().get("replica_warmup", 0.0) - warm0
    new = entry.pool.replicas[-1]
    if warmed <= 0 or len(new.warmed_buckets) != len(BUCKETS) or \
            not new.batches_done:
        raise AssertionError("the new replica: warm-up %.1f ms, buckets %s,"
                             " batches %d" % (warmed, new.warmed_buckets,
                                              new.batches_done))
    scaler.down_idle_for_s = DRAIN_IDLE_S
    scaler.down_cooldown_s = DRAIN_IDLE_S
    t1 = time.time()
    while (entry.pool.size() > 1 or scaler.transitions[-1][1] != "down") \
            and time.time() - t1 < DRAIN_TIMEOUT_S:
        time.sleep(0.1)
    if entry.pool.size() != 1 or scaler.transitions[-1][1] != "down":
        raise AssertionError("the pool did not drain back to 1 in %.0f s"
                             % DRAIN_TIMEOUT_S)
    reaction = get_registry().get("veles_autoscale_reaction_s").labels(
        model="alexnet")
    out = {"rows_answered": len(rows), "shed": sum(shed),
           "rows_per_s": len(rows) / burst_s,
           "transitions": [(d, n) for _, d, n in scaler.transitions],
           "reaction_s": reaction.percentile(50),
           "new_replica_batches": new.batches_done,
           "replica_warmup_ms": warmed, "drained_in_s": time.time() - t1}
    print("observability autoscale: %d threads for %.0f s at an admission "
          "bound of %d: %d rows answered (%.0f rows/s), %d shed; up to 2 "
          "replicas (reaction %.3f s, the new replica warmed %.1f ms over "
          "buckets %s, then served %d batches), drained back to 1 in %.2f "
          "s; transitions %s" % (
              BURST_THREADS, BURST_S, BURST_CAPACITY, len(rows),
              out["rows_per_s"], sum(shed), out["reaction_s"], warmed,
              new.warmed_buckets, new.batches_done, out["drained_in_s"],
              out["transitions"]))
    return out


def endpoints_check(numpy, frontend, stub, re):
    """/metrics (Prometheus text with the serving, op and HBM families),
    /profile.json (serve_forward:b64: FLOPs, bytes, p50, bound and
    utilization <= UTILIZATION_LIMIT), /alerts.json, /history.json, and
    a status POST with the JAX package's payload keys."""
    # /profile.json first: it samples the card's memory into the gauges
    profile = json.loads(get_url(frontend.port, "/profile.json"))
    prom = get_url(frontend.port, "/metrics").decode()
    pattern = re.compile(PROM_LINE)
    bad = [line for line in prom.strip().splitlines()
           if not pattern.match(line)]
    families = {line.split()[2] for line in prom.splitlines()
                if line.startswith("# TYPE ")}
    needed = ("veles_serving_requests_total", "veles_serving_latency_ms",
              "veles_serving_cache_hits_total", "veles_op_ms",
              "veles_hbm_live_bytes", "veles_hbm_peak_bytes",
              "veles_hbm_limit_bytes", "veles_step_mfu",
              "veles_autoscale_replicas", "veles_alerts_active")
    if bad or [f for f in needed if f not in families]:
        raise AssertionError("/metrics: %d bad lines (%s), missing %s" % (
            len(bad), bad[:3], [f for f in needed if f not in families]))
    if 'veles_hbm_live_bytes{device="cuda:0"}' not in prom:
        raise AssertionError("/metrics has no card memory series")
    rows = {r["op"]: r for r in profile["ops"]}
    row = rows.get("serve_forward:b64")
    if row is None or not row.get("flops") or not row.get("bytes") or \
            row.get("p50_ms") is None or row.get("bound") is None or \
            not 0.0 < row.get("utilization", 0.0) <= UTILIZATION_LIMIT:
        raise AssertionError("/profile.json serve_forward:b64 row %s" % row)
    alerts = json.loads(get_url(frontend.port, "/alerts.json"))
    history = json.loads(get_url(frontend.port,
                                 "/history.json?series=veles_serving"))
    if not alerts["rules"] or "series" not in history:
        raise AssertionError("/alerts.json %s, /history.json %s" % (
            sorted(alerts), sorted(history)))
    deadline = time.time() + 10
    while not stub.posts and time.time() < deadline:
        time.sleep(0.1)
    if not stub.posts or stub.posts[-1][0] != "/update" or \
            set(stub.posts[-1][1]) != STATUS_KEYS:
        raise AssertionError("status posts: %s" % (
            [(p, sorted(b)) for p, b in stub.posts[-1:]]))
    out = {"families": len(families), "serve_forward_b64": row,
           "device": profile["device"], "memory": profile["memory"],
           "alerts_firing": [r["name"] for r in alerts["rules"]
                             if r["firing"]],
           "history_series": len(history["series"])}
    print("observability endpoints: /metrics %d families, all lines "
          "Prometheus; /profile.json serve_forward:b64 %.4g FLOP, %.4g B, "
          "p50 %.3f ms, %s-bound, utilization %.4f; alerts firing %s; "
          "history %d series; %d status POSTs" % (
              len(families), row["flops"], row["bytes"], row["p50_ms"],
              row["bound"], row["utilization"], out["alerts_firing"],
              out["history_series"], len(stub.posts)))
    return out


def attribution(trace):
    """The serving trace: it loads, its ``http:*`` spans carry the
    clients' ``X-Request-Id``s; the p50 of ``http:/api`` (the AlexNet
    route's single requests of the routing round) against the p50 of
    the forwards that ran in that round (``op:serve_forward:b<n>``, n <
    64), and ``http:/api/batch`` against ``op:serve_forward:b64``."""
    spans = span_table(trace)
    ids = {"alexnet-%d" % i for i in range(16)} | \
        {"mnist-%d" % i for i in range(16)}
    carried = {e["args"].get("trace_id") for name, events in spans.items()
               if name.startswith("http:") for e in events}
    if not ids <= carried:
        raise AssertionError("http spans lack request ids %s" % sorted(
            ids - carried)[:5])
    singles = [e for e in spans["http:/api"]
               if str(e["args"].get("trace_id", "")).startswith("alexnet-")]
    start = min(e["ts"] for e in singles)
    end = max(e["ts"] + e["dur"] for e in singles)
    forwards = [e for name, events in spans.items()
                if re_bucket(name) is not None and re_bucket(name) < 64
                for e in events if start <= e["ts"] <= end]
    batch = spans["http:/api/batch"]
    b64 = [e for e in spans["op:serve_forward:b64"]
           if batch[0]["ts"] <= e["ts"] <= batch[0]["ts"] + batch[0]["dur"]]
    out = {}
    for key, reqs, fwds in (("single", singles, forwards),
                            ("batch64", batch[:1], b64)):
        req = statistics.median(e["dur"] for e in reqs) / 1e3
        fwd = statistics.median(e["dur"] for e in fwds) / 1e3
        out[key] = {"http_p50_ms": req, "forward_p50_ms": fwd,
                    "outside_forward": 1.0 - fwd / req,
                    "requests": len(reqs), "forwards": len(fwds)}
    print("observability attribution: single requests http:/api p50 %.3f "
          "ms against serve_forward p50 %.3f ms (%d forwards): %.1f%% of a "
          "request outside the forward; the 64-row batch %.3f ms against "
          "%.3f ms: %.1f%%" % (
              out["single"]["http_p50_ms"], out["single"]["forward_p50_ms"],
              out["single"]["forwards"],
              100 * out["single"]["outside_forward"],
              out["batch64"]["http_p50_ms"],
              out["batch64"]["forward_p50_ms"],
              100 * out["batch64"]["outside_forward"]))
    return out


def re_bucket(name):
    """n of the first route's ``op:serve_forward:b<n>``, else None."""
    prefix = "op:serve_forward:b"
    if name.startswith(prefix) and name[len(prefix):].isdigit():
        return int(name[len(prefix):])
    return None


def observe_import_check(tmp):
    """``serve`` with every flag and a traced CLI epoch of the small
    AlexNet in a process of their own load no JAX."""
    import subprocess
    small = os.path.join(tmp, "small_workflow.py")
    with open(small, "w") as f:
        f.write(SMALL_WORKFLOW_FILE)
    check = os.path.join(tmp, "observe_import_check.py")
    with open(check, "w") as f:
        f.write(OBSERVE_IMPORT_CHECK)
    proc = subprocess.run(
        [sys.executable, check, tmp, os.path.join(tmp, "mnist_fc.tar"),
         small], cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    if proc.returncode != 0 or "LOADED []" not in proc.stdout:
        raise AssertionError("observability import check: exit %d\n%s\n%s"
                             % (proc.returncode, proc.stdout[-2000:],
                                proc.stderr[-4000:]))
    for name in ("serve.json", "train.json"):
        span_table(os.path.join(tmp, name))
    print("observability import check: serve with every flag and a traced"
          " epoch loaded no JAX")


def observability_phase(torch, numpy, kernels):
    """Phase 13 (see the module docstring). Returns (result,
    [launches_by_form])."""
    import shutil
    import tempfile
    from veles_tpu_torch.ops.gemm_bench import card_line
    card = card_line()
    tmp = tempfile.mkdtemp(prefix="veles-observe-")
    result, forms = {}, []
    try:
        cell, more = traced_training(torch, numpy, tmp, card)
        result["alexnet_train_traced_f32"] = cell
        forms.extend(more)
        cell, more = residency_traced(torch, tmp)
        result["alexnet_stream_traced"] = cell
        forms.extend(more)
        cell, more = flight_cell(torch, tmp)
        result["flight"] = cell
        forms.append(more)
        result["overhead"] = overhead_cell(torch, tmp, card)
        cell, more = serving_cell(torch, numpy, kernels, tmp, card)
        result["alexnet_serve_full_f32"] = cell
        forms.extend(more)
        observe_import_check(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check_forms("observability", kernels, merge_forms(*forms))
    return result, forms


def stack_watch(period_s):
    """The source a driver run in a process of its own starts with, so
    that a process which stalls or crashes shows where: every thread's
    stack each ``period_s`` seconds, and every thread's stack on a fatal
    signal. A Python thread takes the periodic dumps, under the
    interpreter lock: ``faulthandler.dump_traceback_later`` walks the
    other threads' frames from a C thread that holds no lock, and a
    frame chunk that the running thread frees meanwhile ends the process
    with SIGSEGV (a slave of phase 14 died so, its main thread's stack
    cut after two frames)."""
    return (
        "import faulthandler as _fh, sys as _sys, threading as _th, "
        "time as _t\n"
        "_fh.enable(all_threads=True)\n"
        "def _stack_watch():\n"
        "    while True:\n"
        "        _t.sleep(%r)\n"
        "        _sys.stderr.write('every thread\\'s stack:\\n')\n"
        "        _sys.stderr.flush()\n"
        "        _fh.dump_traceback(all_threads=True)\n"
        "_th.Thread(target=_stack_watch, daemon=True, "
        "name='stack-watch').start()\n" % (period_s,))


#: phase 14: master/slave training on the workflow phase's file. Epochs
#: of the one-slave run (1) and the two-slave run (2); of the kill leg
#: (3) and the bf16 leg (4)
DIST_EPOCHS = 4
DIST_SHORT_EPOCHS = 2
#: (1) against the standalone run in deterministic mode: each epoch's
#: loss within this relative distance, fc7's final weights within this
#: share of their change. The run is not bitwise: a weight that shrinks
#: toward zero within a job comes back as ``base + (new - base)``,
#: rounded (no float32 delta lands on it), and AlexNet's max-pool
#: selections carry such ulps into every weight over later epochs (the
#: first epoch is bitwise; after 4, fc7 read 3.07e-3 of its change on
#: the H100). So the bound is the workflow phase's for runs that are
#: not bitwise; the control reads 1.
DIST_LOSS_REL_TOL = 1e-6
DIST_UPDATE_SHARE_TOL = WORKFLOW_UPDATE_SHARE_TOL
#: (3): the chaos stream seeded 7 kills a slave on its 8th job at this
#: probability (epoch 1's third one-minibatch job of 5)
DIST_DEATH_PROBABILITY = "0.073"
DIST_DEATH_JOB = 8
#: seconds a leg's processes may take (start-up included)
DIST_LEG_S = 420
#: the master's floor on a job's overrun before it drops a slave
DIST_JOB_TIMEOUT = "900"

#: one process of a leg: ``python -c DIST_DRIVER role out <CLI args>``
#: (role ``master``, ``slave`` or ``standalone``) runs
#: ``veles_tpu_torch.__main__.Main().run(args)`` and pickles a report to
#: ``out``: the modules it loaded of jax, ml_dtypes and veles_tpu; a
#: master or a standalone run its parameters (``out.params.npz``) and
#: fc7 before training (``out.fc7_init.npy``), a master its history,
#: epoch close times, minibatches served and exchange series, a
#: standalone run its epoch losses and times; a slave its launch
#: counters (read at exit: the process started with them at 0), job log
#: and per-minibatch launches. SMOKE_DETERMINISTIC=1 sets the
#: deterministic mode, SMOKE_DROP_DELTA=1 makes a master drop fc7's
#: deltas (the control), SMOKE_GATE=<file> holds a slave before it dials
#: until the file exists.
DIST_DRIVER = stack_watch(60) + r"""
import os, pickle, sys, time
role, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
import numpy
import torch
if os.environ.get("SMOKE_DETERMINISTIC") == "1":
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
from veles_tpu_torch.__main__ import Main
from veles_tpu_torch.convert import layer_params
from veles_tpu_torch.launcher import Launcher
report = {"role": role, "closed": [], "first_job": None}


def fc7_index(wf):
    return [i for i, f in enumerate(wf.forwards)
            if type(f).__name__ == "All2AllStrictRELU"][-1]


if role in ("master", "standalone"):
    initialize = Launcher.initialize

    def initialized(self, **kwargs):
        initialize(self, **kwargs)
        wf = self.workflow
        numpy.save(out + ".fc7_init.npy", wf.forwards[
            fc7_index(wf)].module.weights.detach().cpu().numpy())
        return self

    Launcher.initialize = initialized
if role == "master":
    start_master = Launcher._start_master

    def hooked(self):
        wf = self.workflow
        fc7 = fc7_index(wf)
        if os.environ.get("SMOKE_DROP_DELTA") == "1":
            gd = next(g for g in wf.gds if g.forward is wf.forwards[fc7])
            gd.apply_data_from_slave = lambda data, slave=None: None
        finished = wf.decision._on_epoch_finished

        def closing(epoch=None, stats_set=None):
            finished(epoch=epoch, stats_set=stats_set)
            report["closed"].append(time.perf_counter())

        wf.decision._on_epoch_finished = closing
        served = report["served"] = {"batches": 0, "train": 0}
        for name in ("generate_segment_for_slave",
                     "generate_data_for_slave"):
            def counted(*args, _fn=getattr(wf, name), **kwargs):
                if report["first_job"] is None:
                    report["first_job"] = time.perf_counter()
                job = _fn(*args, **kwargs)
                batches = [] if job is None else job["batches"] \
                    if isinstance(job, dict) else \
                    [p for n, p in job if n == wf.loader.name]
                served["batches"] += len(batches)
                served["train"] += sum(b["class"] == 2 for b in batches)
                return job
            setattr(wf, name, counted)
        start_master(self)

    Launcher._start_master = hooked
elif role == "slave" and os.environ.get("SMOKE_GATE"):
    connect = Launcher._connect_slave

    def gated(self):
        while not os.path.exists(os.environ["SMOKE_GATE"]):
            time.sleep(0.05)
        connect(self)

    Launcher._connect_slave = gated
cli = Main()
try:
    report["rc"] = cli.run(argv)
    report["error"] = None
except RuntimeError as e:
    report["rc"], report["error"] = 1, str(e)
report["bad_modules"] = sorted(
    m for m in sys.modules if m in ("jax", "ml_dtypes", "veles_tpu") or
    m.startswith(("jax.", "ml_dtypes.", "veles_tpu.")))
launcher = cli.launcher
wf = cli.workflow
if role == "standalone":
    report["losses"] = [t["loss"] for t in launcher.runner.epoch_times]
    report["times"] = launcher.runner.epoch_times
if role != "slave":
    numpy.savez(out + ".params.npz", **{
        "%d.%s" % (i, k): p.detach().cpu().numpy()
        for i, f in enumerate(wf.forwards)
        for k, p in layer_params(f.module).items()})
if role != "slave":
    report["fc7"] = fc7_index(wf)
if role == "master":
    from veles_tpu_torch.telemetry.registry import get_registry
    report["history"] = wf.decision.epoch_history
    registry = get_registry()
    report["series"] = {}
    for name in ("veles_exchange_bytes_total", "veles_jobs_total",
                 "veles_jobs_requeued_total", "veles_exchange_encode_ms",
                 "veles_exchange_decode_ms", "veles_slave_job_ms"):
        family = registry.get(name)
        report["series"][name] = [] if family is None else [
            (labels, child.summary() if hasattr(child, "summary")
             else child.value) for labels, child in family.series()]
    report["cuda"] = (torch.cuda.device_count(),
                      torch.cuda.is_initialized())
    report["staged"] = getattr(wf.loader, "_staged_", None) is not None
elif role == "slave":
    import chip_smoke
    report["counts"], report["forms"] = chip_smoke.read_counts()
    report["variants"] = {
        name: dict(fn.launches_by_variant)
        for name, fn in chip_smoke.variant_counters().items()}
    report["job_log"] = launcher.job_log
    report["jobs_done"] = launcher._client.jobs_done
    executor = launcher._executor
    trainer = executor._trainer if executor is not None else None
    if trainer is None and executor is not None and launcher.job_log:
        trainer = executor.trainer
    report["per_batch"] = None if trainer is None else (
        chip_smoke.launch_counts(trainer, 1, 0),
        chip_smoke.launch_counts(trainer, 1, 1))
with open(out, "wb") as f:
    pickle.dump(report, f)
sys.exit(report["rc"] if report["error"] is None else 0)
"""


class DistLeg(object):
    """The processes of one leg on the card, started together: a master
    (``CUDA_VISIBLE_DEVICES`` empty: it sees no card) and its slaves, or
    a standalone run. ``processes`` holds (role, CLI args, extra
    environment) triples; a master's and a slave's get ``-l`` / ``-m``
    and the leg's address."""

    def __init__(self, name, tmp, path, processes):
        import socket
        import subprocess
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            self.address = "127.0.0.1:%d" % probe.getsockname()[1]
        self.name, self.tmp = name, tmp
        self.procs, self.outs = [], []
        env = dict(os.environ, PYTHONPATH=REPO,
                   VELES_CONNECT_RETRY_S=str(DIST_LEG_S))
        flag = {"master": ["-l", self.address],
                "slave": ["-m", self.address], "standalone": []}
        for i, (role, args, extra) in enumerate(processes):
            if role == "master":
                extra = dict(extra, CUDA_VISIBLE_DEVICES="")
            out = os.path.join(tmp, "%s_%s%d.pickle" % (name, role, i))
            log = open(out + ".log", "w")
            self.outs.append(out)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", DIST_DRIVER, role, out, path] +
                list(args) + flag[role], env=dict(env, **extra), cwd=tmp,
                stdout=log, stderr=subprocess.STDOUT))
            log.close()

    def wait(self, deadline):
        """Each process's report: (master, [slaves]); any non-zero exit,
        missing report or overrun raises (after killing them all)."""
        import pickle
        import subprocess
        for proc, out in zip(self.procs, self.outs):
            try:
                proc.wait(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                raise AssertionError("%s: %s overran its time:\n%s" % (
                    self.name, out, self.logs()))
            if proc.returncode != 0 or not os.path.exists(out):
                raise AssertionError("%s: %s exited %s:\n%s" % (
                    self.name, out, proc.returncode, self.logs()))
        reports = []
        for out in self.outs:
            with open(out, "rb") as f:
                reports.append(pickle.load(f))
        for report in reports:
            if report["bad_modules"]:
                raise AssertionError("%s: a %s loaded %s" % (
                    self.name, report["role"], report["bad_modules"]))
        return reports[0], reports[1:]

    def fc7_init(self):
        import numpy
        return numpy.load(self.outs[0] + ".fc7_init.npy")

    def logs(self, tail=3000):
        """The end of every process's output, each under its name."""
        parts = []
        for proc, out in zip(self.procs, self.outs):
            with open(out + ".log", errors="replace") as f:
                parts.append("-- %s (exit %s):\n%s" % (
                    os.path.basename(out), proc.poll(), f.read()[-tail:]))
        return "\n".join(parts)

    def kill(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    def params(self):
        """The parameters the master (or the standalone run) saved."""
        import numpy
        with numpy.load(self.outs[0] + ".params.npz") as data:
            return {k: data[k] for k in data.files}


@contextlib.contextmanager
def dist_legs(*legs):
    """The legs, their processes killed on the way out (a leg that
    failed, or one left running by another's failure)."""
    try:
        yield legs
    finally:
        for leg in legs:
            leg.kill()


def dist_epoch_losses(history):
    return [{k: h[k]["loss"] for k in ("validation", "train")}
            for h in history]


def dist_slave_counts(phase, kernels, slaves):
    """The slaves' launches summed, each slave's held to the counts its
    own jobs' minibatches give (K1 and K3 a forward, K4 and K7 a step,
    K6 a bias a step), every launch at a checked form and K1/K3/K4/K6 on
    designed forms; returns (summed counts, forwards, steps, forms)."""
    total, forms = {}, []
    forwards = steps = 0
    variants = {}
    for i, slave in enumerate(slaves):
        f = sum(e["batches"] for e in slave["job_log"])
        s = sum(e["train_batches"] for e in slave["job_log"])
        forwards, steps = forwards + f, steps + s
        if slave["per_batch"] is not None:
            per_forward, per_step = slave["per_batch"]
            want = {k: per_forward[k] * f + (per_step[k] - per_forward[k])
                    * s for k in per_forward}
            if slave["counts"] != want:
                raise AssertionError(
                    "%s slave %d: launches %s, its %d forwards and %d steps "
                    "give %s" % (phase, i, slave["counts"], f, s, want))
        for k, v in slave["counts"].items():
            total[k] = total.get(k, 0) + v
        forms.append(slave["forms"])
        for name, by in slave["variants"].items():
            mine = variants.setdefault(name, {})
            for form, n in by.items():
                mine[form] = mine.get(form, 0) + n
    merged = merge_forms(*forms)
    check_forms(phase, kernels, merged)
    check_designed(phase, variants["gemm_bias_act"])
    for name, designed in DESIGNED_FORMS.items():
        off = {v: n for v, n in variants[name].items()
               if n and v not in designed}
        if off:
            raise AssertionError("%s: %s launches by form %s" % (
                phase, name, variants[name]))
    return total, forwards, steps, merged


def dist_exchange(master, slaves, card):
    """Per job: the slaves' decode, compute, encode and shared-memory ms
    and their waits, the master's encode and decode ms (medians after
    each slave's first job), and the bytes each way."""
    log = [e for s in slaves for e in s["job_log"][1:]] or \
        [e for s in slaves for e in s["job_log"]]

    def med(key):
        values = [e[key] for e in log if key in e]
        return statistics.median(values) if values else None

    series = master["series"]

    def p50(name):
        rows = [v["p50"] for _, v in series[name]]
        return statistics.median(rows) if rows else None

    sent = {d: sum(v for labels, v in series["veles_exchange_bytes_total"]
                   if labels["direction"] == d)
            for d in ("to_slave", "from_slave")}
    jobs = sum(v for _, v in series["veles_jobs_total"])
    out = {"card": card, "jobs": jobs,
           "slave_ms": {k: med(k) for k in (
               "decode_ms", "compute_ms", "encode_ms", "shm_ms",
               "wait_ms", "result_ms")},
           "master_encode_ms_p50": p50("veles_exchange_encode_ms"),
           "master_decode_ms_p50": p50("veles_exchange_decode_ms"),
           "bytes_to_slave_per_job": sent["to_slave"] / max(jobs, 1),
           "bytes_from_slave_per_job": sent["from_slave"] / max(jobs, 1),
           "minibatches_per_job": statistics.mean(
               e["batches"] for s in slaves for e in s["job_log"])}
    exchange = sum(out["slave_ms"][k] or 0.0 for k in (
        "decode_ms", "encode_ms", "wait_ms", "result_ms"))
    out["exchange_over_compute"] = exchange / out["slave_ms"]["compute_ms"]
    return out


def dist_rate(master, epochs, per_epoch):
    """Samples/s of a fleet: the whole run from the first job handed out,
    and the epochs after the first (between epoch closes)."""
    closed = master["closed"]
    return {"samples_per_s": epochs * per_epoch /
            (closed[-1] - master["first_job"]),
            "samples_per_s_after_first_epoch":
            (epochs - 1) * per_epoch / (closed[-1] - closed[0])}


def distributed_phase(torch, numpy, kernels):
    """Master/slave training on phase 9's AlexNet-227 file, the master a
    process with no visible card, each slave a process on the card:
    (1) one slave, ``--segment-size 8 --no-pipeline``, deterministic, 4
    epochs, held to the deterministic standalone run; the master dropping
    fc7's deltas must fail that; (2) two pipelined slaves, ``--segment-size
    2``, float32 delta exchange, 4 epochs; (3) a slave killed mid-epoch
    (``--segment-size 1 --no-pipeline``, deterministic, momentum 0) and
    the unfaulted run: the same curve and weights bit for bit; (4)
    ``--exchange-dtype bfloat16``; (5) the exchange against the compute.
    Returns (result, [launches_by_form])."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="veles_distributed_")
    try:
        return _distributed_phase(torch, numpy, kernels, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _distributed_phase(torch, numpy, kernels, tmp):
    from veles_tpu_torch.loader.base import TRAIN, VALIDATION
    from veles_tpu_torch.ops.gemm_bench import card_line

    card = card_line()
    path = os.path.join(tmp, "alexnet_workflow.py")
    with open(path, "w") as f:
        f.write(WORKFLOW_FILE)
    snaps = "root.smoke.snapshots=%r" % os.path.join(tmp, "snaps")
    quiet = [snaps, "root.common.disable.snapshotting=True"]
    per_epoch = TRAIN_SAMPLES + TRAIN_BATCH
    deadline = lambda: time.time() + DIST_LEG_S  # noqa: E731
    result, all_forms = {"card": card}, []
    det = dict(SMOKE_DETERMINISTIC="1")

    # the reference: the standalone run of the same file and seed in a
    # process of its own, deterministic, as the slaves run, beside (1)
    # (the phase's time is its processes' start-ups)
    with dist_legs(DistLeg("standalone", tmp, path, [
            ("standalone", quiet + ["-s", "7"], det)]), DistLeg(
                "one_slave", tmp, path, [
                    ("master", quiet + ["-s", "7", "--segment-size", "8",
                                        "--job-timeout", DIST_JOB_TIMEOUT],
                     {}),
                    ("slave", quiet + ["-s", "7", "--no-pipeline"], det)])) \
            as (ref_leg, leg1):
        reference, _ = ref_leg.wait(deadline())
        master, slaves = leg1.wait(deadline())
    ref_losses, ref_times = reference["losses"], reference["times"]
    ref_flat = ref_leg.params()
    ref_fc7_init = ref_leg.fc7_init()

    def held(leg, master):
        """(largest relative loss gap, fc7's share of its change, values
        of the losses and parameters that differ) against the
        reference."""
        losses = dist_epoch_losses(master["history"])
        if len(losses) != len(ref_losses):
            raise AssertionError("%s: %d epochs" % (leg.name, len(losses)))
        loss_rel = max(abs(g[k] - w[k]) / abs(w[k])
                       for g, w in zip(losses, ref_losses) for k in w)
        params = leg.params()
        fc7 = "%d.weights" % master["fc7"]
        if not numpy.array_equal(leg.fc7_init(), ref_fc7_init):
            raise AssertionError("%s: fc7 started elsewhere" % leg.name)
        share = float(numpy.abs(params[fc7] - ref_flat[fc7]).max() /
                      numpy.abs(ref_flat[fc7] - ref_fc7_init).max())
        differing = sum(g[k] != w[k] for g, w in zip(losses, ref_losses)
                        for k in w) + sum(int((params[k] != v).sum())
                                          for k, v in ref_flat.items())
        return loss_rel, share, int(differing)

    def check_epochs(name, master, epochs):
        history = master["history"]
        if [h["epoch"] for h in history] != list(range(epochs)):
            raise AssertionError("%s: epochs %s" % (
                name, [h["epoch"] for h in history]))
        for h in history:
            if h["train"]["samples"] != TRAIN_SAMPLES or \
                    h["validation"]["samples"] != TRAIN_BATCH:
                raise AssertionError("%s: epoch %d served %s" % (
                    name, h["epoch"], {k: h[k]["samples"] for k in (
                        "train", "validation")}))
            if not all(math.isfinite(h[k]["loss"]) for k in (
                    "train", "validation")):
                raise AssertionError("%s: loss %s" % (name, h))
        if master["cuda"] != (0, False) or master["staged"]:
            raise AssertionError("%s: the master saw %d cards, initialized "
                                 "CUDA %s, staged %s" % ((name,) +
                                                         master["cuda"] +
                                                         (master["staged"],)))

    # (1) one slave, deterministic, held to the standalone run
    check_epochs("one slave", master, DIST_EPOCHS)
    loss_rel, share, differing = held(leg1, master)
    print("distributed one slave: losses within %.3g relative (limit %g), "
          "fc7 within %.3g of its change (limit %g), %d values differ "
          "from the standalone run" % (loss_rel, DIST_LOSS_REL_TOL, share,
                                      DIST_UPDATE_SHARE_TOL, differing))
    if loss_rel > DIST_LOSS_REL_TOL or share > DIST_UPDATE_SHARE_TOL:
        raise AssertionError("the one-slave run differs from the "
                             "standalone run")
    counts, forwards, steps, forms = dist_slave_counts(
        "distributed one slave", kernels, slaves)
    all_forms.append(forms)
    result["one_slave"] = {
        "loss_rel": loss_rel, "fc7_share": share,
        "values_differing": differing, "launches": counts,
        "exchange": dist_exchange(master, slaves, card),
        "fleet": dist_rate(master, DIST_EPOCHS, per_epoch),
        "standalone": {
            "samples_per_s_sweeps": DIST_EPOCHS * per_epoch / sum(
                t["eval_s"] + t["train_s"] for t in ref_times),
            "samples_per_s_sweeps_after_first_epoch":
            (DIST_EPOCHS - 1) * per_epoch / sum(
                t["eval_s"] + t["train_s"] for t in ref_times[1:])}}
    print("distributed one slave (%s): exchange %s; fleet %s beside the "
          "standalone sweeps' %s" % (
              card, json.dumps(result["one_slave"]["exchange"]),
              json.dumps(result["one_slave"]["fleet"]),
              json.dumps(result["one_slave"]["standalone"])))

    # (4) bf16 deltas, beside the control (fc7's deltas dropped)
    short = ["root.smoke.epochs=%d" % DIST_SHORT_EPOCHS]
    with dist_legs(
            DistLeg("bf16", tmp, path, [
                ("master", quiet + short + [
                    "-s", "7", "--segment-size", "8", "--exchange-dtype",
                    "bfloat16", "--job-timeout", DIST_JOB_TIMEOUT], {}),
                ("slave", quiet + short + ["-s", "7"], {})]),
            DistLeg("control", tmp, path, [
                ("master", quiet + ["-s", "7", "--segment-size", "8",
                                    "--job-timeout", DIST_JOB_TIMEOUT],
                 dict(SMOKE_DROP_DELTA="1")),
                ("slave", quiet + ["-s", "7", "--no-pipeline"], det)])) \
            as (leg4, control):
        master4, slaves4 = leg4.wait(deadline())
        master_c, slaves_c = control.wait(deadline())
    check_epochs("bf16 exchange", master4, DIST_SHORT_EPOCHS)
    counts4, _, _, forms4 = dist_slave_counts("distributed bf16", kernels,
                                              slaves4)
    all_forms.append(forms4)
    result["bf16"] = {"losses": dist_epoch_losses(master4["history"]),
                      "launches": counts4,
                      "exchange": dist_exchange(master4, slaves4, card)}
    print("distributed bf16 deltas (%s): %s" % (card,
                                               json.dumps(result["bf16"])))
    _, control_share, _ = held(control, master_c)
    print("distributed control (the master drops fc7's deltas): fc7 %.3g "
          "of its change (limit %g)" % (control_share,
                                        DIST_UPDATE_SHARE_TOL))
    if control_share <= DIST_UPDATE_SHARE_TOL:
        raise AssertionError("the control passes the one-slave check")
    result["control_fc7_share"] = control_share
    all_forms.append(dist_slave_counts("distributed control", kernels,
                                       slaves_c)[3])

    # (3) a slave killed mid-epoch against the unfaulted run, both
    # deterministic; momentum 0: a slave's SGD velocity is its own, so a
    # replacement would start from none
    kill = quiet + short + ["-s", "7,7,7", "root.smoke.momentum=0.0"]
    masters = kill + ["--segment-size", "1", "--job-timeout",
                      DIST_JOB_TIMEOUT]
    gate = os.path.join(tmp, "gate")
    with dist_legs(
            DistLeg("unfaulted", tmp, path, [
                ("master", masters, {}),
                ("slave", kill + ["--no-pipeline"], det)]),
            DistLeg("faulted", tmp, path, [
                ("master", masters, {}),
                ("slave", kill + ["--no-pipeline",
                                  "--slave-death-probability",
                                  DIST_DEATH_PROBABILITY], det),
                ("slave", kill + ["--no-pipeline"],
                 dict(det, SMOKE_GATE=gate))])) as (unfaulted, faulted):
        # the replacement dials once the chaos death has happened
        faulted.procs[1].wait(timeout=DIST_LEG_S)
        open(gate, "w").close()
        master_u, _ = unfaulted.wait(deadline())
        master_f, slaves_f = faulted.wait(deadline())
    check_epochs("unfaulted", master_u, DIST_SHORT_EPOCHS)
    check_epochs("faulted", master_f, DIST_SHORT_EPOCHS)
    died = slaves_f[0]
    if "chaos death" not in str(died["error"]) or \
            died["jobs_done"] != DIST_DEATH_JOB - 1:
        raise AssertionError("the chaotic slave: %s after %d jobs" % (
            died["error"], died["jobs_done"]))
    requeued = sum(v for labels, v in master_f["series"][
        "veles_jobs_requeued_total"] if labels["reason"] == "dead")
    curve = [[h[k][m] for k in ("validation", "train")
              for m in ("samples", "metric", "normalized", "loss")]
             for h in master_f["history"]]
    want = [[h[k][m] for k in ("validation", "train")
             for m in ("samples", "metric", "normalized", "loss")]
            for h in master_u["history"]]
    params_f, params_u = faulted.params(), unfaulted.params()
    differing = sum(int((params_f[k] != v).sum())
                    for k, v in params_u.items())
    print("distributed kill: the slave died on job %d holding epoch 1's "
          "minibatch; requeued (dead) %d; the curve %s the unfaulted run's, "
          "%d parameter values differ" % (
              died["jobs_done"] + 1, requeued,
              "equals" if curve == want else "DIFFERS FROM", differing))
    if curve != want or differing or requeued < 1:
        raise AssertionError("the faulted run differs: %s against %s"
                             % (curve, want))
    result["kill"] = {"curve": curve, "requeued_dead": requeued,
                      "replacement_jobs": slaves_f[1]["jobs_done"]}

    # (2) two pipelined slaves, float32 deltas
    with dist_legs(DistLeg("two_slaves", tmp, path, [
            ("master", quiet + ["-s", "7", "--segment-size", "2",
                                "--exchange-dtype", "float32",
                                "--job-timeout", DIST_JOB_TIMEOUT], {})] +
            [("slave", quiet + ["-s", "7"], {})] * 2)) as (leg2,):
        master2, slaves2 = leg2.wait(deadline())
    check_epochs("two slaves", master2, DIST_EPOCHS)
    losses = dist_epoch_losses(master2["history"])
    if not losses[-1]["train"] < losses[0]["train"]:
        raise AssertionError("two slaves: the loss did not fall: %s"
                             % losses)
    if not all(s["jobs_done"] > 0 for s in slaves2):
        raise AssertionError("two slaves: jobs %s" % [
            s["jobs_done"] for s in slaves2])
    counts2, forwards, steps, forms2 = dist_slave_counts(
        "distributed two slaves", kernels, slaves2)
    # every minibatch the master served ran once on one slave; those past
    # the last epoch are the pipelines' run-ahead, cancelled on the master
    served = master2["served"]
    per_forward, per_step = slaves2[0]["per_batch"]
    derived = {k: per_forward[k] * served["batches"] +
               (per_step[k] - per_forward[k]) * served["train"]
               for k in per_forward}
    epoch_batches = DIST_EPOCHS * (-(-TRAIN_SAMPLES // TRAIN_BATCH) + 1)
    if (forwards, steps) != (served["batches"], served["train"]) or \
            counts2 != derived or forwards < epoch_batches:
        raise AssertionError(
            "two slaves: %d forwards, %d steps, launches %s; the master "
            "served %s minibatches, which give %s" % (
                forwards, steps, counts2, served, derived))
    all_forms.append(forms2)
    result["two_slaves"] = {
        "losses": losses, "jobs": [s["jobs_done"] for s in slaves2],
        "served": served, "run_ahead_minibatches": forwards - epoch_batches,
        "launches": counts2, "exchange": dist_exchange(master2, slaves2,
                                                       card),
        "fleet": dist_rate(master2, DIST_EPOCHS, per_epoch)}
    print("distributed two slaves (%s): jobs %s, launches %s (derived "
          "from the %d minibatches served, %d of them trained; %d past "
          "the last epoch), exchange %s, fleet %s" % (
              card, result["two_slaves"]["jobs"], counts2, forwards, steps,
              forwards - epoch_batches,
              json.dumps(result["two_slaves"]["exchange"]),
              json.dumps(result["two_slaves"]["fleet"])))
    return result, all_forms


#: phase 15: AlexNet-227 on phase 9's file through ``--gspmd``, 2 epochs
SPMD_EPOCHS = 2
#: the sharded runs against the deterministic standalone one: each
#: epoch's loss within this relative distance, every parameter tensor
#: within this share of its largest change over the run (the workflow
#: phase's bound for runs that are not bitwise)
SPMD_LOSS_REL_TOL = 1e-5
SPMD_UPDATE_SHARE_TOL = WORKFLOW_UPDATE_SHARE_TOL
#: seconds a world of ranks may take (start-up included)
SPMD_WORLD_S = 420
#: the sequence legs: ``scripts/bench_all.py``'s attention and moe
#: configurations at their widths, the data cut to 640 + 128 samples
#: (10 training batches of 64); the ring's and Ulysses's forward within
#: this share of the unsharded forward's largest value, their epoch's
#: losses within this relative distance of the unsharded epoch's (read:
#: 0.0, F15z), every parameter within SPMD_UPDATE_SHARE_TOL of its
#: tensor's largest change over the epoch; the control (a sharded
#: backward that drops a term, ``tests/torch_seq_ranks.py``
#: ``dropped_term``) must break one of the bounds
SPMD_SEQUENCE_SAMPLES = (640, 128)
SPMD_FORWARD_TOL = 1e-5
SPMD_SEQUENCE_LOSS_REL_TOL = 1e-6
#: the expert-parallel leg: ranks (one expert each), training steps, and
#: its layer's forward against ``moe_ffn_reference(n_shards=8)`` within
#: this share of the reference's largest value; the steps' losses within
#: SPMD_LOSS_REL_TOL and the parameters within SPMD_UPDATE_SHARE_TOL of
#: the same steps with that per-shard routing on one process; the
#: control (the router's gradient not summed over the ranks) must break
#: one of the bounds
SPMD_EXPERTS = 8
SPMD_MOE_STEPS = 4
SPMD_MOE_TOL = 1e-5
#: the pipeline leg: 2 stages of tanh(x @ W), microbatches, rows, width;
#: outputs, loss and parameters within this absolute distance of the
#: sequential run on the card
SPMD_PIPELINE = (2, 4, 64, 1024)
SPMD_PIPELINE_ATOL = 1e-5

#: one rank of a ``--gspmd`` leg: ``python -c SPMD_DRIVER out <CLI
#: args>`` runs ``veles_tpu_torch.__main__.Main().run(args)`` and pickles
#: its report to ``out.rank<k>`` (k its process id, 0 without
#: ``--jax-process-id``): the world's size, backend and start-up time,
#: its collectives staged through the host, calls and bytes, each epoch's
#: losses and sweep seconds, each training step's ms by CUDA events, its
#: launch counters (read at exit: the process started with them at 0),
#: the ``veles_gspmd_step_ms`` and ``veles_reshard_ms`` series, the
#: modules it loaded of jax, ml_dtypes and veles_tpu; rank 0 also its
#: parameters (``out.params.npz``), and with SMOKE_SAVE_INIT=1 the
#: initial ones (``out.init.npz``). The ranks a rank 0 starts run this
#: driver too (its source in SMOKE_SPMD_DRIVER). SMOKE_DETERMINISTIC=1
#: sets the deterministic mode; SMOKE_NO_REDUCE=1 skips the gradient
#: collectives (the control).
SPMD_DRIVER = stack_watch(120) + r"""
import os, pickle, sys, time
prefix, argv = sys.argv[1], sys.argv[2:]
import numpy
import torch
if os.environ.get("SMOKE_DETERMINISTIC") == "1":
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
import chip_smoke
from veles_tpu_torch import launcher
from veles_tpu_torch.__main__ import Main
from veles_tpu_torch.convert import layer_params
from veles_tpu_torch.parallel import collectives, mesh
from veles_tpu_torch.parallel.dp import DataParallelTrainer
from veles_tpu_torch.telemetry.registry import get_registry
from veles_tpu_torch.train.step import FusedTrainer
rank = int(argv[argv.index("--jax-process-id") + 1]) \
    if "--jax-process-id" in argv else 0
out = "%s.rank%d" % (prefix, rank)
launcher.rank_command = lambda args: [
    sys.executable, "-c", os.environ["SMOKE_SPMD_DRIVER"], prefix] + list(
    args)
if os.environ.get("SMOKE_NO_REDUCE") == "1":
    init = DataParallelTrainer.__init__

    def no_reduce(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.reduce_gradients = False

    DataParallelTrainer.__init__ = no_reduce


def params_of(wf):
    return {"%d.%s" % (i, k): p.detach().cpu().numpy()
            for i, f in enumerate(wf.forwards)
            for k, p in layer_params(f.module).items()}


if os.environ.get("SMOKE_SAVE_INIT") == "1":
    initialize = launcher.Launcher.initialize

    def initialized(self, **kwargs):
        initialize(self, **kwargs)
        numpy.savez(prefix + ".init.npz", **params_of(self.workflow))
        return self

    launcher.Launcher.initialize = initialized
steps = []
train_batch = FusedTrainer.train_batch


def timed_batch(self, *args, **kwargs):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = train_batch(self, *args, **kwargs)
    end.record()
    steps.append((start, end))
    return result


FusedTrainer.train_batch = timed_batch
cli = Main()
report = {"rank": rank, "rc": cli.run(argv)}
torch.cuda.synchronize()
report["step_ms"] = [s.elapsed_time(e) for s, e in steps]
world = getattr(cli, "world", None)
report["world"] = None if world is None else {
    "size": world.size, "startup_s": world.startup_s,
    "backend": world.backend[0], "rule": world.backend[1]}
report["run_mode"] = cli.launcher.run_mode_used
report["staged"] = dict(collectives.staged)
report["calls"] = dict(collectives.calls)
report["sent_bytes"] = dict(collectives.sent_bytes)
runner = cli.launcher.runner
report["losses"] = [t["loss"] for t in runner.epoch_times]
report["history"] = cli.workflow.decision.epoch_history
report["times"] = [{k: t.get(k) for k in ("eval_s", "train_s", "wall_s")}
                   for t in runner.epoch_times]
report["counts"], report["forms"] = chip_smoke.read_counts()
report["variants"] = {name: dict(fn.launches_by_variant) for name, fn in
                      chip_smoke.variant_counters().items()}
registry = get_registry()
report["series"] = {}
for name in ("veles_gspmd_step_ms", "veles_reshard_ms"):
    family = registry.get(name)
    report["series"][name] = [] if family is None else [
        (labels, child.summary()) for labels, child in family.series()]
report["bad_modules"] = sorted(
    m for m in sys.modules if m in ("jax", "ml_dtypes", "veles_tpu") or
    m.startswith(("jax.", "ml_dtypes.", "veles_tpu.")))
if rank == 0:
    numpy.savez(prefix + ".params.npz", **params_of(cli.workflow))
with open(out, "wb") as f:
    pickle.dump(report, f)
sys.exit(report["rc"])
"""


class SpmdLeg(object):
    """The rank processes of one ``--gspmd`` leg that this script starts
    (rank 0 alone when it starts the others itself, every rank with the
    multi-process flags), each ``SPMD_DRIVER`` with ``args``."""

    def __init__(self, name, tmp, ranks, env):
        import subprocess
        self.name, self.tmp = name, tmp
        self.prefix = os.path.join(tmp, name.replace(" ", "_"))
        self.procs = []
        self.started = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=REPO, SMOKE_SPMD_DRIVER=SPMD_DRIVER,
                   **env)
        for i, args in enumerate(ranks):
            log = open("%s.%d.log" % (self.prefix, i), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-c", SPMD_DRIVER, self.prefix] + list(args),
                env=env, cwd=tmp, stdout=log, stderr=subprocess.STDOUT))
            log.close()

    def wait(self, n):
        """The reports of the world's ``n`` ranks; a failure, a missing
        report or an overrun raises (after killing the processes)."""
        import pickle
        import subprocess
        try:
            for proc in self.procs:
                proc.wait(timeout=max(1.0, SPMD_WORLD_S - (
                    time.perf_counter() - self.started)))
        except subprocess.TimeoutExpired:
            raise AssertionError("%s overran %d s:\n%s" % (
                self.name, SPMD_WORLD_S, self.logs()))
        finally:
            self.kill()
        self.wall_s = time.perf_counter() - self.started
        reports = []
        for k in range(n):
            path = "%s.rank%d" % (self.prefix, k)
            if not os.path.exists(path):
                raise AssertionError("%s: rank %d left no report:\n%s" % (
                    self.name, k, self.logs()))
            with open(path, "rb") as f:
                reports.append(pickle.load(f))
        for report in reports:
            if report["rc"] != 0 or report["bad_modules"]:
                raise AssertionError("%s: rank %d exited %s, loaded %s" % (
                    self.name, report["rank"], report["rc"],
                    report["bad_modules"]))
        return reports

    def params(self, which="params"):
        import numpy
        with numpy.load("%s.%s.npz" % (self.prefix, which)) as data:
            return {k: data[k] for k in data.files}

    def logs(self, tail=3000):
        import glob
        parts = []
        for path in sorted(glob.glob(self.prefix + ".*.log")):
            with open(path, errors="replace") as f:
                parts.append("-- %s:\n%s" % (os.path.basename(path),
                                             f.read()[-tail:]))
        return "\n".join(parts)

    def kill(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def spmd_gap(got, want, init, got_losses, want_losses):
    """(largest relative loss gap over the epochs and classes, largest
    share of a parameter tensor's change, values that differ)."""
    loss_rel = _loss_rel(got_losses, want_losses)
    share = _update_share(got, want, init)
    differing = sum(int((got[k] != want[k]).sum()) for k in want) + sum(
        g[k] != w[k] for g, w in zip(got_losses, want_losses) for k in w)
    return loss_rel, share, int(differing)


def series_summary(reports, name):
    return {json.dumps(labels, sort_keys=True): summary
            for report in reports[:1]
            for labels, summary in report["series"][name]}


def spmd_phase(kernels, standalone=None):
    """Phase 15 (see the module docstring). Returns (result,
    [launches_by_form of each rank of each run]). ``standalone``, a
    :class:`Standalone`, receives the standalone run's history,
    parameters and launches (phase 22 holds its installed run to
    them)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="veles_spmd_")
    try:
        return _spmd_phase(kernels, tmp, standalone)
    finally:
        if standalone is not None:
            standalone.ready.set()
        shutil.rmtree(tmp, ignore_errors=True)


def torch_world():
    """``tests/torch_world.py``, the harness that runs a function on
    every rank of a fresh world, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_world", os.path.join(REPO, "tests", "torch_world.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _spmd_phase(kernels, tmp, standalone=None):
    from veles_tpu_torch.ops.gemm_bench import card_line
    run_world = torch_world().run_world

    # the ranks import the rank functions by this module's name, not as
    # the script's __main__
    import chip_smoke as me
    card = card_line()
    path = os.path.join(tmp, "alexnet_workflow.py")
    with open(path, "w") as f:
        f.write(WORKFLOW_FILE)
    args = [path, "-s", "7", "root.smoke.epochs=%d" % SPMD_EPOCHS,
            "root.smoke.snapshots=%r" % os.path.join(tmp, "snaps"),
            "root.common.disable.snapshotting=True"]
    det = {"SMOKE_DETERMINISTIC": "1"}
    result, all_forms = {"card": card}, []
    per_epoch = TRAIN_SAMPLES

    def leg(name, ranks, env, n, run=None):
        t0 = time.perf_counter() if run is None else run.started
        if run is None:
            run = SpmdLeg(name, tmp, ranks, env)
        reports = run.wait(n)
        for report in reports:
            check_forms("spmd %s rank %d" % (name, report["rank"]), kernels,
                        report["forms"])
            check_designed("spmd %s rank %d" % (name, report["rank"]),
                           report["variants"]["gemm_bias_act"])
            all_forms.append(report["forms"])
        rank0 = reports[0]
        train_s = sum(t["train_s"] for t in rank0["times"])
        out = {"wall_s": time.perf_counter() - t0,
               "world": rank0["world"], "run_mode": rank0["run_mode"],
               "staged_through_host": rank0["staged"],
               "collective_calls": rank0["calls"],
               "collective_bytes": rank0["sent_bytes"],
               "losses": rank0["losses"], "times": rank0["times"],
               "samples_per_s": SPMD_EPOCHS * per_epoch / train_s,
               # the first epoch carries the first step's start-up
               "samples_per_s_last_epoch":
                   per_epoch / rank0["times"][-1]["train_s"],
               "step_ms": statistics.median(rank0["step_ms"]),
               "step_ms_all": rank0["step_ms"],
               "launches": [r["counts"] for r in reports],
               "veles_gspmd_step_ms": series_summary(
                   reports, "veles_gspmd_step_ms"),
               "veles_reshard_ms": series_summary(reports,
                                                  "veles_reshard_ms")}
        print("spmd %s (%s): world %s, staged through the host %s, "
              "%.1f samples/s (%.1f in the last epoch), step %.2f ms (CUDA "
              "events), %.1f s wall" % (
                  name, card, out["world"], out["staged_through_host"],
                  out["samples_per_s"], out["samples_per_s_last_epoch"],
                  out["step_ms"], out["wall_s"]))
        return run, reports, out

    # the reference: the standalone deterministic run, a process of its
    # own, its initial parameters saved; (1) runs beside it (the two
    # processes' start-ups are most of their time)
    one = SpmdLeg("1x1", tmp, [args + ["--gspmd", "1x1"]], det)
    try:
        ref_run, ref, result["standalone"] = leg(
            "standalone", [args], dict(det, SMOKE_SAVE_INIT="1"), 1)
    except BaseException:
        one.kill()
        raise
    want, init = ref_run.params(), ref_run.params("init")
    want_losses = ref[0]["losses"]
    if standalone is not None:
        standalone.history, standalone.params = ref[0]["history"], want
        standalone.forms = ref[0]["forms"]
        standalone.ready.set()

    def held(name, run, reports):
        gap = spmd_gap(run.params(), want, init,
                       reports[0]["losses"], want_losses)
        for report in reports[1:]:
            if report["losses"] != reports[0]["losses"]:
                raise AssertionError("spmd %s: rank %d's losses differ from "
                                     "rank 0's" % (name, report["rank"]))
        return gap

    # (1) world 1 on NCCL: bit for bit the standalone run
    run, reports, result["1x1"] = leg("1x1", None, None, 1, one)
    if reports[0]["world"]["backend"] != "nccl":
        raise AssertionError("spmd 1x1: backend %s, not nccl"
                             % reports[0]["world"])
    gap = held("1x1", run, reports)
    result["1x1"]["values_differing"] = gap[2]
    if gap[2]:
        raise AssertionError("spmd 1x1: %d loss and parameter values differ "
                             "from the standalone run" % gap[2])
    # (2) and (3): data and tensor parallel one at a time (their times
    # are printed), then both controls together, every rank of those
    # started here (no rank waits for another's start-up). The worlds
    # started here meet at a file store of their own; the one rank 0
    # starts meets at its TCP store (HOST:PORT)
    stores = []

    def flags(spec):
        stores.append("file://" + os.path.join(tmp, "store_%s_%d" % (
            spec, len(stores))))
        return [args + ["--gspmd", spec, "--jax-coordinator", stores[-1],
                        "--jax-processes", "2", "--jax-process-id", str(k)]
                for k in range(2)]

    def shapes(spawn_1x2):
        return {"2x1": flags("2x1"),
                "1x2": [args + ["--gspmd", "1x2"]] if spawn_1x2 else
                flags("1x2")}

    def check(label, control, run, reports, out):
        if reports[0]["world"]["backend"] != "gloo":
            raise AssertionError("spmd %s: backend %s, not gloo (two ranks "
                                 "share the card)" % (label,
                                                      reports[0]["world"]))
        loss_rel, share, differing = held(label, run, reports)
        out.update(loss_rel=loss_rel, update_share=share,
                   values_differing=differing)
        held_to_reference("spmd " + label, loss_rel, share,
                          SPMD_LOSS_REL_TOL, control)
        result[label] = out
        print("spmd %s: loss gap %.3g, parameter share %.3g, %d values "
              "differ" % (label, loss_rel, share, differing))

    for name, ranks in sorted(shapes(True).items()):
        check(name, False, *leg(name, ranks, det, 2))
    started = [SpmdLeg(name + " control", tmp, ranks,
                       dict(det, SMOKE_NO_REDUCE="1"))
               for name, ranks in sorted(shapes(False).items())]
    for run in started:
        check(run.name, True, *leg(run.name, None, None, 2, run))
    # (4) sequence parallelism, (5) expert parallelism, (6) the pipeline
    for schedule in ("ring", "ulysses"):
        t0 = time.perf_counter()
        reports = run_world(me.spmd_sequence_rank, 2, (schedule,),
                            backend="auto", timeout=SPMD_WORLD_S,
                            workdir=world_dir(tmp, schedule))
        out = sequence_leg(schedule, reports, kernels, all_forms)
        out["wall_s"] = time.perf_counter() - t0
        result["sequence " + schedule] = out
        print("spmd sequence %s (%s): %s" % (schedule, card, json.dumps(out)))
    t0 = time.perf_counter()
    reports = run_world(me.spmd_moe_rank, SPMD_EXPERTS, (), backend="auto",
                        timeout=SPMD_WORLD_S,
                        workdir=world_dir(tmp, "experts"))
    out = moe_leg(reports, kernels, all_forms)
    out["wall_s"] = time.perf_counter() - t0
    result["experts"] = out
    print("spmd experts (%s): %s" % (card, json.dumps(out)))
    reports = run_world(me.spmd_pipeline_rank, SPMD_PIPELINE[0], (),
                        backend="auto", timeout=SPMD_WORLD_S,
                        workdir=world_dir(tmp, "pipeline"))
    result["pipeline"] = pipeline_leg(reports)
    print("spmd pipeline (%s): %s" % (card, json.dumps(result["pipeline"])))
    return result, all_forms


def world_dir(tmp, name):
    """A rank world's work directory under the phase's ``tmp``."""
    path = os.path.join(tmp, "world_" + name)
    os.makedirs(path, exist_ok=True)
    return path


def _sequence_trainer(moe, device):
    """``bench_all.py``'s attention or moe configuration at its widths
    over the cut data, seeded as the sequence phase seeds it."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.models import samples
    from veles_tpu_torch.models.build import build_training
    n_train, n_valid = SPMD_SEQUENCE_SAMPLES
    prng.get().seed(SEQUENCE_SEED)
    prng.get("loader").seed(SEQUENCE_SEED + 1)
    spec = samples.sequence_bench(moe, samples.SequenceProvider(
        n_train=n_train, n_valid=n_valid,
        seq=SEQUENCE_LENGTHS["moe" if moe else "attention"],
        dim=SEQUENCE_DIM))
    return build_training(
        spec.layers, spec.sample_shape, spec.loader, seed=SEQUENCE_SEED,
        device=device,
        **dict(spec.training, learning_rate=SEQUENCE_LEARNING_RATE))


def _stepped(torch, trainer, fn):
    """``fn()`` with each training step timed by CUDA events: (its
    result, [step ms])."""
    from veles_tpu_torch.train.step import FusedTrainer
    with timed_method(torch, FusedTrainer, "train_batch") as timed:
        out = fn()
        torch.cuda.synchronize()
    return out, [s.elapsed_time(e) for s, e in timed]


def _trainer_params(trainer):
    """{name: a copy} of every parameter of ``trainer``."""
    return {"%d.%s" % (i, k): p.detach().clone()
            for i, layer in enumerate(trainer.params)
            for k, p in layer.items()}


def _update_share(got, want, init):
    """The largest share of a parameter tensor's change over a run
    (``want - init``) by which ``got`` misses ``want`` ({name: numpy
    array or tensor} each)."""
    return max(float(abs(got[k] - want[k]).max()) /
               max(float(abs(want[k] - init[k]).max()), 1e-30)
               for k in want)


def _loss_rel(got, want):
    """The largest relative distance of the losses ``got`` from
    ``want`` (numbers in equal nests of lists and dicts)."""
    if isinstance(want, dict):
        return max(_loss_rel(got[k], want[k]) for k in want)
    if isinstance(want, (list, tuple)):
        return max(_loss_rel(g, w) for g, w in zip(got, want))
    return abs(got - want) / abs(want)


def spmd_sequence_rank(schedule):
    """One rank of the sequence leg: the attention model with
    ``use_ring(schedule)`` on every attention layer over a 2-rank seq
    axis; its forward against the unsharded forward of the same weights,
    one epoch, the same epoch from the same weights under the control
    (``dropped_term``); then (rank 0) the unsharded model's epoch, and
    both runs' losses and parameters against it."""
    import torch
    from torch_seq_ranks import dropped_term

    from veles_tpu_torch.nn.attention import MultiHeadAttentionForward
    from veles_tpu_torch.parallel import collectives, mesh
    device = mesh.world_device()
    grid = mesh.build_mesh({"seq": -1})

    def attach(trainer):
        for m in trainer.model:
            if isinstance(m, MultiHeadAttentionForward):
                m.use_ring(grid, "seq", schedule)

    def losses(stats):
        return {k: stats[k]["losses"].tolist()
                for k in ("validation", "train")}

    t = _sequence_trainer(False, device)
    x = t.loader.original_data[:64].to(device)
    with torch.no_grad():
        local = t._forward(x, False)
        attach(t)
        sharded = t._forward(x, False)
    forward = float((sharded - local).abs().max() / local.abs().max())
    init = _trainer_params(t)
    reset_counts()
    collectives.reset_counts()
    stats, steps = _stepped(torch, t, lambda: t.run_epoch(0))
    counts, forms = read_counts()
    out = {"forward_share": forward, "steps_ms": steps,
           "losses": losses(stats),
           "train_s": sum(steps) / 1e3, "forms": forms, "counts": counts,
           "variants": gemm_variants(), "staged": dict(collectives.staged),
           "calls": dict(collectives.calls),
           "backend": mesh.backend_reason()}
    control = _sequence_trainer(False, device)
    attach(control)
    with dropped_term(schedule):
        control_losses = losses(control.run_epoch(0))
    if mesh.world_rank() == 0:
        ref = _sequence_trainer(False, device)
        stats, steps = _stepped(torch, ref, lambda: ref.run_epoch(0))
        out["reference"] = losses(stats)
        out["reference_steps_ms"] = steps
        want = _trainer_params(ref)
        out["update_share"] = _update_share(_trainer_params(t), want, init)
        out["control"] = {
            "loss_rel": _loss_rel(control_losses, out["reference"]),
            "update_share": _update_share(_trainer_params(control), want,
                                          init)}
    return out


def held_to_reference(label, loss_rel, share, loss_tol, control):
    """Raise unless the losses within ``loss_tol`` and the parameters
    within SPMD_UPDATE_SHARE_TOL of their change hold (or, for a
    ``control``, unless one of them breaks)."""
    within = loss_rel <= loss_tol and share <= SPMD_UPDATE_SHARE_TOL
    if within == control:
        raise AssertionError(
            "%s: losses %.3g from the reference's (bound %g), parameters "
            "%.3g of their change (bound %g)%s" % (
                label, loss_rel, loss_tol, share, SPMD_UPDATE_SHARE_TOL,
                ": the control must fail" if control else ""))


def sequence_leg(schedule, reports, kernels, all_forms):
    """The sequence leg's checks: the forward's share, every rank alike,
    the forms, the epoch's losses and parameters against the unsharded
    one's, and the control."""
    first = reports[0]["value"]
    for report in reports:
        value = report["value"]
        label = "spmd sequence %s rank %d" % (schedule, report["rank"])
        check_forms(label, kernels, value["forms"])
        check_designed(label, value["variants"])
        all_forms.append(value["forms"])
        if value["forward_share"] > SPMD_FORWARD_TOL:
            raise AssertionError("%s: forward %.3g of the unsharded one's "
                                 "largest value (bound %g)" % (
                                     label, value["forward_share"],
                                     SPMD_FORWARD_TOL))
        if value["losses"] != first["losses"]:
            raise AssertionError("%s: losses differ from rank 0's" % label)
    rel = _loss_rel(first["losses"], first["reference"])
    label = "spmd sequence %s" % schedule
    held_to_reference(label, rel, first["update_share"],
                      SPMD_SEQUENCE_LOSS_REL_TOL, False)
    control = first["control"]
    held_to_reference(label + " control", control["loss_rel"],
                      control["update_share"], SPMD_SEQUENCE_LOSS_REL_TOL,
                      True)
    n_train = SPMD_SEQUENCE_SAMPLES[0]
    return {"backend": first["backend"], "staged_through_host":
            first["staged"], "collective_calls": first["calls"],
            "forward_share": max(r["value"]["forward_share"]
                                 for r in reports),
            "loss_rel": rel, "update_share": first["update_share"],
            "control": control,
            "step_ms": statistics.median(first["steps_ms"]),
            "samples_per_s": n_train / first["train_s"],
            "unsharded_step_ms": statistics.median(
                first["reference_steps_ms"]),
            "unsharded_samples_per_s": n_train / (
                sum(first["reference_steps_ms"]) / 1e3),
            "rank_seconds": [r["seconds"] for r in reports]}


def spmd_moe_rank():
    """One rank of the expert-parallel leg: the moe model with
    ``use_experts`` over an 8-rank expert axis; its moe layer's forward
    on a batch against ``moe_ffn_reference(n_shards=8)`` on the card, a
    few training steps, the same steps from the same weights under the
    control (``router_unreduced``); then (rank 0) the steps with that
    per-shard routing in one process, and both runs' losses and
    parameters against them."""
    import torch
    from torch_seq_ranks import router_unreduced

    from veles_tpu_torch.nn.moe import MoEForward
    from veles_tpu_torch.parallel import collectives, mesh
    from veles_tpu_torch.parallel.ep import moe_ffn_reference
    from veles_tpu_torch.loader.base import TRAIN
    device = mesh.world_device()
    grid = mesh.build_mesh({"expert": -1})

    def moe_of(trainer):
        return next(m for m in trainer.model if isinstance(m, MoEForward))

    def per_shard(moe):
        """``moe``'s forward with the expert path's routing, unsharded."""
        def forward(x):
            tokens = x.reshape(-1, x.shape[-1])
            y = moe_ffn_reference(tokens, moe.weights, moe.up, moe.down,
                                  moe.n_experts, moe.capacity_factor,
                                  n_shards=SPMD_EXPERTS).reshape(x.shape)
            return (y + x if moe.residual else y).to(x.dtype)
        return forward

    t = _sequence_trainer(True, device)
    moe = moe_of(t)
    moe.use_experts(grid)
    x = t.loader.original_data[:64].to(device)
    with torch.no_grad():
        got = moe(x)
        want = per_shard(moe)(x)
    share = float((got - want).abs().max() / want.abs().max())
    init = _trainer_params(t)
    reset_counts()
    collectives.reset_counts()
    idx = t._segment_indices(TRAIN)[:SPMD_MOE_STEPS]
    (losses, _), steps = _stepped(torch, t, lambda: t.train_rows(
        idx, 0, t._dropout_seed()))
    counts, forms = read_counts()
    out = {"forward_share": share, "losses": losses.tolist(),
           "steps_ms": steps, "forms": forms, "counts": counts,
           "variants": gemm_variants(), "staged": dict(collectives.staged),
           "calls": dict(collectives.calls),
           "backend": mesh.backend_reason()}
    control = _sequence_trainer(True, device)
    moe_of(control).use_experts(grid)
    with router_unreduced():
        control_losses, _ = control.train_rows(idx, 0,
                                               control._dropout_seed())
    if mesh.world_rank() == 0:
        ref = _sequence_trainer(True, device)
        ref_moe = moe_of(ref)
        ref_moe.forward = per_shard(ref_moe)
        ref_losses, _ = ref.train_rows(idx, 0, ref._dropout_seed())
        out["reference"] = ref_losses.tolist()
        want = _trainer_params(ref)
        out["update_share"] = _update_share(_trainer_params(t), want, init)
        out["control"] = {
            "loss_rel": _loss_rel(control_losses.tolist(), out["reference"]),
            "update_share": _update_share(_trainer_params(control), want,
                                          init)}
    return out


def moe_leg(reports, kernels, all_forms):
    first = reports[0]["value"]
    for report in reports:
        value = report["value"]
        label = "spmd experts rank %d" % report["rank"]
        check_forms(label, kernels, value["forms"])
        check_designed(label, value["variants"])
        all_forms.append(value["forms"])
        if value["forward_share"] > SPMD_MOE_TOL:
            raise AssertionError("%s: the moe layer %.3g of the reference's "
                                 "largest value (bound %g)" % (
                                     label, value["forward_share"],
                                     SPMD_MOE_TOL))
        if value["losses"] != first["losses"] or not all(
                math.isfinite(v) for v in value["losses"]):
            raise AssertionError("%s: losses %s (rank 0: %s)" % (
                label, value["losses"], first["losses"]))
    rel = _loss_rel(first["losses"], first["reference"])
    held_to_reference("spmd experts", rel, first["update_share"],
                      SPMD_LOSS_REL_TOL, False)
    control = first["control"]
    held_to_reference("spmd experts control", control["loss_rel"],
                      control["update_share"], SPMD_LOSS_REL_TOL, True)
    return {"backend": first["backend"], "ranks": len(reports),
            "staged_through_host": first["staged"],
            "collective_calls": first["calls"],
            "forward_share": max(r["value"]["forward_share"]
                                 for r in reports),
            "losses": first["losses"], "reference": first["reference"],
            "loss_rel": rel, "update_share": first["update_share"],
            "control": control,
            "step_ms": statistics.median(first["steps_ms"]),
            "rank_seconds": [r["seconds"] for r in reports]}


def spmd_pipeline_rank():
    """One stage of the pipeline leg: ``pipeline_apply`` and one
    ``pipeline_train_step`` of two tanh(x @ W) stages on the card, and
    (rank 0) the sequential run of both stages."""
    import numpy
    import torch

    from veles_tpu_torch.parallel import collectives, mesh
    from veles_tpu_torch.parallel.pp import (pipeline_apply,
                                             pipeline_train_step)
    n_stages, n_micro, mb, dim = SPMD_PIPELINE
    device = mesh.world_device()
    rng = numpy.random.RandomState(19)
    stack = torch.from_numpy((rng.randn(n_stages, dim, dim) /
                              dim ** 0.5).astype(numpy.float32)).to(device)
    xs, ys = (torch.from_numpy(rng.randn(n_micro, mb, dim).astype(
        numpy.float32)).to(device) for _ in range(2))
    grid = mesh.build_mesh({"pipe": -1})
    stage = grid.axis("pipe").index

    def stage_fn(w, x):
        return torch.tanh(torch.matmul(x, w))

    def loss_fn(out, y):
        return torch.mean(torch.square(out - y))

    collectives.reset_counts()
    t0 = time.perf_counter()
    out = pipeline_apply(stage_fn, stack[stage], xs, grid)
    new, loss = pipeline_train_step(stage_fn, stack[stage], xs, ys, loss_fn,
                                    grid, learning_rate=0.1)
    torch.cuda.synchronize()
    result = {"stage": stage, "seconds": time.perf_counter() - t0,
              "staged": dict(collectives.staged)}
    params = stack.clone().requires_grad_()
    seq = xs
    for s in range(n_stages):
        seq = stage_fn(params[s], seq)
    seq_loss = torch.stack([loss_fn(seq[i], ys[i])
                            for i in range(n_micro)]).mean()
    grad, = torch.autograd.grad(seq_loss, params)
    result.update(
        out_err=float((out - seq.detach()).abs().max()),
        loss_err=abs(float(loss) - float(seq_loss)),
        param_err=float((new - (stack - 0.1 * grad)[stage]).abs().max()))
    return result


def pipeline_leg(reports):
    worst = {k: max(r["value"][k] for r in reports)
             for k in ("out_err", "loss_err", "param_err")}
    if max(worst.values()) > SPMD_PIPELINE_ATOL:
        raise AssertionError("spmd pipeline: %s beyond %g of the sequential "
                             "run" % (worst, SPMD_PIPELINE_ATOL))
    worst["staged_through_host"] = reports[0]["value"]["staged"]
    worst["seconds"] = [r["value"]["seconds"] for r in reports]
    return worst


#: phase 16: the elastic tier on phase 9's file (``-s 7``), deterministic
ELASTIC_EPOCHS = 2
#: leg B: rank 1 dies at this epoch boundary (after the first epoch's
#: generation committed); the final parameters within this share of
#: their change of the uninterrupted 2x1 run's (the last epoch ran at
#: world 1: the gradient sums in another order)
ELASTIC_LATE_DEATH = 2
ELASTIC_UPDATE_SHARE_TOL = SPMD_UPDATE_SHARE_TOL
#: seconds one leg (its supervisors, every generation's workers) may take
ELASTIC_LEG_S = 420
#: the rendezvous's settle window and heartbeat silence limit
ELASTIC_SETTLE_S = 0.5
ELASTIC_HB_TIMEOUT_S = 10.0
#: the generations' codec: raw, as phase 9's snapshots (gz would
#: compress ~1.3 GB a generation on one core)
ELASTIC_COMPRESSION = ""

#: one elastic worker: ``python -c ELASTIC_WORKER prefix workflow_file
#: [root.* overrides]`` builds phase 9's workflow file as the CLI does
#: with ``-s 7`` and trains it through ``run_elastic_training`` (under a
#: supervisor, or standalone without the ``VELES_ELASTIC_*`` env); its
#: report (``prefix.g<generation>.rank<rank>``, written on a normal or a
#: raising exit, never by a killed worker): the history, each training
#: step's ms by CUDA events, each epoch's training sweep s, the start-up
#: s, each generation it cut (directory, bytes it pickled, s, bytes on
#: disk), the generation it restored, its launch counters (read at exit:
#: it started at 0), the ``veles_spmd_recovery_ms`` series, the modules
#: it loaded of jax, ml_dtypes and veles_tpu; rank 0 also the final
#: parameters (``prefix.params.npz``), with SMOKE_SAVE_INIT=1 the initial
#: ones (``prefix.init.npz``). SMOKE_GRID: the ``--gspmd`` grid;
#: SMOKE_DROP_REGISTRY=1: the restore's random streams dropped (the
#: control).
ELASTIC_WORKER = r"""
import os, pickle, sys, time
t_start = time.perf_counter()
prefix, workflow_file = sys.argv[1], sys.argv[2]
import numpy
import torch
if os.environ.get("SMOKE_DETERMINISTIC") == "1":
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
import chip_smoke
from veles_tpu_torch import prng, snapshotter
from veles_tpu_torch.__main__ import Main
from veles_tpu_torch.config import root
from veles_tpu_torch.convert import layer_params
from veles_tpu_torch.dummy import DummyLauncher
from veles_tpu_torch.parallel import elastic
from veles_tpu_torch.telemetry.registry import get_registry
from veles_tpu_torch.train.step import FusedTrainer
ctx = elastic.worker_context()
gen, rank = (ctx.generation, ctx.rank) if ctx is not None else (0, 0)
for item in sys.argv[3:]:
    exec(item, {"root": root})
cli = Main()
module = cli._load_model(workflow_file)
report = {"rank": rank, "generation": gen,
          "world": ctx.world_size if ctx is not None else 1,
          "gens": [], "restored": None, "train_s": [], "step_ms": []}


def params_of(modules):
    return {"%d.%s" % (i, k): p.detach().cpu().numpy()
            for i, m in enumerate(modules)
            for k, p in layer_params(m).items()}


def build(device):
    cli._seed_random("7")
    made = {}

    def load(cls, **kwargs):
        made["wf"] = cls(DummyLauncher(), **kwargs)
        return made["wf"], False

    module.run(load, lambda **kwargs: None)
    made["wf"].initialize(device=device)
    if os.environ.get("SMOKE_SAVE_INIT") == "1":
        numpy.savez(prefix + ".init.npz",
                    **params_of([f.module for f in made["wf"].forwards]))
    return made["wf"]


restore_latest = snapshotter.restore_latest


def restored(directory, prefix=None):
    wf, path = restore_latest(directory, prefix)
    report["restored"] = (os.path.basename(path),
                          snapshotter.generation_manifest(path))
    if os.environ.get("SMOKE_DROP_REGISTRY") == "1":
        prng._generators.clear()
    return wf, path


snapshotter.restore_latest = restored
save = elastic.save_elastic_checkpoint


def saved(trainer, ctx, params, states, workflow, compression="gz"):
    gen_dir, nbytes, seconds = save(trainer, ctx, params, states, workflow,
                                    compression)
    disk = None
    if ctx.rank == 0:
        disk = sum(os.path.getsize(os.path.join(gen_dir, n))
                   for n in os.listdir(gen_dir))
    report["gens"].append((os.path.basename(gen_dir), nbytes, seconds, disk))
    return gen_dir, nbytes, seconds


elastic.save_elastic_checkpoint = saved
train, train_class, train_batch = (FusedTrainer.train,
                                   FusedTrainer.train_class,
                                   FusedTrainer.train_batch)
steps = []


def timed_train(self, *args, **kwargs):
    report["startup_s"] = time.perf_counter() - t_start - sum(
        g[2] for g in report["gens"])
    return train(self, *args, **kwargs)


def timed_class(self, *args, **kwargs):
    t0 = time.perf_counter()
    out = train_class(self, *args, **kwargs)
    torch.cuda.synchronize()
    report["train_s"].append(time.perf_counter() - t0)
    return out


def timed_batch(self, *args, **kwargs):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = train_batch(self, *args, **kwargs)
    end.record()
    steps.append((start, end))
    return out


FusedTrainer.train = timed_train
FusedTrainer.train_class = timed_class
FusedTrainer.train_batch = timed_batch
trained = {}


def keep(trainer, params, states):
    trained["trainer"] = trainer


report["rc"] = 1
try:
    history = elastic.run_elastic_training(
        build, grid=os.environ.get("SMOKE_GRID") or None, on_epoch=keep,
        compression=chip_smoke.ELASTIC_COMPRESSION)
    report["history"] = [{k: v for k, v in e.items()} for e in history]
    if rank == 0 and "trainer" in trained:
        numpy.savez(prefix + ".params.npz",
                    **params_of(trained["trainer"].forwards))
    report["rc"] = 0
finally:
    torch.cuda.synchronize()
    report["step_ms"] = [s.elapsed_time(e) for s, e in steps]
    report["counts"], report["forms"] = chip_smoke.read_counts()
    report["variants"] = {name: dict(fn.launches_by_variant) for name, fn
                          in chip_smoke.variant_counters().items()}
    family = get_registry().get("veles_spmd_recovery_ms")
    report["recovery"] = [] if family is None else [
        (labels, child.summary()) for labels, child in family.series()]
    report["bad_modules"] = sorted(
        m for m in sys.modules if m in ("jax", "ml_dtypes", "veles_tpu") or
        m.startswith(("jax.", "ml_dtypes.", "veles_tpu.")))
    with open("%s.g%d.rank%d" % (prefix, gen, rank), "wb") as f:
        pickle.dump(report, f)
"""


class ElasticLeg(object):
    """One run of phase 16: ``members`` supervisors (``python -m
    veles_tpu_torch.parallel.elastic supervise``) at an in-process
    ``RendezvousServer``, each supervising ``ELASTIC_WORKER``; or, with
    ``members`` 0, the worker alone (standalone, or with the
    ``VELES_ELASTIC_*`` of ``env``)."""

    def __init__(self, name, tmp, workflow_file, members=2, die=None,
                 epochs=ELASTIC_EPOCHS, env=None, snaps=None):
        import subprocess
        from veles_tpu_torch.parallel.elastic import (ENV_TEST_DIE,
                                                      RendezvousServer)
        self.name, self.tmp = name, tmp
        self.prefix = os.path.join(tmp, name.replace(" ", "_"))
        self.snaps = snaps or self.prefix + "_snaps"
        self.started = time.perf_counter()
        self.server = None
        self.recovery = {}
        worker = [sys.executable, "-c", ELASTIC_WORKER, self.prefix,
                  workflow_file, "root.smoke.epochs = %d" % epochs,
                  "root.smoke.snapshots = %r" % os.path.join(tmp, "unused"),
                  "root.common.disable.snapshotting = True"]
        base = dict(os.environ, PYTHONPATH=REPO, SMOKE_DETERMINISTIC="1",
                    VELES_FLIGHT_DIR=os.path.join(tmp, "flight"),
                    **(env or {}))
        self.procs, self.logs = [], []
        if not members:
            self._start(subprocess, worker, base, "worker")
            return
        self.server = RendezvousServer(
            expected=members, min_workers=1, settle_s=ELASTIC_SETTLE_S,
            heartbeat_timeout_s=ELASTIC_HB_TIMEOUT_S).start()
        addr = "%s:%d" % self.server.address
        for i in range(members):
            env_i = dict(base)
            if die is not None and i == 1:
                env_i[ENV_TEST_DIE] = "1:%d" % die
            self._start(subprocess, [
                sys.executable, "-m", "veles_tpu_torch.parallel.elastic",
                "supervise", "--rdzv", addr, "--member", "h%d" % i,
                "--snapshots", self.snaps, "--max-restarts",
                "3" if i == 0 else "0", "--"] + worker, env_i, "h%d" % i)

    def _start(self, subprocess, argv, env, label):
        log = "%s.%s.log" % (self.prefix, label)
        with open(log, "w") as f:
            self.procs.append(subprocess.Popen(
                argv, env=env, cwd=self.tmp, stdout=f,
                stderr=subprocess.STDOUT, start_new_session=True))
        self.logs.append(log)

    def wait(self):
        """The reports of every worker that exited normally or raised,
        in (generation, rank) order; the supervisors' exit codes. An
        overrun raises after killing every process of the leg."""
        import glob
        import pickle
        try:
            for proc in self.procs:
                while proc.poll() is None:
                    if time.perf_counter() - self.started > ELASTIC_LEG_S:
                        raise AssertionError("elastic %s overran %d s:\n%s"
                                             % (self.name, ELASTIC_LEG_S,
                                                self.tails()))
                    self._poll_recovery()
                    time.sleep(0.25)
        finally:
            self.kill()
        self.wall_s = time.perf_counter() - self.started
        self.codes = [proc.returncode for proc in self.procs]
        reports = []
        for path in glob.glob(self.prefix + ".g*.rank*"):
            with open(path, "rb") as f:
                reports.append(pickle.load(f))
        reports.sort(key=lambda r: (r["generation"], r["rank"]))
        for report in reports:
            if report["bad_modules"]:
                raise AssertionError("elastic %s: generation %d rank %d "
                                     "loaded %s" % (
                                         self.name, report["generation"],
                                         report["rank"],
                                         report["bad_modules"]))
        return reports

    def _poll_recovery(self):
        """The supervisors' ``veles_spmd_recovery_ms`` as their heartbeats
        carry it to the rendezvous's federated view (a feed goes with its
        member, so it is kept as last seen)."""
        if self.server is None:
            return
        for sid, _, name, labels, data in \
                self.server.federation().series_rows():
            if name == "veles_spmd_recovery_ms":
                self.recovery[(sid, labels.get("event"))] = data

    def worker_pids(self):
        """The workers the supervisors announced (``EVENT spmd_worker``)."""
        import re
        pids = []
        for log in self.logs:
            with open(log, errors="replace") as f:
                pids += [int(p) for p in re.findall(
                    r"EVENT spmd_worker t=\S+ .*pid=(\d+)", f.read())]
        return pids

    def kill(self):
        """Kill what is left of the leg: a supervisor still running, and
        then the workers it announced (a supervisor that exited killed
        its own: their pids may name other processes by now)."""
        import signal
        alive = [proc for proc in self.procs if proc.poll() is None]
        for proc in alive:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        if alive and self.server is not None:
            for pid in self.worker_pids():
                try:
                    os.killpg(pid, signal.SIGKILL)
                except OSError:
                    pass  # exited with its generation
        if self.server is not None:
            self.server.stop()

    def tails(self, tail=3000):
        parts = []
        for log in self.logs:
            with open(log, errors="replace") as f:
                parts.append("-- %s:\n%s" % (os.path.basename(log),
                                             f.read()[-tail:]))
        return "\n".join(parts)

    def params(self, which="params"):
        import numpy
        with numpy.load("%s.%s.npz" % (self.prefix, which)) as data:
            return {k: data[k] for k in data.files}


def values_differing_tree(got, want):
    """Values that differ between two equal nests (dicts, lists, arrays,
    numbers; a missing key counts one)."""
    import numpy
    if isinstance(want, dict):
        return sum(values_differing_tree(got[k], want[k]) if k in got
                   else 1 for k in want) + len(set(got) - set(want))
    if isinstance(want, (list, tuple)):
        return sum(values_differing_tree(g, w)
                   for g, w in zip(got, want)) + abs(len(got) - len(want))
    g, w = numpy.asarray(got), numpy.asarray(want)
    if g.shape != w.shape:
        return max(g.size, w.size, 1)
    return int((g != w).sum())


def _elastic_row(reports, leg):
    """Each worker's generation, world, start-up s, samples/s and step ms,
    the generations it cut (MiB pickled, s, MiB on disk) and what it
    restored."""
    rows = []
    for r in reports:
        rows.append({
            "generation": r["generation"], "rank": r["rank"],
            "world": r["world"], "rc": r["rc"],
            "startup_s": r.get("startup_s"),
            "samples_per_s": [TRAIN_SAMPLES / s for s in r["train_s"]],
            "step_ms": statistics.median(r["step_ms"])
            if r["step_ms"] else None,
            "gens": [{"dir": d, "MiB": n / 1048576.0, "s": s,
                      "disk_MiB": None if b is None else b / 1048576.0}
                     for d, n, s, b in r["gens"]],
            "restored": None if r["restored"] is None else {
                "dir": r["restored"][0],
                "world_size": r["restored"][1].get("world_size"),
                "parts": r["restored"][1].get("nparts")},
            "restore_ms": [s for labels, s in r["recovery"]
                           if labels.get("event") == "restore"]})
    return {"workers": rows, "wall_s": leg.wall_s,
            "supervisor_codes": leg.codes}


def elastic_phase(kernels, one_rank=None):
    """Phase 16 (see the module docstring). Returns (result,
    [launches_by_form of each worker]). ``one_rank``, a
    :class:`OneRank`, receives the one-rank reference run's history and
    parameters (phase 17 holds its preempted job to them)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="veles_elastic_")
    try:
        return _elastic_phase(kernels, tmp, one_rank)
    finally:
        if one_rank is not None:
            one_rank.ready.set()
        shutil.rmtree(tmp, ignore_errors=True)


class OneRank(object):
    """Phase 16's one-rank reference run (phase 9's file through
    ``ELASTIC_WORKER``, 2 epochs), handed to phase 17 beside it:
    ``history`` and ``params`` once ``ready`` is set (None if phase 16
    failed first)."""

    def __init__(self):
        self.ready = threading.Event()
        self.history = self.params = None


def _elastic_phase(kernels, tmp, one_rank=None):
    import shutil

    import torch

    from veles_tpu_torch import snapshotter
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.ops.gemm_bench import card_line
    from veles_tpu_torch.parallel import elastic
    from veles_tpu_torch.parallel.gspmd import GSPMDTrainer
    from veles_tpu_torch.telemetry import alerts
    from veles_tpu_torch.train.runner import trainer_for
    card = card_line()
    path = os.path.join(tmp, "alexnet_workflow.py")
    with open(path, "w") as f:
        f.write(WORKFLOW_FILE)
    result, all_forms = {"card": card}, []
    path_kernels = ("gemm_bias_act", "lrn_fwd", "lrn_bwd", "column_reduce",
                    "uniform_fill")

    def collect(leg, beside=()):
        reports = leg.wait()
        name = leg.name
        total = collections.Counter()
        for r in reports:
            label = "elastic %s generation %d rank %d" % (
                name, r["generation"], r["rank"])
            check_forms(label, kernels, r["forms"])
            if sum(r["counts"].values()):
                check_designed(label, r["variants"]["gemm_bias_act"])
            all_forms.append(r["forms"])
            total.update(r["counts"])
        idle = [k for k in path_kernels if not total[k]]
        if idle:
            raise AssertionError("elastic %s: no launch of %s" % (name, idle))
        out = _elastic_row(reports, leg)
        out.update(launches=dict(total), beside=list(beside))
        if leg.server is not None:
            out.update(generation=leg.server.generation,
                       world=leg.server.world_size,
                       lost_total=leg.server.lost_total,
                       reform_s=leg.server.last_recovery_s,
                       supervisors_recovery_ms={
                           "%s %s" % k: v for k, v in leg.recovery.items()})
        result[name] = out
        print("elastic %s (%s): %s" % (name, card, json.dumps(out,
                                                             default=str)))
        return reports

    def together(*legs):
        """The reports of legs started together (each beside the others:
        their processes' start-ups are most of their time); a failure
        kills every one of them."""
        names = [leg.name for leg in legs]
        try:
            return [collect(leg, [n for n in names if n != leg.name])
                    for leg in legs]
        finally:
            for leg in legs:
                leg.kill()

    def start(name, **kwargs):
        return ElasticLeg(name, tmp, path, **kwargs)

    def final(reports):
        done = [r for r in reports if r["rank"] == 0 and r["rc"] == 0]
        if not done:
            raise AssertionError("no rank 0 worker finished")
        return done[-1]

    # the references: the 2x1 world uninterrupted, and one rank alone
    # beside it
    two, one = start("2x1"), start("one rank", members=0,
                                   env={"SMOKE_SAVE_INIT": "1"})
    two_reports, one_reports = together(two, one)
    want2, params2 = final(two_reports)["history"], two.params()
    want1, init = final(one_reports)["history"], one.params("init")
    params1 = one.params()
    if one_rank is not None:
        one_rank.history, one_rank.params = want1, params1
        one_rank.ready.set()
    if two.codes != [0, 0]:
        raise AssertionError("elastic 2x1: supervisors exited %s" % two.codes)

    # the alert rule watches the lost-participant counter over 300 s
    engine = alerts.AlertEngine(rules=[
        r for r in alerts.DEFAULT_RULES
        if r["name"] == "spmd_participant_lost"], min_eval_interval_s=0)
    engine.evaluate(now=time.time() - 301.0, force=True)

    # leg A, alone: rank 1 killed at the first epoch boundary, before
    # that epoch's generation commits: world 1 from the generation-
    # initial checkpoint (written at world 2), every value the one-rank
    # run's
    leg_a = start("kill A", die=1)
    reports, = together(leg_a)
    engine.evaluate(now=time.time(), force=True)
    survivor = final(reports)
    checks = {
        "supervisor_codes": leg_a.codes == [0, 1],
        "generation": leg_a.server.generation >= 1,
        "world": leg_a.server.world_size == 1,
        "lost": leg_a.server.lost_total >= 1,
        "restored_g0.0_of_world_2": survivor["restored"] is not None and
        survivor["restored"][0] == "wf_g0.0.shards" and
        survivor["restored"][1]["world_size"] == 2 and
        survivor["restored"][1]["parts"] == ["part0.pickle", "part1.pickle"],
        "alert": "spmd_participant_lost" in engine.active()}
    differing = {"history": values_differing_tree(survivor["history"], want1),
                 "params": values_differing_tree(leg_a.params(), params1)}
    result["kill A"].update(checks=checks, values_differing=differing)
    print("elastic kill A: %s, values differing from the one-rank run %s"
          % (checks, differing))
    if not all(checks.values()) or any(differing.values()):
        raise AssertionError("elastic kill A: %s, %s\n%s" % (
            checks, differing, leg_a.tails()))

    # leg B: rank 1 killed after the first epoch's generation committed
    # (epoch 1 bit for bit the 2x1 run's, the rest at world 1), beside a
    # 1x2 world that writes a generation and the control: leg A's
    # generation-initial checkpoint restored without the random registry
    control_snaps = os.path.join(tmp, "control_snaps")
    os.makedirs(control_snaps)
    shutil.copytree(os.path.join(leg_a.snaps, "wf_g0.0.shards"),
                    os.path.join(control_snaps, "wf_g0.0.shards"))
    leg_b = start("kill B", die=ELASTIC_LATE_DEATH)
    tp = start("1x2", epochs=1, env={"SMOKE_GRID": "1x2"})
    control = start("control", members=0, snaps=control_snaps, env={
        elastic.ENV_WORLD: "1", elastic.ENV_GEN: "9", elastic.ENV_RANK: "0",
        elastic.ENV_SNAPSHOTS: control_snaps, "SMOKE_DROP_REGISTRY": "1"})
    reports, _, control_reports = together(leg_b, tp, control)
    survivor = final(reports)
    share = _update_share(leg_b.params(), params2, init)
    first = values_differing_tree(survivor["history"][:1], want2[:1])
    checks = {
        "supervisor_codes": leg_b.codes == [0, 1],
        "world": leg_b.server.world_size == 1,
        "restored_g0.1_of_world_2": survivor["restored"] is not None and
        survivor["restored"][0] == "wf_g0.%d.shards" % (
            ELASTIC_LATE_DEATH - 1) and
        survivor["restored"][1]["world_size"] == 2}
    result["kill B"].update(checks=checks, first_epoch_differing=first,
                            update_share=share)
    print("elastic kill B: %s, first epoch values differing %d, parameters "
          "%.3g of their change (bound %g)" % (checks, first, share,
                                                ELASTIC_UPDATE_SHARE_TOL))
    if not all(checks.values()) or first or \
            share > ELASTIC_UPDATE_SHARE_TOL:
        raise AssertionError("elastic kill B: %s\n%s" % (result["kill B"],
                                                         leg_b.tails()))

    # the reshard: a 1x2 world's generation restored at 1x1 here, every
    # parameter the world's gathered whole to the bit
    whole = tp.params()
    t0 = time.perf_counter()
    wf, gen_path = snapshotter.restore_latest(tp.snaps)
    load_s = time.perf_counter() - t0
    wf.workflow = DummyLauncher()
    wf.initialize(device=torch.device("cuda"))
    trainer = trainer_for(wf, GSPMDTrainer)
    params, _ = trainer.pull_params()
    trainer.shutdown()
    got = {"%d.%s" % (i, k): v.detach().cpu().numpy()
           for i, layer in enumerate(params) for k, v in layer.items()}
    reshard = {"generation": os.path.basename(gen_path),
               "mesh_axes": snapshotter.generation_manifest(
                   gen_path)["mesh_axes"],
               "load_s": load_s,
               "values_differing": values_differing_tree(got, whole)}
    result["1x2"]["reshard"] = reshard
    print("elastic 1x2 restored at 1x1: %s" % json.dumps(reshard))
    if reshard["values_differing"] or reshard["mesh_axes"] != {
            "batch": 1, "model": 2}:
        raise AssertionError("elastic reshard: %s" % reshard)
    del wf, trainer, params
    torch.cuda.empty_cache()

    # the controls: a torn generation never restores; leg A's restore
    # without the random registry differs from the one-rank run
    gens = sorted(d for d in os.listdir(two.snaps) if d.endswith(".shards"))
    newest, older = (os.path.join(two.snaps, d) for d in gens[-1:-3:-1])
    os.unlink(os.path.join(newest, snapshotter.MANIFEST_NAME))
    torn = {}
    try:
        snapshotter.load_sharded_generation(newest)
        torn["no manifest"] = "loaded"
    except Exception as e:  # noqa: BLE001 -- any failure is the refusal
        torn["no manifest"] = type(e).__name__
    torn["no manifest restores"] = os.path.basename(
        snapshotter.restore_latest(two.snaps)[1])
    part = os.path.join(older, "part1.pickle")
    with open(part, "r+b") as f:
        f.truncate(os.path.getsize(part) // 2)
    try:
        snapshotter.load_sharded_generation(older)
        torn["part1 truncated"] = "loaded"
    except Exception as e:  # noqa: BLE001
        torn["part1 truncated"] = type(e).__name__
    torn["part1 truncated restores"] = os.path.basename(
        snapshotter.restore_latest(two.snaps)[1])
    result["torn"] = torn
    print("elastic torn generations: %s" % torn)
    if "loaded" in (torn["no manifest"], torn["part1 truncated"]) or \
            torn["no manifest restores"] != gens[-2] or \
            torn["part1 truncated restores"] != gens[-3]:
        raise AssertionError("elastic torn-generation control: %s" % torn)
    differing = {"history": values_differing_tree(
        final(control_reports)["history"], want1),
                 "params": values_differing_tree(control.params(), params1)}
    result["control"]["values_differing"] = differing
    print("elastic control (restored without the random registry): values "
          "differing from the one-rank run %s" % differing)
    if not (differing["history"] and differing["params"]):
        raise AssertionError("elastic control: the restore without the "
                             "registry equals the one-rank run")
    return result, all_forms


# -- phase 17: the meta-workflows and the gang scheduler -------------------

#: the genetic optimizer's generations and population, the ensemble's
#: members and train ratio
META_GENERATIONS, META_POPULATION = 2, 3
META_ENSEMBLE = (2, 0.8)
#: the seed of the CLI runs (the population's stream); each job runs with
#: the optimizer's and the ensemble's own seeds (1234, 1234 + 1000 i)
META_SEED = "7"
#: the card's allocated bytes after the warm worker's last job may exceed
#: those after its first by at most this
META_MEMORY_SLACK = 64 << 20
#: seconds any one command of the phase may take
META_COMMAND_S = 600
#: what every job adds to its argv (nothing: the jobs run on the card;
#: a rehearsal on the CPU gives ``-a cpu``), the device of the phase's
#: own tensors, and the model's classes
META_JOB_ARGV = ()
META_DEVICE = "cuda"
META_CLASSES = 1000
#: the kernels a training job launches, and a forward-only (test) one
META_TRAIN_KERNELS = ("gemm_bias_act", "lrn_fwd", "lrn_bwd",
                      "column_reduce", "uniform_fill")
META_TEST_KERNELS = ("gemm_bias_act", "lrn_fwd")

#: every job's model: phase 9's file (AlexNet-227 at full width over
#: ``SyntheticImageLoader`` 512 + 128, batch 128) with the learning rate
#: read from ``root.meta.lr`` (a ``Tune`` in the genetics config), the
#: evaluator's ``publish_output`` on, the loader never reshuffling (an
#: ensemble's members test on one sample order, which ``EnsembleLoader``
#: checks; a 1-epoch run never reshuffles anyway), 1 epoch
#: (``root.meta.epochs``), and the snapshotter only where
#: ``root.meta.snapshots`` names a directory (the ensembles': a genetics
#: job keeps no 0.65 GB snapshot); a genetics job reports its
#: ``fitness``, its last training minibatch's loss negated (its error
#: count, the first metric, is 128 of 128 after one epoch at any rate:
#: 1000 classes of random labels). Under SMOKE_DETERMINISTIC=1 it runs
#: the card's libraries deterministically (as phase 9's runs); under
#: SMOKE_KERNEL_REPORT=DIR a run that ends writes its process's kernel
#: launches (``ops.launch_report()``) to DIR/<pid>.json (a cold job's
#: account; a warm worker's replies carry them)
META_WORKFLOW_FILE = """
import json
import os

import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.models.alexnet import (ALEXNET_LAYERS,
                                            AlexNetWorkflow,
                                            SyntheticImageLoader)
from veles_tpu_torch.result_provider import IResultProvider
from veles_tpu_torch.snapshotter import SnapshotterToFile
from veles_tpu_torch.units import Unit


class Fitness(Unit, IResultProvider):
    view_group = "SERVICE"

    def run(self):
        pass

    def get_metric_values(self):
        return {"fitness": -float(self.workflow.evaluator.loss)}


if os.environ.get("SMOKE_DETERMINISTIC") == "1":
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)


def run(load, main):
    wf, restored = load(
        AlexNetWorkflow,
        loader_factory=lambda wf: SyntheticImageLoader(
            workflow=wf, n_train=%d, n_valid=%d, minibatch_size=%d,
            shuffle_limit=0),
        layers=ALEXNET_LAYERS, max_epochs=root.meta.get("epochs", 1),
        learning_rate=float(root.meta.lr), momentum=0.9,
        weights_decay=5e-4)
    if not restored and root.meta.get("snapshots"):
        snap = SnapshotterToFile(wf, compression="", time_interval=0,
                                 name="snapshotter")
        snap.link_from(wf.decision)
        snap.gate_skip = ~wf.loader.epoch_ended
        snap.directory = root.meta.snapshots
    elif not restored:
        Fitness(wf, name="fitness")
    wf.evaluator.publish_output = True
    main()
    reports = os.environ.get("SMOKE_KERNEL_REPORT")
    if reports:
        from veles_tpu_torch.ops import launch_report
        os.makedirs(reports, exist_ok=True)
        with open(os.path.join(reports, "%%d.json" %% os.getpid()),
                  "w") as f:
            json.dump(launch_report(), f)
""" % (TRAIN_SAMPLES, TRAIN_BATCH, TRAIN_BATCH)

META_GA_CONFIG = """
from veles_tpu_torch.genetics import Tune
root.meta.lr = Tune(0.01, 0.002, 0.05)
"""


class MetaCommand(object):
    """``python -m veles_tpu_torch argv`` started in a process of its
    own; :meth:`wait` requires exit 0 and returns its wall seconds."""

    def __init__(self, argv, env, cwd, label):
        import subprocess
        self.label, self.t0 = label, time.perf_counter()
        self.log = os.path.join(cwd, "%s.log" % label.replace(" ", "_"))
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "veles_tpu_torch"] + list(argv),
                env=env, cwd=cwd, stdout=f, stderr=subprocess.STDOUT)

    def wait(self, timeout=META_COMMAND_S):
        try:
            code = self.proc.wait(timeout=timeout)
        finally:
            self.kill()
        if code != 0:
            with open(self.log, errors="replace") as f:
                raise AssertionError("meta %s exited %d:\n%s" % (
                    self.label, code, f.read()[-4000:]))
        return time.perf_counter() - self.t0

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def meta_command(argv, env, cwd, label):
    """:class:`MetaCommand` run to its end: its wall seconds."""
    return MetaCommand(argv, env, cwd, label).wait()


def reported_forms(label, kernels, report, need):
    """Check one process's ``ops.launch_report()`` (forms as their repr):
    every launch at a form the kernel phase checked, K1 on its designed
    forms, K3, K4 and K6 on theirs, each kernel of ``need`` launched.
    Returns its launches by form under the kernel phase's keys."""
    by_repr = {}
    for row in kernels:
        by_repr.setdefault(row["name"], {})[repr(row["_form"])] = \
            row["_form"]
    forms = {}
    for name, entry in report.items():
        for key, n in entry["forms"]:
            form = by_repr.get(name, {}).get(key)
            if form is None:
                raise AssertionError(
                    "%s: %d %s launches at a form the kernel phase did "
                    "not check: %s" % (label, n, name, key))
            mine = forms.setdefault(name, {})
            mine[form] = mine.get(form, 0) + n
    idle = [k for k in need if not report.get(k, {}).get("launches")]
    if idle:
        raise AssertionError("%s: no launch of %s" % (label, idle))
    check_designed(label, report["gemm_bias_act"]["variants"])
    for name, designed in sorted(DESIGNED_FORMS.items()):
        off = {v: c for v, c in report[name]["variants"].items()
               if v not in designed and c}
        if off:
            raise AssertionError("%s: %s launches by form %s (all must be "
                                 "%s)" % (label, name, off, sorted(designed)))
    return forms


def launch_steps(label, replies, need):
    """The launches of each job of one warm worker, from its replies'
    cumulative counts; each job must have launched every kernel of
    ``need``."""
    steps, before = [], {}
    for i, counts in enumerate(replies):
        step = {k: v["launches"] - before.get(k, 0)
                for k, v in counts.items()}
        idle = [k for k in need if not step.get(k)]
        if idle:
            raise AssertionError("%s: job %d launched no %s" % (label, i,
                                                                  idle))
        steps.append(step)
        before = {k: v["launches"] for k, v in counts.items()}
    return steps


def kernel_reports(directory):
    """The ``SMOKE_KERNEL_REPORT`` files of ``directory``, by pid."""
    out = {}
    for name in sorted(os.listdir(directory)) if os.path.isdir(
            directory) else ():
        with open(os.path.join(directory, name)) as f:
            out[int(name.split(".")[0])] = json.load(f)
    return out


def meta_phase(kernels, one_rank=None):
    """Phase 17 (see the module docstring). Returns (result,
    [launches_by_form of each job process])."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="veles_meta_")
    try:
        return _meta_phase(kernels, tmp, one_rank)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _meta_phase(kernels, tmp, one_rank):
    from veles_tpu_torch.ops.gemm_bench import card_line
    card = card_line()
    files = {"workflow": os.path.join(tmp, "meta_workflow.py"),
             "ga_config": os.path.join(tmp, "meta_ga_config.py"),
             "ens_config": os.path.join(tmp, "meta_ens_config.py"),
             "b_config": os.path.join(tmp, "meta_b_config.py"),
             "elastic": os.path.join(tmp, "alexnet_workflow.py")}
    for key, text in (
            ("workflow", META_WORKFLOW_FILE), ("ga_config", META_GA_CONFIG),
            ("ens_config", "root.meta.lr = 0.01\nroot.meta.snapshots = "
             "%r\n" % os.path.join(tmp, "ens_snaps")),
            ("b_config", "root.meta.lr = 0.01\n"),
            ("elastic", WORKFLOW_FILE)):
        with open(files[key], "w") as f:
            f.write(text)
    env = dict(os.environ, PYTHONPATH=REPO, SMOKE_DETERMINISTIC="1",
               VELES_FLIGHT_DIR=os.path.join(tmp, "flight"))
    result, all_forms = {"card": card}, []
    # (A) then (C) in one thread, (D) then (B) in another: each waits on
    # processes of its own, mostly their start-up
    walls = {}
    (genetics, forms_a), (scheduled, forms_b) = beside(
        walls, ("A and C", lambda: _meta_serial(kernels, tmp, files, env,
                                                result)),
        ("D and B", lambda: _meta_scheduled(kernels, tmp, files, env,
                                            one_rank, result)))
    all_forms += forms_a + forms_b
    # (B) against (A): the same population, the same best, bit for bit
    checks = {"best_fitness": scheduled["best_fitness"] ==
              genetics["best_fitness"],
              "best_config": scheduled["best_config"] ==
              genetics["best_config"]}
    result["B"]["equal_to_A"] = checks
    result["walls"] = walls
    print("meta B against A (%s): %s" % (card, checks))
    if not all(checks.values()):
        raise AssertionError("meta B: %s against A's %s" % (
            {k: scheduled[k] for k in ("best_fitness", "best_config")},
            {k: genetics[k] for k in ("best_fitness", "best_config")}))
    return result, all_forms


def _meta_serial(kernels, tmp, files, env, result):
    forms = []
    genetics = meta_genetics_cli(kernels, tmp, files, env, result, forms)
    meta_ensembles(kernels, tmp, files, env, result, forms)
    return genetics, forms


def _meta_scheduled(kernels, tmp, files, env, one_rank, result):
    forms = []
    meta_preemption(kernels, tmp, files, env, one_rank, result, forms)
    scheduled = meta_genetics_scheduled(kernels, tmp, files, env, result,
                                        forms)
    return scheduled, forms


def meta_genetics_cli(kernels, tmp, files, env, result, forms):
    """(A): ``--optimize`` through the CLI with one warm worker; the best
    chromosome re-run cold, and sent to a warm worker with another seed
    (the control)."""
    import math
    from veles_tpu_torch.parallel.warm_pool import WarmPool
    best_path = os.path.join(tmp, "ga_best.json")
    wall = meta_command(
        ["--optimize", "%d:%d" % (META_GENERATIONS, META_POPULATION),
         files["workflow"], files["ga_config"], "-s", META_SEED,
         "--result-file", best_path, "-v", "warning"] +
        list(META_JOB_ARGV), env, tmp, "A optimize")
    with open(best_path) as f:
        best = json.load(f)
    evals = best["evaluations"]
    samples = TRAIN_SAMPLES + TRAIN_BATCH
    out = {"wall_s": wall, "best_fitness": best["fitness"],
           "best_config": best["config"],
           "evaluations": [{
               "generation": e["generation"], "overrides": e["overrides"],
               "fitness": e["fitness"], "wall_s": e["wall_s"],
               "samples_per_s": samples / e["wall_s"],
               "cuda_allocated": e["cuda_allocated"], "pid": e["pid"]}
               for e in evals],
           "generation_s": {g: sum(e["wall_s"] for e in evals
                                   if e["generation"] == g)
                            for g in sorted({e["generation"]
                                             for e in evals})}}
    out["launches"] = launch_steps("meta A", [e["kernel_counts"]
                                              for e in evals],
                                   META_TRAIN_KERNELS)
    forms.append(reported_forms("meta A warm worker", kernels,
                                evals[-1]["kernel_counts"],
                                META_TRAIN_KERNELS))
    allocated = [e["cuda_allocated"] for e in evals]
    checks = {"evaluations": len(evals) == META_POPULATION + (
        META_GENERATIONS - 1) * (META_POPULATION - max(
            2, META_POPULATION // 2)),
              "finite": all(math.isfinite(e["fitness"]) for e in evals),
              "one_worker": len({e["pid"] for e in evals}) == 1,
              "memory": all(a is not None for a in allocated) and
              allocated[-1] <= allocated[0] + META_MEMORY_SLACK}
    # the best chromosome cold: a fresh process, the evaluation's argv
    warm = next(e for e in evals if e["fitness"] == best["fitness"] and
                e["overrides"] == best["config"])
    reports = os.path.join(tmp, "A_reports")
    cold_path = os.path.join(tmp, "ga_cold.json")
    head = [files["workflow"], files["ga_config"]] + [
        "%s=%r" % kv for kv in warm["overrides"].items()]
    argv = head + ["--result-file", cold_path, "-s", "1234", "-v",
                   "warning"] + list(META_JOB_ARGV)
    cold_run = MetaCommand(argv, dict(env, SMOKE_KERNEL_REPORT=reports),
                           tmp, "A cold")
    # beside it, the control: the same job in a warm worker under another
    # seed (a job without ``-s`` runs under the CLI's default, 1234: the
    # evaluation's own); the worker's start-up timed by a job that fails
    # at once
    control_path = os.path.join(tmp, "ga_control.json")
    t0 = time.perf_counter()
    try:
        with WarmPool(workers=1, env=env) as pool:
            pool.run([os.path.join(tmp, "no_such_workflow.py")])
            out["worker_startup_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            reply = pool.run(head + ["--result-file", control_path, "-s",
                                     META_SEED, "-v", "warning"] +
                             list(META_JOB_ARGV), result_file=control_path)
        out["control_s"] = time.perf_counter() - t0
    except BaseException:
        cold_run.kill()
        raise
    out["cold_s"] = cold_run.wait()
    with open(cold_path) as f:
        cold = json.load(f)
    for pid, report in kernel_reports(reports).items():
        forms.append(reported_forms("meta A cold", kernels, report,
                                    META_TRAIN_KERNELS))
    checks["cold_equals_warm"] = values_differing_tree(
        cold, warm["result"]) == 0 and set(cold) == set(warm["result"])
    if not reply.get("ok"):
        raise AssertionError("meta A control: %s" % reply)
    forms.append(reported_forms("meta A control", kernels,
                                reply["kernel_counts"], META_TRAIN_KERNELS))
    out["control_differing"] = values_differing_tree(reply["result"],
                                                     warm["result"])
    checks["control_differs"] = out["control_differing"] > 0
    out["checks"] = checks
    result["A"] = out
    print("meta A (%s): %s" % (result["card"], json.dumps(out,
                                                              default=str)))
    if not all(checks.values()):
        raise AssertionError("meta A: %s" % checks)
    return out


def meta_genetics_scheduled(kernels, tmp, files, env, result, forms):
    """(B): ``ScheduledGeneticsOptimizer`` over ``Scheduler(3,
    preempt=False)``: each chromosome a cold job, three on the card at
    once, from (A)'s seed and stream."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.config import root
    from veles_tpu_torch.genetics import Tune
    from veles_tpu_torch.sched import (DONE, ScheduledGeneticsOptimizer,
                                       Scheduler)
    from veles_tpu_torch.telemetry.registry import get_registry
    reports = os.path.join(tmp, "B_reports")
    job_env = dict(env, SMOKE_KERNEL_REPORT=reports)

    class EnvScheduler(Scheduler):
        def submit(self, spec, now=None):
            spec.env.update(job_env)
            return super(EnvScheduler, self).submit(spec, now)

    # the CLI's ``-s 7`` seeds the default stream, then draws the loader's
    # and the chaos stream's seeds from it, before the population draws
    rand = prng.RandomGenerator("meta").seed(int(META_SEED))
    rand.randint(1 << 31)
    rand.randint(1 << 31)
    root.meta.lr = Tune(0.01, 0.002, 0.05)
    sched = EnvScheduler(3, tick_s=0.1, preempt=False,
                         log_dir=os.path.join(tmp, "B_logs"))
    t0 = time.perf_counter()
    sched.start()
    try:
        optimizer = ScheduledGeneticsOptimizer(
            scheduler=sched, job_timeout_s=META_COMMAND_S,
            workflow_file=files["workflow"], config_file=files["ga_config"],
            generations=META_GENERATIONS, population_size=META_POPULATION,
            extra_argv=list(META_JOB_ARGV), rand=rand)
        best = optimizer.run()
    finally:
        sched.stop()
        del root.__dict__["meta"]
    jobs = sched.jobs()
    out = {"wall_s": time.perf_counter() - t0, "best_fitness": best.fitness,
           "best_config": optimizer.overrides_for(best),
           "jobs": [{"id": j.id, "name": j.spec.name, "state": j.state,
                     "queue_wait_s": j.queue_wait_s,
                     "run_s": j.finished_t - j.started_t} for j in jobs],
           "generation_s": {}}
    for gen in sorted({j.spec.name for j in jobs}):
        mine = [j for j in jobs if j.spec.name == gen]
        out["generation_s"][gen] = max(j.finished_t for j in mine) - min(
            j.submitted_t for j in mine)
    found = kernel_reports(reports)
    for pid, report in found.items():
        forms.append(reported_forms("meta B job %d" % pid, kernels, report,
                                    META_TRAIN_KERNELS))
    family = get_registry().get("veles_sched_jobs_total")
    done = family.labels(tenant="genetics", state=DONE).value \
        if family is not None else 0
    checks = {"jobs_done": all(j.state == DONE for j in jobs),
              "tenant": {j.spec.tenant for j in jobs} == {"genetics"},
              "reports": len(found) == len(jobs),
              "veles_sched_jobs_total": done >= len(jobs)}
    out["checks"] = checks
    result["B"] = out
    print("meta B (%s): %s" % (result["card"], json.dumps(
        out, default=str)))
    if not all(checks.values()):
        raise AssertionError("meta B: %s" % checks)
    return out


def meta_ensembles(kernels, tmp, files, env, result, forms):
    """(C): ``--ensemble-train 2:0.8`` then ``--ensemble-test`` through the
    CLI; each member's test against a cold ``-w <snapshot> --test`` run;
    ``EnsembleLoader`` on the card; the aggregate recomputed."""
    import numpy
    import torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.ensemble import EnsembleTester, aggregate_metrics
    from veles_tpu_torch.loader.ensemble import EnsembleLoader
    from veles_tpu_torch.snapshotter import load_workflow
    size, ratio = META_ENSEMBLE
    train_path = os.path.join(tmp, "ensemble.json")
    test_path = os.path.join(tmp, "ensemble_test.json")
    out = {"train_s": meta_command(
        ["--ensemble-train", "%d:%s" % (size, ratio), files["workflow"],
         files["ens_config"], "-s", META_SEED, "--result-file", train_path,
         "-v", "warning"] + list(META_JOB_ARGV), env, tmp, "C train")}
    # each member's test cold (its argv), beside the CLI's tests
    tester = EnsembleTester(workflow_file=files["workflow"],
                            config_file=files["ens_config"],
                            results_file=train_path,
                            extra_argv=list(META_JOB_ARGV))
    reports = os.path.join(tmp, "C_reports")
    paths = [os.path.join(tmp, "cold_test%d.json" % i) for i in range(size)]
    colds = [MetaCommand(tester.model_argv(i, path),
                         dict(env, SMOKE_KERNEL_REPORT=reports), tmp,
                         "C cold %d" % i) for i, path in enumerate(paths)]
    try:
        out["test_s"] = meta_command(
            ["--ensemble-test", train_path, files["workflow"],
             files["ens_config"], "-s", META_SEED, "--result-file",
             test_path, "-v", "warning"] + list(META_JOB_ARGV), env, tmp,
            "C test")
    except BaseException:
        for cold in colds:
            cold.kill()
        raise
    out["cold_tests_s"] = max(cold.wait() for cold in colds)
    with open(train_path) as f:
        trained = json.load(f)
    with open(test_path) as f:
        tested = json.load(f)
    for name, data, need in (("train", trained, META_TRAIN_KERNELS),
                             ("test", tested, META_TEST_KERNELS)):
        evals = data["evaluations"]
        out[name + "_launches"] = launch_steps(
            "meta C " + name, [e["kernel_counts"] for e in evals], need)
        forms.append(reported_forms("meta C %s warm worker" % name, kernels,
                                    evals[-1]["kernel_counts"], need))
        out[name + "_evaluations"] = [
            {k: e[k] for k in ("index", "pid", "wall_s", "cuda_allocated")}
            for e in evals]
    snaps = [m["Snapshot"] for m in trained["models"]]
    outputs = [numpy.asarray(m["Output"], numpy.float32)
               for m in tested["models"]]
    rows = TRAIN_BATCH + int(ratio * TRAIN_SAMPLES)
    checks = {
        "snapshots": [os.path.basename(p).split(".")[0] for p in snaps] ==
        ["wf_m%d" % i for i in range(size)] and
        len({os.path.dirname(p) for p in snaps}) == 1 and
        all(os.path.exists(p) for p in snaps),
        # the test pass serves validation and the cut train class
        "trained_on": [o.shape for o in outputs] ==
        [(rows, META_CLASSES)] * size}
    # each member's test against its cold run
    differing = []
    for i, path in enumerate(paths):
        with open(path) as f:
            differing.append(values_differing_tree(json.load(f),
                                                   tested["models"][i]))
    out["cold_differing"] = differing
    checks["cold_equals_warm"] = not any(differing)
    for pid, report in kernel_reports(reports).items():
        forms.append(reported_forms("meta C cold test", kernels, report,
                                    META_TEST_KERNELS))
    # the members' fc7 (each snapshot read here, the random registry put
    # back after: other phases run in this process)
    saved = dict(prng._generators)
    fc7 = []
    try:
        for path in snaps:
            wf = load_workflow(path)
            fc7.append(numpy.asarray([
                f for f in wf.forwards if type(f).__name__ ==
                "All2AllStrictRELU"][-1]._params["weights"]))
            del wf
    finally:
        prng._generators.clear()
        prng._generators.update(saved)
    out["fc7_differing"] = int((fc7[0] != fc7[1]).sum())
    checks["fc7_differ"] = out["fc7_differing"] > 0
    # the stacking loader on the card
    loader = EnsembleLoader(workflow=DummyWorkflow(), file=test_path)
    loader.initialize(device=torch.device(META_DEVICE))
    staged, _ = loader.stage(torch.device(META_DEVICE))
    got = staged.cpu().numpy()
    out["stacked_shape"] = list(got.shape)
    out["stacked_differing"] = int((got != numpy.stack(outputs, 1)).sum())
    checks["stacked"] = tuple(got.shape) == (rows, size, META_CLASSES) and \
        out["stacked_differing"] == 0
    del loader, staged
    checks["aggregate"] = tested["aggregate"] == json.loads(json.dumps(
        aggregate_metrics(tested["models"])))
    out["checks"] = checks
    result["C"] = out
    print("meta C (%s): %s" % (result["card"], json.dumps(
        out, default=str)))
    if not all(checks.values()):
        raise AssertionError("meta C: %s" % checks)


def sched_cli(args, env, cwd, timeout=120):
    """``python -m veles_tpu_torch sched args`` (exit 0): its stdout."""
    import subprocess
    proc = subprocess.run([sys.executable, "-m", "veles_tpu_torch",
                           "sched"] + list(args), env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError("sched %s exited %d:\n%s" % (
            args[0], proc.returncode, proc.stderr[-3000:]))
    return proc.stdout


def journal_events(state):
    """(event, job id, pids) of every line of the scheduler's journal."""
    path = os.path.join(state, "journal.jsonl")
    events = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    e = json.loads(line)
                except ValueError:
                    break
                events.append((e["ev"], e["job"]["id"],
                               tuple(e["job"]["pids"])))
    return events


def http_json(addr, path, timeout=5.0):
    import urllib.request
    with urllib.request.urlopen("http://%s%s" % (addr, path),
                                timeout=timeout) as resp:
        body = resp.read().decode()
    return body if path.startswith("/metrics") and \
        not path.endswith(".json") else json.loads(body)


def meta_poll(predicate, what, timeout_s=META_COMMAND_S, poll_s=0.2):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(poll_s)
    raise AssertionError("meta D: %s not reached in %d s" % (what,
                                                             timeout_s))


def metric_value(text, name, **labels):
    import re
    want = ",".join('%s="%s"' % kv for kv in sorted(labels.items()))
    for line in text.splitlines():
        m = re.match(r"^%s(\{[^}]*\})? (\S+)$" % name, line)
        if m and (m.group(1) or "{}")[1:-1] == want:
            return float(m.group(2))
    return 0.0


def meta_preemption(kernels, tmp, files, env, one_rank, result, forms):
    """(D): ``sched serve --pool 1`` as a process; tenant a's preemptible
    job (phase 16's worker, 2 epochs) preempted by tenant b's interactive
    one once a's first generation committed (a held by SIGSTOP from then,
    so the preemption lands before it could finish), a resumed from it;
    ``sched serve`` killed while a's second grant runs and restarted on
    the same state directory: it adopts a's gang. Against phase 16's
    one-rank reference run (``one_rank``, a :class:`OneRank`), or, with
    none (phase 17 alone), the same run started here beside."""
    import glob
    import pickle
    import signal
    import subprocess
    from veles_tpu_torch.parallel.elastic import _free_port
    from veles_tpu_torch.sched.journal import JobJournal
    state = os.path.join(tmp, "sched_state")
    snaps = os.path.join(tmp, "a_snaps")
    reports = os.path.join(tmp, "D_reports")
    addr = "127.0.0.1:%d" % _free_port()
    serve_env = dict(env, SMOKE_KERNEL_REPORT=reports)
    a_prefix = os.path.join(tmp, "sched_a")
    worker = [sys.executable, "-c", ELASTIC_WORKER, a_prefix,
              files["elastic"], "root.smoke.epochs = %d" % ELASTIC_EPOCHS,
              "root.smoke.snapshots = %r" % os.path.join(tmp, "unused"),
              "root.common.disable.snapshotting = True"]
    reference = None if one_rank is not None else ElasticLeg(
        "meta reference", tmp, files["elastic"], members=0)
    serves = []

    def serve():
        log = open(os.path.join(tmp, "serve%d.log" % len(serves)), "w")
        serves.append(subprocess.Popen(
            [sys.executable, "-m", "veles_tpu_torch", "sched", "serve",
             "--pool", "1", "--addr", addr, "--state-dir", state,
             "--log-dir", os.path.join(tmp, "D_logs"), "--min-run-s", "0",
             "--tick-s", "0.1"], env=serve_env, cwd=tmp, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True))
        log.close()
        t0 = time.perf_counter()

        def ready():
            try:
                return http_json(addr, "/status")
            except OSError:   # not listening yet, or 503 while recovering
                return None

        meta_poll(ready, "sched serve answering")
        return time.perf_counter() - t0

    def jobs():
        return {j["name"]: j for j in http_json(addr, "/jobs.json")["jobs"]}

    out = {}
    try:
        out["serve_start_s"] = serve()
        t_submit = time.perf_counter()
        a_id = sched_cli(["submit", "--addr", addr, "--name", "a-train",
                          "--tenant", "a", "--snapshots", snaps, "--"] +
                         worker, env, tmp).split()[0]
        meta_poll(lambda: glob.glob(os.path.join(snaps, "*",
                                                 "MANIFEST.json")),
                  "a's first generation")
        out["a_first_generation_s"] = time.perf_counter() - t_submit
        first = [p for ev, job, p in journal_events(state)
                 if ev == "grant" and job == a_id][-1]
        for pid in first:
            os.killpg(pid, signal.SIGSTOP)
        t_b = time.perf_counter()
        sched_cli(["submit", "--addr", addr, "--name", "b-train",
                   "--tenant", "b", "--qos", "interactive", "--",
                   sys.executable, "-m", "veles_tpu_torch",
                   files["workflow"], files["b_config"], "--result-file",
                   os.path.join(tmp, "b.json"), "-v", "warning"] +
                  list(META_JOB_ARGV), env, tmp)
        meta_poll(lambda: jobs()["a-train"]["state"] == "preempted",
                  "a preempted")
        out["b_submit_to_preempt_s"] = time.perf_counter() - t_b
        meta_poll(lambda: jobs()["b-train"]["state"] == "done" and
                  jobs()["a-train"]["state"] == "running", "a resumed")
        metrics = http_json(addr, "/metrics")
        out["preemptions_total"] = metric_value(
            metrics, "veles_sched_preemptions_total", tenant="a")
        before_kill = [ev for ev, job, _ in journal_events(state)
                       if job == a_id]
        second = [p for ev, job, p in journal_events(state)
                  if ev == "grant" and job == a_id][-1]
        rows = jobs()
        out["b"] = {k: rows["b-train"][k] for k in (
            "queue_wait_s", "started_t", "finished_t", "preemptions")}
        # the scheduler dies while a's second grant runs
        os.killpg(serves[-1].pid, signal.SIGKILL)
        serves[-1].wait()
        alive = all(os.path.exists("/proc/%d" % pid) for pid in second)
        out["adoption_s"] = serve()
        metrics = http_json(addr, "/metrics")
        out["adopted_total"] = metric_value(
            metrics, "veles_sched_gangs_adopted_total")
        out["recovery_ms"] = {m: metric_value(
            metrics, "veles_sched_recovery_ms_sum", phase=m)
            for m in ("replay", "probe", "adopt")}
        meta_poll(lambda: jobs()["a-train"]["state"] in ("done", "failed"),
                  "a done")
        rows = jobs()
        out["a"] = {k: rows["a-train"][k] for k in (
            "state", "preemptions", "preempt_resume_s", "queue_wait_s")}
        status = json.loads(sched_cli(["status", "--addr", addr, "--json"],
                                      env, tmp))
        out["status"] = {"pool": status["status"]["pool"],
                         "jobs": {j["name"]: j["state"]
                                  for j in status["jobs"]}}
        if reference is not None:
            want = reference.wait()
    finally:
        if reference is not None:
            reference.kill()
        for proc in serves:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGINT)
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
    if reference is not None:
        for r in want:
            check_forms("meta D reference", kernels, r["forms"])
            forms.append(r["forms"])
        want = [r for r in want if r["rc"] == 0][-1]
        want = {"history": want["history"], "params": reference.params()}
    else:
        one_rank.ready.wait(META_COMMAND_S)
        if one_rank.history is None:
            raise AssertionError("meta D: no one-rank reference from "
                                 "phase 16")
        want = {"history": one_rank.history, "params": one_rank.params}
    # the image the restarted scheduler compacted (a adopted, running),
    # then every event since
    image, events = JobJournal(state).replay()
    adopted = [j for j in image["jobs"] if j["id"] == a_id][-1]
    record = ([e["job"] for e in events if e["job"]["id"] == a_id] or
              [adopted])[-1]
    mine = []
    for path in glob.glob(a_prefix + ".g*.rank0"):
        with open(path, "rb") as f:
            mine.append(pickle.load(f))
    done = [r for r in mine if r["rc"] == 0]
    checks = {
        "journal": before_kill == ["submit", "grant", "preempt", "grant"],
        "history": [s for _, s in record["history"]] == [
            "pending", "running", "preempted", "running", "done"],
        "preemptions_total": out["preemptions_total"] == 1,
        "adopted_same_pid": alive and out["adopted_total"] == 1 and
        adopted["state"] == "running" and tuple(adopted["pids"]) == second,
        "status_cli": out["status"]["jobs"] == {"a-train": "done",
                                                "b-train": "done"},
        "a_done": out["a"]["state"] == "done" and len(done) == 1,
        "restored": bool(done) and done[0]["restored"] is not None}
    if done:
        a = done[0]
        out["a_worker"] = {"generation": a["generation"],
                           "restored": a["restored"][0],
                           "startup_s": a.get("startup_s")}
        out["values_differing"] = {
            "history": values_differing_tree(a["history"], want["history"]),
            "params": values_differing_tree(
                dict(numpy_load(a_prefix + ".params.npz")),
                want["params"])}
        checks["equal_to_reference"] = not any(
            out["values_differing"].values())
        forms.append(a["forms"])
        check_forms("meta D a", kernels, a["forms"])
        check_designed("meta D a", a["variants"]["gemm_bias_act"])
        idle = [k for k in META_TRAIN_KERNELS if not a["counts"][k]]
        if idle:
            raise AssertionError("meta D a: no launch of %s" % idle)
    for pid, report in kernel_reports(reports).items():
        forms.append(reported_forms("meta D b", kernels, report,
                                    META_TRAIN_KERNELS))
    out["checks"] = checks
    result["D"] = out
    print("meta D (%s): %s" % (result["card"], json.dumps(
        out, default=str)))
    if not all(checks.values()):
        raise AssertionError("meta D: %s" % checks)


# -- phase 18: queue-fed serving, the URI snapshot stores, the autotuner ----

#: the autotune leg: seconds a key may search (the baseline always runs)
#: and launches a candidate is timed over, back to back
SERVICE_BUDGET_S = "0.5"
SERVICE_ITERS = "10"
SERVICE_AUTOTUNE_S = 300
#: the phase's run of phase 9's file: training and validation samples
#: (cut from 512 + 128 for time), one epoch
SERVICE_SAMPLES = (128, 64)
#: the REST legs: rounds of concurrent single requests, clients a round
#: (list codec, then base64); the hand-written entry's control leg; the
#: socket feed's samples
SERVICE_ROUNDS = 2
SERVICE_CLIENTS = 16
SERVICE_CONTROL_REQUESTS = 4
SERVICE_SOCKET_SAMPLES = 8
SERVICE_DEVICE = "cuda"
SERVICE_CLI_ARGS = ()
SERVICE_AUTOTUNE_ARGS = ()
SERVICE_WAIT_S = 300


def split_launches():
    """{kernel: Counter of launches by (M, K, N, dtype, [block depth,]
    form, splits)} of K1/K2 and K5 in this process so far."""
    from veles_tpu_torch.ops.gemm import kahan_gemm, linear_act
    return {"gemm_bias_act": collections.Counter(
                linear_act.launches_by_splits),
            "kahan_gemm": collections.Counter(
                kahan_gemm.launches_by_splits)}


def splits_since(before):
    """The launches of :func:`split_launches` since ``before``."""
    now = split_launches()
    return {name: now[name] - before.get(name, collections.Counter())
            for name in now}


def default_splits(name, key):
    """The split count the plan gives a launch key of
    :func:`split_launches` with no override (the general forms: 1)."""
    from veles_tpu_torch.ops.gemm import gemm_plan, kahan_plan
    if name == "kahan_gemm":
        m, k, n, dtype, bk, form, _ = key
        return 1 if form == "general" else \
            kahan_plan(m, n, k, bk, dtype).splits
    m, k, n, dtype, form, _ = key
    return 1 if form == "general" else gemm_plan(m, n, k, dtype).splits


def check_default_splits(label, launches):
    """Every K1/K2 and K5 launch of ``launches`` ran at its plan's own
    split count (no tuned count reached it); returns the totals."""
    off = {name: {repr(key): n for key, n in counter.items()
                  if key[-1] != default_splits(name, key)}
           for name, counter in launches.items()}
    off = {name: keys for name, keys in off.items() if keys}
    totals = {name: sum(counter.values())
              for name, counter in launches.items()}
    if off:
        raise AssertionError("%s: launches at a non-default split count: %s"
                             % (label, off))
    print("%s: every K1/K2 and K5 launch at its plan's own split count "
          "(%s)" % (label, ", ".join("%s %d" % kv
                                     for kv in sorted(totals.items()))))
    return totals


def parse_key(key):
    """``op|k=v|...`` (``autotune._key``) -> (op, {field: text})."""
    op, *fields = key.split("|")
    return op, dict(field.split("=", 1) for field in fields)


def tuned_split_count(torch, op, fields, config):
    """The split count a cache entry's plan launches at."""
    from veles_tpu_torch.ops.gemm import gemm_plan, kahan_plan
    m, n, k = (int(fields[f]) for f in ("m", "n", "k"))
    dtype = getattr(torch, fields["dtype"])
    splits = (config or {}).get("splits")
    if op == "gemm_kahan":
        return kahan_plan(m, n, k, int(fields["bk"]), dtype, True,
                          splits).splits
    return gemm_plan(m, n, k, dtype, True, splits).splits


def check_entries(torch, entries):
    """Every entry of the tuned cache against the plain version on the
    card, at the kernel phase's tolerances: K1/K2 ``linear_act`` at the
    entry's split count against ``linear_act_plain``, K5 ``kahan_gemm``
    against ``kahan_matmul_plain``. Returns {key: max |err|}."""
    from veles_tpu_torch.ops.gemm import (kahan_gemm, kahan_matmul_plain,
                                          linear_act, linear_act_plain)
    gen = torch.Generator(device=SERVICE_DEVICE).manual_seed(18)
    errors = {}
    for key, entry in sorted(entries.items()):
        op, fields = parse_key(key)
        m, n, k = (int(fields[f]) for f in ("m", "n", "k"))
        dt = getattr(torch, fields["dtype"])
        splits = (entry.get("config") or {}).get("splits")
        a = (torch.rand(m, k, device=SERVICE_DEVICE, generator=gen) * 2 -
             1).to(dt)
        b = ((torch.rand(k, n, device=SERVICE_DEVICE, generator=gen) * 2 -
              1) / k ** 0.5).to(dt)
        if op == "gemm_kahan":
            bk = int(fields["bk"])
            got = kahan_gemm(a, b, bk, splits=splits)
            want = kahan_matmul_plain(a, b, bk)
            tol = GEMM_TOL["float32"]
        else:
            bias = (torch.rand(n, device=SERVICE_DEVICE, generator=gen) *
                    0.2 - 0.1) if fields["bias"] == "1" else None
            got = linear_act(a, b, bias, fields["act"],
                             getattr(torch, fields["out"]), splits=splits)
            want = linear_act_plain(a, b, bias, fields["act"],
                                    getattr(torch, fields["out"]))
            tol = GEMM_TOL[fields["dtype"]]
        errors[key] = check_close("tuned %s x%s" % (key, splits), got, want,
                                  *tol)
        del a, b, got, want
    print("autotune entries: %d held to their plain versions, max |err| "
          "%.3g" % (len(errors), max(errors.values(), default=0.0)))
    return errors


def autotune_leg(torch, tmp, card):
    """``python -m veles_tpu_torch.ops.gemm_bench --autotune`` into a
    phase-owned cache, its table printed beside the split sweeps' times
    of the shared shapes; every entry held to the plain version; a fresh
    read of the file giving the same plans with no search. Returns
    (result, cache path, entries)."""
    import subprocess
    from veles_tpu_torch.ops import autotune
    path = os.path.join(tmp, "tuned.json")
    env = dict(os.environ, PYTHONPATH=REPO, VELES_AUTOTUNE="search",
               VELES_AUTOTUNE_CACHE=path,
               VELES_AUTOTUNE_BUDGET_S=SERVICE_BUDGET_S,
               VELES_AUTOTUNE_ITERS=SERVICE_ITERS)
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "veles_tpu_torch.ops.gemm_bench",
         "--autotune"] + list(SERVICE_AUTOTUNE_ARGS), env=env, cwd=tmp,
        capture_output=True, text=True, timeout=SERVICE_AUTOTUNE_S)
    wall = time.perf_counter() - t
    if out.returncode != 0:
        raise AssertionError("gemm_bench --autotune exited %d: %s%s" % (
            out.returncode, out.stdout[-4000:], out.stderr[-4000:]))
    print(out.stdout.strip())
    print("autotune leg (%s): %.1f s in a process of its own" % (card, wall))
    entries = dict(autotune.AutotuneCache(path).items())
    if not entries:
        raise AssertionError("gemm_bench --autotune persisted nothing")
    errors = check_entries(torch, entries)
    # a fresh read of the file, in cache mode: the same plans, no search
    with env_set(VELES_AUTOTUNE="cache", VELES_AUTOTUNE_CACHE=path):
        autotune.reset()
        before = autotune.summary()
        for key, entry in sorted(entries.items()):
            op, fields = parse_key(key)
            m, n, k = (int(fields[f]) for f in ("m", "n", "k"))
            dt = getattr(torch, fields["dtype"])
            if op == "gemm_kahan":
                got = autotune.gemm_plan(m, n, k, dt, level=1,
                                         bk=int(fields["bk"]),
                                         device=SERVICE_DEVICE)
            else:
                got = autotune.linear_plan(
                    m, n, k, dt, fields["act"], getattr(torch, fields["out"]),
                    fields["bias"] == "1", SERVICE_DEVICE)
            if got != (entry["impl"], entry.get("config")):
                raise AssertionError("fresh read of %s: %s, the file holds "
                                     "%s" % (key, got, entry))
        after = autotune.summary()
    autotune.reset()
    searches = after["searches"] - before["searches"]
    hits = after["hits"] - before["hits"]
    if searches or hits != len(entries):
        raise AssertionError("fresh read: %d searches, %d hits of %d "
                             "entries" % (searches, hits, len(entries)))
    print("autotune fresh read: %d plans as persisted, 0 searches" % hits)
    # the split sweeps' times of the shapes both measured
    beside = []
    for key, entry in sorted(entries.items()):
        op, fields = parse_key(key)
        shape = (int(fields["m"]), int(fields["k"]), int(fields["n"]),
                 fields["dtype"])
        sweeps = SWEPT.get(("kahan" if op == "gemm_kahan" else "k1",) +
                           shape)
        if sweeps:
            beside.append({"key": key, "tuned_ms": entry.get("candidate_ms"),
                           "sweep_ms": sweeps})
    for row in beside:
        print("autotune beside the sweep (%s): %s" % (card, json.dumps(row)))
    rows = {key: {"config": e.get("config"), "best_ms": e.get("best_ms"),
                  "baseline_ms": e.get("baseline_ms"),
                  "candidates": e.get("candidates"),
                  "split_count": tuned_split_count(
                      torch, parse_key(key)[0], parse_key(key)[1],
                      e.get("config")),
                  "default_split_count": tuned_split_count(
                      torch, parse_key(key)[0], parse_key(key)[1], None),
                  "max_abs_err": errors[key]}
            for key, e in entries.items()}
    return {"wall_s": wall, "entries": rows, "beside_sweeps": beside,
            "fresh_read_hits": hits}, path, entries


#: {("k1" | "kahan", M, K, N, dtype): {splits: ms}} of the kernel phase's
#: split sweeps, for the autotune leg's table
SWEPT = {}


def remember_sweeps(sweep, kahan):
    for kind, rows, shapes in (("k1", sweep, SWEEP_SHAPES),
                               ("kahan", kahan, KAHAN_SWEEP_SHAPES)):
        for row, (_, m, k, n, dtype) in zip(rows, shapes):
            SWEPT[(kind, m, k, n, dtype)] = row["ms"]


class FileServer(object):
    """A local ``http.server`` over ``directory`` on a thread; a request
    for ``cut`` gets half its body under the full Content-Length."""

    def __init__(self, directory, cut=None):
        import functools
        import http.server

        class Handler(http.server.SimpleHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if cut is None or not self.path.endswith("/" + cut):
                    return super(Handler, self).do_GET()
                size = os.path.getsize(os.path.join(directory, cut))
                self.send_response(200)
                self.send_header("Content-Length", str(size))
                self.end_headers()
                with open(os.path.join(directory, cut), "rb") as f:
                    self.wfile.write(f.read(size // 2))
                self.close_connection = True

        self.server = http.server.ThreadingHTTPServer(
            ("127.0.0.1", 0), functools.partial(Handler,
                                                directory=directory))
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def url(self, name):
        return "http://127.0.0.1:%d/%s" % (self.server.server_address[1],
                                           name)

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def params_differing(numpy, forwards, want):
    """Values of the restored (not initialized) forwards' parameters,
    in the JAX layout, that differ from ``want``'s."""
    n = 0
    for fwd, params in zip(forwards, want):
        got = fwd.__dict__.get("_params") or {}
        if sorted(got) != sorted(params):
            raise AssertionError("%s restored %s, expected %s" % (
                fwd.name, sorted(got), sorted(params)))
        n += sum(int((numpy.asarray(got[k]) != params[k]).sum())
                 for k in params)
    return n


def snapshot_stores(torch, numpy, tmp, card):
    """Phase 9's AlexNet-227 file through the CLI (``-s 7``, one epoch of
    :data:`SERVICE_SAMPLES`), its ``SnapshotterToFile`` export and a
    ``SnapshotterToDB`` export, then restores through ``SnapshotterToFile.
    import_`` from ``sqlite://db#key``, ``sqlite://db`` and a local
    ``http://`` server: 0 parameter values differing each; a missing key
    and a body cut short must fail. Returns (result, a restored workflow,
    launches_by_form of the run)."""
    import sqlite3

    from veles_tpu_torch import prng
    from veles_tpu_torch.convert import layer_params, to_jax_layout
    from veles_tpu_torch.snapshotter import (SnapshotterToDB,
                                             SnapshotterToFile)
    source = WORKFLOW_FILE.replace(
        "n_train=%d, n_valid=%d" % (TRAIN_SAMPLES, TRAIN_BATCH),
        "n_train=%d, n_valid=%d" % SERVICE_SAMPLES)
    if source == WORKFLOW_FILE:
        raise AssertionError("phase 9's file has no sample counts to cut")
    path = os.path.join(tmp, "alexnet_service.py")
    with open(path, "w") as f:
        f.write(source)
    snaps = os.path.join(tmp, "snapshots")
    prng._generators.clear()
    reset_counts()
    t = time.perf_counter()
    main = workflow_cli(path, "-s", "7", "--precision", "float32",
                        "root.smoke.epochs=1", "root.smoke.momentum=0.9",
                        "root.smoke.snapshots=%r" % snaps,
                        *SERVICE_CLI_ARGS)
    run_s = time.perf_counter() - t
    forms = read_counts()[1]
    wf = main.workflow
    want = [to_jax_layout(layer_params(f.module)) for f in wf.forwards]
    (to_file,) = [u for u in wf if isinstance(u, SnapshotterToFile)]
    file_s, nbytes = to_file.exports[-1]
    name = os.path.basename(to_file.destination)
    database = os.path.join(tmp, "snapshots.db")
    to_db = SnapshotterToDB(wf, database=database, compression="",
                            name="db_snapshotter")
    to_db.export()
    wf.del_ref(to_db)
    db_s, db_bytes = to_db.exports[-1]
    conn = sqlite3.connect(database)
    try:
        limit = conn.getlimit(sqlite3.SQLITE_LIMIT_LENGTH)
    finally:
        conn.close()
    key = to_db.destination.split("#", 1)[1]
    del main, wf, to_file
    torch.cuda.empty_cache()
    result = {"cli_run_s": run_s, "snapshot_mib": nbytes / 1048576.0,
              "file_export_s": file_s, "db_export_s": db_s,
              "db_payload_bytes": db_bytes,
              "sqlite_limit_length": limit, "restores": {}}
    print("service snapshot (%s): %.1f MiB; SnapshotterToFile %.3f s, "
          "SnapshotterToDB %.3f s (%d bytes a row; SQLITE_LIMIT_LENGTH %d)"
          % (card, result["snapshot_mib"], file_s, db_s, db_bytes, limit))
    files = FileServer(snaps)
    cut = FileServer(snaps, cut=name)
    restored = None
    try:
        for label, uri in (("sqlite_key", "sqlite://%s#%s" % (database,
                                                               key)),
                           ("sqlite_newest", "sqlite://%s" % database),
                           ("http", files.url(name))):
            prng._generators.clear()
            t = time.perf_counter()
            wf = SnapshotterToFile.import_(uri)
            seconds = time.perf_counter() - t
            differing = params_differing(numpy, wf.forwards, want)
            result["restores"][label] = {"s": seconds,
                                         "differing": differing}
            print("service restore %s (%s): %.3f s, %d parameter values "
                  "differ" % (uri, card, seconds, differing))
            if differing:
                raise AssertionError("restore from %s differs" % uri)
            restored = wf
        for label, uri in (("missing key", "sqlite://%s#%s.none" % (
                database, key)), ("cut body", cut.url(name))):
            try:
                SnapshotterToFile.import_(uri)
            except Exception as e:  # noqa: BLE001 -- the control's point
                result["control_" + label.replace(" ", "_")] = \
                    type(e).__name__
                print("service restore control %s: %s (%s)" % (
                    label, type(e).__name__, str(e)[:120]))
            else:
                raise AssertionError("the %s control restored a workflow"
                                     % label)
    finally:
        files.close()
        cut.close()
    return result, restored, forms


def service_graph(torch, forwards, make_loader, make_tail):
    """A fresh service workflow: Repeater -> ``make_loader(wf)`` ->
    ``forwards`` (moved out of wherever they were) -> ``make_tail(wf,
    loader)`` -> the repeater, initialized on the card. Returns
    (workflow, loader, tail)."""
    from veles_tpu_torch.accelerated_units import AcceleratedWorkflow
    from veles_tpu_torch.plumbing import Repeater
    wf = AcceleratedWorkflow(name="service")
    repeater = Repeater(wf)
    repeater.link_from(wf.start_point)
    loader = make_loader(wf)
    loader.link_from(repeater)
    prev, attr = loader, "minibatch_data"
    for fwd in forwards:
        fwd.unlink_all()
        fwd.workflow = wf
        fwd.link_from(prev)
        fwd.link_attrs(prev, ("input", attr))
        prev, attr = fwd, "output"
    tail = make_tail(wf, loader)
    tail.link_from(prev)
    tail.link_attrs(prev, ("input", "output"))
    repeater.link_from(tail)
    wf.initialize(device=SERVICE_DEVICE)
    return wf, loader, tail


def check_tuned_splits(torch, label, launches, tuned):
    """Every K1 launch of ``launches`` ran at the split count of its
    shape's entry in ``tuned`` ({key: entry}), and it launched; returns
    {repr(launch key): n}."""
    from veles_tpu_torch.ops import autotune
    k1 = launches["gemm_bias_act"]
    if not sum(k1.values()) or sum(launches["kahan_gemm"].values()):
        raise AssertionError("%s: K1 launches %s, K5 %s" % (
            label, dict(k1), dict(launches["kahan_gemm"])))
    for (m, k, n, dtype, form, splits), count in k1.items():
        key = autotune._key("linear", m=m, n=n, k=k,
                            dtype=autotune._dtype_name(dtype),
                            act="strict_relu",
                            out=autotune._dtype_name(dtype), bias=1)
        if key not in tuned:
            raise AssertionError("%s: %d K1 launches at %s, which the "
                                 "tuner holds no entry for" % (
                                     label, count, key))
        want = tuned_split_count(torch, "linear", parse_key(key)[1],
                                 tuned[key].get("config"))
        if splits != want:
            raise AssertionError("%s: %d K1 launches of %s at x%d, its "
                                 "entry x%d" % (label, count, key, splits,
                                                want))
    print("%s: every K1 launch at its cache entry's split count: %s" % (
        label, ", ".join("%dx%dx%d %s x%d: %d" % (m, k, n, form, s, c)
                         for (m, k, n, _, form, s), c in sorted(
                             k1.items(), key=repr))))
    return {repr(key): n for key, n in k1.items()}


def rest_leg(torch, numpy, forwards, label, minibatch, rounds, clients,
             tuned, seed):
    """``forwards`` behind ``RestfulLoader`` and ``RESTfulAPI`` (``batch
    size`` linked to the loader's when ``minibatch`` > 1): ``rounds`` of
    ``clients`` concurrent single requests, the list codec then base64;
    the replies held to the plain forward by :func:`check_replies` with a
    swapped pair and a zeroed fc7 as controls; K1 and K3 twice a
    forward, no other kernel, every K1 launch at its tuned split count.
    Returns (result, launches_by_form)."""
    from veles_tpu_torch.loader.restful import RestfulLoader
    from veles_tpu_torch.models.alexnet import ALEXNET_SAMPLE_SHAPE
    from veles_tpu_torch.models.build import plain_forward
    from veles_tpu_torch.restful_api import RESTfulAPI
    shape = tuple(ALEXNET_SAMPLE_SHAPE)

    def make_api(wf, loader):
        api = RESTfulAPI(wf, port=0, host="127.0.0.1",
                         response_timeout=SERVICE_WAIT_S)
        api.feed = loader.feed
        if minibatch > 1:
            api.link_attrs(loader, ("batch_size", "minibatch_size"))
        return api

    wf, loader, api = service_graph(
        torch, forwards, lambda wf: RestfulLoader(
            workflow=wf, sample_shape=shape, feed_timeout=SERVICE_WAIT_S,
            minibatch_size=minibatch), make_api)
    rng = numpy.random.RandomState(seed)
    samples = rng.uniform(-1, 1, (rounds, clients) + shape).astype(
        numpy.float32)
    bodies = [[(json.dumps({"input": s.tolist(), "codec": "list",
                            "id": i}).encode() if r % 2 == 0 else
                b64_body(s, id=i)) for i, s in enumerate(samples[r])]
              for r in range(rounds)]
    before = split_launches()
    reset_counts()
    calls0 = forwards[0].run_calls
    thread = threading.Thread(target=wf.run, daemon=True)
    thread.start()
    latencies, served, walls, per_round = [], [], [], []
    try:
        for r in range(rounds):
            c0 = forwards[0].run_calls
            got, lat, wall = concurrent_posts(api.port, bodies[r])
            for i, reply in enumerate(got):
                if reply.get("id") != i:
                    raise AssertionError("%s: reply %d echoes id %s" % (
                        label, i, reply.get("id")))
            served += [reply["result"] for reply in got]
            latencies += lat
            walls.append(wall)
            per_round.append(forwards[0].run_calls - c0)
    finally:
        loader.finish()
        thread.join(timeout=SERVICE_WAIT_S)
        api.stop()
    if thread.is_alive():
        raise AssertionError("%s: the service workflow did not end" % label)
    forwards_run = forwards[0].run_calls - calls0
    counts, by_form = read_counts()
    expected = dict.fromkeys(kernel_counters(), 0)
    expected.update(gemm_bias_act=2 * forwards_run, lrn_fwd=2 * forwards_run)
    if counts != expected:
        raise AssertionError("%s: launch counts %s over %d forwards, "
                             "expected %s" % (label, counts, forwards_run,
                                              expected))
    splits = check_tuned_splits(torch, label, splits_since(before), tuned)
    model = torch.nn.Sequential(*[f.module for f in forwards])
    inputs = samples.reshape((-1,) + shape)
    want = forward_rows(torch, numpy, lambda x: plain_forward(model, x),
                        inputs)
    served = numpy.array(served, numpy.float64)
    swapped = served.copy()
    swapped[[0, 1]] = served[[1, 0]]
    fc7 = max(i for i, f in enumerate(forwards)
              if type(f).__name__ == "All2AllStrictRELU")
    zeroed = forward_rows(torch, numpy, lambda x: forward_zeroing(
        model, x, fc7), inputs)
    err, spread, controls = check_replies(
        numpy, label, served, want, (("swapped", swapped),
                                     ("fc7_zeroed", zeroed)))
    lat = sorted(latencies)
    result = {"minibatch": minibatch, "requests": len(lat),
              "p50_ms": 1e3 * statistics.median(lat),
              "p95_ms": 1e3 * lat[min(len(lat) - 1, int(0.95 * len(lat)))],
              "rounds_s": walls, "forwards_per_round": per_round,
              "forwards": forwards_run, "launches_by_splits": splits,
              "centred_logit_err": err, "spread": spread,
              "controls": controls}
    print("%s: p50 %.1f ms, p95 %.1f ms, forwards per round %s" % (
        label, result["p50_ms"], result["p95_ms"], per_round))
    del wf, loader, api
    return result, by_form


def socket_leg(torch, numpy, forwards, tuned):
    """``forwards`` behind ``SocketFedLoader``: a producer sends
    :data:`SERVICE_SOCKET_SAMPLES` samples and one of the wrong shape
    over TCP (that one acked with an error), then ``finish``, which ends
    the workflow; the rows a tail unit collected held to the plain
    forward. Returns (result, launches_by_form)."""
    import socket

    from veles_tpu_torch.models.alexnet import ALEXNET_SAMPLE_SHAPE
    from veles_tpu_torch.models.build import plain_forward
    from veles_tpu_torch.units import Unit
    from veles_tpu_torch.zmq_loader import SocketFedLoader
    shape = tuple(ALEXNET_SAMPLE_SHAPE)

    class Rows(Unit):
        """Collects the valid rows of each forward."""

        def __init__(self, workflow, **kwargs):
            super(Rows, self).__init__(workflow, **kwargs)
            self.input = None
            self.size = 0
            self.rows = []
            self.demand("input")

        def run(self):
            self.rows.extend(self.input[:int(self.size)].float().cpu()
                             .numpy())

    def make_tail(wf, loader):
        rows = Rows(wf, name="rows")
        rows.link_attrs(loader, ("size", "minibatch_size"))
        return rows

    wf, loader, rows = service_graph(
        torch, forwards, lambda wf: SocketFedLoader(
            workflow=wf, sample_shape=shape, feed_timeout=SERVICE_WAIT_S),
        make_tail)
    samples = numpy.random.RandomState(20).uniform(
        -1, 1, (SERVICE_SOCKET_SAMPLES,) + shape).astype(numpy.float32)
    lines = [json.dumps({"data": s.tolist()}).encode() for s in samples]
    lines.insert(3, json.dumps({"data": [1.0, 2.0]}).encode())
    lines.append(b'{"cmd": "finish"}')
    before = split_launches()
    reset_counts()
    thread = threading.Thread(target=wf.run, daemon=True)
    thread.start()
    acks = []
    try:
        with socket.create_connection(tuple(loader.address),
                                      timeout=SERVICE_WAIT_S) as sock:
            f = sock.makefile("rwb")
            for line in lines:
                f.write(line + b"\n")
                f.flush()
                acks.append(json.loads(f.readline()))
        thread.join(timeout=SERVICE_WAIT_S)
    finally:
        loader.stop_serving()
    if thread.is_alive():
        raise AssertionError("socket feed: finish did not end the workflow")
    bad = [i for i, a in enumerate(acks) if "error" in a]
    if bad != [3] or acks[-1] != {"ok": True, "finished": True} or \
            len(acks) != len(lines):
        raise AssertionError("socket feed acks %s" % acks)
    counts, by_form = read_counts()
    splits = check_tuned_splits(torch, "socket feed", splits_since(before),
                                tuned)
    if counts["gemm_bias_act"] != 2 * len(samples):
        raise AssertionError("socket feed: K1 launched %d times for %d "
                             "samples" % (counts["gemm_bias_act"],
                                          len(samples)))
    model = torch.nn.Sequential(*[f.module for f in forwards])
    want = forward_rows(torch, numpy, lambda x: plain_forward(model, x),
                        samples)
    served = numpy.array(rows.rows, numpy.float64)
    swapped = served.copy()
    swapped[[0, 1]] = served[[1, 0]]
    err, spread, controls = check_replies(
        numpy, "socket feed", served, want, (("swapped", swapped),))
    return {"samples": len(samples), "error_acks": bad,
            "launches_by_splits": splits, "centred_logit_err": err,
            "spread": spread, "controls": controls}, by_form


def service_phase(torch, numpy, kernels, card, outside):
    """Phase 18: the autotune leg, the snapshot stores, the REST service
    and the socket feed (see the module's docstring). ``outside``: the
    K1/K5 launches by split count of the script so far, the sweeps'
    left out. Returns (result, [launches_by_form])."""
    import shutil
    import tempfile
    from veles_tpu_torch.ops import autotune
    tmp = tempfile.mkdtemp(prefix="veles-service-")
    try:
        result = {"outside_phase_18": check_default_splits(
            "before phase 18", outside)}
        result["autotune"], tuned_path, tuned = autotune_leg(torch, tmp,
                                                             card)
        result["stores"], restored, forms_run = snapshot_stores(
            torch, numpy, tmp, card)
        check_forms("service snapshot run", kernels, forms_run)
        forwards = list(restored.forwards)
        del restored
        all_forms = [forms_run]
        with env_set(VELES_AUTOTUNE="cache",
                     VELES_AUTOTUNE_CACHE=tuned_path):
            autotune.reset()
            try:
                for name, minibatch, seed in (("rest_mb1", 1, 181),
                                              ("rest_mb16", 16, 182)):
                    result[name], forms = rest_leg(
                        torch, numpy, forwards, "service " + name,
                        minibatch, SERVICE_ROUNDS, SERVICE_CLIENTS, tuned,
                        seed)
                    all_forms.append(forms)
                # the control: a hand-written entry at a valid count that
                # is neither the default nor the tuned one must be the
                # count the launches run at
                key = autotune._key("linear", m=1, n=4096, k=4096,
                                    dtype="float32", act="strict_relu",
                                    out="float32", bias=1)
                fields = parse_key(key)[1]
                taken = {tuned_split_count(torch, "linear", fields, None),
                         tuned_split_count(torch, "linear", fields,
                                           tuned[key].get("config"))}
                hand = next(s for s in autotune.SPLIT_LADDER
                            if tuned_split_count(torch, "linear", fields, {
                                "splits": s}) not in taken)
                control = dict(tuned, **{key: {"impl": "kernel",
                                               "config": {"splits": hand}}})
                autotune.get_cache().put(key, control[key])
                result["hand_entry"], forms = rest_leg(
                    torch, numpy, forwards, "service hand-written entry",
                    1, 1, SERVICE_CONTROL_REQUESTS, control, 183)
                result["hand_entry"]["splits"] = hand
                all_forms.append(forms)
                result["socket"], forms = socket_leg(torch, numpy,
                                                     forwards, control)
                all_forms.append(forms)
            finally:
                autotune.reset()
        for forms in all_forms[1:]:
            check_forms("service", kernels, forms)
        del forwards
        torch.cuda.empty_cache()
        return result, all_forms
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 19: the observed run. AlexNet-227 at full width through the CLI
#: (``-s 7``), 128 training samples and no validation class (the
#: confusion comes from ``FusedTrainer.confusion_segment``), 2 epochs
OBSERVE_SAMPLES = 128
OBSERVE_EPOCHS = 2
#: single requests served from the last snapshot
OBSERVE_REQUESTS = 8
#: AlexNet's layers with weights: 5 convolutions, 3 fully connected
OBSERVE_TRAINED_LAYERS = 8
#: seconds the CLI run may take, and its start-up until the graphics
#: endpoint is written
OBSERVE_RUN_S = 600
#: what the run adds to its argv (nothing on the card; a rehearsal on the
#: CPU gives ``-a cpu``) and the device of the script's own tensors
OBSERVE_CLI_ARGS = ()
OBSERVE_DEVICE = "cuda"

#: phase 19's workflow file: phase 9's AlexNet-227 cut to
#: ``OBSERVE_SAMPLES`` training samples and no validation class, a raw
#: snapshot every epoch into ``root.obs.dir``, ``add_plotters()``, a
#: ``Publisher`` after the plot chain with the backends ``root.obs.
#: backends`` names, and ``Observed``: at ``initialize()`` it writes the
#: graphics endpoint and the launcher's ids to ``root.obs.dir`` and holds
#: the run until ``root.obs.subscribers`` renderers subscribed; its
#: results carry the epoch history. Deterministic under
#: SMOKE_DETERMINISTIC=1; after the run it writes the runner's epoch
#: times, the graphics server's counts and, under SMOKE_KERNEL_REPORT,
#: the process's kernel launches
OBSERVE_WORKFLOW_FILE = """
import json
import os

import torch

from veles_tpu_torch.config import root
from veles_tpu_torch.models.alexnet import (ALEXNET_LAYERS,
                                            AlexNetWorkflow,
                                            SyntheticImageLoader)
from veles_tpu_torch.publishing import Publisher
from veles_tpu_torch.result_provider import IResultProvider
from veles_tpu_torch.snapshotter import SnapshotterToFile
from veles_tpu_torch.units import Unit


class Observed(Unit, IResultProvider):
    view_group = "SERVICE"

    def initialize(self, **kwargs):
        launcher = self.launcher
        if not hasattr(launcher, "plots_endpoints"):
            return      # restored outside a run
        server = launcher._graphics_server
        # written whole, then renamed: a reader sees all of it or nothing
        path = os.path.join(root.obs.dir, "endpoint.json")
        with open(path + ".tmp", "w") as f:
            json.dump({"endpoints": server.endpoints if server else None,
                       "id": launcher.id, "log_id": launcher.log_id}, f)
        os.replace(path + ".tmp", path)
        if server is not None and not server.wait_for_subscribers(
                root.obs.subscribers, 300):
            raise RuntimeError("no renderer subscribed")

    def run(self):
        pass

    def get_metric_values(self):
        return {"epoch_history": [
            {k: v["normalized"] for k, v in h.items()
             if isinstance(v, dict) and "normalized" in v}
            for h in self.workflow.decision.epoch_history]}


if os.environ.get("SMOKE_DETERMINISTIC") == "1":
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)


def run(load, main):
    wf, restored = load(
        AlexNetWorkflow,
        loader_factory=lambda wf: SyntheticImageLoader(
            workflow=wf, n_train=%d, n_valid=0, minibatch_size=%d),
        layers=ALEXNET_LAYERS, max_epochs=%d, learning_rate=0.01,
        momentum=0.9, weights_decay=5e-4)
    snap = SnapshotterToFile(wf, compression="", time_interval=0,
                             name="snapshotter")
    snap.link_from(wf.decision)
    snap.gate_skip = ~wf.loader.epoch_ended
    snap.directory = root.obs.dir
    wf.add_plotters()
    pub = Publisher(wf, backends={
        name: {"file": os.path.join(root.obs.dir, "report." + ext)}
        for name, ext in (("markdown", "md"), ("pdf", "pdf"))
        if name in root.obs.backends})
    pub.link_from(wf.plotters[-1])
    pub.gate_block = ~wf.decision.complete
    Observed(wf, name="observed")
    main()
    launcher = wf.workflow
    if launcher.runner is None:
        return      # a dry run
    server = launcher._graphics_server
    with open(os.path.join(root.obs.dir, "run.json"), "w") as f:
        json.dump({"epoch_times": launcher.runner.epoch_times,
                   "graphics": server.stats() if server else None,
                   "snapshot_bytes": list(server.snapshot_bytes)
                   if server else []}, f, default=str)
    reports = os.environ.get("SMOKE_KERNEL_REPORT")
    if reports:
        from veles_tpu_torch.ops import launch_report
        os.makedirs(reports, exist_ok=True)
        with open(os.path.join(reports, "%%d.json" %% os.getpid()),
                  "w") as f:
            json.dump(launch_report(), f)
""" % (OBSERVE_SAMPLES, TRAIN_BATCH, OBSERVE_EPOCHS)


def importable(name):
    import importlib.util
    return importlib.util.find_spec(name) is not None


def observed_overrides(tmp, dashboard, subscribers, backends):
    return ["root.obs.dir=%r" % tmp, "root.obs.subscribers=%d" % subscribers,
            "root.obs.backends=%r" % (backends,),
            "root.common.disable.plotting=False",
            "root.common.web.host='127.0.0.1'",
            "root.common.web.port=%d" % dashboard.port,
            "root.common.web.notification_interval=0.2"]


def observed_run(tmp, dashboard, renderers):
    """The CLI run of phase 19 in a process of its own, watched: the
    script subscribes to its graphics server (and a ``graphics_client``
    renders PNGs where matplotlib imports). Returns (snapshots received,
    the endpoint file, wall s, start-up s, the run's log path)."""
    import pickle
    import subprocess
    import zlib
    from veles_tpu_torch.graphics_server import TOPIC_END, Subscription
    path = os.path.join(tmp, "observed.py")
    with open(path, "w") as f:
        f.write(OBSERVE_WORKFLOW_FILE)
    backends = [name for name, module in (("markdown", "jinja2"),
                                          ("pdf", "matplotlib"))
                if renderers[module]]
    subscribers = 2 if renderers["matplotlib"] else 1
    argv = [sys.executable, "-m", "veles_tpu_torch", path, "-s", "7",
            "--web-status", "--result-file",
            os.path.join(tmp, "results.json")] + list(OBSERVE_CLI_ARGS) + \
        observed_overrides(tmp, dashboard, subscribers, backends)
    env = dict(os.environ, PYTHONPATH=REPO, SMOKE_DETERMINISTIC="1",
               SMOKE_KERNEL_REPORT=os.path.join(tmp, "kernels"))
    log = os.path.join(tmp, "observed.log")
    endpoint_file = os.path.join(tmp, "endpoint.json")
    t0 = time.perf_counter()
    client = None
    with open(log, "w") as out:
        proc = subprocess.Popen(argv, env=env, cwd=tmp, stdout=out,
                                stderr=subprocess.STDOUT)
    try:
        while not os.path.exists(endpoint_file):
            if proc.poll() is not None or \
                    time.perf_counter() - t0 > OBSERVE_RUN_S:
                raise AssertionError("observed run: no endpoint (exit %s)"
                                     % proc.poll())
            time.sleep(0.05)
        startup_s = time.perf_counter() - t0
        with open(endpoint_file) as f:
            endpoint = json.load(f)
        tcp = endpoint["endpoints"]["tcp"]
        subscription = Subscription(tcp)
        if renderers["matplotlib"]:
            client = subprocess.Popen(
                [sys.executable, "-m", "veles_tpu_torch.graphics_client",
                 "--endpoint", tcp, "--mode", "png", "--out",
                 os.path.join(tmp, "png")],
                env=dict(os.environ, PYTHONPATH=REPO,
                         CUDA_VISIBLE_DEVICES=""), cwd=tmp)
            os.makedirs(os.path.join(tmp, "png"), exist_ok=True)
        snapshots = []
        while True:
            message = subscription.get(OBSERVE_RUN_S)
            if message is None:
                raise AssertionError("observed run: no snapshot for %d s"
                                     % OBSERVE_RUN_S)
            topic, payload = message
            if topic == TOPIC_END:
                break
            snapshots.append(pickle.loads(zlib.decompress(payload)))
        subscription.close()
        code = proc.wait(timeout=OBSERVE_RUN_S)
        wall_s = time.perf_counter() - t0
        if client is not None and client.wait(timeout=60) != 0:
            raise AssertionError("graphics_client exited %d"
                                 % client.returncode)
    finally:
        for p in (proc, client):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
    if code != 0:
        with open(log, errors="replace") as f:
            raise AssertionError("observed run exited %d:\n%s"
                                 % (code, f.read()[-4000:]))
    return snapshots, endpoint, wall_s, startup_s, log


def dashboard_checks(dashboard, endpoint, units):
    """(3): the run listed (its id, mode ``standalone``, ``units`` units),
    its publisher's record among its session's logs, its workflow's
    ``run`` begin and end among its events."""
    got = dashboard.receive_request({
        "request": "workflows", "args": ["mode", "units", "name"]})
    entry = got["result"].get(endpoint["id"])
    logs = dashboard.receive_request({
        "request": "logs", "find": {"session": endpoint["log_id"]}})
    published = [r["message"] for r in logs["result"]
                 if r["message"].startswith("publishing the results")]
    events = dashboard.receive_request({
        "request": "events", "find": {"session": endpoint["log_id"],
                                      "name": "run"}})["result"]
    run_events = [e["type"] for e in events
                  if e["instance"].startswith("AlexNetWorkflow@")]
    checks = {"listed": entry == {"mode": "standalone", "units": units,
                                  "name": "AlexNetWorkflow"},
              "publisher_logged": len(published) == 1,
              "run_begin_end": run_events == ["begin", "end"]}
    result = {"entry": entry, "logs": len(logs["result"]),
              "published": published, "run_events": run_events,
              "checks": checks}
    print("observers dashboard: %s" % json.dumps(result))
    if not all(checks.values()):
        raise AssertionError("observers dashboard: %s" % result)
    return result


def curve_checks(snapshots, history):
    """(2a): every epoch-curve snapshot holds the result file's history
    up to its epoch; returns the values differing (0)."""
    seen, differing = {}, 0
    for snap in snapshots:
        if type(snap).__name__ != "EpochMetricPlotter":
            continue
        i = seen[snap.name] = seen.get(snap.name, -1) + 1
        want = [h[snap.klass] for h in history[:i + 1] if snap.klass in h]
        differing += sum(1 for g, w in zip(snap.values, want) if g != w)
        differing += abs(len(snap.values) - len(want))
    if seen.get("train n_err_pt") != OBSERVE_EPOCHS - 1 or differing:
        raise AssertionError("observers curves: %s snapshots, %d values "
                             "differ" % (seen, differing))
    return {"curve_snapshots": {k: v + 1 for k, v in seen.items()},
            "curve_values_differing": differing}


def confusion_checks(torch, numpy, snapshot, matrix):
    """(2b-d): the last snapshot restored in this process; the confusion
    recomputed by ``confusion_segment`` on the card (deterministic, as
    the run) against the run's last plotted ``matrix``, with the truth
    shifted by one row as the control of the truth, and with fc8's
    classes rolled by one as the control of the forward (the matrix must
    move; with the weights restored it must come back); the same sweep
    against numpy's matrix of the forward's argmaxes, every row's
    top-two logit gap above 0 (no tie for the argmax to break), and the
    count of classes predicted printed: under the filler's flat softmax
    every argmax may land on one class, and then (b) holds one column;
    those logits held to the plain versions by the centred-logit check.
    Returns (result, the launches by form of the sweeps)."""
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.loader.base import TRAIN
    from veles_tpu_torch.nn.all2all import All2AllSoftmax
    from veles_tpu_torch.snapshotter import SnapshotterToFile
    from veles_tpu_torch.train.runner import trainer_for
    warned = []
    wf = SnapshotterToFile.import_(snapshot)
    wf.workflow = DummyLauncher()
    with deterministic(torch, warned):
        wf.initialize(device=torch.device(OBSERVE_DEVICE))
        trainer = trainer_for(wf)
        idx = trainer._segment_indices(TRAIN)
        reset_counts()
        conf = trainer.confusion_segment(None, idx).cpu().numpy()
        counts, forms = read_counts()
        kernel, plain, zeroed, truth = [], [], [], []
        k1 = [i for i, m in enumerate(trainer.forwards)
              if type(m).__name__.startswith("All2All") and
              not isinstance(m, All2AllSoftmax)]
        with torch.no_grad():
            for row in idx:
                x, labels, valid = trainer._gather(
                    torch.from_numpy(row).to(trainer.device))
                kernel.append(trainer._forward(x, False)[valid])
                trainer.plain = True
                plain.append(trainer._forward(x, False)[valid])
                trainer.plain = False
                zeroed.append(forward_zeroing(trainer.forwards, x,
                                              k1[-1])[valid])
                truth.append(labels[valid])
        forms = read_counts()[1]
        # the forward's control: fc8's classes rolled by one (its weight
        # rows and bias) move every argmax one column, so the matrix must
        # move with them; then the weights go back and the sweep again
        # gives the run's matrix
        params = trainer.pull_params()[0]
        rolled = [dict(layer) for layer in params]
        bias = rolled[-1]["bias"]
        rolled[-1] = {k: torch.roll(v, 1, dims=[
            d for d, n in enumerate(v.shape) if n == bias.shape[0]][0])
            for k, v in rolled[-1].items()}
        fc8_rolled = trainer.confusion_segment(rolled, idx).cpu().numpy()
        restored = trainer.confusion_segment(params, idx).cpu().numpy()
        # the truth's control: shifted by one row of the matrix (each
        # sample's label + 1; rolling the samples' labels instead would
        # leave the matrix alone when every argmax is one class)
        loader = wf.loader
        loader.original_labels = torch.remainder(
            loader.original_labels + 1, conf.shape[0]).to(
            loader.original_labels.dtype)
        loader.release_staged()
        shifted = trainer_for(wf).confusion_segment(None, idx).cpu().numpy()
    logits = torch.cat(kernel).float().cpu().numpy()
    truth = torch.cat(truth).cpu().numpy()
    argmax = numpy.zeros(conf.shape, numpy.int32)
    numpy.add.at(argmax, (truth, logits.argmax(axis=1)), 1)
    # each row's top-two gap: (c) means something only where the argmax
    # is not a tie; the classes predicted say how many columns (b) holds
    top2 = numpy.sort(logits, axis=1)[:, -2:]
    gaps = top2[:, 1] - top2[:, 0]
    spreads = logits.max(axis=1) - logits.min(axis=1)

    def probs(t):
        return torch.softmax(t.float(), dim=1).cpu().numpy()

    kernel_p, plain_p = probs(torch.cat(kernel)), probs(torch.cat(plain))
    swapped = kernel_p.copy()
    swapped[[0, 1]] = kernel_p[[1, 0]]
    err, spread, shares = check_replies(
        numpy, "observers confusion logits", kernel_p, plain_p,
        [("swapped", swapped),
         ("fc7_zeroed", torch.cat(zeroed).float().cpu().numpy())])
    result = {
        "matrix_sum": int(matrix.sum()),
        "recomputed_cells_differing": int((conf != matrix).sum()),
        "shifted_truth_cells_differing": int((shifted != matrix).sum()),
        "fc8_rolled_cells_differing": int((fc8_rolled != matrix).sum()),
        "fc8_rolled_is_columns_rolled": bool(
            (fc8_rolled == numpy.roll(conf, 1, axis=1)).all()),
        "restored_cells_differing": int((restored != conf).sum()),
        "argmax_cells_differing": int((argmax != conf).sum()),
        "predicted_classes": int(len(numpy.unique(logits.argmax(axis=1)))),
        "top2_gap_min": float(gaps.min()),
        "top2_gap_median": float(numpy.median(gaps)),
        "logit_spread_median": float(numpy.median(spreads)),
        "sweep_launches": counts, "centred_logit_err": err,
        "centred_logit_spread": spread, "control_shares": shares,
        "nondeterministic_ops": warned}
    print("observers confusion: %s" % json.dumps(result))
    if result["matrix_sum"] != OBSERVE_SAMPLES or \
            result["recomputed_cells_differing"] or \
            not result["shifted_truth_cells_differing"] or \
            not result["fc8_rolled_cells_differing"] or \
            result["restored_cells_differing"] or \
            result["argmax_cells_differing"] or \
            not result["top2_gap_min"] > 0 or \
            not counts.get("gemm_bias_act") or not counts.get("lrn_fwd"):
        raise AssertionError("observers confusion: %s" % result)
    del wf, trainer
    return result, forms


def observed_serving(torch, numpy, dashboard, snapshot):
    """(3): the last snapshot behind ``ServingFrontend`` reporting to the
    dashboard; ``OBSERVE_REQUESTS`` single requests, their replies held
    to the plain forward by the centred-logit check with its controls;
    the dashboard's serving block counts them (its queries a second over
    the metrics' window). Returns (result, launches by form)."""
    from veles_tpu_torch.models.build import plain_forward
    from veles_tpu_torch.nn.all2all import All2AllSoftmax
    from veles_tpu_torch.serving.frontend import ServingFrontend
    from veles_tpu_torch.serving.model_store import ModelStore
    model = ModelStore().load(snapshot, device=OBSERVE_DEVICE)
    frontend = ServingFrontend(model, host="127.0.0.1", port=0,
                               replicas=1, max_batch_size=8,
                               batch_timeout_ms=5.0, max_queue=64,
                               response_timeout=300.0).start()
    reporter = frontend.report_to("127.0.0.1:%d" % dashboard.port,
                                  interval=0.2, name="observed serving")
    window = frontend.metrics._qps_window
    rng = numpy.random.RandomState(19)
    inputs = rng.uniform(-1, 1, (OBSERVE_REQUESTS,) + tuple(
        model.sample_shape)).astype(numpy.float32)
    bodies = [json.dumps({"input": x.tolist(), "codec": "list",
                          "id": i}).encode() for i, x in enumerate(inputs)]
    try:
        reset_counts()
        replies, latencies, wall = concurrent_posts(frontend.port, bodies)
        counts, forms = read_counts()
        block, deadline = None, time.time() + 30
        while time.time() < deadline:
            entry = dashboard.receive_request({
                "request": "workflows",
                "args": ["serving"]})["result"].get(reporter.id)
            block = (entry or {}).get("serving")
            if block and round(block["qps"] * window) == OBSERVE_REQUESTS:
                break
            time.sleep(0.1)
    finally:
        frontend.stop()
    served = numpy.array([replies[i]["result"]
                          for i in range(OBSERVE_REQUESTS)])
    k1 = [i for i, m in enumerate(model.module)
          if type(m).__name__.startswith("All2All") and
          not isinstance(m, All2AllSoftmax)]
    want = forward_rows(torch, numpy, lambda x: plain_forward(
        model.module, x), inputs)
    swapped = served.copy()
    swapped[[0, 1]] = served[[1, 0]]
    zeroed = forward_rows(torch, numpy, lambda x: forward_zeroing(
        model.module, x, k1[-1]), inputs)
    err, spread, shares = check_replies(
        numpy, "observers serving", served, want,
        [("swapped", swapped), ("fc7_zeroed", zeroed)])
    counted = None if not block else round(block["qps"] * window)
    result = {"requests": OBSERVE_REQUESTS, "dashboard_counted": counted,
              "dashboard_block": block, "launches": counts,
              "p50_ms": 1e3 * statistics.median(latencies), "wall_s": wall,
              "centred_logit_err": err, "control_shares": shares}
    print("observers serving: %s" % json.dumps(result))
    if counted != OBSERVE_REQUESTS or not counts.get("gemm_bias_act"):
        raise AssertionError("observers serving: %s" % result)
    del model
    return result, forms


def snapshot_diffs(tmp):
    """(4): ``compare_snapshots.main()`` of the last snapshot against
    itself (every max diff 0) and of epoch 2 against epoch 1 (every
    trained layer's weights moved)."""
    import io
    from contextlib import redirect_stdout
    from veles_tpu_torch.scripts import compare_snapshots

    def table(first, second):
        out = io.StringIO()
        with redirect_stdout(out):
            if compare_snapshots.main(["-q", first, second]) != 0:
                raise AssertionError("compare_snapshots failed")
        rows = {}
        for line in out.getvalue().splitlines()[3:-1]:
            cells = [c.strip() for c in line.strip("|").split("|")]
            rows[(cells[0], cells[1])] = float(cells[4])
        return rows

    first, last = (os.path.join(tmp, "wf.%d.pickle" % e)
                   for e in (OBSERVE_EPOCHS - 2, OBSERVE_EPOCHS - 1))
    same = table(last, last)
    moved = table(first, last)
    weights = {unit: v for (unit, attr), v in moved.items()
               if attr == "weights"}
    result = {"self_max_diff": max(same.values()), "rows": len(same),
              "trained_layers": len(weights),
              "unmoved_layers": sorted(k for k, v in weights.items()
                                       if not v > 0),
              "weights_max_diff": weights}
    print("observers compare_snapshots: %s" % json.dumps(result))
    if result["self_max_diff"] != 0 or \
            len(weights) != OBSERVE_TRAINED_LAYERS or \
            result["unmoved_layers"]:
        raise AssertionError("observers compare_snapshots: %s" % result)
    return result


def report_checks(tmp, results, renderers):
    """(4): the report holds every value of the result file (the
    publisher's ``gather_info()`` results, as the markdown template
    prints them), and where matplotlib renders, each plotter's PNG and
    the PDF exist and are not empty. Returns the report's bytes by
    file."""
    out = {}
    if renderers["jinja2"]:
        with open(os.path.join(tmp, "report.md")) as f:
            text = f.read()
        section = text.split("## Results", 1)[1].split("\n## ", 1)[0]
        rows = dict(line.strip("|").split(" | ", 1) for line in
                    section.strip().splitlines()[2:])
        rows = {k.strip(): v.strip() for k, v in rows.items()}
        missing = {k: (rows.get(k), str(v)) for k, v in results.items()
                   if rows.get(k) != str(v)}
        if missing or len(rows) != len(results):
            raise AssertionError("observers report: rows differ from the "
                                 "result file: %s" % missing)
        out["report.md"] = len(text.encode())
    if renderers["matplotlib"]:
        for name in ("train_n_err_pt", "validation_n_err_pt", "confusion"):
            out["png/%s.png" % name] = os.path.getsize(
                os.path.join(tmp, "png", name + ".png"))
        out["report.pdf"] = os.path.getsize(os.path.join(tmp,
                                                         "report.pdf"))
        if not all(out.values()):
            raise AssertionError("observers renders: %s" % out)
    return out


def observers_phase(torch, numpy, kernels, card):
    """Phase 19 (see the module docstring). Returns (result,
    [launches_by_form])."""
    import shutil
    import tempfile
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.telemetry.registry import get_registry
    from veles_tpu_torch.web_status import WebStatusServer
    renderers = {m: importable(m) for m in ("matplotlib", "jinja2")}
    absent = [m for m, ok in renderers.items() if not ok]
    if absent:
        print("observers: %s does not import here: %s run only in the CPU "
              "tests (tests/test_torch_plotting.py, tests/test_torch_"
              "publisher.py, tests/test_torch_observers.py)" % (
                  " and ".join(absent), ", ".join(
                      {"matplotlib": "the graphics client, the PNGs and the "
                                     "PDF report",
                       "jinja2": "the markdown report"}[m]
                      for m in absent)))
    tmp = tempfile.mkdtemp(prefix="veles-observers-")
    t0 = time.perf_counter()
    dashboard = WebStatusServer(host="127.0.0.1", port=0).start()
    requests = get_registry().get("veles_webstatus_http_requests_total")
    before = {d["path"]: c.value for d, c in requests.series()}
    try:
        snapshots, endpoint, wall_s, startup_s, log = observed_run(
            tmp, dashboard, renderers)
        with open(os.path.join(tmp, "results.json")) as f:
            results = json.load(f)
        with open(os.path.join(tmp, "run.json")) as f:
            run = json.load(f)
        # the same file built here (not run) for its unit count
        main = Main()
        if main.run([os.path.join(tmp, "observed.py"), "-s", "7",
                     "--dry-run", "exec"] + observed_overrides(
                         tmp, dashboard, 0, [])) != 0:
            raise AssertionError("observers: the dry run failed")
        units = len(main.workflow.graph_description()["nodes"])
        del main
        result = {"run_wall_s": wall_s, "startup_s": startup_s,
                  "epochs": [{k: t.get(k) for k in (
                      "wall_s", "train_s", "confusion_s", "services_s")}
                      for t in run["epoch_times"]],
                  "graphics": run["graphics"],
                  "snapshot_bytes": run["snapshot_bytes"],
                  "renderers": renderers,
                  "dashboard": dashboard_checks(dashboard, endpoint, units)}
        result.update(curve_checks(snapshots, results["epoch_history"]))
        matrix = [s for s in snapshots
                  if type(s).__name__ == "MatrixPlotter"][-1].matrix
        last = os.path.join(tmp, "wf.%d.pickle" % (OBSERVE_EPOCHS - 1))
        result["confusion"], sweep_forms = confusion_checks(
            torch, numpy, last, matrix)
        result["report_bytes"] = report_checks(tmp, results, renderers)
        result["compare_snapshots"] = snapshot_diffs(tmp)
        torch.cuda.empty_cache()
        result["serving"], serve_forms = observed_serving(
            torch, numpy, dashboard, last)
        reports = kernel_reports(os.path.join(tmp, "kernels"))
        if len(reports) != 1:
            raise AssertionError("observers: %d kernel reports"
                                 % len(reports))
        run_forms = reported_forms("observed run", kernels,
                                   list(reports.values())[0],
                                   META_TRAIN_KERNELS)
        result["run_launches"] = {k: v["launches"] for k, v in
                                  list(reports.values())[0].items()}
        for label, forms in (("observers sweep", sweep_forms),
                             ("observers serving", serve_forms)):
            check_forms(label, kernels, forms)
        after = {d["path"]: c.value for d, c in requests.series()}
        result["dashboard_requests"] = {
            k: v - before.get(k, 0) for k, v in after.items()
            if v - before.get(k, 0)}
        result["phase_s"] = time.perf_counter() - t0
        print("observers: run %.1f s (start-up %.1f s), epochs %s, "
              "graphics %s, snapshot bytes %s, dashboard requests %s, "
              "report bytes %s" % (
                  wall_s, startup_s, json.dumps(result["epochs"]),
                  json.dumps(run["graphics"]),
                  json.dumps(run["snapshot_bytes"]),
                  json.dumps(result["dashboard_requests"]),
                  json.dumps(result["report_bytes"])))
        return result, [run_forms, sweep_forms, serve_forms]
    finally:
        dashboard.stop()
        shutil.rmtree(tmp, ignore_errors=True)


#: phase 20: the services' workflow. AlexNet-227 at full width through the
#: CLI (``-s 7``, deterministic) over pickled class files of
#: ``SyntheticImageLoader``'s generator, 128 training and 64 validation
#: samples in minibatches of 64, 2 epochs; run H reads the files through
#: ``HDFSLoader`` from a WebHDFS stub, run D through a ``Downloader``
#: ahead of ``PicklesLoader``
SERVICES_SAMPLES = (128, 64)
SERVICES_BATCH = 64
SERVICES_EPOCHS = 2
SERVICES_SIDE = 227
SERVICES_CLASSES = 1000
#: the layers the workflow file builds (a rehearsal on the CPU gives
#: ``small_alexnet_layers(10)``), the run's extra argv (``-a cpu`` there)
#: and the device of the script's own tensors
SERVICES_LAYERS = "ALEXNET_LAYERS"
SERVICES_CLI_ARGS = ()
SERVICES_DEVICE = "cuda"
#: single requests to the package served from the forge, beside one
#: 64-row batch
SERVICES_REQUESTS = 8
#: the SOM of (e): 2 epochs of ``som_run``'s 8x8 map over its digits
SERVICES_SOM_EPOCHS = 2

#: phase 20's workflow file. ``root.svc.mode`` "hdfs": ``HDFSLoader`` at
#: ``root.svc.namenode``, with an ``Avatar`` (SERVICE) after the decision
#: mirroring fc7's weights and bias and the loader's epoch number, an
#: ``AvatarServer``, ``Kept`` (a ``RemoteAvatar`` pulling after the
#: Avatar each epoch, keeping each pull beside the Avatar's own copy), a
#: ``Shell`` and a ``Manhole`` over ``{"workflow": workflow}``;
#: "download": a ``Downloader`` of ``root.svc.url`` into ``root.svc.data``
#: linked from the start point (initialized before the loader) ahead of
#: ``PicklesLoader`` over the files it promises
SERVICES_WORKFLOW_FILE = """
import os

from veles_tpu_torch.avatar import Avatar, AvatarServer, RemoteAvatar
from veles_tpu_torch.config import root
from veles_tpu_torch.downloader import Downloader
from veles_tpu_torch.interaction import Manhole, Shell
from veles_tpu_torch.loader.hdfs import HDFSLoader
from veles_tpu_torch.loader.pickles import PicklesLoader
from veles_tpu_torch.models.alexnet import (ALEXNET_LAYERS,
                                            AlexNetWorkflow,
                                            small_alexnet_layers)
from veles_tpu_torch.nn.units import All2AllStrictRELU

FILES = ("train.pickle", "valid.pickle")


class Watched(object):
    def __init__(self, fc7, loader):
        self.fc7, self.loader = fc7, loader

    @property
    def weights(self):
        return self.fc7.weights

    @property
    def bias(self):
        return self.fc7.bias

    @property
    def epoch_number(self):
        return self.loader.epoch_number


class Kept(RemoteAvatar):
    hide_from_registry = True

    def init_unpickled(self):
        super(Kept, self).init_unpickled()
        self.kept_ = []

    def pull(self):
        super(Kept, self).pull()
        own = {a: getattr(self.avatar_, a) for a in self.attrs}
        self.kept_.append((
            self.rev, {a: getattr(self, a) for a in self.attrs},
            {a: v.cpu() if hasattr(v, "cpu") else v for a, v in own.items()}))


def run(load, main):
    svc = root.svc
    if svc.mode == "hdfs":
        def factory(wf):
            return HDFSLoader(
                workflow=wf, namenode=svc.namenode,
                train_path="/data/" + FILES[0],
                validation_path="/data/" + FILES[1], minibatch_size=%d)
    else:
        def factory(wf):
            return PicklesLoader(
                workflow=wf, train_path=os.path.join(svc.data, FILES[0]),
                validation_path=os.path.join(svc.data, FILES[1]),
                minibatch_size=%d)
    wf, _ = load(AlexNetWorkflow, loader_factory=factory, layers=%s,
                 max_epochs=%d, learning_rate=0.01, momentum=0.9,
                 weights_decay=5e-4)
    if svc.mode == "download":
        fetch = Downloader(wf, url=svc.url, directory=svc.data, files=FILES,
                           name="downloader")
        fetch.link_from(wf.start_point)
    else:
        fc7 = [f for f in wf.forwards if isinstance(f, All2AllStrictRELU)][-1]
        avatar = Avatar(wf, source=Watched(fc7, wf.loader),
                        attrs=("weights", "bias", "epoch_number"),
                        view_group="SERVICE", name="avatar")
        avatar.link_from(wf.decision)
        wf.avatar_server_ = AvatarServer(avatar)
        kept = Kept(wf, address=wf.avatar_server_.address,
                    attrs=avatar.attrs, view_group="SERVICE", name="kept")
        kept.avatar_ = avatar
        kept.link_from(avatar)
        Shell(wf, name="shell").link_from(wf.decision)
        wf.manhole_ = Manhole(locals={"workflow": wf}).start()
    main()
"""


class WebHDFSStub(object):
    """A WebHDFS namenode stub on 127.0.0.1 over ``blobs`` ({path:
    bytes}): ``OPEN`` and ``GETFILESTATUS`` under ``/webhdfs/v1``."""

    def __init__(self, blobs):
        import http.server
        import urllib.parse

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                parsed = urllib.parse.urlparse(self.path)
                blob = blobs.get(parsed.path[len("/webhdfs/v1"):])
                code = 200
                if not parsed.path.startswith("/webhdfs/v1/") or \
                        blob is None:
                    code, blob = 404, b'{"RemoteException": {}}'
                elif "op=GETFILESTATUS" in parsed.query:
                    blob = json.dumps({"FileStatus": {
                        "length": len(blob), "type": "FILE"}}).encode()
                elif "op=OPEN" not in parsed.query:
                    code, blob = 400, b"{}"
                self.send_response(code)
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.server.daemon_threads = True
        self.namenode = "127.0.0.1:%d" % self.server.server_address[1]
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def services_data():
    """The class files: ``SyntheticImageLoader``'s generator at the
    phase's sizes, pickled as (data, labels): {file name: bytes}."""
    import pickle
    from veles_tpu_torch.models.alexnet import SyntheticImageLoader
    n_train, n_valid = SERVICES_SAMPLES
    arrays = SyntheticImageLoader(
        n_train=n_train, n_valid=n_valid, side=SERVICES_SIDE,
        n_classes=SERVICES_CLASSES)._generate()
    data, labels = arrays["data"].numpy(), arrays["labels"].numpy()
    # the generator's layout: validation first, then training
    return {"valid.pickle": pickle.dumps((data[:n_valid], labels[:n_valid]),
                                         protocol=4),
            "train.pickle": pickle.dumps((data[n_valid:], labels[n_valid:]),
                                         protocol=4)}


def write_tar(path, members):
    """A tar at ``path`` of ``members`` ({name: bytes})."""
    import io
    import tarfile
    with tarfile.open(path, "w") as tar:
        for name, blob in sorted(members.items()):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))


def expected_launches(trainer, epochs):
    """{kernel: launches} of ``epochs`` fused epochs of ``trainer``'s
    workflow: K1 and K3 a forward, K4 a step for each LRN, K6 a step for
    each bias, K7 a step for each dropout."""
    from veles_tpu_torch.loader.base import TRAIN, VALIDATION
    steps = epochs * len(trainer._segment_indices(TRAIN))
    forwards = steps + epochs * len(trainer._segment_indices(VALIDATION))
    kinds = [type(m).__name__ for m in trainer.forwards]
    n_lrn = kinds.count("LRNormalizerForward")
    return {"gemm_bias_act": kinds.count("All2AllStrictRELU") * forwards,
            "lrn_fwd": n_lrn * forwards, "lrn_bwd": n_lrn * steps,
            "column_reduce": sum("bias" in p for p in trainer.params) * steps,
            "uniform_fill": kinds.count("DropoutForward") * steps,
            "kahan_gemm": 0}


def services_runs(torch, tmp, blobs, warned):
    """Runs H and D (see the module docstring, phase 20 (a)): returns
    {"H": (Main, wall s, launches, forms), "D": ...}."""
    from veles_tpu_torch import prng
    www = os.path.join(tmp, "www")
    os.makedirs(www)
    write_tar(os.path.join(www, "services.tar"), blobs)
    stub = WebHDFSStub({"/data/" + k: v for k, v in blobs.items()})
    host = FileServer(www)
    path = os.path.join(tmp, "services.py")
    with open(path, "w") as f:
        f.write(SERVICES_WORKFLOW_FILE % (
            SERVICES_BATCH, SERVICES_BATCH, SERVICES_LAYERS,
            SERVICES_EPOCHS))
    runs = {}
    try:
        for key, mode in (("H", "hdfs"), ("D", "download")):
            data = os.path.join(tmp, "data-" + key)
            prng._generators.clear()
            reset_counts()
            t = time.perf_counter()
            with deterministic(torch, warned):
                main = workflow_cli(
                    path, "-s", "7", *(list(SERVICES_CLI_ARGS) + [
                        "root.svc.mode=%r" % mode,
                        "root.svc.namenode=%r" % stub.namenode,
                        "root.svc.url=%r" % host.url("services.tar"),
                        "root.svc.data=%r" % data]))
                if SERVICES_DEVICE == "cuda":
                    torch.cuda.synchronize()
            wall = time.perf_counter() - t
            counts, forms = read_counts()
            want = expected_launches(main.launcher.runner.trainer,
                                     SERVICES_EPOCHS)
            if SERVICES_DEVICE == "cuda" and counts != want:
                raise AssertionError("services run %s: launches %s, expected "
                                     "%s" % (key, counts, want))
            if key == "D" and sorted(os.listdir(data)) != sorted(blobs):
                raise AssertionError("services run D: the download left %s"
                                     % sorted(os.listdir(data)))
            runs[key] = (main, wall, counts, forms)
            print("services run %s (%s): %.1f s, losses %s, launches %s" % (
                key, mode, wall, json.dumps([t["loss"] for t in
                                             main.launcher.runner.epoch_times]),
                json.dumps(counts)))
    finally:
        stub.close()
        host.close()
    return runs


def services_data_checks(runs, blobs, tmp):
    """(a): runs H and D equal in every value of their histories and
    final parameters; the controls: a changed training label in the stub
    changes the loaded labels, an archive without a promised file raises
    ``FileNotFoundError``, an unreachable namenode the gated
    ``RuntimeError``."""
    import pickle
    import socket
    from veles_tpu_torch.downloader import Downloader
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.loader.hdfs import HDFSLoader
    states, histories = {}, {}
    for key, (main, _, _, _) in runs.items():
        wf = main.workflow
        states[key] = run_state(wf, [t["loss"] for t in
                                     main.launcher.runner.epoch_times])
        histories[key] = json.dumps(wf.decision.epoch_history, default=str,
                                    sort_keys=True)
    differing = values_differing(states["H"], states["D"])
    if differing or histories["H"] != histories["D"]:
        raise AssertionError("services: runs H and D differ in %d values, "
                             "histories equal %s" % (
                                 differing, histories["H"] == histories["D"]))
    data, labels = pickle.loads(blobs["train.pickle"])
    labels = labels.copy()
    labels[0] = (labels[0] + 1) % SERVICES_CLASSES
    changed = dict(blobs, **{"train.pickle": pickle.dumps((data, labels),
                                                          protocol=4)})
    del data
    stub = WebHDFSStub({"/data/" + k: v for k, v in changed.items()})
    try:
        loader = HDFSLoader(namenode=stub.namenode,
                            train_path="/data/train.pickle",
                            validation_path="/data/valid.pickle",
                            minibatch_size=SERVICES_BATCH)
        loader.load_dataset()
    finally:
        stub.close()
    label_moved = int((loader.original_labels != runs["H"][0].workflow.
                       loader.original_labels).sum())
    del loader
    if label_moved != 1:
        raise AssertionError("services control: the changed label moved %d "
                             "loaded labels" % label_moved)
    www = os.path.join(tmp, "www")
    write_tar(os.path.join(www, "partial.tar"),
              {"valid.pickle": blobs["valid.pickle"]})
    host = FileServer(www)
    try:
        Downloader(DummyWorkflow(), url=host.url("partial.tar"),
                   directory=os.path.join(tmp, "partial"),
                   files=("train.pickle", "valid.pickle")).initialize()
        missing = None
    except FileNotFoundError as e:
        missing = str(e)
    finally:
        host.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    try:
        HDFSLoader(namenode="127.0.0.1:%d" % closed,
                   train_path="/data/train.pickle").load_dataset()
        unreachable = None
    except RuntimeError as e:
        unreachable = str(e)
    try:
        HDFSLoader(train_path="/data/train.pickle").load_dataset()
        gated = None
    except RuntimeError as e:
        gated = str(e)
    if missing is None or unreachable is None or "cannot fetch" not in \
            unreachable or gated is None or "namenode" not in gated:
        raise AssertionError("services controls: missing file %r, "
                             "unreachable %r, no namenode %r" % (
                                 missing, unreachable, gated))
    print("services (a): runs H and D 0 values differing; controls: the "
          "changed label moved %d, %s, %s" % (label_moved, missing,
                                              unreachable[:80]))
    return {"values_differing": differing, "label_control_moved": label_moved,
            "archive_control": missing, "unreachable_control": unreachable,
            "gated_control": gated}


def avatar_checks(wf):
    """(b): every pull of ``Kept`` equals the Avatar's copy of that epoch,
    the last one the final fc7, revisions one apart; epoch 1's pull
    differs from the final fc7 (the control); a second ``RemoteAvatar``
    after the run reads the last revision. Stops the server."""
    from veles_tpu_torch.avatar import RemoteAvatar
    from veles_tpu_torch.dummy import DummyWorkflow
    from veles_tpu_torch.nn.units import All2AllStrictRELU
    server = wf.avatar_server_
    kept = wf["kept"]
    fc7 = [f for f in wf.forwards if isinstance(f, All2AllStrictRELU)][-1]
    final = {"weights": fc7.weights.detach().cpu(),
             "bias": fc7.bias.detach().cpu()}
    pulls = kept.kept_
    revs = [rev for rev, _, _ in pulls]
    per_epoch = [sum(int((pulled[a] != own[a]).sum()) for a in final)
                 for _, pulled, own in pulls]
    last = sum(int((pulls[-1][1][a] != final[a]).sum()) for a in final)
    control = sum(int((pulls[1][1][a] != final[a]).sum()) for a in final)
    epochs = [pulled["epoch_number"] for _, pulled, _ in pulls]
    second = RemoteAvatar(DummyWorkflow(), address=server.address)
    try:
        second.initialize()
        second_rev = second.rev
        second_differing = sum(int((second.__dict__[a] != final[a]).sum())
                               for a in final)
    finally:
        second.close()
        kept.close()
        server.stop()
    result = {"pulls": len(pulls), "revs": revs, "epoch_numbers": epochs,
              "pull_vs_own_differing": per_epoch,
              "last_vs_final_differing": last,
              "epoch1_vs_final_differing": control,
              "second_rev": second_rev,
              "second_differing": second_differing,
              "publish_ms": server.publish_ms,
              "published_bytes": server.published_bytes}
    print("services (b) avatar: %s" % json.dumps(result))
    if len(pulls) != SERVICES_EPOCHS + 1 or \
            revs != list(range(revs[0], revs[0] + len(pulls))) or \
            any(per_epoch) or last or not control or \
            second_rev != revs[-1] or second_differing:
        raise AssertionError("services avatar: %s" % result)
    return result


def manhole_reading(wf):
    """(d): a client of the run's Manhole evaluates fc7's bias sum (and its
    device); the reply must equal this script's own reading."""
    import socket
    from veles_tpu_torch.nn.units import All2AllStrictRELU
    manhole = wf.manhole_
    expr = ("(lambda b: (float(b.detach().sum()), b.device.type))([f for f "
            "in workflow.forwards if type(f).__name__ == "
            "'All2AllStrictRELU'][-1].bias)")
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
            sock.settimeout(60)
            sock.connect(manhole.path)
            f = sock.makefile("rw")
            banner = f.readline()
            f.read(4)
            f.write(expr + "\n")
            f.flush()
            reply = f.readline().strip()
            f.write("exit\n")
            f.flush()
    finally:
        manhole.stop()
    fc7 = [u for u in wf.forwards if isinstance(u, All2AllStrictRELU)][-1]
    mine = repr((float(fc7.bias.detach().sum()), fc7.bias.device.type))
    if "manhole" not in banner or reply != mine:
        raise AssertionError("services manhole: %r against %r (banner %r)"
                             % (reply, mine, banner))
    return reply


def interaction_checks():
    """(d): ``SIGUSR1`` prints a dump naming ``MainThread`` (the handler
    installed by the phase), ``debug_deadlocks()`` finds no thread, and a
    ``-i`` launcher answers ``is_interactive``."""
    import io
    import signal
    from veles_tpu_torch.interaction import debug_deadlocks
    from veles_tpu_torch.launcher import Launcher
    captured, saved = io.StringIO(), sys.stderr
    sys.stderr = captured
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        for _ in range(200):
            if "MainThread" in captured.getvalue():
                break
            time.sleep(0.01)
    finally:
        sys.stderr = saved
    dump = captured.getvalue()
    suspects = debug_deadlocks(file=io.StringIO())
    interactive = (Launcher(interactive=True).is_interactive,
                   Launcher().is_interactive)
    result = {"dump_names_main_thread": "MainThread" in dump,
              "dump_bytes": len(dump),
              "suspects": [t.name for t in suspects],
              "is_interactive": interactive}
    if not result["dump_names_main_thread"] or suspects or \
            interactive != (True, False):
        raise AssertionError("services interaction: %s" % result)
    return result


def forge_leg(torch, numpy, kernels, wf, tmp):
    """(c): the trained run H exported with a manifest, uploaded by
    ``update_forge`` to a ``ForgeServer`` that holds a token, a second
    version through ``forge.client.main``; list and details; version 1.0
    fetched byte-equal; served from the fetched package on the card; the
    refusals. Returns (result, launches_by_form)."""
    import shutil
    from veles_tpu_torch.export.package import export_workflow
    from veles_tpu_torch.forge import ForgeClient, ForgeServer
    from veles_tpu_torch.forge import client as forge_client
    from veles_tpu_torch.scripts import update_forge
    token = "phase-20-token"
    scan = os.path.join(tmp, "packages")
    pkg = os.path.join(scan, "alexnet227")
    t = time.perf_counter()
    export_workflow(wf, pkg)
    manifest = {"name": "alexnet227", "version": "1.0", "author": "smoke",
                "short_description": "AlexNet-227 trained by phase 20",
                "export": "contents.json"}
    with open(os.path.join(pkg, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    export_s = time.perf_counter() - t
    exported = {n: open(os.path.join(pkg, n), "rb").read()
                for n in sorted(os.listdir(pkg))}
    mib = sum(len(b) for b in exported.values()) / 1048576.0
    second = os.path.join(tmp, "second")
    os.makedirs(second)
    for name in exported:
        if name != "manifest.json":
            os.link(os.path.join(pkg, name), os.path.join(second, name))
    with open(os.path.join(second, "manifest.json"), "w") as f:
        json.dump(dict(manifest, version="1.1"), f)
    server = ForgeServer(os.path.join(tmp, "storage"), port=0,
                         token=token).start()
    address = "127.0.0.1:%d" % server.port
    result = {"package_mib": mib, "export_s": export_s}
    try:
        t = time.perf_counter()
        if update_forge.main([scan, "--server", address, "--token",
                              token]) != 0:
            raise AssertionError("services forge: update_forge failed")
        result["upload_s"] = time.perf_counter() - t
        t = time.perf_counter()
        forge_client.main(["upload", "-s", address, "-d", second, "--token",
                           token])
        result["client_upload_s"] = time.perf_counter() - t
        client = ForgeClient(address)
        listed = client.list()
        versions = [v["version"] for v in
                    client.details("alexnet227")["versions"]]
        if [m["name"] for m in listed] != ["alexnet227"] or \
                listed[0]["version"] != "1.1" or versions != ["1.0", "1.1"]:
            raise AssertionError("services forge: list %s, versions %s"
                                 % (listed, versions))
        fetched = os.path.join(tmp, "fetched")
        t = time.perf_counter()
        got = client.fetch("alexnet227", fetched, version="1.0")
        result["fetch_s"] = time.perf_counter() - t
        unequal = sorted(n for n in set(exported) | set(os.listdir(fetched))
                         if not os.path.exists(os.path.join(fetched, n)) or
                         open(os.path.join(fetched, n), "rb").read() !=
                         exported.get(n))
        del exported
        if got != "1.0" or unequal:
            raise AssertionError("services forge: fetched %s, files that "
                                 "differ %s" % (got, unequal))
        result["serving"], forms = forge_serving(torch, numpy, wf, fetched)
        result["refusals"] = forge_refusals(client, address, token, pkg)
    finally:
        server.stop()
        shutil.rmtree(scan, ignore_errors=True)
    check_forms("services forge serving", kernels, forms)
    print("services (c) forge: %s" % json.dumps(result, default=str))
    return result, forms


def forge_refusals(client, address, token, pkg):
    """An upload without the token (nothing stored), the same version
    again, a delete through GET: refused; after a delete, fetch is 404."""
    import urllib.error
    from veles_tpu_torch.forge import ForgeClient
    refused = {}
    for label, uploader in (("no token", ForgeClient(address)),
                            ("same version", ForgeClient(address,
                                                         token=token))):
        try:
            uploader.upload(pkg)
            refused[label] = None
        except RuntimeError as e:
            refused[label] = str(e)
    try:
        urllib.request.urlopen("http://%s/forge?query=delete&name="
                               "alexnet227" % address, timeout=30)
        refused["GET delete"] = None
    except urllib.error.HTTPError as e:
        refused["GET delete"] = e.code
    versions = [v["version"] for v in
                client.details("alexnet227")["versions"]]
    ForgeClient(address, token=token).delete("alexnet227", version="1.1")
    try:
        urllib.request.urlopen("http://%s/fetch?name=alexnet227&version=1.1"
                               % address, timeout=30)
        refused["fetch after delete"] = 200
    except urllib.error.HTTPError as e:
        refused["fetch after delete"] = e.code
    if None in refused.values() or "token" not in refused["no token"] or \
            "already exists" not in refused["same version"] or \
            versions != ["1.0", "1.1"] or \
            refused["fetch after delete"] != 404:
        raise AssertionError("services forge refusals: %s, versions %s"
                             % (refused, versions))
    return refused


def forge_serving(torch, numpy, wf, fetched):
    """The fetched package (``ServeableModel.from_package(...,
    full=True)``) behind ``ServingFrontend`` on the card: 8 single
    requests and one 64-row batch, held by the centred-logit check to the
    plain forward of run H's final weights, a reply swap and a zeroed fc7
    as the controls; K1 and K3 launched. Returns (result, forms)."""
    from veles_tpu_torch.models.build import plain_forward
    from veles_tpu_torch.nn.all2all import All2AllSoftmax
    from veles_tpu_torch.serving.model_store import ServeableModel
    t = time.perf_counter()
    model = ServeableModel.from_package(fetched, device=SERVICES_DEVICE,
                                        full=True)
    load_s = time.perf_counter() - t
    trained = ServeableModel.from_workflow(wf).module
    rng = numpy.random.RandomState(20)
    inputs = rng.uniform(-1, 1, (64,) + tuple(model.sample_shape)).astype(
        numpy.float32)
    bodies = [json.dumps({"input": x.tolist(), "codec": "list",
                          "id": i}).encode()
              for i, x in enumerate(inputs[:SERVICES_REQUESTS])]
    with serving(model) as frontend:
        reset_counts()
        replies, latencies, wall = concurrent_posts(frontend.port, bodies)
        t = time.perf_counter()
        batch = post(frontend.port, "/api/batch", b64_body(inputs))
        batch_s = time.perf_counter() - t
        counts, forms = read_counts()
    singles = numpy.array([r["result"] for r in replies])
    batched = numpy.array(batch["results"])
    want = forward_rows(torch, numpy, lambda x: plain_forward(trained, x),
                        inputs)
    k1 = [i for i, m in enumerate(model.module)
          if type(m).__name__.startswith("All2All") and
          not isinstance(m, All2AllSoftmax)]
    zeroed = forward_rows(torch, numpy, lambda x: forward_zeroing(
        model.module, x, k1[-1]), inputs)
    shares = {}
    for label, served, rows in (("singles", singles, slice(
            0, SERVICES_REQUESTS)), ("batch", batched, slice(0, 64))):
        swapped = served.copy()
        swapped[[0, 1]] = served[[1, 0]]
        err, spread, shares[label] = check_replies(
            numpy, "services forge %s" % label, served, want[rows],
            [("swapped", swapped), ("fc7_zeroed", zeroed[rows])])
        shares[label]["err_share"] = err / spread
    if SERVICES_DEVICE == "cuda" and not (counts["gemm_bias_act"] and
                                          counts["lrn_fwd"]):
        raise AssertionError("services forge serving launches %s" % counts)
    latencies = sorted(latencies)
    result = {"load_s": load_s, "requests": SERVICES_REQUESTS,
              "p50_ms": 1e3 * statistics.median(latencies),
              "p95_ms": 1e3 * latencies[min(len(latencies) - 1, int(
                  0.95 * len(latencies)))],
              "singles_wall_s": wall, "batch_s": batch_s,
              "launches": counts, "checks": shares}
    del model
    return result, forms


def kohonen_leg(torch):
    """(e): ``KohonenWorkflow.run()`` (eager, on the card) and its
    ``make_fused_runner()`` from the same seeds, ``som_run``'s digits and
    8x8 map, 2 epochs: 0 codebook values differ, the quantization error
    falls below the untrained codebook's, no kernel of the port runs."""
    from veles_tpu_torch import prng
    from veles_tpu_torch.datasets import golden_digits
    from veles_tpu_torch.dummy import DummyLauncher
    from veles_tpu_torch.models.mnist import MnistLoader
    from veles_tpu_torch.models.mnist_ae import KohonenWorkflow
    from veles_tpu_torch.nn.kohonen import som_quality
    digits = golden_digits(*BASELINE_DIGITS)
    runs = {}
    reset_counts()
    for key in ("eager", "fused"):
        prng.get().seed(BASELINE_SEED)
        prng.get("loader").seed(BASELINE_SEED + 1)
        wf = KohonenWorkflow(
            DummyLauncher(), loader_factory=lambda w: MnistLoader(
                workflow=w, provider=digits, minibatch_size=SOM_MINIBATCH),
            sx=SOM_SIDE, sy=SOM_SIDE, epochs=SERVICES_SOM_EPOCHS)
        wf.initialize(device=SERVICES_DEVICE)
        initial = wf.trainer.weights.clone()
        t = time.perf_counter()
        if key == "eager":
            wf.run()
        else:
            runner = wf.make_fused_runner()
            if type(runner).__name__ != "SOMFusedRunner":
                raise AssertionError("kohonen: runner %r" % runner)
            runner.run()
        if SERVICES_DEVICE == "cuda":
            torch.cuda.synchronize()
        runs[key] = (wf, initial, time.perf_counter() - t)
    counts = read_counts()[0]
    eager, fused = runs["eager"][0], runs["fused"][0]
    differing = int((eager.trainer.weights != fused.trainer.weights).sum())
    loader = eager.loader
    train = loader.stage(loader.device_)[0][loader.class_lengths[1]:]
    before = som_quality(runs["eager"][1], SOM_SIDE, SOM_SIDE, train)
    after = som_quality(eager.trainer.weights, SOM_SIDE, SOM_SIDE, train)
    result = {"updates": [eager.trainer.time, fused.trainer.time],
              "stopped": bool(eager.stopped), "values_differing": differing,
              "eager_s": runs["eager"][2], "fused_s": runs["fused"][2],
              "untrained": before, "trained": after, "launches": counts}
    print("services (e) kohonen: %s" % json.dumps(result))
    if differing or eager.trainer.time != fused.trainer.time or \
            not result["stopped"] or any(counts.values()) or \
            not after["quantization_error"] < before["quantization_error"]:
        raise AssertionError("services kohonen: %s" % result)
    return result


def services_phase(torch, numpy, kernels, card):
    """Phase 20 (see the module docstring). Returns (result,
    [launches_by_form])."""
    import shutil
    import tempfile
    from veles_tpu_torch.interaction import install_stack_dump_handler
    t0 = time.perf_counter()
    ipython = importable("IPython")
    print("services: IPython %s here (the Shell %s)" % (
        "imports" if ipython else "does not import",
        "would embed on a terminal" if ipython else "warns and stays off"))
    previous = install_stack_dump_handler()
    tmp = tempfile.mkdtemp(prefix="veles-services-")
    warned = []
    try:
        blobs = services_data()
        runs = services_runs(torch, tmp, blobs, warned)
        result = {"ipython": ipython, "deterministic_warnings": warned,
                  "walls_s": {k: v[1] for k, v in runs.items()},
                  "launches": {k: v[2] for k, v in runs.items()}}
        result["data"] = services_data_checks(runs, blobs, tmp)
        del blobs
        wf = runs["H"][0].workflow
        result["avatar"] = avatar_checks(wf)
        result["manhole"] = manhole_reading(wf)
        for key in ("H", "D"):
            check_forms("services run " + key, kernels, runs[key][3])
        result["forge"], serve_forms = forge_leg(torch, numpy, kernels, wf,
                                                 tmp)
        forms = [runs["H"][3], runs["D"][3], serve_forms]
        del runs, wf
        if SERVICES_DEVICE == "cuda":
            torch.cuda.empty_cache()
        result["interaction"] = interaction_checks()
        print("services (d) interaction: manhole %s, %s" % (
            result["manhole"], json.dumps(result["interaction"])))
        result["kohonen"] = kohonen_leg(torch)
        result["phase_s"] = time.perf_counter() - t0
        print("services: runs %s s, forge upload %.2f s + %.2f s, fetch "
              "%.2f s, serve load %.2f s, package %.1f MiB, avatar publish "
              "%.1f ms / %d bytes, requests p50 %.1f ms p95 %.1f ms, phase "
              "%.1f s" % (
                  json.dumps(result["walls_s"]), result["forge"]["upload_s"],
                  result["forge"]["client_upload_s"],
                  result["forge"]["fetch_s"],
                  result["forge"]["serving"]["load_s"],
                  result["forge"]["package_mib"],
                  result["avatar"]["publish_ms"],
                  result["avatar"]["published_bytes"],
                  result["forge"]["serving"]["p50_ms"],
                  result["forge"]["serving"]["p95_ms"], result["phase_s"]))
        return result, forms
    finally:
        import signal
        signal.signal(signal.SIGUSR1, previous)
        shutil.rmtree(tmp, ignore_errors=True)

#: phase 21, the model-family leg: a workflow file whose class subclasses
#: ``CifarWorkflow`` over golden objects 10000 + 2000 (drawn once in the
#: file's module) at its default minibatch of 100, FAMILY_EPOCHS epochs,
#: deterministic, through ``Main().run`` with ``-s 7``; held to
#: ``veles_tpu_torch.run`` of the same class from the same seeds (0
#: values differing), and ``run()`` seeded with FAMILY_CONTROL_SEED as
#: the control that must differ (the first epoch's order does not
#: depend on the loader's stream, whose first shuffle follows the
#: epoch: a control that reseeds only the loader differs in no value
#: after one epoch); then the
#: parity harness's ``train_cifar`` on the same objects and ``train_fc``
#: on golden digits FAMILY_DIGITS, FAMILY_HARNESS_EPOCHS each
FAMILY_OBJECTS = (10000, 2000)
FAMILY_DIGITS = (1000, 500)
#: one epoch, not two: the whole script took 1148 s of its 1,200 on a
#: slow host (910 s on another) with two
FAMILY_EPOCHS = 1
FAMILY_HARNESS_EPOCHS = 1
FAMILY_SEED = "7"
FAMILY_CONTROL_SEED = "8"
FAMILY_DEVICE = "cuda"
#: the CLI's device flags and ``run()``'s device keywords (the card's
#: defaults; a CPU rehearsal passes ``-a cpu`` and ``backend="cpu"``)
FAMILY_CLI_ARGS = ()
FAMILY_RUN_KWARGS = {}
FAMILY_WORKFLOW_FILE = """
from veles_tpu_torch.datasets import golden_objects
from veles_tpu_torch.models.cifar import CifarWorkflow

OBJECTS = golden_objects(%d, %d)
_DRAWN = []


def provider():
    if not _DRAWN:
        _DRAWN.append(OBJECTS())
    return _DRAWN[0]


class GoldenCifar(CifarWorkflow):
    def __init__(self, workflow=None, **kwargs):
        kwargs.setdefault("max_epochs", %d)
        super(GoldenCifar, self).__init__(workflow, provider=provider,
                                          **kwargs)
"""


def family_state(wf):
    """:func:`run_state` of a finished run of the leg's class: each
    epoch's class losses and error counts, every parameter."""
    history = wf.decision.epoch_history
    losses = [dict(("%s %s" % (klass, key), h[klass][key])
                   for klass in ("validation", "train")
                   for key in ("metric", "normalized"))
              for h in history]
    for row, times in zip(losses, wf.workflow.runner.epoch_times):
        row.update(("%s loss" % k, v) for k, v in times["loss"].items())
    return run_state(wf, losses)


def family_phase(torch, numpy, kernels):
    """Phase 21 (see the module docstring). Returns (result,
    [launches_by_form])."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="veles_family_")
    try:
        return _family_phase(torch, numpy, kernels, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _family_phase(torch, numpy, kernels, tmp):
    import veles_tpu_torch
    from veles_tpu_torch import prng
    from veles_tpu_torch.__main__ import Main
    from veles_tpu_torch.datasets import golden_digits
    from veles_tpu_torch.models import parity
    path = os.path.join(tmp, "golden_cifar.py")
    with open(path, "w") as f:
        f.write(FAMILY_WORKFLOW_FILE % (FAMILY_OBJECTS + (FAMILY_EPOCHS,)))
    warned, phases, result = [], [], {}
    card = FAMILY_DEVICE == "cuda"

    def counted(label, run, want=None):
        reset_counts()
        t = time.perf_counter()
        with deterministic(torch, warned):
            out = run()
            if card:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts, forms = read_counts()
        if want is not None and card and counts != want(out):
            raise AssertionError("family %s: launches %s, expected %s" % (
                label, counts, want(out)))
        check_forms("family " + label, kernels, forms)
        phases.append(forms)
        result[label] = {"wall_s": wall, "launches": counts}
        return out

    def expected(wf):
        return expected_training_counts(wf.workflow.runner.trainer,
                                        FAMILY_EPOCHS)

    def programmatic(cls, seed=FAMILY_SEED):
        prng._generators.clear()
        Main()._seed_random(seed)
        return veles_tpu_torch.run(cls, **FAMILY_RUN_KWARGS)

    t0 = time.perf_counter()
    prng._generators.clear()
    main = counted("cli", lambda: workflow_cli(
        path, "-s", FAMILY_SEED, *FAMILY_CLI_ARGS),
        lambda m: expected(m.workflow))
    cls = type(main.workflow)
    if cls.__name__ != "GoldenCifar" or \
            type(main.workflow).__mro__[1].__name__ != "CifarWorkflow":
        raise AssertionError("family: the CLI picked %s" % cls.__name__)
    cli = family_state(main.workflow)
    ran = counted("run", lambda: programmatic(cls), expected)
    control = counted("control_seed", lambda: programmatic(
        cls, FAMILY_CONTROL_SEED), expected)
    differing = values_differing(family_state(ran), cli)
    control_differing = values_differing(family_state(control), cli)
    history = main.workflow.decision.epoch_history
    result.update({
        "epochs": len(history),
        "validation_errors": [h["validation"]["normalized"]
                              for h in history],
        "run_vs_cli_differing": differing,
        "control_differing": control_differing,
        "deterministic_warnings": warned})
    print("family: run() vs the CLI %d values differing, the control "
          "(-s %s) %d; validation errors %s" % (
              differing, FAMILY_CONTROL_SEED, control_differing,
              result["validation_errors"]))
    if len(history) != FAMILY_EPOCHS or differing or not control_differing:
        raise AssertionError("family: %d epochs, run() vs the CLI %d values "
                             "differing, control %d" % (
                                 len(history), differing, control_differing))
    del main, ran, control
    objects = sys.modules[cls.__module__].provider
    digits = golden_digits(*FAMILY_DIGITS)
    device = FAMILY_RUN_KWARGS.get("backend")
    result["train_cifar_best_validation_error"] = counted(
        "train_cifar", lambda: parity.train_cifar(
            objects, FAMILY_HARNESS_EPOCHS, device=device))
    result["train_fc_best_validation_error"] = counted(
        "train_fc", lambda: parity.train_fc(
            digits, FAMILY_HARNESS_EPOCHS, device=device))
    for name in ("train_cifar", "train_fc"):
        value = result["%s_best_validation_error" % name]
        if not 0.0 <= value <= 1.0:
            raise AssertionError("family %s: best validation error %r" % (
                name, value))
    result["phase_s"] = time.perf_counter() - t0
    sys.modules.pop(cls.__module__, None)
    gc.collect()
    if card:
        torch.cuda.empty_cache()
    return result, phases


#: phase 22: the port installed on a card host as a user installs it. The
#: installable files the phase copies out of the tree (so that
#: setuptools writes nothing into it); the installed CLI run is phase
#: 15's standalone run (phase 9's file verbatim, ``-s 7``, SPMD_EPOCHS,
#: deterministic) with a raw snapshot every epoch, its control the same
#: from ``-s 8``; the kernels its runs must launch; 16 concurrent single
#: requests (list codec) and one 64-row base64 batch to the installed
#: ``serve``; seconds any installed command may take
INSTALLED_FILES = ("veles_tpu_torch", "pyproject.toml", "README.md",
                   os.path.join("deploy", "torch"))
INSTALLED_SEED = "7"
INSTALLED_CONTROL_SEED = "8"
INSTALLED_KERNELS = ("gemm_bias_act", "lrn_fwd", "lrn_bwd", "column_reduce",
                     "uniform_fill")
INSTALLED_REQUESTS = 16
INSTALLED_BATCH = 64
INSTALLED_S = 600
#: the CPU rehearsal's: ("-a", "cpu") and "cpu"
INSTALLED_CLI_ARGS = ()
INSTALLED_DEVICE = "cuda"

#: the installed run's workflow file: the deterministic mode (as phase
#: 15's ranks set it), then phase 9's file (``root.smoke.base``)
#: unchanged; after the run it pickles to ``root.smoke.report`` where
#: ``veles_tpu_torch`` and its ``csrc/`` were imported from, the kernel
#: libraries the process loaded, the decision's epoch history, every
#: parameter, its kernel launches (``ops.launch_report()``) and the
#: modules of jax, ml_dtypes and veles_tpu it holds
INSTALLED_WORKFLOW_FILE = """
import importlib.util
import pickle
import sys

import torch

from veles_tpu_torch.config import root

torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.use_deterministic_algorithms(True, warn_only=True)


def run(load, main):
    import veles_tpu_torch
    from veles_tpu_torch.convert import layer_params
    from veles_tpu_torch.ops import build, launch_report
    spec = importlib.util.spec_from_file_location("alexnet_workflow",
                                                  root.smoke.base)
    base = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base)
    loaded = []

    def loading(*args, **kwargs):
        loaded.append(load(*args, **kwargs))
        return loaded[-1]

    base.run(loading, main)
    wf = loaded[0][0]
    report = {
        "file": veles_tpu_torch.__file__, "csrc": build.CSRC,
        "libraries": build.loaded(), "launches": launch_report(),
        "history": wf.decision.epoch_history,
        "params": {"%d.%s" % (i, k): p.detach().cpu().numpy()
                   for i, f in enumerate(wf.forwards)
                   for k, p in layer_params(f.module).items()},
        "modules": sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "ml_dtypes", "veles_tpu"))}
    with open(root.smoke.report, "wb") as f:
        pickle.dump(report, f)
"""


class Standalone(object):
    """Phase 15's deterministic standalone run of phase 9's file, handed
    to phase 22 beside it: ``history``, ``params`` and ``forms`` (its
    launches by form) once ``ready`` is set (None if phase 15 failed
    first)."""

    def __init__(self):
        self.ready = threading.Event()
        self.history = self.params = self.forms = None


class Installed(object):
    """The processes of phase 22's installed copy: each started with
    only the prefix on ``PYTHONPATH`` in a directory outside the tree,
    its output to a log; :meth:`stop` ends every one."""

    def __init__(self, tmp, prefix):
        self.tmp, self.prefix, self.procs = tmp, prefix, []
        self.cwd = os.path.join(tmp, "outside")
        os.makedirs(self.cwd, exist_ok=True)
        self.env = dict(os.environ, PYTHONPATH=prefix, PATH=os.pathsep.join(
            [os.path.join(prefix, "bin"), os.environ.get("PATH", "")]))

    def start(self, label, script, *args):
        import subprocess
        log = os.path.join(self.tmp, label + ".log")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [os.path.join(self.prefix, "bin", script)] + list(args),
                env=self.env, cwd=self.cwd, stdout=out,
                stderr=subprocess.STDOUT)
        proc.label, proc.log = label, log
        self.procs.append(proc)
        return proc

    def wait(self, proc, timeout=INSTALLED_S):
        """``proc``'s exit, which must be 0 within ``timeout`` s; returns
        its output."""
        import subprocess
        try:
            code = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            code = "overran %d s" % timeout
        with open(proc.log, errors="replace") as f:
            output = f.read()
        if code != 0:
            raise AssertionError("installed %s exited %s:\n%s" % (
                proc.label, code, output[-4000:]))
        return output

    def stop(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def answered(port, path, proc, timeout=INSTALLED_S):
    """The body of ``GET path`` on 127.0.0.1:``port`` once the server
    ``proc`` answers (it must stay up)."""
    t0 = time.perf_counter()
    while True:
        try:
            return get_url(port, path)
        except OSError:
            if proc.poll() is not None or \
                    time.perf_counter() - t0 > timeout:
                raise AssertionError("installed %s never answered %s "
                                     "(exit %s)" % (proc.label, path,
                                                    proc.poll()))
            time.sleep(0.2)


def copy_installable(tree):
    """The tree's installable files under ``tree``, without a built
    ``csrc/build/`` or byte code."""
    import shutil
    ignore = shutil.ignore_patterns("__pycache__", "build", "*.pyc")
    for name in INSTALLED_FILES:
        src = os.path.join(REPO, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(tree, name), ignore=ignore)
        else:
            shutil.copy(src, tree)


def installed_phase(torch, numpy, kernels, standalone):
    """Phase 22 (see the module docstring). Returns (result,
    [launches_by_form of each installed run])."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="veles_installed_")
    procs = Installed(tmp, os.path.join(tmp, "prefix"))
    try:
        return _installed_phase(torch, numpy, kernels, standalone, procs)
    finally:
        procs.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def _installed_phase(torch, numpy, kernels, standalone, procs):
    import pickle
    import subprocess
    from veles_tpu_torch.ops import build
    from veles_tpu_torch.ops.gemm_bench import card_line
    from veles_tpu_torch.parallel.elastic import _free_port
    card = INSTALLED_DEVICE == "cuda"
    tmp, prefix = procs.tmp, procs.prefix
    t0 = started = time.time()
    tree = os.path.join(tmp, "tree")
    copy_installable(tree)
    # (1) the bootstrap: pip from the copy into the prefix, offline,
    # then every kernel built from the prefix's sources
    env = dict(os.environ, PYTHON=sys.executable)
    env.pop("PYTHONPATH", None)
    t = time.perf_counter()
    proc = subprocess.run(
        ["sh", os.path.join(tree, "deploy", "torch", "deploy.sh"),
         "--target", prefix], env=env, cwd=procs.cwd, capture_output=True,
        text=True, timeout=INSTALLED_S)
    deploy_s = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError("installed: deploy.sh exited %d:\n%s\n%s" % (
            proc.returncode, proc.stdout[-4000:], proc.stderr[-4000:]))
    built = json.loads([line for line in proc.stdout.splitlines()
                        if line.startswith('{"seconds"')][-1])
    result = {"deploy_s": deploy_s,
              "install_s": deploy_s - built["wall_s"],
              "build_wall_s": built["wall_s"],
              "build_s": built["seconds"]}
    print("installed: deploy.sh %.1f s, of it the kernels' build %.1f s "
          "wall: %s" % (deploy_s, built["wall_s"], ", ".join(
              "%s %.1f s" % kv for kv in sorted(built["seconds"].items()))))
    # (2) the prefix's sources are the tree's, each built anew into the
    # prefix during this phase
    package = os.path.join(prefix, "veles_tpu_torch")
    csrc = os.path.join(package, "csrc")
    names = build.sources() + build.headers()
    if sorted(n for n in os.listdir(csrc) if n != "build") != sorted(names):
        raise AssertionError("installed csrc/ holds %s, the tree's %s" % (
            sorted(os.listdir(csrc)), sorted(names)))
    for name in names:
        with open(os.path.join(csrc, name), "rb") as a, \
                open(os.path.join(build.CSRC, name), "rb") as b:
            if a.read() != b.read():
                raise AssertionError("installed %s differs from the tree's"
                                     % name)
    built_dir = os.path.join(csrc, "build")
    for name, path in built["libraries"].items():
        if os.path.dirname(path) != built_dir or \
                built["seconds"][name] <= 0.0 or \
                os.path.getmtime(path) < started:
            raise AssertionError("installed: %s's library %s was not built "
                                 "into the prefix during the phase (%.1f s)"
                                 % (name, path, built["seconds"][name]))
    # (3) the installed CLI run and its control, side by side
    base = os.path.join(tmp, "alexnet_workflow.py")
    path = os.path.join(tmp, "installed.py")
    for name, text in ((base, WORKFLOW_FILE),
                       (path, INSTALLED_WORKFLOW_FILE)):
        with open(name, "w") as f:
            f.write(text)

    def cli(label, seed, *overrides):
        return procs.start(
            label, "veles-tpu-torch", path, "-s", seed,
            "root.smoke.epochs=%d" % SPMD_EPOCHS,
            "root.smoke.base=%r" % base,
            "root.smoke.report=%r" % os.path.join(tmp, label + ".pickle"),
            *(tuple(overrides) + tuple(INSTALLED_CLI_ARGS)))

    snaps = os.path.join(tmp, "snaps")
    t = time.perf_counter()
    runs = {"run": cli("run", INSTALLED_SEED,
                       "root.smoke.snapshots=%r" % snaps),
            "control": cli("control", INSTALLED_CONTROL_SEED,
                           "root.smoke.snapshots=%r" % os.path.join(
                               tmp, "control_snaps"),
                           "root.common.disable.snapshotting=True")}
    reports = {}
    for label, run in runs.items():
        procs.wait(run)
        result[label + "_s"] = time.perf_counter() - t
        with open(os.path.join(tmp, label + ".pickle"), "rb") as f:
            reports[label] = pickle.load(f)
    run = reports["run"]
    for label, report in reports.items():
        if report["file"] != os.path.join(package, "__init__.py") or \
                report["csrc"] != csrc or report["modules"]:
            raise AssertionError(
                "installed %s imported %s (csrc %s), loaded %s" % (
                    label, report["file"], report["csrc"],
                    report["modules"]))
        if card and report["libraries"] != {
                name: built["libraries"][name]
                for name in report["libraries"]}:
            raise AssertionError("installed %s loaded %s, not the prefix's "
                                 "libraries %s" % (label,
                                                   report["libraries"],
                                                   built["libraries"]))
    result["libraries_loaded"] = sorted(run["libraries"])
    if not standalone.ready.wait(INSTALLED_S):
        raise AssertionError("installed: phase 15's standalone run never "
                             "came")
    if standalone.params is None:
        raise AssertionError("installed: phase 15 failed before its "
                             "standalone run")
    want = (standalone.history, standalone.params)
    differing = values_differing_tree((run["history"], run["params"]), want)
    control = values_differing_tree((reports["control"]["history"],
                                     reports["control"]["params"]), want)
    result.update(values_differing=differing, control_differing=control,
                  epochs=len(run["history"]))
    print("installed: the installed CLI run vs phase 15's standalone run "
          "%d values differing (history and parameters), the control (-s "
          "%s) %d" % (differing, INSTALLED_CONTROL_SEED, control))
    if differing or not control or len(run["history"]) != SPMD_EPOCHS:
        raise AssertionError("installed: %d epochs, %d values differing, "
                             "control %d" % (len(run["history"]),
                                             differing, control))
    forms = []
    if card:
        for label, report in reports.items():
            forms.append(reported_forms("installed " + label, kernels,
                                        report["launches"],
                                        INSTALLED_KERNELS))
        want_forms = {name: {k: n for k, n in by_form.items() if n}
                      for name, by_form in standalone.forms.items()}
        want_forms = {name: v for name, v in want_forms.items() if v}
        if forms[0] != want_forms:
            raise AssertionError("installed run launches %s, the standalone "
                                 "run's %s" % (forms[0], want_forms))
    result["launches"] = {label: {k: v["launches"] for k, v in
                                  report["launches"].items()}
                          for label, report in reports.items()}
    # (4) the installed serve on the run's snapshots, (5) the other
    # console scripts, all started together
    port, status_port, forge_port = _free_port(), _free_port(), _free_port()
    t = time.perf_counter()
    serve = procs.start(
        "serve", "veles-tpu-torch-serve", "--model", snaps, "--host",
        "127.0.0.1", "--port", str(port), "--max-batch-size",
        str(INSTALLED_BATCH), "--response-timeout", "300",
        *INSTALLED_CLI_ARGS)
    status = procs.start("web-status", "veles-tpu-torch-web-status",
                         "--host", "127.0.0.1", "--port", str(status_port))
    forge = procs.start("forge-server", "veles-tpu-torch-forge-server",
                        "-r", os.path.join(tmp, "forge"), "--host",
                        "127.0.0.1", "-p", str(forge_port))
    compare = installed_compare(procs, snaps)
    answered(port, "/healthz", serve)
    result["serve_start_s"] = time.perf_counter() - t
    result["web_status_bytes"] = len(answered(status_port, "/", status))
    result["forge_list"] = json.loads(answered(
        forge_port, "/forge?query=list", forge))
    if result["forge_list"] != [] or not result["web_status_bytes"]:
        raise AssertionError("installed web-status / forge-server: %s" %
                             result)
    result["compare_snapshots"] = compare()
    result["serve"] = installed_serving(torch, numpy, port, snaps,
                                        run["params"])
    result["phase_s"] = time.time() - t0
    print("installed (%s): %s" % (card_line() if card else "CPU",
                                  json.dumps(result, default=str)))
    return result, forms


def installed_compare(procs, snaps):
    """``veles-tpu-torch-compare-snapshots -q`` of the run's last
    snapshot against a copy of it, started; the function returned waits
    for it and requires every row's max diff to be 0."""
    import shutil
    from veles_tpu_torch.snapshotter import latest_snapshot
    last = latest_snapshot(snaps)
    copy = os.path.join(procs.tmp, "copy.pickle")
    shutil.copy(last, copy)
    proc = procs.start("compare-snapshots",
                       "veles-tpu-torch-compare-snapshots", "-q", last, copy)

    def read():
        output = procs.wait(proc)
        rows = [line for line in output.splitlines()
                if line.startswith("|")]
        diffs = [float(cells[4]) for cells in
                 ([c.strip() for c in line.strip("|").split("|")]
                  for line in rows[2:])]
        out = {"rows": len(diffs), "max_diff": max(diffs) if diffs else None}
        if not diffs or out["max_diff"] != 0:
            raise AssertionError("installed compare-snapshots: %s\n%s" % (
                out, output[-3000:]))
        return out

    return read


def installed_serving(torch, numpy, port, snaps, params):
    """The installed ``serve`` on ``snaps``: INSTALLED_REQUESTS concurrent
    single requests (list codec) and one INSTALLED_BATCH-row base64
    batch, held by the centred-logit check to the plain forward of the
    run's final weights (the snapshot loaded here, its parameters the
    run's to the bit), a reply swap and fc7 zeroed as the controls."""
    from veles_tpu_torch.convert import layer_params
    from veles_tpu_torch.nn.all2all import All2AllSoftmax
    from veles_tpu_torch.serving.model_store import ModelStore
    model = ModelStore().load(snaps, device=INSTALLED_DEVICE)
    loaded = {"%d.%s" % (i, k): p.detach().cpu().numpy()
              for i, m in enumerate(model.module)
              for k, p in layer_params(m).items()}
    if values_differing_tree(loaded, params):
        raise AssertionError("installed serving: the snapshot's weights "
                             "are not the run's")
    rng = numpy.random.RandomState(22)
    inputs = rng.uniform(-1, 1, (INSTALLED_BATCH,) + tuple(
        model.sample_shape)).astype(numpy.float32)
    bodies = [json.dumps({"input": x.tolist(), "codec": "list",
                          "id": i}).encode()
              for i, x in enumerate(inputs[:INSTALLED_REQUESTS])]
    replies, latencies, wall = concurrent_posts(port, bodies)
    t = time.perf_counter()
    batch = post(port, "/api/batch", b64_body(inputs))
    batch_s = time.perf_counter() - t
    k1 = [i for i, m in enumerate(model.module)
          if type(m).__name__.startswith("All2All") and
          not isinstance(m, All2AllSoftmax)]

    def plain(zeroed=None):
        """The plain forward of ``inputs`` on the device, the output of
        layer ``zeroed`` set to 0."""
        with torch.inference_mode():
            x = torch.from_numpy(inputs).to(INSTALLED_DEVICE)
            for i, module in enumerate(model.module):
                x = module.plain_forward(x)
                if i == zeroed:
                    x = x.new_zeros(x.shape)
            return x.float().cpu().numpy()

    want, zeroed = plain(), plain(k1[-1])
    shares = {}
    for label, served in (("singles", numpy.array(
            [r["result"] for r in replies])),
            ("batch", numpy.array(batch["results"]))):
        rows = slice(0, len(served))
        swapped = served.copy()
        swapped[[0, 1]] = served[[1, 0]]
        err, spread, shares[label] = check_replies(
            numpy, "installed serve %s" % label, served, want[rows],
            [("swapped", swapped), ("fc7_zeroed", zeroed[rows])])
        shares[label]["err_share"] = err / spread
    latencies = sorted(latencies)
    del model
    return {"requests": INSTALLED_REQUESTS,
            "p50_ms": 1e3 * statistics.median(latencies),
            "p95_ms": 1e3 * latencies[min(len(latencies) - 1, int(
                0.95 * len(latencies)))],
            "singles_wall_s": wall, "batch_s": batch_s,
            "batch_rows_per_s": INSTALLED_BATCH / batch_s,
            "checks": shares}


def numpy_load(path):
    import numpy
    with numpy.load(path) as data:
        return {k: data[k] for k in data.files}


def beside(walls, *phases):
    """Run each ``(name, fn)`` of ``phases`` in a thread of its own, all
    at once; their results in order, each phase's seconds in ``walls``.
    When one raises, the first error is raised once every phase has
    ended (each stops the processes it started)."""
    results, errors = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            errors.append(e)
        finally:
            walls[name] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=phase, name=phase[0])
               for phase in phases]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return [results[name] for name, _ in phases]


def main():
    # deterministic cuBLAS for the workflow and eager phases' runs: read
    # when the first cuBLAS handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # every run generates its synthetic data: no dataset cache on disk
    os.environ.setdefault("VELES_DATASET_CACHE", "0")
    import numpy
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the autotuner reads a fresh empty cache: every phase and every
    # process it starts plans by default, whatever cache the machine
    # holds; phase 18 tunes into a cache of its own
    import atexit
    import shutil
    import tempfile
    tune_dir = tempfile.mkdtemp(prefix="veles-autotune-")
    atexit.register(shutil.rmtree, tune_dir, True)
    os.environ["VELES_AUTOTUNE_CACHE"] = os.path.join(tune_dir,
                                                      "autotune.json")
    os.environ["VELES_AUTOTUNE"] = "cache"
    import veles_tpu_torch  # noqa: F401  (fails outside a checkout)
    from veles_tpu_torch.nn.precision import get_policy
    from veles_tpu_torch.ops import build
    from veles_tpu_torch.ops.gemm_bench import card_line

    card = card_line()
    print(card)
    print("torch %s, CUDA %s, device %s" % (
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0)))
    phase_s = {}
    # the launches each phase counted (all forms), by the phase's name:
    # phases 14-17 run beside each other, and how many jobs, steps and
    # requests their legs take depends on timing
    phases, launches_by_phase, counted = [], {}, 0
    t0 = mark = time.perf_counter()
    seconds = build.build_all()
    print("build: %s (all in parallel, %.1f s wall)" % (
        ", ".join("%s %.1f s" % kv for kv in sorted(seconds.items())),
        time.perf_counter() - t0))
    print("build: CPython bindings %s" % ", ".join(
        "%s %.1f s" % kv for kv in sorted(seconds.items())
        if kv[0].endswith("_binding.cpp")))
    get_policy("float32").configure_backends()

    def lap(name, legs=None):
        nonlocal mark, counted
        now = time.perf_counter()
        phase_s[name] = round(now - mark, 1)
        mark = now
        for leg, forms in legs or ((name, phases[counted:]),):
            if forms:
                launches_by_phase[leg] = {
                    k: sum(v.values())
                    for k, v in sorted(merge_forms(*forms).items())}
        counted = len(phases)

    lap("build")
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

    before_sweeps = split_launches()
    sweep, ksweep = split_sweep(torch), kahan_sweep(torch)
    swept = splits_since(before_sweeps)
    remember_sweeps(sweep, ksweep)
    print("split sweep (%s): %s" % (card, json.dumps(sweep)))
    print("kahan split sweep (%s): %s" % (card, json.dumps(ksweep)))
    lap("kernels")

    model, served, serving_forms = slice_phase(torch, numpy)
    check_forms("serving", kernels, serving_forms)
    check_designed("serving", served["gemm_variants"])
    served.update(forward_phase(torch, model))
    print("serving (%s): %s" % (card, json.dumps(served)))
    del model
    lap("serving")

    phases.append(serving_forms)
    trained = []
    for policy, check in (("float32", True), ("bfloat16", False)):
        result, forms = training_phase(torch, policy, check)
        check_forms("training " + policy, kernels, forms)
        check_designed("training " + policy, result["gemm_variants"])
        phases.append(forms)
        trained.append(result)
        print("training (%s): %s" % (card, json.dumps(result)))
    get_policy("float32").configure_backends()
    lap("training")

    disciplines, forms = disciplines_phase(torch, numpy, card)
    check_forms("disciplines", kernels, forms)
    check_designed("disciplines", disciplines["gemm_variants"])
    phases.append(forms)
    print("disciplines (%s): %s" % (card, json.dumps(disciplines)))
    print("device rating (%s): %s" % (card, json.dumps(rating_phase(torch))))
    lap("disciplines")

    baseline, forms = baseline_phase(torch, kernels)
    phases.extend(forms)
    print("baseline (%s): %s" % (card, json.dumps(baseline, default=str)))
    lap("baseline")

    sequence, forms = sequence_phase(torch, numpy, kernels)
    phases.extend(forms)
    print("sequence (%s): %s" % (card, json.dumps(sequence, default=str)))
    lap("sequence")

    workflow, forms = workflow_phase(torch, numpy, kernels)
    phases.extend(forms)
    print("workflow (%s): %s" % (card, json.dumps(workflow, default=str)))
    lap("workflow")

    (eager, served), forms = eager_export_phases(torch, numpy, kernels)
    phases.extend(forms)
    print("eager (%s): %s" % (card, json.dumps(eager, default=str)))
    print("export and serve (%s): %s" % (card, json.dumps(served,
                                                          default=str)))
    lap("eager and export")

    residency, forms = residency_phase(torch, numpy, kernels)
    phases.extend(forms)
    print("residency (%s): %s" % (card, json.dumps(residency, default=str)))
    lap("residency")

    observed, forms = observability_phase(torch, numpy, kernels)
    phases.extend(forms)
    print("observability (%s): %s" % (card, json.dumps(observed,
                                                       default=str)))
    lap("observability")

    # phases 14, 15, 16 and 17 run beside each other: each waits on
    # processes of its own (slaves, ranks, supervised workers, jobs) whose
    # time is mostly their start-up (``import torch`` alone takes ~6-7 s
    # on the card's host, P16c), and one after another 14-16 took ~700 s
    # of the script's 1200 (F16z); phase 17 holds its preempted job to
    # phase 16's one-rank run
    # phase 22 (the installed copy: its install, its build and its
    # processes, host work mostly) runs beside them too, its CLI run held
    # to phase 15's standalone run
    walls = {}
    one_rank, standalone = OneRank(), Standalone()
    (distributed, forms14), (spmd, forms15), (elastic, forms16), \
        (meta, forms17), (installed, forms22) = beside(
            walls, ("distributed", lambda: distributed_phase(torch, numpy,
                                                             kernels)),
            ("spmd", lambda: spmd_phase(kernels, standalone)),
            ("elastic", lambda: elastic_phase(kernels, one_rank)),
            ("meta", lambda: meta_phase(kernels, one_rank)),
            ("installed", lambda: installed_phase(torch, numpy, kernels,
                                                  standalone)))
    phases.extend(forms14 + forms15 + forms16 + forms17 + forms22)
    print("distributed (%s): %s" % (card, json.dumps(distributed,
                                                     default=str)))
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "spmd.json"), "w") as f:
        json.dump(spmd, f, default=str)
    print("spmd (%s): %s" % (card, json.dumps({
        k: {kk: vv for kk, vv in v.items() if kk not in (
            "step_ms_all", "times", "launches")} if isinstance(v, dict)
        else v for k, v in spmd.items()}, default=str)))
    with open(os.path.join(out_dir, "elastic.json"), "w") as f:
        json.dump(elastic, f, default=str)
    print("elastic (%s): %s" % (card, json.dumps({
        k: v.get("checks", v.get("values_differing", "")) if isinstance(
            v, dict) else v for k, v in elastic.items()}, default=str)))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, default=str)
    print("meta (%s): %s" % (card, json.dumps({
        k: v.get("checks", "") if isinstance(v, dict) else v
        for k, v in meta.items()}, default=str)))
    with open(os.path.join(out_dir, "installed.json"), "w") as f:
        json.dump(installed, f, default=str)
    lap("distributed, spmd, elastic, meta and installed beside each other", (
        ("distributed", forms14), ("spmd", forms15),
        ("elastic", forms16), ("meta", forms17), ("installed", forms22)))

    now = split_launches()
    service, forms = service_phase(torch, numpy, kernels, card, {
        name: now[name] - swept[name] for name in now})
    phases.extend(forms)
    with open(os.path.join(out_dir, "service.json"), "w") as f:
        json.dump(service, f, default=str)
    print("service (%s): %s" % (card, json.dumps({
        k: {kk: vv for kk, vv in v.items() if kk != "entries"}
        if isinstance(v, dict) else v for k, v in service.items()},
        default=str)))
    lap("service")

    observers, forms = observers_phase(torch, numpy, kernels, card)
    phases.extend(forms)
    with open(os.path.join(out_dir, "observers.json"), "w") as f:
        json.dump(observers, f, default=str)
    lap("observers")

    services, forms = services_phase(torch, numpy, kernels, card)
    phases.extend(forms)
    with open(os.path.join(out_dir, "services.json"), "w") as f:
        json.dump(services, f, default=str)
    lap("services")

    family, forms = family_phase(torch, numpy, kernels)
    phases.extend(forms)
    print("family (%s): %s" % (card, json.dumps(family, default=str)))
    lap("family")
    phase_s.update(("%s (its own wall)" % k, round(v, 1))
                   for k, v in walls.items())
    total_s = time.perf_counter() - t0
    print("phase seconds (%s): %s, %.1f in all" % (
        card, json.dumps(phase_s), total_s))
    print("launches by phase (%s): %s" % (card,
                                          json.dumps(launches_by_phase)))
    # the kernels line outgrows the tail of the output a caller sees
    with open(os.path.join(out_dir, "phases.json"), "w") as f:
        json.dump({"card": card, "phase_s": phase_s, "total_s": total_s,
                   "build_s": seconds,
                   "launches_by_phase": launches_by_phase}, f)

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
