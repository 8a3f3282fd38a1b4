#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, PS-training and LM-training
paths on one H100 and hold each of its hand-written kernels against its
plain PyTorch version.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one, and without the
``ps_pytorch_tpu_torch`` package beside this file). Imports nothing of JAX.

Phases, one line each:

1. the card (nvidia-smi name and power limit), torch/CUDA versions, TF32 off;
2. build every kernel from ``ps_pytorch_tpu_torch/csrc`` (one nvcc per
   source, all at once; sm_90a), then count the tensor-core instructions
   (HMMA / HGMMA, from ``cuobjdump -sass``) of each tensor-core
   instantiation: K4 bf16 and f32 (D 32, 64, 128; normalized and
   partial), K5 / K6 bf16 (D 32, 64, 128; f32 and bf16 out) and K5 / K6
   f32 (D 32, 64, 128); the f32 kernels count only their TF32
   ``HMMA.1688.F32.TF32`` lines; a zero fails the run;
   beside ptxas's registers and spill bytes, and the registers and spills
   of K1's, K2's and K3's kernels;
3. K1's KV entry quantize_kv_write vs its plain version, bit-exact over
   the whole pool, at the serving path's shapes (a prefill write of 128
   positions x 8 heads x 64 bf16 into one slot; a decode write of 8
   slots, held once more with one position max_len, which is dropped):
   device time a launch (profiler), wall time a call (CUDA events), the
   plain version's and the bound, for the decode write at 8 positions in
   range as the serve path sends them; the empty-launch floor (the device
   time of a fill of one element: no launch goes under it); the serving
   pool's write a call and a tick
   through ``serve.kv``; then quantize_rows (K1's per-row kernel, one
   piece) bit-exact at a ragged f32 and an odd bf16 shape; phases 3, 7
   and 8 also hold rows and pieces that hold a NaN and no inf (a NaN
   scale, a zero payload), compared as bits;
4. K4 flash_fwd vs its plain version at the prefill shape [1, 128, 8, 64]
   (bf16 and f32, causal), at head dims 32 and 128 (both types) and an
   odd T = 100, twice (the same bits); timed with CUDA events and
   ``torch.profiler``'s device time (which also shows the route: bf16 runs
   ``flash_fwd_mma_kernel``, f32 ``flash_fwd_tf32_kernel``) beside
   ``scaled_dot_product_attention`` (the library yardstick, never called by
   the port; memory-efficient attention for f32) and its bound;
5. serve: d512 x 6 bf16 model, flash prefill, int8 KV pool, 8 slots,
   32 open-loop requests; every request completes, tokens in range, p50/p99
   finite, and the kernel launch counters match the work done: K4 once a
   layer a prefill, K1's KV entry once a layer a prefill and a decode
   tick, no other K1 entry;
6. f32 engine vs the port's per-sequence ``generate`` on the card;
7. K2 (one-piece calls of ``quantize_tensors``) vs its plain version,
   bit-exact (payload and scale), at the training wire's shapes: the
   largest ResNet18 leaf stacked for 8 workers [8, 3, 3, 512, 512], a BN
   leaf [8, 512], the dense bias [8, 10], a ragged odd length and an
   all-zero tensor; timed, with its bound; then the per-leaf wire's step:
   ResNet18's 62 stacked leaves in one ``quantize_tensors`` call,
   bit-exact against the plain version, with its device time, host
   wrapper time and device launches a step beside the bound and the
   two-pass floor;
8. K1's shared-scale entry ``quantize_rows_scaled_many`` vs its plain
   version, bit-exact, at the largest leaf's block-128 rows [8, 18432,
   128], then the block-128 wire's step (the 62 leaves in one call) as in
   phase 7, and the two-round wire's round 2 of that step (each leaf's
   region sums as 128-wide rows, 87552 in all) in one
   ``quantize_rows_many`` call, the same figures;
9. train: ResNet18 at full width on synthetic CIFAR-10, 8 stacked workers,
   batch 128 each, lr 0.1, momentum 0.9, num-aggregate 5 (random_k), the
   int8 per-tensor wire, through ``cli.train.main``: every loss finite, no
   skipped step, one K2 call per step (all 62 leaves); step time p50 and
   images/s; then a short run on the block-128 wire (one call of K1's
   shared-scale entry per step);
10. train held on the card: one LeNet step at 8 workers on the card (the
   kernels) against the same step on the CPU (the plain versions), same
   params, batch and mask, for the per-tensor and block-128 wires, and a
   NaN-injected step that must leave the params alone;
11. K3 accumulate_rescale_int8 vs its plain version, bit-exact, at the
   homomorphic two-round wire's shapes: the ResNet18 fused stacked payload
   [8, 11173968], one region [8, 1396746], [8, 130], [258, 4096] and
   [1, 1], the 2 x 4 grid's hops (stacked ICI [4, 22347928] and DCN
   [2, 11173968], one process's ICI [4, 11173964] and DCN [2, 5586984])
   and the fused payload as views at storage offsets 1, 8 and 15, with
   divisors 5.0, 8.0 and a device-tensor divisor; timed (CUDA events a
   call, the profiler's device time a launch), with its bound;
12. train ResNet18 (8 x 128, lr 0.1, momentum 0.9, num-aggregate 5) through
   ``cli.train.main`` on the autotune-best wire (``--compress-grad 2round
   --bucket-bytes 0 --wire-domain homomorphic``) for 10 steps: finite
   losses, no skipped step, exactly one K3 and one K2 call per step;
   then 3 steps of the dequant two-round wire (two K2 calls per step:
   round 1, and round 2 over all eight regions), 3 of it at block 128
   per leaf (62 pieces: one K1 shared-scale call for round 1, one
   ``quantize_rows_many`` call for round 2) and 3 at block 128 fused
   (``--bucket-bytes 0``: one piece), and 3 of the ZeRO-1 placement on
   the two-round wire (one K2 call per bucket);
12b. checkpoints on the same path: ResNet18 (phase 9's configuration)
   through ``cli.train.main --train-dir DIR --eval-freq 5``, 10 steps:
   ``model_step_5``, ``model_step_10`` and ``elastic.json`` written, each
   file's CRC trailer verifies, step 10 restores to the trainer's live
   state bit for bit; ``--resume --max-steps 15`` logs its resume at 10
   and runs steps 11-15 (finite losses, one K2 call a step) with the
   ``ckpt_corrupt`` fault at 15; a further ``--resume`` quarantines step 15
   and falls back to 10; ``cli.evaluate --once --device cuda`` within 1e-5
   (relative) of ``Trainer.validate()`` on that state; a 3-step
   ``--error-feedback`` run restores its residuals bit for bit; the bytes
   on disk, a save's host half and background write, load + restore and
   the evaluator a checkpoint (on the trainer's 992 whole-batch test
   images and on a 10,000-image synthetic test split), in seconds (every other phase runs with
   ``--no-checkpoints``);
13. one LeNet step at 8 workers, card vs CPU (phase 10's rule, with K
   times its bound on the two-round wires' coarser second rounding), on the
   autotune-best wire with EF, int8 homomorphic in 64 KiB buckets, the
   two-round dequant wire with block-128 scales and ZeRO-1 int8
   homomorphic, each with its launch counts;
14. K4's partial triple flash_partial, K5 flash_bwd_dq and K6
   flash_bwd_dkv against their plain versions at the LM-1 attention shape
   [8, 1024, 8, 64] (one causal hop at offsets 0) and at an LM-ring hop
   [8, 2048, 8, 64] (four stacked shards x batch 2, per-shard offsets of
   hop 3: one shard's keys all masked), each in bf16 and f32, each twice
   (the same bits); timed with CUDA events and ``torch.profiler``'s
   device time (which also shows each call's route: f32 runs the TF32
   kernels ``flash_fwd_tf32_kernel``, ``flash_dq_tf32_kernel``,
   ``flash_dkv_tf32_kernel``), with their bounds;
   K4-partial beside aten's forward and K5 + K6 beside its backward (the
   library yardsticks, never called by the port: wall and device time):
   for bf16 aten's flash forward and the backward sdpa picks by default,
   for f32 memory-efficient attention both ways;
15. LM-1: the JAX bench's LM leg at full width (vocab 2048, d512, depth
   6, 8 heads, seq 1024, batch 8, bf16 block math over f32 params, remat,
   SGD lr 0.01 momentum 0.9) through ``cli.train_lm.main`` at (dp 1,
   sp 1) with flash attention, 20 steps: every loss finite, launches per
   step exactly L n (1 + remat) K4-partial, L n K5 and L n K6; step p50
   and tokens/s; then 8 steps of the same at ``cli.train_lm``'s default
   ``--dtype float32`` (K4-K6 on the TF32 route), the same checks;
16. LM-ring: the same model at seq 8192 on (dp 1, sp 4) stacked shards,
   batch 2, 5 steps, the same checks;
17. a small LM step at (dp 2, sp 4), f32: the card (kernels) against the
   CPU (plain versions) on the one-way ring, the bidirectional ring and
   Ulysses (K4 normalized + K5/K6 in the input dtype), each with its
   launch counts;
18. VGG16 (BN) at full width on phase 9's configuration through
   ``cli.train.main``, 20 steps: every loss finite, no skipped step, the
   launches derived from its 58-leaf tree (K2 once a step); step p50,
   images/s, peak device memory; then VGG16NoBN and VGG11 3 steps each;
19. ResNet18 at ``--dtype bfloat16`` on phase 9's configuration, 20 steps
   (finite losses, K2 once a step), its step p50 and peak memory beside
   phase 9's f32 ones; then ``--dtype bfloat16 --remat``, 3 steps, its
   peak memory beside the bf16 run's (every run's peak measured after a
   one-step run of its configuration, whose peak is printed too); and
   one worker's forward and backward at 128 images in f32, bf16 and
   bf16 + remat, each one's peak memory;
20. one step at 8 workers of a narrow VGG11-BN (an eighth of VGG11's
   widths) with injected draws (augmentation, mask, Dropout keep-masks),
   card vs CPU under phase 10's rule, with local BN, with synced BN and
   with synced BN under ``bn_mode="local"``, one K2 call each;
20b. ResNet18 at full width, 8 workers x 128, synced BN under
   ``bn_mode="local"`` through ``make_ps_train_step`` (no CLI builds a
   synced model under local), the int8 wire, 5 steps from distinct
   per-worker stats rows: finite losses, one K2 call a step, the rows
   still distinct; step p50 and peak memory;
20c. synced BN across processes: two processes share the card over gloo,
   4 workers each, ResNet18 8 x 128 through ``cli.train --bn-mode
   synced`` on the int8 wire, 3 steps, then 3 under ``bn_mode="local"``
   (20b's library configuration) from distinct rows: finite losses, each
   process's K2 split halves once a step, the params against the stacked
   runs of the same seed (cuDNN deterministic in both; bit for bit is the
   rule), each process's stats rows the stacked run's; the step p50,
   host-copy share and peak per process beside the stacked run's and
   phase 20b's;
21. the event stream on phase 9's configuration: the tracer's host cost
   (8 steps without ``--trace`` and 8 with, in turns, twice); then
   ``--metrics-file``, ``--trace``, ``--mode straggler --kill-threshold
   0.02``, ``--straggler-storm-n 2`` and the ``{"sigterm": 4}`` fault:
   the run stops at step 4 with ``model_step_4`` written, ``--resume``
   runs 5-6, every record validates, ``straggler`` comes before
   ``straggler_storm``, the trace holds ``dispatch``, ``sync`` and
   ``ckpt_save`` spans, K2 ran once a step;
22. Adam and AMSGrad on phase 9's configuration (lr 0.001), 5 steps
   each through ``cli.train.main``: finite losses, the last below the
   first, K2 once a step, Adam's step 5 saved and resumed bit for bit;
   each optimizer update's device time on the flat state beside its
   bound (p, g and the moments read once, p and the moments written
   once); step p50 beside phase 9's SGD; then LM-1 bf16 with
   ``--optimizer adam``, 4 steps, with K4-K6's launch counts;
23. one process on ``torch.distributed`` NCCL at world size 1
   (``--coordinator-address``), the 8 workers on the process-spanning
   axis, phase 9's configuration with EF residuals on three wires
   (per-tensor int8 through K2's split route, block 128 through K1's
   shared-scale split route, the autotune-best two-round homomorphic
   fused wire: K2's split route then K3), 5 steps each: params, EF
   residuals and ``model_step_5`` bit for bit the stacked backend's run
   of the same seed (cuDNN deterministic in both), each split half once
   a step and the fused entries never; both step p50s;
24. two processes sharing the card, 4 workers each, the collectives
   over a gloo group through host memory: the same three wires, each
   ``model_step_5`` byte for byte phase 23's stacked one, the split
   routes' launches per process, step p50 and the host-copy share; a
   NaN-only piece in process 1's rows gives both processes scale NaN and
   an all-zero payload (K2 and K1 block 128); and (24b, run before phase
   23) both split routes at the ResNet18 step against their plain
   versions and the fused entries (a NaN-only piece too), timed beside
   the fused entry, each half's device time beside its own bound and the
   two halves' floor, profiled in this process (every capture padded
   with host time: ``obs.profiler.padded_profile``), and, where a capture
   holds no device event, again in a fresh process of this script
   (``--split-child``) after the empty captures are printed;
   phases 23, 30 and 30b print the SHA-256 of their checkpoints or
   aggregates (24's files are 23's, byte for byte), so runs of two trees
   compare by their lines;
25. the data path at full width: CIFAR-10 written in its on-disk form
   (``cifar-10-batches-py``, 50,000 + 10,000 images from
   ``make_synthetic``) and read back equal through ``prepare_data``, then
   phase 9's configuration from those files (``--data-root DIR
   --no-synthetic --trace``) for 10 steps: finite losses, K2 once a step,
   one ``h2d`` span a dispatched batch inside a ``fetch`` span; the step
   p50 beside phase 9's, the fetch's share of the step, the native
   gather's time for one 8 x 128 batch against numpy indexing; MNIST
   (gzipped idx) and SVHN (.mat) written small and read back equal;
26. the adaptive wire: ResNet18 8 x 128 on the autotune-best wire in 4 MiB
   buckets with ``--precision-adapt`` under a budget of 0.6 of the
   all-int8 effective bytes and the count adapting in [4, 8] over
   2-step windows, steps 4-5 stalled past the armed watchdog, 12 steps:
   the ``mask_adapt`` records the controller's rule implies, at least one
   ``precision_adapt``, K3 once a bucket a step and no K1 / K2 call; then
   the step called directly: the full count bit for bit the static
   step's params and EF residuals over 3 steps, all-int8 tags within
   1e-6 of the largest update after one step (the lattice scale is a
   quotient by the peak, as in JAX: its last bit) and within phase 13's
   K x 1e-2 after three, no host sync added by the device count and tags,
   and one K3 launch with the count as its device divisor held against
   its plain version;
27. stochastic rounding: ResNet18 8 x 128, 3 steps each on the int8 and
   the two-round wires with ``--quant-rounding stochastic``: finite
   losses and no K1 / K2 launch; the mean round-trip error over 64 of the
   card's draws of a 1 M-element tensor within 4 standard errors of 0;
   ``pack_int4`` / ``unpack_int4`` / ``quantize_lattice`` on the card bit
   for bit the CPU's;
28. the resume-reshape: ResNet18 8 x 128 ZeRO-1 with EF at 4 MiB buckets
   stopped by SIGTERM at step 4, resumed on 4 workers at ``--bucket-bytes
   0`` to step 6, then on 8 at 2 MiB to step 8: one ``resume_reshape``
   record each, the step count continued, the moments the card restored
   bit for bit the plain CPU reshape of the file, the EF residuals' sum
   kept bit for bit; the reshape's host seconds;
29. ``--overlap on`` at 4 MiB buckets on the per-tensor int8 and the
   homomorphic two-round wires, 8 steps each in turns with the serial
   schedule (twice): the step p50s, one K2 call (and K3 launch) a bucket
   a step, the share of the wire's event time before the last worker's
   backward ended; then 5 steps with EF called directly, params and EF
   residuals bit for bit the serial step's (cuDNN deterministic); a
   block-128 run's K1 calls (one a bucket);
30. ``--dcn-hosts 2`` (a 2 x 4 grid) at ``--bucket-bytes 0`` on the dequant
   (also block 128) and homomorphic two-round wires: the launches the code
   implies (K3 two a piece on the homomorphic wire), one aggregate's K3
   launches at the ICI and DCN hops bit for bit their plain versions, the
   aggregate within JAX's bound of the exact mean, the homomorphic step
   p50 beside phase 12's flat autotune-best run;
30b. the same grid over processes: two processes share the card over
   gloo, one host of the 2 x 4 grid each (``ProcessHybridAxis``), on the
   block-128 dequant and the homomorphic two-round wires, 3 steps each:
   ``model_step_3`` byte for byte the stacked grid's run of the seed
   (cuDNN deterministic in both), and NCCL at world size 1 (both hosts in
   one process) too; each process's launches as the code implies (K3
   twice a step, the split halves once, the ICI round 1's fused K1 and
   round 2 once); one aggregate's K3 launches at each per-process hop
   shape bit for bit their plain versions and the aggregate the stacked
   grid's; the step p50 and host-copy share beside phase 30's stacked p50;
   the split halves, K1's round 2 and K3 timed at the per-process shapes;
31. ``cli.train --config-json runs/autotune_resnet18.json`` (the record's
   best candidate: the homomorphic two-round wire in one fused bucket)
   on phase 12's geometry, 3 steps, with ``--profile-dir`` and
   ``--trace``: the launches the expanded flags imply (one K2 and one K3
   a step), a Chrome trace naming K3's kernel and the loop's ``fetch`` /
   ``dispatch`` / ``h2d`` spans, the capture's one-time host seconds;
32. LM-1's model (bf16, remat, flash) through ``cli.train_lm.main`` under
   ``tp 4 --shard-vocab``, ``dp_tp 2 x 4`` and ``pp 2 x 4 microbatches``,
   8 steps each: finite losses, the last below the first, K4 (normalized)
   2 c, K5 and K6 c launches a step, c the attention calls of a step
   (depth for tp and dp_tp: one call a block over every shard's heads;
   (M + S - 1) depth / S = 15 for pp: every stage's blocks run every
   tick in one call); step p50 beside phase 15's; then ``cli.evaluate_lm
   --once`` on the tp run's checkpoint (finite perplexity);
33. one f32 step of tp 4 (vocab-parallel) and of pp 2 x 2 microbatches at
   depth 2, card vs CPU under phase 17's rule, with launch counts;
34. (run right after phase 14) K4 normalized, K5 and K6 (input-dtype
   gradients) against their plain versions at phase 32's shapes, [8 x 4,
   1024, 2, 64] (tp) and [2 x 2, 1024, 8, 64] (pp), bf16 and f32, and
   phase 35's dp_tp_pp tick [8, 1024, 4, 64] in bf16, each twice (the same
   bits), timed beside the bound and aten's attention;
35. LM-1's model (bf16, remat, flash) with 8 experts at capacity factor
   1.25, 8 steps each: ``cli.train_lm.main`` under ``moe 4`` (top-1 and
   top-2), ``ep_sp 2 x 2`` (the flash ring) and ``pp_moe 2 x 2 x 4
   microbatches``, and the dp_tp_pp library at 2 x 2 x 2 (4
   microbatches): finite losses, the last below the first, a finite
   ``aux_loss`` in every MoE record, K4 / K4-partial / K5 / K6 launches a
   step as MOE_SCHEMES counts them; step p50 beside phase 15's, each
   run's peak memory; then ``cli.evaluate_lm --once --generate 8`` on the
   moe run's checkpoint (finite perplexity);
36. one f32 step at depth 2 of moe 4 top-2 with drops, ep_sp 2 x 2,
   pp_moe 2 x 2 x 2 microbatches and dp_tp_pp 2 x 2 x 2, card vs CPU under
   phase 33's rule, the expert choices equal, with launch counts;
37. the serving CLI: ``cli.train_lm`` writes checkpoints at steps 2 and 4
   of bench.py's serve model (d512 x 6, 8 heads, vocab 2048, bf16), then
   ``cli.serve --int8-kv --dtype bfloat16 --slots 8 --requests 32 --rate
   100`` (prompts 64-128, 64-128 new tokens) three times, each with
   ``--events`` and ``--trace``: from step 2 with ``--poll-interval
   0.05`` (exactly one rollover, to 4), on a copy of the directory with
   ``--fault-plan '{"rollover_corrupt": [4]}'`` (one abort, served on 2
   throughout), and with ``--slo-budget`` and ``--traffic-spike``
   (requests shed); every record validates, one terminal record a
   request, the outcome counts add up to 32, K1's KV entry 6 launches a
   prefill and a tick and no K4 (the CLI's prefill is naive, as JAX's);
   tokens/s, p50 / p99 per-token latency and TTFT, the drain's, swap's
   and abort's seconds; then an f32 d256 x 2 engine across a rollover,
   each request's tokens the per-sequence ``generate`` on the weights of
   its ``weights_step``;
38. phase 12b's ResNet18 run with ``--compress-checkpoints``: the ``PSCK``
   files verify, step 10 restores bit for bit (also from the plain form),
   ``--resume`` continues at 11 (K2 once a step), ``cli.evaluate --once``
   reads them; the bytes on disk, a save's host half and background write
   in turns with the plain form, load + restore of each form;
39. pscheck on the card: the whole contract registry
   (``ps_pytorch_tpu_torch.check``, 37 configurations) recorded with
   ``device="cuda"``: zero findings, PSC104 clean against the committed
   ``check/comm_contract.json``; each spec's kernel nodes on the tape as
   many, entry by entry, as its kernels' ``.launches`` counters grew; at
   least one node each of K1's KV write, K2 and K3; the same accounting
   rows and ``feeds_params`` flags as the same registry recorded on the
   CPU in this run; then the canonical step (ResNet18, 8 workers x 128,
   the int8 wire in 4 MiB buckets) recorded, its rows those of the
   registry's ``ps_resnet18_int8_replicated_bucketed``, and timed with
   no tape active (p50 of 9 steps after 3), beside phase 9's p50; the
   phase's seconds;
40. psnumerics on the card: PSC111-114 over phase 39's records, zero
   findings; each spec's ``NumericsReport`` (recorded on the card) the
   CPU's in this run, event for event (scale roots by their count); the
   canonical full-width step through the four rules; the phase's seconds;
41. autotune on the card: ``tools.autotune --model resnet18 --probe-top
   3`` (every candidate recorded on the card, the card's profile
   measured there, ResNet18 at its published widths), with the int8
   4 MiB wire and the fused homomorphic two-round wire probed too
   (``--probe``: the card's profile ranks the uncompressed wires first):
   a schema-valid record, each probe stamped ``gpu`` and the card's
   name, its K1 / K2 / K3 launches grown as its knobs say (K2 in both
   named probes, K3 in the homomorphic one), the profile carrying the
   card's name and power limit; the best candidate's flag line run 2 steps
   through ``cli.train --config-json``; ``cli.tune`` sweeping 2 learning
   rates x 4 steps of ResNet18 with ``--compress-grad compress`` (one K2
   call a step) and ``--workload lm`` 2 x 2 steps on the flash kernels
   (K4-K6 launched); the seconds of each part;
42. the port's pslint gate (``python -m ps_pytorch_tpu_torch.lint
   ps_pytorch_tpu_torch chip_smoke.py --baseline lint_baseline_torch.json``)
   in a process of its own on this machine: exit 0 and no new finding;
   its seconds and finding count;
43. the trace front end: phase 29's configuration (ResNet18 8 x 128, the
   int8 wire in 4 MiB buckets), ``--overlap on`` and then serial, 3 steps
   each through ``cli.train.main`` with ``--trace`` and ``--profile-dir``
   (steps 2-3 captured): ``tools.trace_report`` merges the span stream and
   passes ``--require-phases fetch,dispatch,sync``; ``tools.overlap_report
   trace`` finds device events in both profiles, and in the pipelined one
   a ``bucket_reduce_o*`` range a bucket a captured step (11) holding every
   K2 launch of the captured steps; both reports printed, their overlap
   fractions reported, not gated; ``analysis.scaling_bench`` on LeNet and
   ResNet18 x 128 at 1 / 2 / 4 / 8 stacked workers (3 timed steps after 2),
   ``tools.dcn_scaling`` at 1 and 2 gloo processes sharing the card (LeNet,
   5 steps), each record with the card's name and power limit;
44. ``tools.longcontext_check`` at T=8192 on 8 stacked shards, f32, at 1
   and 8 heads: the causal flash ring's value and gradients within the JAX
   tool's tolerances of the full-attention oracle, with exactly 16 K4
   partial, 8 K5 and 8 K6 launches (f32 route) each; errors beside JAX's
   CPU record;
45. ``tools.predicted_scaling`` on ResNet18 at 8 and 16 stacked workers,
   every mode, the link rates given (450 / 50 GB/s) and t1 measured on the
   card: the pscheck contract's kinds, no failure, one K2 launch a tape
   kernel node, each row's bytes by kind within 1% of JAX's committed
   record's, printed beside them with the row's kernel nodes;
46. ``tools.convergence --suite r04 --steps 20 --eval-freq 10``: three
   ResNet18 legs on the real-digits stand-in, each beside its polling
   evaluator: finite losses, evaluator steps 10 and 20, the int8 leg's one
   K2 call a step and the none leg's none;
47. each phase's wall seconds, the count of ``device_profile``'s captures
   and retries (each empty one with its host events and launch calls),
   the kernels JSON line, then the result line.

Any mismatch raises; the exit code is then non-zero.

    python3 chip_smoke.py --phases 2,3,4,5,7,8,9,12,12b,14,18,...,42,43,44,45,46 \
        [--package-root DIR]

runs only the named phases (the build 2; the serving pool's write of 3
through ``serve.kv`` alone; the flash kernels 4 and 14; the serve run of
5, its K1 counts reported, not required, on another tree; the 62-leaf
wire steps of 7 and 8 alone, with round 2 in 8; the ResNet18 run of 9;
K3's cases of 11; the two-round, homomorphic and ZeRO-1 wires of 12;
the checkpoints of 12b; the VGG runs of 18; the bf16 runs of 19, after
phase 9's f32 run; the held steps of 20; the synced-local ResNet18 run of
20b; the event stream of 21; the
split routes at the ResNet18 step of 24b alone; the
data path of 25, the adaptive wire of 26, stochastic rounding of 27, the
resume-reshape of 28, the pipelined wire of 29, the hierarchical wire of
30, which reports no flat run beside its own when run alone, the
``--config-json`` and profiler run of 31, the tp / dp_tp / pp runs of 32,
which report no dp_sp run beside their own when run alone, the held
steps of 33, the flash kernels at their shard shapes of 34, the MoE and
dp_tp_pp runs of 35, which report no dp_sp run beside their own when run
alone, the held MoE and dp_tp_pp steps of 36, the serving CLI of 37, the
compressed checkpoints of 38, pscheck of 39, which reports no phase 9
p50 beside its own when run alone, psnumerics of 40, which runs 39
first, autotune of 41, the lint gate of 42, the trace front end of 43,
the long-context check of 44, predicted scaling of 45, the convergence
legs of 46),
against the
``ps_pytorch_tpu_torch`` package under DIR when given (not phase 2, which
checks this tree's kernel list; another checkout:
a parent commit timed in turns with this one on the same card; a parent
without the multi-tensor entries runs its per-leaf loop of
``quantize_int8``), and prints their lines; no kernels line, no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {                 # H100 SXM dense peaks (f32: CUDA cores)
    torch.bfloat16: 989e12,
    torch.float32: 67e12,
    torch.int8: 1979e12,
}
# f32 products on the tensor cores as 3xTF32, three TF32 products each: the
# least time the card needs for an f32-accurate product (the f32 flash
# kernels' bound)
TF32X3_OPS_PER_S = 494.7e12 / 3
ITERS = 200
# set by --package-root: the package timed is another checkout's, whose
# kernels may bear other names than this one's routes; its directory, which
# the phases' child processes take too
OTHER_TREE = False
PACKAGE_ROOT = None


class SmokeError(RuntimeError):
    pass


class ProfilerEmpty(SmokeError):
    """Every trace of one ``device_profile`` came back without device
    events: no time can be read from it."""


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit equality: an f32 tensor is compared as int32, so a NaN equals
    a NaN of the same bits."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = ITERS, warmup: int = 10) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls,
    measured with CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> tuple:
    """Device time per call from ``torch.profiler`` over ``iters``
    back-to-back calls: for each CUDA kernel name, its mean time per
    recorded launch times its launches per call (at least one), summed;
    and that per name (ms per call). Per-launch means keep the figure
    right when the trace drops some of a kernel's events: summed over the
    calls instead, one run read K5 at 0.16 ms a call where CUDA events
    timed 0.53 ms."""
    total, by_name, _ = device_profile(fn, iters)
    return total, by_name


PROFILE_ATTEMPTS = 6
# device_profile's captures and the ones of them that were a retry after an
# empty trace, over the run, and each empty capture's host events and the
# kernel launch calls among them (printed by main)
PROFILE_SESSIONS = PROFILE_RETRIES = 0
EMPTY_CAPTURES = []


def device_profile(fn, iters: int = 10) -> tuple:
    """``device_ms``'s figures and the device launches (kernels and
    memsets) per call, by name. Each capture is padded with host time at
    both ends (``obs.profiler.padded_profile``): the profiler misplaces a
    capture's device events by up to 5.8 ms on the host's clock, and
    drops those it places before the capture began. A capture without
    device events is listed with its host events and launch calls (did
    the host record the launches?)."""
    from ps_pytorch_tpu_torch.obs import padded_profile

    global PROFILE_SESSIONS, PROFILE_RETRIES
    fn()
    torch.cuda.synchronize()
    seen = {}
    for attempt in range(PROFILE_ATTEMPTS):
        PROFILE_SESSIONS += 1
        PROFILE_RETRIES += attempt > 0
        with padded_profile() as prof:
            for _ in range(iters):
                fn()
        events = prof.events()
        for evt in events:
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                rec = seen.setdefault(evt.name[:80], [0, 0.0])
                rec[0] += 1
                rec[1] += evt.time_range.elapsed_us() / 1e3
        if seen:
            break
        EMPTY_CAPTURES.append({"capture": PROFILE_SESSIONS, "host_events": len(events),
                               "launch_calls": sum("LaunchKernel" in e.name for e in events)})
    if not seen:
        raise ProfilerEmpty(f"profiler: no device time recorded in {PROFILE_ATTEMPTS} traces; "
                            f"empty captures {EMPTY_CAPTURES[-PROFILE_ATTEMPTS:]}")
    per_call = {k: max(1, round(n / iters)) for k, (n, _) in seen.items()}
    by_name = {k: t / n * per_call[k] for k, (n, t) in seen.items()}
    return sum(by_name.values()), by_name, per_call


# each phase's wall seconds, by its label, over the run (printed by main)
PHASE_SECONDS = {}


def print_phase_seconds(t_main: float) -> None:
    """Each phase's wall seconds and the run's, from main's start."""
    print("phase seconds: " + json.dumps(
        {"phases": PHASE_SECONDS, "sum": sum(PHASE_SECONDS.values()),
         "run": time.perf_counter() - t_main}))


def print_captures() -> None:
    """How many ``device_profile`` captures the run took, and how many of
    them were a retry after a capture without device events."""
    print("profiler captures of device_profile: " + json.dumps(
        {"captures": PROFILE_SESSIONS, "retries": PROFILE_RETRIES, "empty": EMPTY_CAPTURES}))


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the tensor-core instantiations: (kernel, D, variant), K4 (both types)
# by entry, the bf16 K5 / K6 by output type, the f32 (TF32) K5 / K6 one
# per D
TF32_KERNELS = ("flash_fwd_tf32_kernel", "flash_dq_tf32_kernel", "flash_dkv_tf32_kernel")
MMA_KERNELS = ([(k, d, f"normalize={n}")
                for k in ("flash_fwd_mma_kernel", "flash_fwd_tf32_kernel")
                for d in (32, 64, 128) for n in ("true", "false")]
               + [(k, d, f"out={out}")
                  for k in ("flash_dq_mma_kernel", "flash_dkv_mma_kernel")
                  for d in (32, 64, 128) for out in ("f32", "bf16")]
               + [(k, d, "in=f32") for k in ("flash_dq_tf32_kernel", "flash_dkv_tf32_kernel")
                  for d in (32, 64, 128)])
_MANGLED_FWD = re.compile(r"(flash_fwd_(?:mma|tf32)_kernel)ILi(\d+)ELb([01])E")
_MANGLED_BWD = re.compile(r"(flash_d(?:q|kv)_mma_kernel)ILi(\d+)E(?:Li\d+E)?(f|13__nv_bfloat16)E")
_MANGLED_TF32 = re.compile(r"(flash_d(?:q|kv)_tf32_kernel)ILi(\d+)E")


def _instantiation(mangled: str):
    m = _MANGLED_FWD.search(mangled)
    if m is not None:
        return (m.group(1), int(m.group(2)),
                "normalize=" + ("true" if m.group(3) == "1" else "false"))
    m = _MANGLED_TF32.search(mangled)
    if m is not None:
        return (m.group(1), int(m.group(2)), "in=f32")
    m = _MANGLED_BWD.search(mangled)
    return None if m is None else (m.group(1), int(m.group(2)),
                                   "out=" + ("f32" if m.group(3) == "f" else "bf16"))


def _cuobjdump(nvcc: str) -> str:
    import shutil

    for cand in (os.path.join(os.path.dirname(nvcc), "cuobjdump"), shutil.which("cuobjdump")):
        if cand and os.path.exists(cand):
            return cand
    raise SmokeError("cuobjdump not found beside nvcc or on PATH")


def tensor_core_counts(lib_path: str, nvcc: str) -> dict:
    """Tensor-core instructions in the SASS of each K4 / K5 / K6
    tensor-core instantiation of the built library: HMMA / HGMMA lines,
    and for the f32 kernels only their TF32 ones (``HMMA.1688.F32.TF32``)."""
    sass = subprocess.run([_cuobjdump(nvcc), "-sass", lib_path], stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = _instantiation(line.split("Function :")[1].strip())
            if current is not None:
                counts[current] = 0
        elif current is not None and re.search(
                r"\bHMMA\.\S*TF32" if current[0] in TF32_KERNELS else r"\bHG?MMA\.", line):
            counts[current] += 1
    return counts


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes ptxas reported for each K4 / K5 / K6
    tensor-core instantiation (``-Xptxas -v`` in the build's log)."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = _instantiation(m.group(1))
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(current, {}).update(spill_stores=int(m.group(1)),
                                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(current, {})["registers"] = int(m.group(1))
    return out


# K1's, K2's and K3's kernels, whose registers and spills phase 2 prints
QUANT_KERNELS = ("absmax_many_kernel", "quantize_many_kernel",
                 "quantize_rows_scaled_many_kernel", "quantize_kv_write_kernel",
                 "quantize_rows_many_kernel", "rows_absmax_many_kernel",
                 "rows_quantize_given_many_kernel", "accum_rescale_aligned_kernel",
                 "accum_rescale_kernel")


def ptxas_quant_report(log: str) -> dict:
    """Registers and spill bytes ptxas reported for each of QUANT_KERNELS
    (each is one instantiation; ptxas names them mangled)."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = next((k for k in QUANT_KERNELS
                            if re.search(r"\d%s" % k, m.group(1))), None)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(current, {}).update(spill_stores=int(m.group(1)),
                                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(current, {})["registers"] = int(m.group(1))
    return out


def phase_build() -> dict:
    """Phase 2: build every kernel, then read the tensor-core instruction
    count of each K4 / K5 / K6 tensor-core instantiation from the
    library's SASS (a zero fails the run) and ptxas's registers and
    spills."""
    from ps_pytorch_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    seconds = time.perf_counter() - t0
    counts = tensor_core_counts(lib, _build._nvcc())
    regs = ptxas_report(_build.build_log())
    rec = {}
    for key in MMA_KERNELS:
        name = f"{key[0]}<D={key[1]}, {key[2]}>"
        require(counts.get(key, 0) > 0,
                f"build: {name} has {counts.get(key, 0)} tensor-core instructions")
        rec[name] = {"tensor_core_instructions": counts[key], **regs.get(key, {})}
    quant = ptxas_quant_report(_build.build_log())
    require(sorted(quant) == sorted(QUANT_KERNELS) and
            all("registers" in v for v in quant.values()),
            f"build: ptxas reported {sorted(quant)} of {QUANT_KERNELS}")
    print(f"phase 2 build: {seconds:.1f} s "
          f"({', '.join(os.path.basename(s) for s in _build.sources())} -> "
          f"{os.path.relpath(lib)}); K4/K5/K6 tensor-core SASS: " + json.dumps(rec)
          + "; K1/K2/K3: " + json.dumps(quant))
    return rec


# phase 5's serving pool: 8 slots of 256 positions, 8 heads of 64, bf16
# K / V, 128-token prompts, depth 6
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_PROMPT, SERVE_HEADS, SERVE_HD = 8, 256, 128, 8, 64
# a decode tick's positions, one a slot, all in range as the serve path
# sends them; phase 3 also holds the write with slot 3's at max_len,
# which is dropped
DECODE_POS = (5, 200, 255, 100, 17, 64, 130, 0)


def _serve_kv(rows: int, seed: int, dev):
    """K and V ``[rows, H, hd]`` as the serving engine hands them to its
    pool: head splits of one bf16 projection (strided views)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    _, k, v = _qkv(1, rows, SERVE_HEADS, SERVE_HD, torch.bfloat16, g, dev)
    return k[0], v[0]


def _serve_layer_pool(dev, seed: int) -> list:
    """One layer's int8 pool views (k_q, k_s, v_q, v_s), random contents."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (SERVE_SLOTS, SERVE_MAX_LEN, SERVE_HEADS, SERVE_HD)
    q = [torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int32)
         .to(torch.int8) for _ in range(2)]
    return [q[0], torch.rand(shape[:-1] + (1,), generator=g, device=dev),
            q[1], torch.rand(shape[:-1] + (1,), generator=g, device=dev)]


def empty_launch_floor(dev) -> dict:
    """The device time of one launch that does next to nothing, PyTorch's
    fill of a one-element tensor (the floor under every launch:
    profiler), and the time a call of such launches back to back (CUDA
    events: the launch rate from Python)."""
    one = torch.empty(1, device=dev)
    fn = lambda: one.fill_(1.0)
    dev_total, _, launches = device_profile(fn, iters=50)
    require(sum(launches.values()) == 1, f"empty launch: {launches}")
    return {"device_us": dev_total * 1e3, "ms": time_ms(fn)}


def kv_pool_write_case(dev) -> dict:
    """The serving pool's int8 write through ``serve.kv`` at phase 5's
    shapes: a prefill write of 128 positions and a decode write
    of 8 slots, per call and per tick (x depth): wall ms (CUDA events),
    device us and device launches (profiler)."""
    from ps_pytorch_tpu_torch.serve import kv

    cfg = serve_config(torch.bfloat16, "flash")
    pool = kv.init_kv_pool(cfg, SERVE_SLOTS, SERVE_MAX_LEN, int8=True, device=dev)
    kp, vp = _serve_kv(SERVE_PROMPT, 21, dev)
    kd, vd = _serve_kv(SERVE_SLOTS, 22, dev)
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    out = {}
    for name, fn in (("prefill", lambda: kv.write_slot(pool, 0, 3, kp, vp)),
                     ("decode", lambda: kv.write_token(pool, 0, pos, kd, vd))):
        dev_total, by_name, launches = device_profile(fn, iters=50)
        ms = time_ms(fn)
        out[name] = {"ms": ms, "device_us": dev_total * 1e3,
                     "device_launches": sum(launches.values()),
                     "per_tick": {"ms": ms * cfg.depth, "device_us": dev_total * 1e3 * cfg.depth,
                                  "device_launches": sum(launches.values()) * cfg.depth},
                     "device_kernels": {k[:60]: v * 1e3 for k, v in by_name.items()}}
    return out


def _kv_write_exact(what: str, k, v, pool, **where) -> float:
    """K1's KV entry and its plain version on copies of one pool: one
    launch counted, the whole pool bit-exact; the largest difference."""
    from ps_pytorch_tpu_torch.ops.quantize import quantize_kv_write, quantize_kv_write_plain

    plain = [t.clone() for t in pool]
    c0 = quantize_kv_write.launches
    quantize_kv_write(k, v, *pool, **where)
    calls = quantize_kv_write.launches - c0
    quantize_kv_write_plain(k, v, *plain, **where)
    torch.cuda.synchronize()
    require(calls == 1, f"K1 kv {what}: {calls} launches counted for one call")
    for got, want in zip(pool, plain):
        require(torch.equal(got, want), f"K1 kv {what}: the pool differs from plain")
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(pool, plain))


def phase_k1(dev) -> dict:
    """Phase 3: K1's KV entry at the serving shapes (a prefill write of 128
    positions into one slot, a decode write of 8 slots; that decode write
    once more with one position at max_len, which is dropped) against its
    plain version on a copy of the same pool, bit-exact over the whole
    pool; its device time a launch, wall time a call, the plain version's,
    the bound and the empty-launch floor; the pool write a tick; then
    ``quantize_rows`` (``quantize_rows_many``'s one-piece call on the
    lane-group kernel) bit-exact at a ragged f32 and an odd bf16 shape."""
    from ps_pytorch_tpu_torch.ops.quantize import (
        quantize_kv_write,
        quantize_kv_write_plain,
        quantize_rows,
        quantize_rows_plain,
    )

    out = {}
    pos = torch.tensor(DECODE_POS, dtype=torch.int32, device=dev)
    for name, rows, where in (("prefill", SERVE_PROMPT, dict(slot=3)),
                              ("decode", SERVE_SLOTS, dict(pos=pos))):
        k, v = _serve_kv(rows, 31 + rows, dev)
        k[0, 0] = 0.0  # an all-zero head vector: scale 0, inv 0
        pool = _serve_layer_pool(dev, rows)
        if name == "decode":
            dropped = pos.clone()
            dropped[3] = SERVE_MAX_LEN
            _kv_write_exact("decode, one position dropped", k, v, pool, pos=dropped)
        err = _kv_write_exact(name, k, v, pool, **where)
        plain = [t.clone() for t in pool]
        fn = lambda: quantize_kv_write(k, v, *pool, **where)
        dev_total, by_name, launches = device_profile(fn, iters=50)
        require(list(launches) and all("quantize_kv_write_kernel" in n for n in launches)
                and sum(launches.values()) == 1, f"K1 kv {name}: launched {launches}")
        # every row is written: the bound counts all of them
        n_elt = rows * SERVE_HEADS * SERVE_HD
        n_bytes = 2 * (2 * n_elt + n_elt + 4 * rows * SERVE_HEADS) + (4 * rows if "pos" in where
                                                                         else 0)
        b_ms, b_by = bound_ms(n_bytes, 2 * 4.0 * n_elt, PEAK_OPS_PER_S[torch.float32])
        out[name] = {
            "rows": rows, "heads": SERVE_HEADS, "head_dim": SERVE_HD, "dtype": "bfloat16",
            "max_abs_err": err, "ms": time_ms(fn), "device_us": dev_total * 1e3,
            "plain_ms": time_ms(lambda: quantize_kv_write_plain(k, v, *plain, **where)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
    # a NaN and no inf (F1): the rows holding one get a NaN scale and a
    # zero payload, bit for bit the plain version's
    k, v = _serve_kv(SERVE_SLOTS, 41, dev)
    k[2, 3, 9] = float("nan")
    v[5] = float("nan")
    for name, where in (("prefill", dict(slot=3)), ("decode", dict(pos=pos))):
        pool = _serve_layer_pool(dev, 7)
        plain = [t.clone() for t in pool]
        quantize_kv_write(k, v, *pool, **where)
        quantize_kv_write_plain(k, v, *plain, **where)
        torch.cuda.synchronize()
        require(all(same_bits(a, b) for a, b in zip(pool, plain)),
                f"K1 kv {name} NaN-only: the pool differs from plain")
    out["nan_only"] = {"bit_exact": True, "max_abs_err": 0.0}
    out["empty_launch_floor"] = empty_launch_floor(dev)
    out["pool_write"] = kv_pool_write_case(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for name, nb, bs, dt in (("rows_ragged", 1001, 128, torch.float32),
                             ("rows_odd_bf16", 17, 500, torch.bfloat16)):
        x = (torch.randn((nb, bs), generator=g, device=dev) * 3.0).to(dt)
        x[7] = 0.0
        q, s = quantize_rows(x)
        qp, sp = quantize_rows_plain(x)
        torch.cuda.synchronize()
        require(torch.equal(q, qp) and torch.equal(s, sp), f"K1 {name}: differs from plain")
        out[name] = {"shape": [nb, bs], "max_abs_err": 0.0,
                     "ms": time_ms(lambda: quantize_rows(x))}
        x[3, 1] = float("nan")  # NaN-only rows (F1)
        x[9] = float("nan")
        q, s = quantize_rows(x)
        qp, sp = quantize_rows_plain(x)
        torch.cuda.synchronize()
        require(same_bits(q, qp) and same_bits(s, sp), f"K1 {name} NaN-only: differs from plain")
    print("phase 3 K1 quantize_kv_write bit-exact vs plain: " + json.dumps(out))
    return out


def _qkv(b, t, h, d, dt, g, dev):
    """q, k, v as the engine hands them to attention: head-split views of
    one [B, T, 3*H*D] projection (strided, not contiguous)."""
    qkv = torch.randn((b, t, 3 * h * d), generator=g, device=dev).to(dt)
    return [a.reshape(b, t, h, d) for a in qkv.split(h * d, dim=-1)]


# Each flash kernel's route for each input type, chosen by dtype with no
# fallback from one to another: (kernel family, dtype) -> kernel
FLASH_ROUTE = {
    ("flash_fwd", torch.bfloat16): "flash_fwd_mma_kernel",
    ("flash_fwd", torch.float32): "flash_fwd_tf32_kernel",
    ("flash_dq", torch.bfloat16): "flash_dq_mma_kernel",
    ("flash_dq", torch.float32): "flash_dq_tf32_kernel",
    ("flash_dkv", torch.bfloat16): "flash_dkv_mma_kernel",
    ("flash_dkv", torch.float32): "flash_dkv_tf32_kernel",
}


def _device_route(what: str, fn, dt, family: str = "flash_fwd") -> tuple:
    """The flash kernel's own device time per call of ``fn`` (an entry of
    ``family``: K4 ``flash_fwd``, K5 ``flash_dq``, K6 ``flash_dkv``) and
    every kernel the call ran (tensor offsets add the small copies that
    build their device table); fails unless the one kernel of the family
    among them is the kernel of ``dt``'s route."""
    _, by_name = device_ms(fn)
    want = FLASH_ROUTE[(family, dt)]
    mine = [name for name in by_name if family + "_" in name]
    require(len(mine) == 1 and (OTHER_TREE or want in mine[0]),
            f"{what}: ran {sorted(by_name)}, expected one {want}")
    return by_name[mine[0]], sorted(by_name)


def phase_k4(flash_fwd, flash_fwd_plain, dev) -> dict:
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(2)
    # name, T, D, dtype, causal, atol, rtol
    cases = [("prefill_bf16", 128, 64, torch.bfloat16, True, 2e-2, 1e-2),
             ("prefill_f32", 128, 64, torch.float32, True, 1e-5, 0.0),
             ("odd_t100_f32_causal", 100, 64, torch.float32, True, 1e-5, 0.0),
             ("odd_t100_f32", 100, 64, torch.float32, False, 1e-5, 0.0),
             ("prefill_bf16_d32", 128, 32, torch.bfloat16, True, 2e-2, 1e-2),
             ("prefill_bf16_d128", 128, 128, torch.bfloat16, True, 2e-2, 1e-2),
             ("prefill_f32_d32", 128, 32, torch.float32, True, 1e-5, 0.0),
             ("prefill_f32_d128", 128, 128, torch.float32, True, 1e-5, 0.0),
             ("odd_t100_bf16_causal", 100, 64, torch.bfloat16, True, 2e-2, 1e-2)]
    b, h = 1, 8
    out = {}
    for name, t, d, dt, causal, atol, rtol in cases:
        q, k, v = _qkv(b, t, h, d, dt, g, dev)
        o, lse = flash_fwd(q, k, v, causal=causal)
        o2, lse2 = flash_fwd(q, k, v, causal=causal)
        op, lsep = flash_fwd_plain(q, k, v, causal, 1.0 / d ** 0.5)
        torch.cuda.synchronize()
        require(torch.equal(o, o2) and torch.equal(lse, lse2),
                f"K4 {name}: changed between two runs")
        err = (o.float() - op.float()).abs()
        lim = atol + rtol * op.float().abs()
        require(bool((err <= lim).all()), f"K4 {name}: o off by {float(err.max())}")
        lse_err = float((lse - lsep).abs().max())
        require(lse_err <= (1e-4 if dt == torch.bfloat16 else 1e-5),
                f"K4 {name}: lse off by {lse_err}")
        pairs = t * (t + 1) // 2 if causal else t * t
        n_bytes = 4 * b * t * h * d * q.element_size() + b * h * t * 4
        rate = TF32X3_OPS_PER_S if dt == torch.float32 else PEAK_OPS_PER_S[dt]
        b_ms, b_by = bound_ms(n_bytes, 4.0 * d * pairs * h * b, rate)
        qh, kh, vh = (a.transpose(1, 2) for a in (q, k, v))
        kernel = lambda: flash_fwd(q, k, v, causal=causal)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
        dev_ms, kernels = _device_route(f"K4 {name}", kernel, dt)
        rec = {
            "shape": [b, t, h, d], "dtype": str(dt).replace("torch.", ""),
            "causal": causal, "max_abs_err": float(err.max()),
            "lse_max_abs_err": lse_err,
            "ms": time_ms(kernel), "device_ms": dev_ms, "device_kernels": kernels,
            "plain_ms": time_ms(
                lambda: flash_fwd_plain(q, k, v, causal, 1.0 / d ** 0.5)),
            "library_ms": time_ms(sdpa), "library_device_ms": device_ms(sdpa)[0],
            "bound_ms": b_ms, "bound_by": b_by,
        }
        out[name] = rec
    print("phase 4 K4 flash_fwd vs plain: " + json.dumps(out))
    return out


def serve_config(dtype, impl):
    from ps_pytorch_tpu_torch.models import TransformerConfig

    # the repo's own serving shape: bench.py's serve leg (vocab 2048,
    # d512, depth 6, 8 heads, 128-token prompts + 128 new tokens)
    return TransformerConfig(vocab_size=2048, dim=512, depth=6, heads=8,
                             mlp_ratio=4, max_seq_len=256, compute_dtype=dtype,
                             attention_impl=impl)


def phase_serve(card: str, dev) -> dict:
    from ps_pytorch_tpu_torch.models import init_transformer
    from ps_pytorch_tpu_torch.obs import Tracer, summarize_spans
    from ps_pytorch_tpu_torch.ops.flash_attention import flash_fwd
    from ps_pytorch_tpu_torch.ops import quantize as qz
    from ps_pytorch_tpu_torch.serve import (
        ServeConfig, ServingEngine, TrafficConfig, make_requests, run_open_loop,
    )

    cfg = serve_config(torch.bfloat16, "flash")
    params = init_transformer(cfg, torch.Generator().manual_seed(0), device=dev)
    tracer = Tracer("chip_smoke_serve")
    engine = ServingEngine(cfg, params, ServeConfig(
        slots=8, max_len=256, max_prompt_len=128, kv_int8=True,
    ), tracer=tracer, device=dev)
    engine.warmup()
    tracer.drain()
    tc = TrafficConfig(n_requests=32, rate_rps=100.0, prompt_len_min=64,
                       prompt_len_max=128, new_tokens_min=64,
                       new_tokens_max=128, vocab_size=cfg.vocab_size, seed=0)
    requests = make_requests(tc)
    done = []
    tick = engine.tick

    def recording_tick():
        out = tick()
        done.extend(out)
        return out

    engine.tick = recording_tick
    p0, d0 = engine.n_prefills, engine.n_decode_steps
    # K1's entries: the KV entry first
    k1 = ["quantize_kv_write", "quantize_rows", "quantize_rows_many", "quantize_rows_scaled_many"]
    flash_fwd.launches = 0
    for name in k1:
        getattr(qz, name).launches = 0
    summary = run_open_loop(engine, requests)
    torch.cuda.synchronize()
    launches = {"flash_fwd": flash_fwd.launches,
                **{name: getattr(qz, name).launches for name in k1}}
    prefills = engine.n_prefills - p0
    steps = engine.n_decode_steps - d0

    require(summary["requests_completed"] == 32 and len(done) == 32,
            f"serve: {summary['requests_completed']}/32 requests completed")
    by_rid = {c.rid: c for c in done}
    for r in requests:
        c = by_rid[r.rid]
        require(len(c.tokens) == r.max_new_tokens, f"serve: rid {r.rid} short")
        require(all(0 <= t < cfg.vocab_size for t in c.tokens),
                f"serve: rid {r.rid} token out of range")
    for key in ("p50_token_latency_s", "p99_token_latency_s"):
        require(summary[key] is not None and np.isfinite(summary[key]),
                f"serve: {key} not finite")
    require(prefills == 32, f"serve: {prefills} prefills for 32 requests")
    require(launches["flash_fwd"] == cfg.depth * prefills,
            f"serve: K4 launched {launches['flash_fwd']} times, expected "
            f"{cfg.depth} x {prefills} prefills")
    require(OTHER_TREE or launches["quantize_kv_write"] == cfg.depth * (prefills + steps),
            f"serve: K1's KV entry launched {launches.get('quantize_kv_write')} times, "
            f"expected {cfg.depth} x ({prefills} prefills + {steps} decode steps)")
    require(OTHER_TREE or all(launches[name] == 0 for name in k1[1:]),
            f"serve: K1's other entries launched on the serve path: {launches}")
    rec = {
        "card": card, "model": "d512x6 vocab2048 bf16 flash-prefill int8-kv",
        "slots": 8, "prefills": prefills, "decode_steps": steps,
        "launches": launches, "summary": summary,
        "phases": summarize_spans(tracer.drain()),
    }
    print("phase 5 serve: " + json.dumps(rec))
    return rec


def _top2_margin(cfg, params, prompt, upto: int, dev) -> float:
    """Greedy replay of the per-sequence path to the decode step that
    emits new token ``upto``; returns that step's top-2 logit margin."""
    from ps_pytorch_tpu_torch.models.decode import _decode_one, init_kv_cache, prefill

    t_prompt = len(prompt)
    buf = torch.zeros((1, t_prompt + upto + 1), dtype=torch.long, device=dev)
    buf[0, :t_prompt] = torch.from_numpy(prompt.astype(np.int64)).to(dev)
    cache = init_kv_cache(cfg, 1, 256, device=dev)
    with torch.no_grad():
        if t_prompt > 1:
            cache = prefill(cfg, params, buf[:, : t_prompt - 1], cache)
        for pos in range(t_prompt - 1, t_prompt + upto):
            logits, cache = _decode_one(cfg, params, cache, buf[:, pos], pos)
            buf[:, pos + 1] = torch.argmax(logits, dim=-1)
    top2 = torch.topk(logits[0], 2).values
    return float(top2[0] - top2[1])


def phase_exact(dev) -> dict:
    from ps_pytorch_tpu_torch.models import generate, init_transformer
    from ps_pytorch_tpu_torch.serve import Request, ServeConfig, ServingEngine

    cfg = serve_config(torch.float32, "flash")
    params = init_transformer(cfg, torch.Generator().manual_seed(3), device=dev)
    engine = ServingEngine(cfg, params, ServeConfig(
        slots=8, max_len=256, max_prompt_len=128, kv_int8=False), device=dev)
    engine.warmup()
    rng = np.random.RandomState(1)
    reqs = [Request(rid=i, prompt=rng.randint(0, cfg.vocab_size, p).astype(np.int32),
                    max_new_tokens=16)
            for i, p in enumerate((9, 16, 5, 13))]
    outs = engine.decode_requests(reqs)
    mismatches = []
    for c, r in zip(outs, reqs):
        want = generate(cfg, params, torch.from_numpy(r.prompt)[None], 16,
                        max_len=256, device=dev)[0, len(r.prompt):].cpu().numpy()
        got = np.asarray(c.tokens)
        if not np.array_equal(got, want):
            i = int(np.nonzero(got != want)[0][0])
            margin = _top2_margin(cfg, params, r.prompt, i, dev)
            mismatches.append({"rid": r.rid, "index": i, "top2_margin": margin})
            require(margin < 1e-4, f"exact: rid {r.rid} diverges at new token "
                    f"{i} with top-2 margin {margin}")
    rec = {"requests": len(reqs), "new_tokens": 16 * len(reqs),
           "mismatches_on_near_ties": mismatches}
    print("phase 6 f32 engine == per-sequence generate: " + json.dumps(rec))
    return rec

# ResNet18's largest leaf (BasicBlock_7/Conv_1 kernel) and the wire's
# worker count: the shapes the training path hands K2 and K1
RESNET18_LEAVES = 62
BIG_LEAF = (3, 3, 512, 512)
WORKERS = 8
# ResNet18's 11173962 parameters padded to n*s = 8 x 1396746: the fused
# two-round payload K3 sums per step
RESNET18_PADDED = 11173968


def resnet18_step_pieces(dev) -> list:
    """ResNet18's 62 leaves stacked for 8 workers, magnitudes varying by
    worker and leaf: the pieces the per-leaf wire quantizes in a step."""
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves

    params, _ = build_model("ResNet18").init(torch.Generator().manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(12)
    out = []
    for leaf in tree_leaves(params):
        scale = torch.exp(torch.randn((WORKERS,) + (1,) * leaf.dim(), generator=g, device=dev))
        out.append(torch.randn((WORKERS,) + tuple(leaf.shape), generator=g, device=dev)
                   * scale * 0.01)
    require(len(out) == RESNET18_LEAVES, f"ResNet18 has {len(out)} leaves")
    return out


def _wire_entry(block: int):
    """The quantize of one wire step over its pieces, through the
    package's own entry, and that entry's call counter: one
    ``quantize_int8_many`` call where the package has it, else (a parent
    tree) ``quantize_int8`` leaf by leaf, as its wire loop calls it."""
    from ps_pytorch_tpu_torch.ops import quantize as q
    from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis

    axis = WorkerAxis(WORKERS)
    if hasattr(q, "quantize_int8_many"):
        counter = q.quantize_rows_scaled_many if block else q.quantize_tensors
        return (lambda xs: q.quantize_int8_many(xs, axis, block)), counter
    counter = q.quantize_rows_scaled if block else q.quantize_tensor
    return (lambda xs: [q.quantize_int8(x, axis_name=axis, block_size=block,
                                        return_absmax=True) for x in xs]), counter


def host_ms(fn, reps: int = 20) -> float:
    """Median host time of one call of ``fn`` (the wrapper's enqueue
    cost), each call started on an idle card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def wire_step_case(dev, block: int) -> dict:
    """The per-leaf wire's quantize of one ResNet18 step (62 stacked
    leaves; block 0: K2, block 128: K1's shared-scale entry), held
    bit-exact against the same call on CPU copies (the plain versions),
    with its device time, wall and host time, wrapper calls and device
    launches per step beside the bound (x read once, every output written
    once) and the two-pass floor (x read twice)."""
    from ps_pytorch_tpu_torch.ops import quantize as q

    xs = resnet18_step_pieces(dev)
    fn, counter = _wire_entry(block)
    c0 = counter.launches
    got = fn(xs)
    torch.cuda.synchronize()
    calls = counter.launches - c0
    want = fn([x.cpu() for x in xs])
    for i, ((qg, sg, ag), (qw, sw, aw)) in enumerate(zip(got, want)):
        require(torch.equal(qg.cpu(), qw) and torch.equal(sg.cpu(), sw)
                and torch.equal(ag.cpu(), aw),
                f"wire step block {block}: piece {i} differs from the plain version")
    if not OTHER_TREE:
        require(calls == 1, f"wire step block {block}: {calls} wrapper calls, expected 1")
    n_in = sum(x.numel() for x in xs)
    n_out = sum(qg.numel() + 4 * sg.numel() + 4 * ag.numel() for qg, sg, ag in got)
    dev_total, by_name, launches = device_profile(lambda: fn(xs))
    b_ms, b_by = bound_ms(4 * n_in + n_out, 4.0 * n_in, PEAK_OPS_PER_S[torch.float32])
    rec = {
        "pieces": len(xs), "elements": n_in, "wrapper_calls": calls,
        "device_launches": sum(launches.values()),
        "device_ms": dev_total, "device_kernels": {k[:60]: v for k, v in by_name.items()},
        "ms": time_ms(lambda: fn(xs), iters=50), "host_ms": host_ms(lambda: fn(xs)),
        "bound_ms": b_ms, "bound_by": b_by,
        "two_pass_floor_ms": (8 * n_in + n_out) / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": 0.0,
    }
    if not OTHER_TREE:
        plain = (q.quantize_tensors_plain if not block else
                 lambda ys: q.quantize_rows_scaled_many_plain(ys, block))
        rec["plain_ms"] = time_ms(lambda: plain(xs), iters=5)
    return rec


def _slice128(total: int, n: int) -> int:
    """A region's length of the block-128 two-round wire: ceil(total / n)
    in whole 128-blocks (collectives._slice_len)."""
    return (-(-total // n) + 127) // 128 * 128


def resnet18_round2_rows(dev) -> list:
    """The block-128 two-round wire's round-2 input of one ResNet18 step:
    each leaf padded to ``n * s`` (s whole blocks a region), its region
    sums ``[n, s]`` as ``[n s / 128, 128]`` rows."""
    out = []
    for x in resnet18_step_pieces(dev):
        n = x[0].numel()
        s = _slice128(n, WORKERS)
        flat = torch.nn.functional.pad(x.reshape(WORKERS, n), (0, WORKERS * s - n))
        out.append(flat.reshape(WORKERS, WORKERS * s).sum(0).reshape(-1, 128))
    return out


def round2_step_case(dev) -> dict:
    """Round 2 of a block-128 two-round ResNet18 step (62 pieces) in one
    ``quantize_rows_many`` call, held bit-exact against the same call on
    CPU copies (the plain version); device time, wall and host time,
    launches counted and device launches a step beside the bound (the
    rows read once, int8 and a scale a row written once)."""
    from ps_pytorch_tpu_torch.ops import quantize as q

    fn, plain = q.quantize_rows_many, q.quantize_rows_many_plain
    xs = resnet18_round2_rows(dev)
    c0 = fn.launches
    got = fn(xs)
    torch.cuda.synchronize()
    calls = fn.launches - c0
    for i, ((qg, sg), (qw, sw)) in enumerate(zip(got, plain([x.cpu() for x in xs]))):
        require(torch.equal(qg.cpu(), qw) and torch.equal(sg.cpu(), sw),
                f"round 2: piece {i} differs from the plain version")
    require(calls == 1, f"round 2: {calls} launches counted, expected 1")
    rows = sum(x.shape[0] for x in xs)
    n_in = sum(x.numel() for x in xs)
    dev_total, by_name, launches = device_profile(lambda: fn(xs))
    b_ms, b_by = bound_ms(4 * n_in + n_in + 4 * rows, 4.0 * n_in, PEAK_OPS_PER_S[torch.float32])
    return {"pieces": len(xs), "rows": rows, "elements": n_in, "wrapper_calls": calls,
            "device_launches": sum(launches.values()), "device_ms": dev_total,
            "device_kernels": {k[:60]: v for k, v in by_name.items()},
            "ms": time_ms(lambda: fn(xs), iters=50), "host_ms": host_ms(lambda: fn(xs)),
            "plain_ms": time_ms(lambda: plain(xs), iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}


def phase_k2(dev) -> dict:
    from ps_pytorch_tpu_torch.ops.quantize import quantize_tensor, quantize_tensor_plain

    g = torch.Generator(device=dev).manual_seed(7)
    cases = [("largest_leaf", (WORKERS,) + BIG_LEAF), ("bn_leaf", (WORKERS, 512)),
             ("dense_bias", (WORKERS, 10)), ("ragged_odd", (WORKERS, 12345)),
             ("all_zero", (WORKERS, 4099))]
    out = {}
    for name, shape in cases:
        x = torch.randn(shape, generator=g, device=dev) * 0.01
        if name == "all_zero":
            x.zero_()
        q, s = quantize_tensor(x)
        qp, sp = quantize_tensor_plain(x)
        torch.cuda.synchronize()
        require(torch.equal(q, qp), f"K2 {name}: int8 payload differs from plain")
        require(torch.equal(s, sp), f"K2 {name}: scale differs from plain")
        if name == "all_zero":
            require(float(s) == 0.0 and not bool(q.any()), "K2 all_zero: scale or payload != 0")
        n = x.numel()
        # the contract's bound: x read once, q written once, one scale
        b_ms, b_by = bound_ms(4 * n + n + 4, 4.0 * n, PEAK_OPS_PER_S[torch.float32])
        out[name] = {
            "shape": list(shape), "max_abs_err": float((q.int() - qp.int()).abs().max()),
            "scale_equal": True,
            "ms": time_ms(lambda: quantize_tensor(x)),
            "plain_ms": time_ms(lambda: quantize_tensor_plain(x)),
            "bound_ms": b_ms, "bound_by": b_by,
            "two_pass_floor_ms": (8 * n + n + 4) / HBM_BYTES_PER_S * 1e3,
        }
    # a NaN and no inf (F1): NaN absmax and scale, zero payload, the
    # finite pieces beside it unchanged; bit for bit the plain version's
    from ps_pytorch_tpu_torch.ops.quantize import quantize_tensors, quantize_tensors_plain

    xs = [torch.randn((WORKERS, n), generator=g, device=dev) * 0.01 for n in (4099, 12345, 10)]
    xs[1][3, 100] = float("nan")
    for i, (got, want) in enumerate(zip(quantize_tensors(xs), quantize_tensors_plain(xs))):
        require(all(same_bits(a, b) for a, b in zip(got, want)),
                f"K2 NaN-only: piece {i} differs from plain")
    require(bool(torch.isnan(quantize_tensors(xs)[1][1])), "K2 NaN-only: the scale is not NaN")
    out["nan_only"] = {"bit_exact": True, "max_abs_err": 0.0}
    out["resnet18_step"] = wire_step_case(dev, 0)
    print("phase 7 K2 quantize_tensors bit-exact vs plain: " + json.dumps(out))
    return out


def phase_k1_scaled(dev) -> dict:
    from ps_pytorch_tpu_torch.ops.quantize import (
        quantize_rows_scaled_many,
        quantize_rows_scaled_many_plain,
    )

    g = torch.Generator(device=dev).manual_seed(8)
    nb = int(np.prod(BIG_LEAF)) // 128
    x = torch.randn((WORKERS, nb * 128), generator=g, device=dev) * 0.01
    x.view(WORKERS, nb, 128)[:, 5] = 0.0  # one block all-zero on every worker
    (q, s, a), = quantize_rows_scaled_many([x], 128)
    (qp, sp, ap), = quantize_rows_scaled_many_plain([x], 128)
    torch.cuda.synchronize()
    require(torch.equal(q, qp), "K1 scaled: int8 payload differs from plain")
    require(torch.equal(s, sp) and torch.equal(a, ap), "K1 scaled: scales differ from plain")
    n = x.numel()
    b_ms, b_by = bound_ms(4 * n + n + 8 * nb, 4.0 * n, PEAK_OPS_PER_S[torch.float32])
    # a NaN and no inf (F1), in one block of one worker, and a NaN round-2
    # row: bit for bit the plain versions'
    from ps_pytorch_tpu_torch.ops.quantize import quantize_rows_many, quantize_rows_many_plain

    xn = x.clone()
    xn.view(WORKERS, nb, 128)[6, 9, 17] = float("nan")
    for got, want in zip(quantize_rows_scaled_many([xn], 128)[0],
                         quantize_rows_scaled_many_plain([xn], 128)[0]):
        require(same_bits(got, want), "K1 scaled NaN-only: differs from plain")
    rows = xn.view(-1, 128)[:4096]
    for got, want in zip(quantize_rows_many([rows])[0], quantize_rows_many_plain([rows])[0]):
        require(same_bits(got, want), "K1 rows_many NaN-only: differs from plain")
    torch.cuda.synchronize()
    out = {"shape": [WORKERS, nb, 128], "shared_rows": nb, "nan_only": {"bit_exact": True},
           "max_abs_err": float((q.int() - qp.int()).abs().max()),
           "ms": time_ms(lambda: quantize_rows_scaled_many([x], 128)),
           "plain_ms": time_ms(lambda: quantize_rows_scaled_many_plain([x], 128)),
           "bound_ms": b_ms, "bound_by": b_by,
           "resnet18_step": wire_step_case(dev, 128),
           "resnet18_round2": round2_step_case(dev)}
    print("phase 8 K1 quantize_rows_scaled_many / quantize_rows_many bit-exact vs plain: "
          + json.dumps(out))
    return out


TRAIN_ARGS = ["--network", "ResNet18", "--dataset", "Cifar10", "--num-workers",
              str(WORKERS), "--batch-size", "128", "--lr", "0.1", "--momentum", "0.9",
              "--num-aggregate", "5", "--compress-grad", "compress", "--log-interval",
              "1", "--device", "cuda"]


def _train(steps: int, extra=(), checkpoints: bool = False) -> dict:
    """``cli.train.main`` on the Train configuration; without
    ``checkpoints`` (every phase but 12b) it writes none."""
    from ps_pytorch_tpu_torch.cli import train as cli_train

    args = TRAIN_ARGS + ["--max-steps", str(steps), *extra]
    if not checkpoints:
        args.append("--no-checkpoints")
    return cli_train.main(args)


def _peak_of(fn) -> tuple:
    """``fn(base)`` and its device-memory high-water mark: bytes above
    ``base``, what was allocated when it started (``max_memory_allocated``
    after ``reset_peak_memory_stats``; garbage collected first, so no
    earlier run's tensors are freed inside the window)."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn(base)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _step_memory(base: int, rows: list):
    """A stand-in for the trainer's ``make_ps_train_step`` whose steps
    each append ``(bytes allocated, high-water mark so far)`` above
    ``base`` to ``rows`` once the step's kernels are done."""
    import ps_pytorch_tpu_torch.trainer as trainer_mod

    make = trainer_mod.make_ps_train_step

    def probed_make(*a, **k):
        step = make(*a, **k)

        def probed(*sa, **sk):
            out = step(*sa, **sk)
            torch.cuda.synchronize()
            rows.append((torch.cuda.memory_allocated() - base,
                         torch.cuda.max_memory_allocated() - base))
            return out

        return probed

    return probed_make


def _train_peak(steps: int, extra=(), reset=lambda: None, per_step=None) -> tuple:
    """``_train`` of ``steps`` and its peak memory, after a one-step run
    of the same configuration whose peak is returned too: the first run
    of a shape holds cuDNN's trial workspaces while it picks the shape's
    engine (PyTorch then caches the plan), so the two differ. ``reset``
    runs between them (the launch counters). A ``per_step`` list gets
    each step's memory (``_step_memory``) of the second run."""
    import ps_pytorch_tpu_torch.trainer as trainer_mod

    first = _peak_of(lambda base: _train(1, extra))[1]
    reset()

    def run(base):
        if per_step is None:
            return _train(steps, extra)
        make = trainer_mod.make_ps_train_step
        trainer_mod.make_ps_train_step = _step_memory(base, per_step)
        try:
            return _train(steps, extra)
        finally:
            trainer_mod.make_ps_train_step = make

    out, peak = _peak_of(run)
    return out, peak, first


def _step_p50(hist, warm: int = 3) -> float:
    """Median step seconds after ``warm`` steps (cuDNN's algorithm search)."""
    return float(np.median([h["time_cost"] for h in hist[warm:]]))


def phase_train(card: str) -> dict:
    """Phase 9. On another tree (``--package-root``) the launch counts
    are reported, not required: a parent counts its calls per leaf."""
    _, k2c = _wire_entry(0)
    _, k1c = _wire_entry(128)

    steps = 20

    def reset():
        k2c.launches = 0
        k1c.launches = 0

    out, peak, first_peak = _train_peak(steps, reset=reset)
    k2, k1s = k2c.launches, k1c.launches
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    require(len(losses) == steps and all(np.isfinite(v) for v in losses),
            f"train: losses {losses}")
    require(out["train"]["skipped_steps"] == 0.0, "train: a step was skipped")
    require(OTHER_TREE or k2 == steps,
            f"train: K2 called {k2} times, expected once a step for {steps} steps")
    require(k1s == 0, f"train: K1 scaled launched {k1s} times on the per-tensor wire")
    times = [h["time_cost"] for h in hist[3:]]  # after warm-up (cuDNN autotune)
    p50 = float(np.median(times))
    rec = {"card": card, "model": "ResNet18 synthetic Cifar10 f32 (TF32 off)",
           "workers": WORKERS, "batch_per_worker": 128, "steps": steps,
           "wire": "int8 per-tensor, num-aggregate 5 random_k",
           "launches": {k2c.__name__: k2, k1c.__name__: k1s},
           "loss_first": losses[0], "loss_last": losses[-1],
           "step_ms_p50": p50 * 1e3, "step_ms_min": min(times) * 1e3,
           "step_ms_max": max(times) * 1e3,
           "images_per_s": WORKERS * 128 / p50, "peak_mem_bytes": peak,
           "peak_mem_first_run_bytes": first_peak, "val": out["val"]}
    print("phase 9 train ResNet18 int8 per-tensor: " + json.dumps(rec))

    steps_b = 3
    k2c.launches = 0
    k1c.launches = 0
    out_b = _train(steps_b, ["--quant-block-size", "128"])
    torch.cuda.synchronize()
    k1s_b, k2_b = k1c.launches, k2c.launches
    lb = [h["loss"] for h in out_b["history"]]
    require(all(np.isfinite(v) for v in lb), f"train block-128: losses {lb}")
    require(OTHER_TREE or k1s_b == steps_b,
            f"train block-128: K1 scaled called {k1s_b} times, expected once a step "
            f"for {steps_b} steps")
    require(k2_b == 0, f"train block-128: K2 launched {k2_b} times")
    rec_b = {"wire": "int8 block-128", "steps": steps_b,
             "launches": {k1c.__name__: k1s_b, k2c.__name__: k2_b},
             "losses": lb,
             "step_ms_last": out_b["history"][-1]["time_cost"] * 1e3}
    print("phase 9b train ResNet18 int8 block-128: " + json.dumps(rec_b))
    rec["block128"] = rec_b
    return rec


# K3's operands on the 2 x 4 grid's homomorphic wire at --bucket-bytes 0
# (phases 30 and 30b report the shapes they see): the stacked grid's ICI
# hop and DCN hop, and one process's ICI and DCN hops when each process
# holds one host; pitches with s % 16 of 8, 0, 12 and 8
GRID_K3_HOPS = (("grid_ici_hop", 4, 22347928), ("grid_dcn_hop", 2, 11173968),
                ("process_ici_hop", 4, 11173964), ("process_dcn_hop", 2, 5586984))
# storage offsets of phase 11's views of the fused payload: every row's
# base off the 16-byte grid
K3_VIEW_OFFSETS = (1, 8, 15)


def _k3_device_ms(fn) -> float:
    """K3's own device time a call (profiler): the kernel's entries only."""
    _, by_name, _ = device_profile(fn)
    times = [t for name, t in by_name.items() if "accum_rescale" in name]
    require(bool(times), f"K3: no accum_rescale kernel in the trace ({sorted(by_name)})")
    return sum(times)


def phase_k3(dev) -> dict:
    """Phase 11: K3 bit for bit against its plain version at the wires'
    shapes, at the 2 x 4 grid's hop shapes and on views of the fused
    payload at odd storage offsets; CUDA-event time a call, device time
    a launch (a device-tensor divisor: no fill beside the kernel), the
    plain version's time and the bound."""
    from ps_pytorch_tpu_torch.ops.quantize import (
        accumulate_rescale_int8,
        accumulate_rescale_plain,
    )

    g = torch.Generator(device=dev).manual_seed(11)
    cases = [("resnet18_fused", WORKERS, RESNET18_PADDED, 0),
             ("resnet18_region", WORKERS, RESNET18_PADDED // WORKERS, 0),
             ("ragged", WORKERS, 130, 0), ("int16_capacity", 258, 4096, 0), ("one", 1, 1, 0)]
    cases += [(name, n, s, 0) for name, n, s in GRID_K3_HOPS]
    cases += [(f"resnet18_fused_offset{o}", WORKERS, RESNET18_PADDED, o) for o in K3_VIEW_OFFSETS]
    out = {}
    for name, n, s, offset in cases:
        buf = torch.randint(-127, 128, (n * s + offset,), generator=g, device=dev,
                            dtype=torch.int32).to(torch.int8)
        recv = buf[offset:].view(n, s)  # contiguous, storage offset `offset`
        recv[:, 0] = 127  # a full-scale column
        err = 0
        for d in (5.0, 8.0, torch.tensor(float(n), device=dev)):
            k3 = accumulate_rescale_int8(recv, d)
            plain = accumulate_rescale_plain(recv, d)
            torch.cuda.synchronize()
            require(torch.equal(k3, plain), f"K3 {name} divisor {d}: differs from plain")
            err = max(err, int((k3.int() - plain.int()).abs().max()))
        # the contract's bound: recv read once, the int8 row written once;
        # n adds per column on the int8 path
        b_ms, b_by = bound_ms(n * s + s, float(n * s), PEAK_OPS_PER_S[torch.int8])
        div = torch.tensor(5.0, device=dev)
        out[name] = {
            "shape": [n, s], "storage_offset": offset, "s_mod_16": s % 16,
            "base_mod_16": recv.data_ptr() % 16, "max_abs_err": float(err),
            "ms": time_ms(lambda: accumulate_rescale_int8(recv, 5.0)),
            "device_ms": _k3_device_ms(lambda: accumulate_rescale_int8(recv, div)),
            "plain_ms": time_ms(lambda: accumulate_rescale_plain(recv, 5.0), iters=20),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        del buf, recv
    print("phase 11 K3 accumulate_rescale_int8 bit-exact vs plain: " + json.dumps(out))
    return out


def _pieces(cfg, params) -> int:
    """How many pieces the config's wire ships per step (one per leaf,
    or one per bucket of its plan), from the port's own geometry."""
    from ps_pytorch_tpu_torch.parallel.buckets import tree_layout, tree_leaves
    from ps_pytorch_tpu_torch.parallel.ps import state_plan

    if cfg.bucket_bytes is None and cfg.opt_placement != "sharded":
        return len(tree_leaves(params))
    return state_plan(cfg, tree_layout(params).total).n_buckets


def expected_launches(cfg, params) -> dict:
    """Wrapper calls per step of ``cfg``'s wire, computed from the code (a
    multi-tensor call counts once, however many pieces it takes): round 1
    quantizes every piece in one call (K2 per tensor, K1 shared-scale per
    block); the dequant two-round wire requantizes every region of every
    piece in a second call (K2 per tensor, K1's ``quantize_rows_many`` per
    block); the homomorphic two-round wire runs K3 once per piece; the
    ZeRO-1 wire has round 1 only, one call per bucket. The pipelined
    schedule (``--overlap on``) makes each of those calls once a bucket.
    The hierarchical dequant wire (``--dcn-hosts``) quantizes twice
    before its round 2 (the ICI round 1 and the DCN hop's round 1), and
    its homomorphic wire runs K3 twice a piece (the ICI and DCN hops).
    Nothing on a wire calls ``quantize_rows`` or the KV entry."""
    p = _pieces(cfg, params)
    block = bool(cfg.quant_block_size)
    sharded = cfg.opt_placement == "sharded"
    two_round = cfg.compress == "int8_2round" and not sharded
    hom = cfg.wire_domain == "homomorphic"
    hier = two_round and cfg.dcn_hosts > 1
    calls = p if sharded or cfg.overlap == "pipelined" else 1
    round1 = calls * (2 if hier and not hom else 1)
    round2 = calls if two_round and not hom else 0
    return {
        "quantize_tensors": 0 if block else round1 + round2,
        "quantize_rows_scaled_many": round1 if block else 0,
        "quantize_rows_many": round2 if block else 0,
        "quantize_rows": 0,
        "quantize_kv_write": 0,
        "accumulate_rescale_int8": p * (2 if hier else 1) if two_round and hom else 0,
    }


def _counters():
    from ps_pytorch_tpu_torch.ops import quantize as q

    return {name: getattr(q, name) for name in (
        "quantize_tensors", "quantize_rows_scaled_many", "quantize_rows_many", "quantize_rows",
        "quantize_kv_write", "accumulate_rescale_int8")}


def reset_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_train_wires(card: str) -> dict:
    from ps_pytorch_tpu_torch.cli._flags import add_ps_flags, add_train_flags, ps_config_from
    from ps_pytorch_tpu_torch.models import build_model, init_model

    resnet, _ = init_model(build_model("ResNet18"), torch.Generator().manual_seed(0),
                           device="cpu")
    runs = [("autotune_best", 10, ["--compress-grad", "2round", "--bucket-bytes", "0",
                                   "--wire-domain", "homomorphic"]),
            ("2round_dequant", 3, ["--compress-grad", "2round", "--bucket-bytes", "0"]),
            # per leaf: 62 pieces, round 2 in one quantize_rows_many call
            ("2round_dequant_block128", 3, ["--compress-grad", "2round",
                                            "--quant-block-size", "128"]),
            ("2round_dequant_block128_fused", 3, ["--compress-grad", "2round", "--bucket-bytes",
                                                  "0", "--quant-block-size", "128"]),
            ("zero1_2round", 3, ["--opt-placement", "sharded", "--compress-grad", "2round"])]
    parser = add_ps_flags(add_train_flags(argparse.ArgumentParser()))
    out = {}
    for name, steps, flags in runs:
        # the config cli.train builds from these flags
        cfg = ps_config_from(parser.parse_args(TRAIN_ARGS + flags), WORKERS)
        want = {k: v * steps for k, v in expected_launches(cfg, resnet).items()}
        reset_counts()
        res = _train(steps, flags)
        torch.cuda.synchronize()
        got = read_counts()
        hist = res["history"]
        losses = [h["loss"] for h in hist]
        require(len(losses) == steps and all(np.isfinite(v) for v in losses),
                f"train {name}: losses {losses}")
        require(res["train"]["skipped_steps"] == 0.0, f"train {name}: a step was skipped")
        require(got == want, f"train {name}: launches {got}, expected {want}")
        rec = {"flags": " ".join(flags), "steps": steps, "launches": got,
               "loss_first": losses[0], "loss_last": losses[-1], "losses": losses}
        if steps >= 10:
            times = [h["time_cost"] for h in hist[3:]]  # after cuDNN's warm-up
            p50 = float(np.median(times))
            rec.update({"card": card, "step_ms_p50": p50 * 1e3,
                        "step_ms_min": min(times) * 1e3, "step_ms_max": max(times) * 1e3,
                        "images_per_s": WORKERS * 128 / p50})
        out[name] = rec
    require(out["autotune_best"]["launches"]["accumulate_rescale_int8"] == 10,
            "train autotune_best: K3 not launched once per step")
    require(out["2round_dequant_block128"]["launches"]["quantize_rows_many"] == 3,
            "train 2round_dequant_block128: round 2 not one K1 call a step")
    print("phase 12 train ResNet18 on the two-round / homomorphic / ZeRO-1 wires: "
          + json.dumps(out))
    return out


def _state_bits(a, b) -> bool:
    """Two states' checkpoint dicts equal leaf for leaf, bit for bit."""
    from ps_pytorch_tpu_torch.utils.serialization import to_state_dict

    def leaves(sd, path=""):
        if isinstance(sd, dict):
            for k, v in sd.items():
                yield from leaves(v, f"{path}/{k}")
        else:
            yield path, sd

    la, lb = list(leaves(to_state_dict(a))), list(leaves(to_state_dict(b)))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        (x is None and y is None) or (np.asarray(x).dtype == np.asarray(y).dtype
                                      and np.asarray(x).shape == np.asarray(y).shape
                                      and np.asarray(x).tobytes() == np.asarray(y).tobytes())
        for (_, x), (_, y) in zip(la, lb))


FULL_TEST = 10000  # CIFAR-10's test split


def phase_checkpoint(card: str) -> dict:
    """Phase 12b: checkpoints on the paper's main path. ResNet18 8 x 128
    on the int8 per-tensor wire through ``cli.train.main --train-dir``:
    10 steps saving at 5 and 10; every file's trailer verifies and step
    10 restores to the trainer's live state bit for bit; ``--resume
    --max-steps 15`` resumes at 10 and runs 11-15 (one K2 call a step),
    its step-15 file truncated by the ``ckpt_corrupt`` fault; a further
    ``--resume`` quarantines 15 and falls back to 10; ``cli.evaluate
    --once`` within 1e-5 of ``Trainer.validate()`` on that state (the
    trainer's 1024-image synthetic test split, 992 images in whole
    batches); a 3-step ``--error-feedback`` run restores its residuals
    bit for bit. Timed: the bytes on disk, a save's host half (gather +
    submit) and its background write, load + restore, the evaluator a
    checkpoint on that split and on a FULL_TEST-image one."""
    import logging
    import tempfile

    from ps_pytorch_tpu_torch import checkpoint as ckpt
    from ps_pytorch_tpu_torch.cli import evaluate as cli_evaluate
    from ps_pytorch_tpu_torch.data import make_synthetic
    from ps_pytorch_tpu_torch.resilience import elastic

    lines = []

    class Grab(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    grab = Grab()
    log = logging.getLogger("ps_pytorch_tpu_torch")
    log.addHandler(grab)
    rec = {"card": card}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            d = os.path.join(tmp, "models")
            ck = ["--train-dir", d, "--eval-freq", "5"]
            reset_counts()
            first = _train(10, ck, checkpoints=True)
            torch.cuda.synchronize()
            require(read_counts()["quantize_tensors"] == 10,
                    f"checkpoint: launches {read_counts()} in 10 steps")
            trainer = first["trainer"]
            require(ckpt.available_steps(d) == [5, 10]
                    and os.path.exists(os.path.join(d, elastic.GEOMETRY_FILE)),
                    f"checkpoint: files {sorted(os.listdir(d))}")
            for step in (5, 10):
                ckpt.verify_checkpoint(d, step)
            t0 = time.perf_counter()
            restored = trainer._restore_step(10)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            require(_state_bits(restored, trainer.state),
                    "checkpoint: step 10 restored differs from the live state")
            # the two halves of a save, timed apart: the caller's copy to
            # the host and submit, then the writer thread's msgpack + write
            t0 = time.perf_counter()
            trainer._ckpt.save(trainer.checkpoint_state(), os.path.join(tmp, "timed"), 10)
            host_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            trainer._ckpt.wait()
            write_s = time.perf_counter() - t0
            nbytes = os.path.getsize(ckpt.checkpoint_path(d, 10))

            lines.clear()
            reset_counts()
            res = _train(15, ck + ["--resume", "--fault-plan", '{"ckpt_corrupt": [15]}'],
                         checkpoints=True)
            torch.cuda.synchronize()
            counts = read_counts()
            steps = [h["step"] for h in res["history"]]
            losses = [h["loss"] for h in res["history"]]
            require(any(x.startswith("resumed from") and x.endswith("model_step_10")
                        for x in lines), "checkpoint: no 'resumed from ... model_step_10' line")
            require(steps == [11, 12, 13, 14, 15] and all(np.isfinite(losses)),
                    f"checkpoint resume: steps {steps}, losses {losses}")
            require(counts["quantize_tensors"] == 5
                    and sum(counts.values()) == counts["quantize_tensors"],
                    f"checkpoint resume: launches {counts}, expected K2 once a step")
            require(ckpt.latest_valid_step(d) == 10, "checkpoint: step 15 is not damaged")

            lines.clear()
            back = _train(10, ck + ["--resume"], checkpoints=True)
            require(os.path.exists(ckpt.checkpoint_path(d, 15) + ckpt.QUARANTINE_SUFFIX)
                    and ckpt.available_steps(d) == [5, 10]
                    and back["trainer"].state.step == 10 and back["history"] == [],
                    "checkpoint: step 15 not quarantined or no fall back to 10")
            require(any("quarantined corrupt checkpoint" in x for x in lines),
                    "checkpoint: no quarantine line")
            val = back["val"]
            # validate()'s batches: test-batch-size 500 cut to whole workers
            ev = cli_evaluate.Evaluator("ResNet18", "Cifar10", d,
                                        eval_batch_size=500 // WORKERS * WORKERS,
                                        device="cuda")
            t0 = time.perf_counter()
            got = ev.run(once=True)
            eval_first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ev.evaluate_step(10)
            eval_s = time.perf_counter() - t0
            require(list(got) == [10] and all(np.isfinite(list(got[10].values()))),
                    f"checkpoint: evaluator {got}")
            for k in ("loss", "prec1", "prec5"):
                require(abs(got[10][k] - val[k]) <= 1e-5 * max(abs(val[k]), 1e-6),
                        f"checkpoint: evaluator {k} {got[10][k]} vs validate {val[k]}")
            cli = cli_evaluate.main(["--model-dir", d, "--network", "ResNet18", "--dataset",
                                     "Cifar10", "--once", "--device", "cuda"])
            require(list(cli) == [10] and np.isfinite(cli[10]["loss"]),
                    f"checkpoint: cli.evaluate {cli}")
            # the evaluator's time a checkpoint at CIFAR-10's test-split
            # size, 10,000 images in batches of the CLI's default 1000
            full = cli_evaluate.Evaluator("ResNet18", "Cifar10", d, device="cuda")
            full.dataset = make_synthetic("Cifar10", train_size=WORKERS, test_size=FULL_TEST)
            t0 = time.perf_counter()
            full.evaluate_step(10)
            eval_full_first_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got_full = full.evaluate_step(10)
            eval_full_s = time.perf_counter() - t0
            require(all(np.isfinite(list(got_full.values()))),
                    f"checkpoint: evaluator on {FULL_TEST} images {got_full}")

            de = os.path.join(tmp, "ef")
            ef = _train(3, ["--train-dir", de, "--eval-freq", "3", "--error-feedback"],
                        checkpoints=True)
            live = ef["trainer"]
            ef_back = live._restore_step(3)
            require(_state_bits(ef_back, live.state) and live.state.comm_state is not None,
                    "checkpoint: EF residuals not restored bit for bit")
            ef_bytes = os.path.getsize(ckpt.checkpoint_path(de, 3))
    finally:
        log.removeHandler(grab)
    rec.update({
        "files": [5, 10, 15], "bytes_on_disk": nbytes, "ef_bytes_on_disk": ef_bytes,
        "save_host_s": host_s, "save_write_s": write_s, "load_restore_s": load_s,
        "evaluator_images": ev.eval_batch_size * (len(ev.dataset.test_labels)
                                                  // ev.eval_batch_size),
        "evaluator_first_s": eval_first_s, "evaluator_s": eval_s,
        "resume_steps": steps, "resume_losses": losses, "resume_launches": counts,
        "evaluator": got[10], "validate": val,
        "evaluator_full": {"images": FULL_TEST, "first_s": eval_full_first_s,
                           "s": eval_full_s, **got_full}})
    print("phase 12b checkpoints ResNet18 save / resume / quarantine / evaluate: "
          + json.dumps(rec))
    return rec


def _lenet_pair(dev, cfg_kw, faults=None):
    from ps_pytorch_tpu_torch.data import make_preprocessor
    from ps_pytorch_tpu_torch.models import build_model, init_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, init_ps_state, make_ps_train_step
    from ps_pytorch_tpu_torch.resilience.faults import FaultPlan

    cfg = PSConfig(num_workers=WORKERS, **cfg_kw)
    model = build_model("LeNet")
    params, _ = init_model(model, torch.Generator().manual_seed(5), device="cpu")
    plan = FaultPlan(**faults) if faults else None
    out = {}
    for d in ("cpu", dev):
        tx = build_optimizer("sgd", 0.02, momentum=0.9)
        st = init_ps_state(model, tx, cfg, params=params, batch_stats={}, device=d)
        step = make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor("MNIST", True),
                                  faults=plan, device=d)
        out[str(torch.device(d).type)] = (st, step)
    return out


def _held_rule(name: str, pc, pg, p0, bound: float = 1e-2) -> dict:
    """Phase 10's card-vs-CPU rule on the params after one step: every
    param within ``bound`` (1%) of the step's largest update, at most 1%
    of them off by more than 1e-6."""
    moved = float((pc - p0).abs().max())
    diff = (pc - pg).abs()
    require(float(diff.max()) <= bound * moved,
            f"held {name}: card vs CPU params differ by {float(diff.max())} "
            f"(update {moved}, bound {bound} of it)")
    frac = float((diff > 1e-6).float().mean())
    require(frac <= 0.01, f"held {name}: {frac:.4f} of params differ by > 1e-6")
    return {"max_abs_diff": float(diff.max()), "max_update": moved, "frac_diff_gt_1e-6": frac}


def phase_held(dev) -> dict:
    """One LeNet step at 8 workers: card (kernels) vs CPU (plain
    versions). Tolerance: the two devices' f32 convolutions differ in
    their last bits, so a few int8 payloads round the other way; every
    param must agree within 1% of the step's largest update and at most
    1% of them may differ by more than 1e-6."""
    from ps_pytorch_tpu_torch.data import make_synthetic
    from ps_pytorch_tpu_torch.ops.quantize import quantize_rows_scaled_many, quantize_tensors
    from ps_pytorch_tpu_torch.parallel.ps import StepDraws

    d = make_synthetic("MNIST", train_size=WORKERS * 16, test_size=8, seed=4)
    batch = {"image": d.train_images, "label": d.train_labels}
    perm = torch.tensor([3, 0, 6, 1, 5, 2, 7, 4])
    out = {}
    for name, kw in (("per_tensor", dict(compress="int8", num_aggregate=5)),
                     ("block128", dict(compress="int8", quant_block_size=128,
                                       num_aggregate=5))):
        pair = _lenet_pair(dev, kw)
        res = {}
        for key, (st, step) in pair.items():
            k2, k1s = quantize_tensors.launches, quantize_rows_scaled_many.launches
            p0 = st.params.flat.detach().cpu().clone()
            st, m = step(st, batch, StepDraws(perm=perm))
            res[key] = (st.params.flat.detach().cpu(), p0, float(m["loss"]),
                        quantize_tensors.launches - k2,
                        quantize_rows_scaled_many.launches - k1s)
        (pc, p0, lc, _, _), (pg, _, lg, k2g, k1g) = res["cpu"], res["cuda"]
        out[name] = _held_rule(name, pc, pg, p0)
        want = (1, 0) if name == "per_tensor" else (0, 1)  # LeNet's 8 leaves, one call
        require((k2g, k1g) == want,
                f"held {name}: calls K2 {k2g}, K1 scaled {k1g}, expected {want}")
        out[name].update({"loss_cpu": lc, "loss_cuda": lg})
    pair = _lenet_pair(dev, dict(compress="int8"), faults={"nan_grads": [1]})
    st, step = pair["cuda"]
    p0 = st.params.flat.clone()
    st, m = step(st, batch, StepDraws())
    require(torch.equal(st.params.flat, p0), "held nan: params moved on a NaN step")
    require(float(m["skipped_steps"]) == 1.0, "held nan: skipped_steps != 1")
    out["nan_step"] = {"params_unchanged": True, "skipped_steps": 1.0}
    print("phase 10 train held on the card vs CPU (LeNet, 8 workers): " + json.dumps(out))
    return out


def phase_held_wires(dev) -> dict:
    """Phase 10's card-vs-CPU rule on the wires of this slice, with one
    change for the two-round wires: their second rounding (K3's rescale
    by K, or round 2's requantize of the region sums) sits on a lattice up
    to K times coarser than round 1's, so one element that rounds the
    other way on the card moves its param by up to K times what a flip
    on the one-round wire does; there the bound is K% of the update."""
    from ps_pytorch_tpu_torch.data import make_synthetic
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, StepDraws

    d = make_synthetic("MNIST", train_size=WORKERS * 16, test_size=8, seed=4)
    batch = {"image": d.train_images, "label": d.train_labels}
    perm = torch.tensor([3, 0, 6, 1, 5, 2, 7, 4])
    wires = {
        "autotune_best_ef": dict(compress="int8_2round", bucket_bytes=0,
                                 wire_domain="homomorphic", num_aggregate=5,
                                 error_feedback=True),
        "int8_homomorphic_64k": dict(compress="int8", bucket_bytes=65536,
                                     wire_domain="homomorphic", num_aggregate=5),
        "2round_dequant_block128": dict(compress="int8_2round", quant_block_size=128,
                                        num_aggregate=5),
        "zero1_int8_homomorphic": dict(opt_placement="sharded", compress="int8",
                                       wire_domain="homomorphic", num_aggregate=5),
    }
    out = {}
    for name, kw in wires.items():
        pair = _lenet_pair(dev, kw)
        res = {}
        for key, (st, step) in pair.items():
            reset_counts()
            p0 = st.params.flat.detach().cpu().clone()
            st, m = step(st, batch, StepDraws(perm=perm))
            res[key] = (st.params.flat.detach().cpu(), p0, float(m["loss"]), read_counts(),
                        float(m["skipped_steps"]))
        (pc, p0, lc, _, _), (pg, _, lg, counts, skipped) = res["cpu"], res["cuda"]
        cfg = PSConfig(num_workers=WORKERS, **kw)
        coarse = cfg.compress == "int8_2round" and cfg.opt_placement != "sharded"
        bound = 1e-2 * (cfg.effective_aggregate if coarse else 1)
        out[name] = _held_rule(name, pc, pg, p0, bound)
        require(skipped == 0.0, f"held {name}: the card skipped the step")
        want = expected_launches(cfg, pair["cpu"][0].params.tree())
        require(counts == want, f"held {name}: launches {counts}, expected {want}")
        out[name].update({"bound_fraction": bound, "loss_cpu": lc, "loss_cuda": lg,
                          "launches": counts})
    print("phase 13 wires held on the card vs CPU (LeNet, 8 workers): " + json.dumps(out))
    return out


def phase_vgg(card: str) -> dict:
    """Phase 18: the VGG family at full width through ``cli.train.main``
    on phase 9's configuration (8 workers x 128, int8 per-tensor wire,
    num-aggregate 5, f32 with TF32 off): VGG16 (BN) 20 steps with every
    loss finite, no skipped step and the launches ``expected_launches``
    derives from VGG16's 58-leaf tree (K2 once a step); its step p50 after
    warm-up, images/s and peak memory, and the memory held after steps 1,
    2, 3, 10 and 20, required flat from step 3 to 20 (or a step keeps what
    it should free). Then
    VGG16NoBN and VGG11 (BN) 3 steps each: finite losses, the same launch
    rule."""
    from ps_pytorch_tpu_torch.cli._flags import add_ps_flags, add_train_flags, ps_config_from
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves

    parser = add_ps_flags(add_train_flags(argparse.ArgumentParser()))
    out = {}
    for name, steps in (("VGG16", 20), ("VGG16NoBN", 3), ("VGG11", 3)):
        flags = ["--network", name]
        cfg = ps_config_from(parser.parse_args(TRAIN_ARGS + flags), WORKERS)
        with torch.device("meta"):  # the tree's shapes, for the launch rule
            params, _ = build_model(name).init(torch.Generator())
        want = {k: v * steps for k, v in expected_launches(cfg, params).items()}
        mem = []
        res, peak, first_peak = _train_peak(steps, flags, reset_counts, per_step=mem)
        got = read_counts()
        losses = [h["loss"] for h in res["history"]]
        require(len(losses) == steps and all(np.isfinite(v) for v in losses),
                f"train {name}: losses {losses}")
        require(got == want, f"train {name}: launches {got}, expected {want}")
        rec = {"card": card, "steps": steps, "leaves": len(tree_leaves(params)),
               "launches": got, "skipped_steps": res["train"]["skipped_steps"],
               "loss_first": losses[0], "loss_last": losses[-1], "peak_mem_bytes": peak,
               "peak_mem_first_run_bytes": first_peak,
               "mem_after_step_bytes": {s_: mem[s_ - 1][0] for s_ in (1, 2, 3, 10, 20)
                                        if s_ <= len(mem)},
               "peak_after_step_bytes": {s_: mem[s_ - 1][1] for s_ in (1, 2, 3, 10, 20)
                                         if s_ <= len(mem)}}
        if steps >= 10:
            require(res["train"]["skipped_steps"] == 0.0, f"train {name}: a step was skipped")
            # what a step holds once it is done stays flat (64 MB of slack)
            require(mem[-1][0] <= mem[2][0] + 2 ** 26,
                    f"train {name}: {mem[-1][0]} bytes held after step {steps}, "
                    f"{mem[2][0]} after step 3")
            times = [h["time_cost"] for h in res["history"][3:]]
            p50 = _step_p50(res["history"])
            rec.update({"step_ms_p50": p50 * 1e3, "step_ms_min": min(times) * 1e3,
                        "step_ms_max": max(times) * 1e3, "images_per_s": WORKERS * 128 / p50})
        out[name] = rec
    print("phase 18 train VGG16 / VGG16NoBN / VGG11 int8 per-tensor: " + json.dumps(out))
    return out


def _fwd_bwd_peak(dtype, remat: bool) -> int:
    """Peak memory of one worker's ResNet18 forward and backward on 128
    CIFAR-10 images (the activations remat trades, and the gradients),
    on its second run (the first picks cuDNN's engines)."""
    from ps_pytorch_tpu_torch.models import apply_model, build_model, init_model
    from ps_pytorch_tpu_torch.ops.metrics import cross_entropy_loss
    from ps_pytorch_tpu_torch.parallel.buckets import tree_flatten, tree_unflatten

    dev = torch.device("cuda")
    model = build_model("ResNet18", dtype=dtype, remat=remat)
    params, bs = init_model(model, torch.Generator().manual_seed(0), device=dev)
    leaves, skel = tree_flatten(params)
    leaves = [t.requires_grad_(True) for t in leaves]
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(128, 32, 32, 3, generator=g, device=dev)
    y = torch.randint(0, 10, (128,), generator=g, device=dev)

    def run(base):
        logits, _ = apply_model(model, tree_unflatten(skel, leaves), bs, x, train=True)
        return torch.autograd.grad(cross_entropy_loss(logits, y), leaves)

    _peak_of(run)
    return _peak_of(run)[1]


def phase_bf16(card: str, f32: dict) -> dict:
    """Phase 19: phase 9's configuration at ``--dtype bfloat16``, 20 steps
    (finite losses, K2 once a step), its step p50 and peak memory beside
    phase 9's f32 ones from this run (``f32``); then ``--dtype bfloat16
    --remat``, 3 steps (finite losses, K2 once a step), its peak memory
    beside the bf16 run's (reported, not required to be lower)."""
    _, k2c = _wire_entry(0)
    out = {}
    for name, steps, flags in (("bf16", 20, ["--dtype", "bfloat16"]),
                               ("bf16_remat", 3, ["--dtype", "bfloat16", "--remat"])):
        res, peak, first_peak = _train_peak(steps, flags,
                                            lambda: setattr(k2c, "launches", 0))
        k2 = k2c.launches
        losses = [h["loss"] for h in res["history"]]
        require(len(losses) == steps and all(np.isfinite(v) for v in losses),
                f"train ResNet18 {name}: losses {losses}")
        require(OTHER_TREE or k2 == steps,
                f"train ResNet18 {name}: K2 called {k2} times, expected once a step")
        rec = {"card": card, "flags": " ".join(flags), "steps": steps,
               "launches": {k2c.__name__: k2}, "loss_first": losses[0],
               "loss_last": losses[-1], "peak_mem_bytes": peak,
               "peak_mem_first_run_bytes": first_peak}
        if steps >= 10:
            p50 = _step_p50(res["history"])
            rec.update({"step_ms_p50": p50 * 1e3, "images_per_s": WORKERS * 128 / p50})
        out[name] = rec
    out["f32_phase9"] = {k: f32[k] for k in ("step_ms_p50", "images_per_s", "peak_mem_bytes",
                                             "peak_mem_first_run_bytes")}
    out["one_worker_fwd_bwd_peak_bytes"] = {
        "f32": _fwd_bwd_peak(torch.float32, False),
        "bf16": _fwd_bwd_peak(torch.bfloat16, False),
        "bf16_remat": _fwd_bwd_peak(torch.bfloat16, True)}
    print("phase 19 train ResNet18 bf16 / bf16 + remat beside f32: " + json.dumps(out))
    return out


def phase_held_vgg(dev) -> dict:
    """Phase 20: one step at 8 workers (16 images each, synthetic
    CIFAR-10, int8 per-tensor wire, num-aggregate 5) of a narrow VGG11-BN
    (VGG11's table at an eighth of its widths), card against CPU on the
    same params, batch and draws (augmentation, mask and Dropout
    keep-masks from one ``draw_step``): with local BN statistics, with
    synced BN (``bn_mode="synced"``, a model built with ``bn_axis_name``),
    and with synced BN under ``bn_mode="local"`` (the running stats kept
    ``[8, C]``, a row a worker). Phase 10's rule; one K2 call a step on
    the card."""
    from ps_pytorch_tpu_torch.data import make_preprocessor, make_synthetic
    from ps_pytorch_tpu_torch.models import VGG, init_model
    from ps_pytorch_tpu_torch.models.vgg import CFGS
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.mesh import WORKER_AXIS
    from ps_pytorch_tpu_torch.parallel.ps import (
        PSConfig,
        draw_step,
        init_ps_state,
        make_ps_train_step,
    )

    narrow = tuple(v if v == "M" else v // 8 for v in CFGS["A"])
    d = make_synthetic("Cifar10", train_size=WORKERS * 16, test_size=8, seed=4)
    batch = {"image": d.train_images, "label": d.train_labels}
    pre = make_preprocessor("Cifar10", True)
    out = {}
    for name, bn_mode, axis in (("vgg11_bn_narrow", "pmean", None),
                                ("vgg11_bn_narrow_synced", "synced", WORKER_AXIS),
                                ("vgg11_bn_narrow_synced_local", "local", WORKER_AXIS)):
        model = VGG(cfg=narrow, batch_norm=True, bn_axis_name=axis)
        cfg = PSConfig(num_workers=WORKERS, compress="int8", num_aggregate=5, bn_mode=bn_mode)
        params, bs = init_model(model, torch.Generator().manual_seed(5), device="cpu")
        draws = draw_step(cfg, 3, 0, 16, pre, model)
        res = {}
        for key in ("cpu", "cuda"):
            d_ = "cpu" if key == "cpu" else dev
            tx = build_optimizer("sgd", 0.02, momentum=0.9)
            st = init_ps_state(model, tx, cfg, params=params, batch_stats=bs, device=d_)
            step = make_ps_train_step(model, tx, cfg, preprocess=pre, device=d_)
            p0 = st.params.flat.detach().cpu().clone()
            reset_counts()
            st, m = step(st, batch, draws)
            res[key] = (st.params.flat.detach().cpu(), p0, float(m["loss"]), read_counts(),
                        float(m["skipped_steps"]))
        (pc, p0, lc, _, _), (pg, _, lg, counts, skipped) = res["cpu"], res["cuda"]
        rec = _held_rule(name, pc, pg, p0)
        require(skipped == 0.0, f"held {name}: the card skipped the step")
        require(counts["quantize_tensors"] == 1 and sum(counts.values()) == 1,
                f"held {name}: launches {counts}, expected one K2 call")
        rec.update({"loss_cpu": lc, "loss_cuda": lg, "launches": counts})
        out[name] = rec
    print("phase 20 VGG11-BN narrow and synced BN held on the card vs CPU: "
          + json.dumps(out))
    return out


SYNCED_LOCAL_STEPS = 5


def phase_synced_local(card: str) -> dict:
    """Phase 20b: ResNet18 at its published widths, 8 workers x 128
    (synthetic CIFAR-10, augmentation on), synced BN under
    ``bn_mode="local"`` (a model built with ``bn_axis_name``: JAX's CLI
    builds none under local, so the library's ``make_ps_train_step`` is
    the entry point), the int8 per-tensor wire, lr 0.1, momentum 0.9,
    num-aggregate 5, for 5 steps on the card. Every worker's running
    stats start as a distinct row (seeded offsets on the init); every
    loss finite, no skipped step, one K2 call a step, each stats leaf
    ``[8, C]`` with its rows still pairwise distinct after the 5 steps
    (each keeps 0.9^5 of its start offset). Step p50 (host clock after a
    synchronize, after 2 warm-up steps) and the run's peak device memory
    above its start."""
    from ps_pytorch_tpu_torch.data import make_preprocessor, make_synthetic
    from ps_pytorch_tpu_torch.models import build_model, init_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves, tree_map
    from ps_pytorch_tpu_torch.parallel.mesh import WORKER_AXIS
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, init_ps_state, make_ps_train_step

    dev = torch.device("cuda")
    steps = SYNCED_LOCAL_STEPS
    model = build_model("ResNet18", bn_axis_name=WORKER_AXIS)
    cfg = PSConfig(num_workers=WORKERS, bn_mode="local", compress="int8", num_aggregate=5)
    params, bs = init_model(model, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(7)
    rows = tree_map(lambda s: (s.unsqueeze(0) + 0.5 * torch.rand((WORKERS,) + tuple(s.shape),
                                                                 generator=g)).to(dev), bs)
    d = make_synthetic("Cifar10", train_size=WORKERS * PER_WORKER * steps, test_size=8, seed=11)
    batches = [{"image": d.train_images[i * WORKERS * PER_WORKER:(i + 1) * WORKERS * PER_WORKER],
                "label": d.train_labels[i * WORKERS * PER_WORKER:(i + 1) * WORKERS * PER_WORKER]}
               for i in range(steps)]

    def run(base):
        tx = build_optimizer("sgd", 0.1, momentum=0.9)
        st = init_ps_state(model, tx, cfg, params=params, batch_stats=bs, device=dev)
        st.batch_stats = rows
        step = make_ps_train_step(model, tx, cfg, preprocess=make_preprocessor("Cifar10", True),
                                  seed=0, device=dev)
        losses, times, skipped = [], [], 0.0
        for batch in batches:
            t0 = time.perf_counter()
            st, m = step(st, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            skipped = float(m["skipped_steps"])
        return st, losses, times, skipped

    reset_counts()
    (st, losses, times, skipped), peak = _peak_of(run)
    counts = read_counts()
    require(all(np.isfinite(losses)), f"phase 20b: non-finite losses {losses}")
    require(skipped == 0.0, "phase 20b: a step was skipped")
    require(counts["quantize_tensors"] == steps and sum(counts.values()) == steps,
            f"phase 20b: launches {counts}, expected {steps} K2 calls")
    leaves = tree_leaves(st.batch_stats)
    min_apart = float("inf")
    for leaf in leaves:
        require(tuple(leaf.shape[:1]) == (WORKERS,), f"phase 20b: stats leaf {tuple(leaf.shape)}")
        require(bool(torch.isfinite(leaf).all()), "phase 20b: non-finite running stats")
        flat = leaf.reshape(WORKERS, -1)
        apart = (flat[:, None, :] - flat[None, :, :]).abs().amax(-1)
        off_diagonal = ~torch.eye(WORKERS, dtype=torch.bool, device=dev)
        min_apart = min(min_apart, float(apart[off_diagonal].min()))
    require(min_apart > 0.0, "phase 20b: two workers' stats rows became equal")
    rec = {"card": card, "model": "ResNet18 synthetic Cifar10 f32 (TF32 off), synced BN, "
           "bn_mode local", "workers": WORKERS, "batch_per_worker": PER_WORKER, "steps": steps,
           "losses": losses, "launches": counts, "stats_leaves": len(leaves),
           "min_rows_apart": min_apart,
           "step_ms_p50": float(np.median(times[2:])) * 1e3,
           "step_ms": [t * 1e3 for t in times], "peak_bytes": int(peak)}
    print("phase 20b synced BN under bn_mode local, ResNet18 8 x 128 int8 wire: "
          + json.dumps(rec))
    return rec


def phase_events(card: str) -> dict:
    """Phase 21: the trainer's event stream on phase 9's configuration.
    First the tracer's host cost: 8 steps without ``--trace`` and 8 with,
    in turns, twice, each run's step p50 after warm-up. Then one run with
    ``--metrics-file``, ``--trace``, ``--mode straggler --kill-threshold
    0.02`` (below a step), ``--straggler-storm-n 2`` and the fault plan
    ``{"sigterm": 4}`` for up to 6 steps: it stops at step 4 with
    ``model_step_4`` written and validation skipped; ``--resume`` runs
    steps 5-6. Every record passes the port's ``validate_event``, the
    stream holds ``straggler`` before ``straggler_storm``, the trace holds
    ``dispatch``, ``sync`` and ``ckpt_save`` spans, and K2 ran once a
    step."""
    import tempfile

    from ps_pytorch_tpu_torch import checkpoint as ckpt
    from ps_pytorch_tpu_torch.obs.schema import validate_event

    tmp = tempfile.mkdtemp(prefix="chip_smoke_events_")
    cost = {"off": [], "on": []}
    for rep in range(2):
        for mode in ("off", "on"):
            extra = ["--trace", os.path.join(tmp, f"cost{rep}")] if mode == "on" else []
            cost[mode].append(_step_p50(_train(8, extra)["history"]) * 1e3)
    mfile, tdir, cdir = (os.path.join(tmp, x) for x in ("m.jsonl", "trace", "ck"))
    args = ["--metrics-file", mfile, "--trace", tdir, "--mode", "straggler",
            "--kill-threshold", "0.02", "--straggler-storm-n", "2", "--train-dir", cdir,
            "--eval-freq", "0"]
    _, k2c = _wire_entry(0)
    k2c.launches = 0
    first = _train(6, args + ["--fault-plan", '{"sigterm": 4}'], checkpoints=True)
    steps1 = [h["step"] for h in first["history"]]
    require(steps1 == [1, 2, 3, 4] and first["val"] is None,
            f"events: the SIGTERM run took steps {steps1} (val {first['val']})")
    require(ckpt.available_steps(cdir) == [4],
            f"events: checkpoints {ckpt.available_steps(cdir)} after the stop")
    second = _train(6, args + ["--resume"], checkpoints=True)
    steps2 = [h["step"] for h in second["history"]]
    require(steps2 == [5, 6], f"events: the resume took steps {steps2}")
    require(ckpt.available_steps(cdir) == [4, 6], "events: no model_step_6 after the resume")
    k2 = k2c.launches
    require(OTHER_TREE or k2 == 6, f"events: K2 called {k2} times in 6 steps")
    with open(mfile) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        validate_event(dict(r))
    kinds = [r["kind"] for r in recs]
    require("straggler" in kinds and "straggler_storm" in kinds
            and kinds.index("straggler") < kinds.index("straggler_storm"),
            f"events: no straggler then straggler_storm in {kinds}")
    with open(os.path.join(tdir, "trace_train_p0.jsonl")) as f:
        spans = [json.loads(line) for line in f]
    names = {r.get("name") for r in spans if r["kind"] == "span"}
    require({"dispatch", "sync", "ckpt_save"} <= names, f"events: trace spans {sorted(names)}")
    rec = {"card": card, "records": len(recs),
           "kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
           "spans": {n: sum(1 for r in spans if r.get("name") == n) for n in sorted(names)},
           "steps": steps1 + steps2, "launches": {k2c.__name__: k2},
           "checkpoints": ckpt.available_steps(cdir),
           "tracer_cost_step_ms_p50": cost,
           "tracer_cost_fraction": float(np.median(cost["on"]) / np.median(cost["off"]) - 1)}
    print("phase 21 event stream, watchdog, SIGTERM stop and resume: " + json.dumps(rec))
    return rec


def _flash_counters():
    from ps_pytorch_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_fwd,
        flash_partial,
    )

    return {"flash_fwd": flash_fwd, "flash_partial": flash_partial,
            "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}


def reset_flash_counts() -> None:
    for fn in _flash_counters().values():
        fn.launches = 0


def read_flash_counts() -> dict:
    return {name: fn.launches for name, fn in _flash_counters().items()}


def kept_pairs(b, h, tq, tk, causal, q_off, k_off) -> int:
    """The (query, key) pairs the mask keeps, over every row and head:
    the work this run's data needs (masked tiles are skipped)."""
    if not causal:
        return b * h * tq * tk
    qo = np.broadcast_to(np.asarray(q_off.cpu() if torch.is_tensor(q_off) else q_off), (b,))
    ko = np.broadcast_to(np.asarray(k_off.cpu() if torch.is_tensor(k_off) else k_off), (b,))
    q = np.arange(tq)
    return h * int(sum(np.clip(qo[r] + q - ko[r] + 1, 0, tk).sum() for r in range(b)))


def _near(what: str, got, want, tol) -> tuple:
    """Max abs error, required within ``tol`` of the result's largest
    magnitude (f32 sums in another order: the kernels tile by tile on the
    tensor cores, bf16 with P and dS as a bf16 hi + lo pair and f32 as
    3xTF32; the plain versions over whole rows with matmuls); and that
    error over the largest magnitude."""
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    require(err <= tol * max(1.0, top), f"{what} off its plain version by {err}")
    return err, err / top if top > 0 else 0.0


def _aten_yardsticks(q, k, v, do, scale, causal, iters) -> dict:
    """aten's attention on the same work as one K4-partial call and one K5
    + K6 pair (never called by the port). Forward: flash attention for
    bf16, memory-efficient attention for f32 (flash takes no f32); it
    returns (o, logsumexp), the same softmax work as K4's triple.
    Backward, (dq, dk, dv), K5 and K6 together: for bf16 what
    scaled_dot_product_attention picks by default, its fastest call (on
    the H100 cuDNN's flash backward); for f32 memory-efficient attention
    (``bwd_device_kernels`` names the kernels). Wall and device time."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    fwd_args = [x.transpose(1, 2) for x in (q, k, v)]
    qh, kh, vh = (x.detach().requires_grad_(True) for x in fwd_args)
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, scale=scale)
    if q.dtype == torch.bfloat16:
        fwd = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            *fwd_args, dropout_p=0.0, is_causal=causal, scale=scale)
        oh = sdpa()
    else:
        fwd = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
            *fwd_args, None, True, 0.0, is_causal=causal, scale=scale)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            oh = sdpa()
    doh = do.transpose(1, 2)
    bwd = lambda: torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)
    bwd_dev, bwd_kernels = device_ms(bwd)
    return {"fwd_ms": time_ms(fwd, iters), "fwd_device_ms": device_ms(fwd)[0],
            "bwd_ms": time_ms(bwd, iters=50), "bwd_device_ms": bwd_dev,
            "bwd_device_kernels": sorted(bwd_kernels)}


def _partial_case(label: str, b: int, t: int, h: int, dt, q_off, k_off, g,
                  aten_rows=slice(None), aten_causal: bool = True) -> dict:
    """K4-partial, K5 and K6 as a ring hop runs them (causal, the f32
    gradients of ``flash_grads_partial``) at ``[b, t, h, 64]`` with the
    hop's per-row offsets, against their plain versions, each twice (the
    same bits), timed beside the bound and aten's attention on the rows
    ``aten_rows`` (``aten_causal``: a diagonal block; else every key kept)."""
    from ps_pytorch_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_plain,
        flash_fwd_plain,
        flash_partial,
        flash_partial_plain,
    )

    d = 64
    scale = d ** -0.5
    dev = g.device
    q, k, v, do = (torch.randn((b, t, h, d), generator=g, device=dev).to(dt)
                   for _ in range(4))
    pv, m, l = flash_partial(q, k, v, True, scale, q_off, k_off)
    again = flash_partial(q, k, v, True, scale, q_off, k_off)
    pvp, mp, lp = flash_partial_plain(q, k, v, True, scale, q_off, k_off)
    o, lse = flash_fwd_plain(q, k, v, True, scale, q_off=q_off, k_off=k_off)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bwd = (q, k, v, do, lse, delta, True, scale, q_off, k_off)
    dq = flash_bwd_dq(*bwd, out_dtype=torch.float32)
    dk, dv = flash_bwd_dkv(*bwd, out_dtype=torch.float32)
    dq2 = flash_bwd_dq(*bwd, out_dtype=torch.float32)
    dk2, dv2 = flash_bwd_dkv(*bwd, out_dtype=torch.float32)
    want = flash_bwd_plain(*bwd, out_dtype=torch.float32)
    torch.cuda.synchronize()
    errs, rel = {}, {}
    for key, got, ref, tol in (
            ("pv", pv, pvp, 2e-5), ("m", m, mp, 2e-6), ("l", l, lp, 2e-5),
            ("dq", dq, want[0], 5e-5), ("dk", dk, want[1], 5e-5), ("dv", dv, want[2], 5e-5)):
        errs[key], rel[key] = _near(f"{label} {key}", got, ref, tol)
    require(torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2),
            f"{label}: K5/K6 changed between two runs")
    require(all(torch.equal(x, y) for x, y in zip((pv, m, l), again)),
            f"{label}: K4-partial changed between two runs")
    pairs = kept_pairs(b, h, t, t, True, q_off, k_off)
    elt, act = q.element_size(), b * t * h * d
    stat = b * h * t * 4
    # bounds: each input read once, each output written once; 4 D flops
    # per kept pair forward (QK, PV), 6 D for K5, 8 D for K6, at the rate
    # of the input type's products (f32: 3xTF32)
    rate = TF32X3_OPS_PER_S if dt == torch.float32 else PEAK_OPS_PER_S[dt]
    bounds = {
        "partial": bound_ms(3 * act * elt + act * 4 + 2 * stat, 4.0 * d * pairs, rate),
        "dq": bound_ms(4 * act * elt + 2 * stat + act * 4, 6.0 * d * pairs, rate),
        "dkv": bound_ms(4 * act * elt + 2 * stat + 2 * act * 4, 8.0 * d * pairs, rate),
    }
    # fewer back-to-back calls where one call takes milliseconds
    slow = t > 1024 or dt == torch.float32
    iters, plain_iters = (50, 10) if slow else (ITERS, 20)
    rec = {"shape": [b, t, h, d], "dtype": str(dt).replace("torch.", ""),
           "kept_pairs": pairs, "max_abs_err": errs, "err_of_largest": rel}
    partial = lambda: flash_partial(q, k, v, True, scale, q_off, k_off)
    dev_ms, kernels = _device_route(f"{label} K4-partial", partial, dt)
    rec["partial"] = {
        "ms": time_ms(partial, iters), "device_ms": dev_ms, "device_kernels": kernels,
        "plain_ms": time_ms(lambda: flash_partial_plain(q, k, v, True, scale, q_off, k_off),
                            iters=plain_iters),
        "bound_ms": bounds["partial"][0], "bound_by": bounds["partial"][1]}
    plain_bwd_ms = time_ms(lambda: flash_bwd_plain(*bwd, out_dtype=torch.float32),
                           iters=plain_iters)
    for part, family, fn in (
            ("dq", "flash_dq", lambda: flash_bwd_dq(*bwd, out_dtype=torch.float32)),
            ("dkv", "flash_dkv", lambda: flash_bwd_dkv(*bwd, out_dtype=torch.float32))):
        dev_ms, kernels = _device_route(f"{label} {part}", fn, dt, family)
        rec[part] = {"ms": time_ms(fn, iters), "device_ms": dev_ms,
                     "device_kernels": kernels, "plain_ms": plain_bwd_ms,
                     "bound_ms": bounds[part][0], "bound_by": bounds[part][1]}
    lib = _aten_yardsticks(q[aten_rows], k[aten_rows], v[aten_rows], do[aten_rows], scale,
                           aten_causal, iters)
    rec["partial"]["library_ms"] = lib["fwd_ms"]
    rec["partial"]["library_device_ms"] = lib["fwd_device_ms"]
    for part in ("dq", "dkv"):
        rec[part]["library_ms"] = lib["bwd_ms"]
        rec[part]["library_device_ms"] = lib["bwd_device_ms"]
    rec["library_device_kernels"] = lib["bwd_device_kernels"]
    rec["k5_plus_k6"] = {
        "ms": rec["dq"]["ms"] + rec["dkv"]["ms"], "library_ms": lib["bwd_ms"],
        "device_ms": rec["dq"]["device_ms"] + rec["dkv"]["device_ms"],
        "library_device_ms": lib["bwd_device_ms"],
        "bound_ms": rec["dq"]["bound_ms"] + rec["dkv"]["bound_ms"]}
    return rec


def phase_flash_train_kernels(dev) -> dict:
    """Phase 14: K4-partial, K5, K6 against their plain versions."""
    n, t_loc = 4, 2048
    me = torch.arange(n, device=dev)
    # hop 3 of a 4-shard ring, batch 2 per shard: shard i meets key block
    # (i + 3) % 4, so shard 0's keys all lie in its future
    ring_q = (me * t_loc).repeat_interleave(2)
    ring_k = (((me + 3) % n) * t_loc).repeat_interleave(2)
    cases = [("lm1_bf16", 8, 1024, torch.bfloat16, 0, 0),
             ("lm1_f32", 8, 1024, torch.float32, 0, 0),
             ("ring_hop_bf16", 8, t_loc, torch.bfloat16, ring_q, ring_k),
             ("ring_hop_f32", 8, t_loc, torch.float32, ring_q, ring_k)]
    g = torch.Generator(device=dev).manual_seed(14)
    out = {}
    for name, b, t, dt, q_off, k_off in cases:
        # aten on the same work: causal at LM-1's offsets 0; on the ring
        # hop non-causal over the six rows whose shards keep every key (the
        # two of shard 0 keep none and get zeros)
        lm1 = name.startswith("lm1")
        out[name] = rec = _partial_case(name, b, t, 8, dt, q_off, k_off, g,
                                        slice(None) if lm1 else slice(2, None), lm1)
        print(f"phase 14 {name}: " + json.dumps(rec), flush=True)
    return out


# The JAX package's LM bench leg (bench.py:66, 582-595) at full width
LM_DEPTH = 6
LM_ARGS = ["--parallelism", "dp_sp", "--attention-impl", "flash", "--vocab-size", "2048",
           "--dim", "512", "--depth", str(LM_DEPTH), "--heads", "8",
           "--remat", "--lr", "0.01", "--momentum", "0.9", "--log-interval", "1",
           "--device", "cuda"]


def phase_lm(card: str, phase: str, steps: int, n_sp: int, batch: int, seq: int,
             dtype: str = "bfloat16", extra=()) -> dict:
    """Phases 15-16: LM training through ``cli.train_lm.main``, with the
    flash launch counts of the formula (L n (1 + remat) K4-partial, L n
    K5, L n K6 per step)."""
    from ps_pytorch_tpu_torch.cli import train_lm

    flags = ["--dtype", dtype, "--seq-len", str(seq), "--batch-size", str(batch),
             "--num-sp", str(n_sp), "--max-steps", str(steps), *extra]
    reset_flash_counts()
    res = train_lm.main(LM_ARGS + flags)
    torch.cuda.synchronize()
    got = read_flash_counts()
    hops = LM_DEPTH * n_sp
    want = {"flash_fwd": 0, "flash_partial": 2 * hops * steps,
            "flash_bwd_dq": hops * steps, "flash_bwd_dkv": hops * steps}
    hist = res["history"]
    losses = [h_["loss"] for h_ in hist]
    require(len(losses) == steps and all(np.isfinite(v) for v in losses),
            f"{phase}: losses {losses}")
    require(got == want, f"{phase}: launches {got}, expected {want}")
    times = [h_["time_cost"] for h_ in hist[2:]]  # after the first two steps
    p50 = float(np.median(times))
    rec = {"card": card, "flags": " ".join(LM_ARGS[:-2] + flags),
           "layout": f"dp 1 x sp {n_sp}", "steps": steps, "launches": got,
           "losses": losses, "step_ms_p50": p50 * 1e3, "step_ms_min": min(times) * 1e3,
           "step_ms_max": max(times) * 1e3, "tokens_per_s": batch * seq / p50,
           "steady_ms_per_step": res["steady_elapsed_s"] / res["steady_steps"] * 1e3,
           "params": res["params"]}
    print(f"{phase}: " + json.dumps(rec))
    return rec


def phase_lm_held(dev) -> dict:
    """Phase 17: one LM step at (dp 2, sp 4), f32 with TF32 off, card
    (kernels) vs CPU (plain versions) from the same params and tokens.
    Tolerance: the JAX package's own dp_sp bounds (loss rtol 1e-5,
    params rtol 2e-4 / atol 2e-5): the same f32 sums in other orders."""
    from ps_pytorch_tpu_torch import on_device
    from ps_pytorch_tpu_torch.cli.train_lm import make_synthetic_tokens
    from ps_pytorch_tpu_torch.models import TransformerConfig, init_transformer
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
    from ps_pytorch_tpu_torch.parallel.dp_sp import (
        make_lm_train_step,
        make_mesh_2d,
        shard_tokens_2d,
    )

    depth, dp, sp = 2, 2, 4
    mesh = make_mesh_2d(dp, sp)
    tokens = torch.from_numpy(make_synthetic_tokens(256, 4, 256, seed=3))
    variants = {"ring": dict(sp_attention="ring"),
                "ring_bidirectional": dict(sp_attention="ring", bidirectional_ring=True),
                "ulysses": dict(sp_attention="ulysses")}
    out = {}
    for name, kw in variants.items():
        cfg = TransformerConfig(vocab_size=256, dim=256, depth=depth, heads=4,
                                max_seq_len=256, attention_impl="flash", remat=True, **kw)
        params = init_transformer(cfg, torch.Generator().manual_seed(9), device="cpu")
        res = {}
        for d in ("cpu", dev):
            tx = build_optimizer("sgd", 0.1, momentum=0.9)
            p = on_device(params, torch.device(d))
            step = make_lm_train_step(cfg, tx, mesh)
            reset_flash_counts()
            p2, _, loss = step(p, tx.init(p), shard_tokens_2d(tokens.to(d), mesh))
            res[torch.device(d).type] = ([x.detach().cpu() for x in tree_leaves(p2)],
                                         float(loss), read_flash_counts())
        (pc, lc, _), (pg, lg, counts) = res["cpu"], res[torch.device(dev).type]
        require(abs(lg - lc) <= 1e-5 * abs(lc), f"held LM {name}: loss {lg} vs CPU {lc}")
        worst = 0.0
        for a, b in zip(pg, pc):
            excess = (a - b).abs() - (2e-5 + 2e-4 * b.abs())
            worst = max(worst, float((a - b).abs().max()))
            require(bool((excess <= 0).all()), f"held LM {name}: params off by {worst}")
        if name == "ulysses":  # local flash attention over the gathered sequence
            want = {"flash_fwd": 2 * depth, "flash_partial": 0,
                    "flash_bwd_dq": depth, "flash_bwd_dkv": depth}
        else:  # each of the n offsets once per pass, both ring directions
            want = {"flash_fwd": 0, "flash_partial": 2 * depth * sp,
                    "flash_bwd_dq": depth * sp, "flash_bwd_dkv": depth * sp}
        require(counts == want, f"held LM {name}: launches {counts}, expected {want}")
        out[name] = {"loss_cpu": lc, "loss_cuda": lg, "max_abs_param_diff": worst,
                     "launches": counts}
    print("phase 17 LM step held on the card vs CPU (dp 2 x sp 4): " + json.dumps(out))
    return out



# ----------------------------------- phases 22-24: Adam, the process backend

ADAM_ARGS = ["--lr", "0.001"]  # Adam's rate (phase 9's 0.1 is SGD's)
# phases 23 / 24: phase 9's configuration on three wires, with EF residuals
PROC_WIRES = {
    "compress": ["--error-feedback"],
    "block128": ["--quant-block-size", "128", "--error-feedback"],
    "2round_homomorphic": ["--compress-grad", "2round", "--bucket-bytes", "0",
                           "--wire-domain", "homomorphic", "--error-feedback"],
}
PROC_STEPS = 5


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _split_counters():
    from ps_pytorch_tpu_torch.ops import quantize as q

    return {name: getattr(q, name) for name in (
        "tensors_absmax", "quantize_tensors_given", "rows_scaled_absmax",
        "quantize_rows_scaled_given")}


def reset_split_counts() -> None:
    for fn in _split_counters().values():
        fn.launches = 0


def read_split_counts() -> dict:
    return {name: fn.launches for name, fn in _split_counters().items()}


def adam_update_case(name: str) -> dict:
    """One ResNet18 step's optimizer update on the flat state (the padded
    11,173,968 f32): ``tx.update`` + ``apply_updates``, device time
    (profiler) and CUDA-event time, beside its bound: p, g and the
    moments read once, p and the moments written once."""
    from ps_pytorch_tpu_torch.optim import apply_updates, build_optimizer

    n = RESNET18_PADDED
    g = torch.Generator(device="cuda").manual_seed(3)
    p = torch.randn(n, generator=g, device="cuda")
    grad = torch.randn(n, generator=g, device="cuda") * 1e-3
    tx = build_optimizer(name, 1e-3, flat=True)
    _, st = tx.update(grad, tx.init(p), p)  # a state past its first step

    def step():
        u, _ = tx.update(grad, st, p)
        return apply_updates(p, u)

    moments = 3 if name == "amsgrad" else 2
    n_bytes = 4 * n * ((2 + moments) + (1 + moments))
    b_ms, b_by = bound_ms(n_bytes, 13.0 * n, PEAK_OPS_PER_S[torch.float32])
    dev_ms, by_name = device_ms(step)
    return {"elements": n, "bytes": n_bytes, "device_ms": dev_ms, "ms": time_ms(step, iters=50),
            "device_launches": len(by_name), "bound_ms": b_ms, "bound_by": b_by}


def phase_adam(card: str, sgd: dict) -> dict:
    """Phase 22: Adam and AMSGrad on phase 9's configuration (ResNet18 8 x
    128, int8 per-tensor wire) through ``cli.train.main``, 5 steps each:
    finite losses, the last below the first, K2 once a step; Adam's step
    5 saved and resumed bit for bit; each update's device time beside its
    bound; step p50 beside phase 9's SGD. Then LM-1 bf16 with ``--optimizer
    adam`` through ``cli.train_lm.main`` (K4-K6's launch counts)."""
    import tempfile

    from ps_pytorch_tpu_torch import checkpoint as ckpt
    from ps_pytorch_tpu_torch.optim import AdamState

    steps = 5
    t0 = time.perf_counter()
    rec = {"card": card, "steps": steps, "sgd_step_ms_p50": sgd["step_ms_p50"]}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("adam", "amsgrad"):
            d = os.path.join(tmp, name)
            flags = ADAM_ARGS + ["--optimizer", name]
            ck = ["--train-dir", d, "--eval-freq", str(steps)] if name == "adam" else []
            reset_counts()
            out = _train(steps, flags + ck, checkpoints=bool(ck))
            torch.cuda.synchronize()
            k2 = read_counts()["quantize_tensors"]
            losses = [h["loss"] for h in out["history"]]
            trainer = out["trainer"]
            require(len(losses) == steps and all(np.isfinite(losses)),
                    f"phase 22 {name}: losses {losses}")
            require(losses[-1] < losses[0], f"phase 22 {name}: losses do not fall {losses}")
            require(k2 == steps, f"phase 22 {name}: K2 called {k2} times in {steps} steps")
            require(isinstance(trainer.state.opt_state, AdamState)
                    and (trainer.state.opt_state.max_exp_avg_sq is None) == (name == "adam"),
                    f"phase 22 {name}: optimizer state {type(trainer.state.opt_state)}")
            r = {"losses": losses, "launches": {"quantize_tensors": k2},
                 "step_ms_p50": _step_p50(out["history"], warm=2) * 1e3,
                 "update": adam_update_case(name)}
            if ck:
                require(ckpt.available_steps(d) == [steps], f"phase 22: files {os.listdir(d)}")
                back = _train(steps, flags + ck + ["--resume"], checkpoints=True)
                require(back["history"] == [] and back["trainer"].state.step == steps
                        and _state_bits(back["trainer"].state, trainer.state),
                        "phase 22 adam: step 5 not resumed bit for bit")
                r["resume_bit_exact"] = True
            rec[name] = r
            del out, trainer
    rec["seconds"] = time.perf_counter() - t0
    print("phase 22 ResNet18 Adam / AMSGrad: " + json.dumps(rec))
    rec["lm"] = phase_lm(card, "phase 22b LM-1 train_lm --optimizer adam", 4, 1, 8, 1024,
                         extra=["--optimizer", "adam", "--lr", "0.001"])
    return rec


def _files_equal(a: str, b: str) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


def _sha256_of(path: str) -> str:
    """A file's SHA-256: runs of two trees compared by their printed lines."""
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def phase_nccl_one(card: str, root: str) -> dict:
    """Phase 23: one process on ``torch.distributed`` NCCL at world size 1
    (``cli.train --coordinator-address``), the 8 workers on the
    ``ProcessWorkerAxis``, phase 9's configuration on three wires with EF
    residuals, 5 steps each, against the stacked backend's run of the same
    seed: params, EF residuals (the live states) and ``model_step_5``
    bit for bit (cuDNN deterministic for both); the split routes' launches
    (K2's per tensor, K1's shared-scale per block, each half once a step;
    the fused entries none); both step p50s. The stacked files stay in
    ``root`` for phase 24."""
    from ps_pytorch_tpu_torch import checkpoint as ckpt
    from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis, WorkerAxis

    t0 = time.perf_counter()
    rec = {"card": card, "steps": PROC_STEPS}
    for wire, flags in PROC_WIRES.items():
        dirs = {k: os.path.join(root, f"{k}_{wire}") for k in ("stacked", "nccl")}
        runs = {}
        for kind in ("stacked", "nccl"):
            extra = ["--train-dir", dirs[kind], "--eval-freq", str(PROC_STEPS)]
            if kind == "nccl":
                extra += ["--coordinator-address", f"localhost:{_free_port()}",
                          "--num-processes", "1", "--process-id", "0"]
            reset_counts()
            reset_split_counts()
            out = _train(PROC_STEPS, flags + extra, checkpoints=True)
            torch.cuda.synchronize()
            counts = {**read_counts(), **read_split_counts()}
            losses = [h["loss"] for h in out["history"]]
            require(len(losses) == PROC_STEPS and all(np.isfinite(losses)),
                    f"phase 23 {wire} {kind}: losses {losses}")
            axis_ok = isinstance(out["trainer"].mesh,
                                 ProcessWorkerAxis if kind == "nccl" else WorkerAxis)
            require(axis_ok, f"phase 23 {wire} {kind}: axis {out['trainer'].mesh!r}")
            runs[kind] = (out, counts)
            require(ckpt.available_steps(dirs[kind]) == [PROC_STEPS],
                    f"phase 23 {wire} {kind}: files {os.listdir(dirs[kind])}")
        (so, sc), (po, pc) = runs["stacked"], runs["nccl"]
        require(_state_bits(so["trainer"].state, po["trainer"].state),
                f"phase 23 {wire}: params / EF residuals differ from the stacked run")
        require(so["trainer"].state.comm_state is not None, f"phase 23 {wire}: no EF residuals")
        require(_files_equal(ckpt.checkpoint_path(dirs["stacked"], PROC_STEPS),
                             ckpt.checkpoint_path(dirs["nccl"], PROC_STEPS)),
                f"phase 23 {wire}: model_step_{PROC_STEPS} bytes differ")
        block = wire == "block128"
        fused, absmax, given = (("quantize_rows_scaled_many", "rows_scaled_absmax",
                                 "quantize_rows_scaled_given") if block else
                                ("quantize_tensors", "tensors_absmax", "quantize_tensors_given"))
        require(sc[fused] == PROC_STEPS and pc[fused] == 0
                and pc[absmax] == pc[given] == PROC_STEPS
                and sc[absmax] == sc[given] == 0,
                f"phase 23 {wire}: launches stacked {sc}, nccl {pc}")
        if wire == "2round_homomorphic":
            require(pc["accumulate_rescale_int8"] == sc["accumulate_rescale_int8"] == PROC_STEPS,
                    f"phase 23 {wire}: K3 launches stacked {sc}, nccl {pc}")
        rec[wire] = {"flags": " ".join(flags), "bit_exact": True,
                     "model_step_sha256": _sha256_of(
                         ckpt.checkpoint_path(dirs["stacked"], PROC_STEPS)),
                     "launches_stacked": sc, "launches_nccl": pc,
                     "loss_last": so["history"][-1]["loss"],
                     "stacked_step_ms_p50": _step_p50(so["history"], warm=2) * 1e3,
                     "nccl_step_ms_p50": _step_p50(po["history"], warm=2) * 1e3}
        del runs, so, po
    rec["seconds"] = time.perf_counter() - t0
    print("phase 23 NCCL world size 1 vs stacked, bit for bit: " + json.dumps(rec))
    return rec


def split_route_case(dev, block: int) -> dict:
    """The split route of one ResNet18 wire step (62 stacked leaves):
    this process's absmax, then the quantize with it (no cross-process max
    between: one process), bit for bit against the plain versions on CPU
    copies and against the fused entry; device time of the two halves,
    CUDA-event time, beside the fused entry's bound."""
    from ps_pytorch_tpu_torch.ops import quantize as q

    xs = resnet18_step_pieces(dev)
    if block:
        halves = (lambda ys: q.rows_scaled_absmax(ys, block),
                  lambda ys, a: q.quantize_rows_scaled_given(ys, block, a))
        plain = (lambda ys: q.rows_scaled_absmax_plain(ys, block),
                 lambda ys, a: q.quantize_rows_scaled_given_plain(ys, block, a))
        fused = lambda ys: q.quantize_rows_scaled_many(ys, block)
    else:
        halves = (q.tensors_absmax, q.quantize_tensors_given)
        plain = (q.tensors_absmax_plain, q.quantize_tensors_given_plain)
        fused = q.quantize_tensors
    fn = lambda ys: halves[1](ys, halves[0](ys))
    got = fn(xs)
    cpu = [x.cpu() for x in xs]
    want = plain[1](cpu, plain[0](cpu))
    ref = fused(xs)
    torch.cuda.synchronize()
    for i, (g_, w_, r_) in enumerate(zip(got, want, ref)):
        require(all(same_bits(a.cpu(), b) for a, b in zip(g_, w_))
                and all(same_bits(a, b) for a, b in zip(g_, r_)),
                f"split route block {block}: piece {i} differs from the plain / fused version")
    # NaN-only rows in one piece (F1 across the hop): scale NaN, payload
    # 0; the plain version on the card's tensors, as phase 7 holds K2's
    # NaN case (the card's f32 multiply returns its canonical NaN, the
    # CPU's keeps the operand's payload)
    ys = [x.clone() for x in xs[:3]]
    ys[1][3] = float("nan")
    got_nan = fn(ys)
    for i, (g_, w_) in enumerate(zip(got_nan, plain[1](ys, plain[0](ys)))):
        require(all(same_bits(a, b) for a, b in zip(g_, w_)),
                f"split route block {block}: NaN case piece {i} differs from plain")
    require(bool(torch.isnan(got_nan[1][1]).any()) and not bool(got_nan[1][0][3].any()),
            f"split route block {block}: the NaN-only rows did not give scale NaN, payload 0")
    n_in = sum(x.numel() for x in xs)
    n_q = sum(g_[0].numel() for g_ in got)
    n_rows = sum(g_[1].numel() for g_ in got)  # one scale (and absmax) a row or tensor
    f32_ops = PEAK_OPS_PER_S[torch.float32]
    b_ms, b_by = bound_ms(4 * n_in + n_q + 8 * n_rows, 4.0 * n_in, f32_ops)
    # each half alone: the absmax half reads x and writes the absmax; the
    # given half reads x and the absmax, writes q and the scales; the
    # route's floor is the two together (x read twice)
    absmax = halves[0](xs)
    halves_rec = {}
    for half, call, n_bytes in (("absmax", lambda: halves[0](xs), 4 * n_in + 4 * n_rows),
                                ("given", lambda: halves[1](xs, absmax),
                                 4 * n_in + 4 * n_rows + n_q + 4 * n_rows)):
        h_ms, h_by = bound_ms(n_bytes, 4.0 * n_in, f32_ops)
        h_total, h_names, _ = device_profile(call)
        halves_rec[half] = {"device_ms": h_total, "bound_ms": h_ms, "bound_by": h_by,
                            "device_kernels": {k[:60]: v for k, v in h_names.items()}}
    floor_ms = halves_rec["absmax"]["bound_ms"] + halves_rec["given"]["bound_ms"]
    dev_total, by_name, launches = device_profile(lambda: fn(xs))
    return {"pieces": len(xs), "elements": n_in, "device_ms": dev_total,
            "device_launches": sum(launches.values()),
            "device_kernels": {k[:60]: v for k, v in by_name.items()},
            "halves": halves_rec, "two_pass_floor_ms": floor_ms,
            "fused_device_ms": device_ms(lambda: fused(xs))[0],
            "ms": time_ms(lambda: fn(xs), iters=50), "fused_ms": time_ms(lambda: fused(xs),
                                                                         iters=50),
            "plain_ms": time_ms(lambda: plain[1](xs, plain[0](xs)), iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}


def split_cases(dev) -> dict:
    return {"k2": split_route_case(dev, 0), "k1": split_route_case(dev, 128)}


def split_child(out_path: str) -> int:
    """Phase 24b's cases in a process of their own (``--split-child``),
    written to ``out_path`` with the process's profiler captures."""
    split = split_cases(torch.device("cuda"))
    split["captures"] = {"captures": PROFILE_SESSIONS, "retries": PROFILE_RETRIES,
                         "empty": EMPTY_CAPTURES}
    with open(out_path, "w") as f:
        json.dump(split, f)
    return 0


def phase_split(dev) -> dict:
    """Phase 24b, profiled in this process; where a capture comes back
    without device events (late in the whole run the K1 shared-scale
    fused entry's 62-leaf call did so in six captures of six, in three
    runs of three, where a fresh process profiles it), the empty captures
    are printed with their launch calls and the cases run again in a
    fresh process of the script (``--split-child``), timed."""
    import tempfile

    t0 = time.perf_counter()
    try:
        split = split_cases(dev)
        split["profiled_in"] = "this process"
    except ProfilerEmpty as e:
        print(f"phase 24b: in this process after {time.perf_counter() - t0:.1f} s: {e}; "
              "again in a fresh process")
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "split.json")
            cmd = [sys.executable, os.path.abspath(__file__), "--split-child", out]
            if PACKAGE_ROOT is not None:
                cmd += ["--package-root", PACKAGE_ROOT]
            t_child = time.perf_counter()
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True, timeout=600)
            require(proc.returncode == 0,
                    f"phase 24b: its process exited {proc.returncode}: {proc.stderr[-3000:]}")
            with open(out) as f:
                split = json.load(f)
        split["profiled_in"] = "a fresh process, after this one's empty captures"
        split["in_process_empty"] = str(e)
        split["child_seconds"] = time.perf_counter() - t_child
    split["seconds"] = time.perf_counter() - t0
    print("phase 24b split routes at the ResNet18 step, bit-exact vs plain and fused: "
          + json.dumps(split))
    return split


def phase24_child(rank: int, port: int, root: str, out_path: str) -> int:
    """One of phase 24's two processes on the one card: a gloo group
    (``init_process_group`` at ``tcp://localhost:port``), 4 of the 8
    workers, ``cli.train.main`` on each wire (the trainer takes the
    group's ``ProcessWorkerAxis``, whose gloo hops copy through host
    memory); then K2's and K1's split routes with a NaN-only piece in
    process 1's rows. Writes its record to ``out_path``."""
    import torch.distributed as dist

    from ps_pytorch_tpu_torch.ops import quantize as q
    from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis

    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    rec = {"rank": rank}
    try:
        for wire, flags in PROC_WIRES.items():
            reset_counts()
            reset_split_counts()
            out = _train(PROC_STEPS, flags + ["--train-dir", os.path.join(root, f"two_{wire}"),
                                              "--eval-freq", str(PROC_STEPS)], checkpoints=True)
            torch.cuda.synchronize()
            axis = out["trainer"].mesh
            hist = out["history"]
            require(isinstance(axis, ProcessWorkerAxis) and axis.local_size == WORKERS // 2,
                    f"phase 24 rank {rank}: axis {axis!r}")
            step_s = sum(h["time_cost"] for h in hist)
            rec[wire] = {"losses": [h["loss"] for h in hist],
                         "launches": {**read_counts(), **read_split_counts()},
                         "step_ms_p50": _step_p50(hist, warm=2) * 1e3,
                         "host_copy_s": axis.host_copy_s, "steps_s": step_s,
                         "host_copy_share": axis.host_copy_s / step_s}
            dev = out["trainer"].device
            del out
        axis = ProcessWorkerAxis(WORKERS)
        g = torch.Generator().manual_seed(21)
        pieces = [(torch.randn((WORKERS, n), generator=g)[axis.first:][:4] * 0.01).to(dev)
                  for n in (4099, 12345, 10)]
        if rank == 1:
            pieces[1][:] = float("nan")
        nan = {}
        for block in (0, 128):
            got = q.quantize_int8_many(pieces, axis, block)
            torch.cuda.synchronize()
            nan[block] = {"scale_nan": bool(torch.isnan(got[1][1]).all()),
                          "payload_zero": not bool(got[1][0].any()),
                          "finite_scales": all(bool(torch.isfinite(got[i][1]).all())
                                               for i in (0, 2))}
        rec["nan_only"] = nan
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def phase_two_processes(card: str, root: str, nccl: dict) -> dict:
    """Phase 24: two processes share the card, 4 workers each, the
    collectives over a gloo group through host memory; the same three
    wires, each ``model_step_5`` byte for byte phase 23's stacked run's;
    the split routes' launches in each process; the NaN-only piece of
    process 1 gives both processes scale NaN and payload 0. Step p50 and
    the host-copy share (the staged copies' seconds over the steps'
    seconds, the step-5 checkpoint's gather included)."""
    from ps_pytorch_tpu_torch import checkpoint as ckpt

    t0 = time.perf_counter()
    recs = _spawn_children("--phase24-child", root, "phase 24", timeout=400)
    rec = {"card": card, "processes": 2, "workers_per_process": WORKERS // 2}
    for wire in PROC_WIRES:
        two = ckpt.checkpoint_path(os.path.join(root, f"two_{wire}"), PROC_STEPS)
        require(_files_equal(two, ckpt.checkpoint_path(os.path.join(root, f"stacked_{wire}"),
                                                       PROC_STEPS)),
                f"phase 24 {wire}: model_step_{PROC_STEPS} bytes differ from the stacked run")
        block = wire == "block128"
        absmax, given = (("rows_scaled_absmax", "quantize_rows_scaled_given") if block else
                         ("tensors_absmax", "quantize_tensors_given"))
        for r in recs:
            la = r[wire]["launches"]
            require(la[absmax] == la[given] == PROC_STEPS,
                    f"phase 24 {wire} rank {r['rank']}: launches {la}")
        rec[wire] = {"bit_exact_vs_stacked": True,
                     "step_ms_p50": [r[wire]["step_ms_p50"] for r in recs],
                     "stacked_step_ms_p50": nccl[wire]["stacked_step_ms_p50"],
                     "host_copy_share": [r[wire]["host_copy_share"] for r in recs],
                     "launches": [r[wire]["launches"] for r in recs]}
    for r in recs:
        for block, v in r["nan_only"].items():
            require(v["scale_nan"] and v["payload_zero"] and v["finite_scales"],
                    f"phase 24 rank {r['rank']} block {block}: NaN-only piece {v}")
    rec["nan_only"] = [r["nan_only"] for r in recs]
    rec["seconds"] = time.perf_counter() - t0
    print("phase 24 two processes on the card (gloo through host memory) vs stacked: "
          + json.dumps(rec))
    return rec


# ---------------- phases 25-27: the data path, the adaptive wire, stochastic rounding

DATA_STEPS = 10
PER_WORKER = 128  # the Train configuration's per-worker batch


def _chw_rows(x: np.ndarray) -> np.ndarray:
    """CIFAR's on-disk rows: each image as 3072 bytes, channel-major."""
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2).reshape(len(x), -1))


def write_cifar10(root: str, d) -> str:
    """CIFAR-10's python layout under ``root``: ``cifar-10-batches-py``
    with ``data_batch_1..5`` (the train split in five) and
    ``test_batch``, each a pickled dict of bytes keys."""
    import pickle

    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    parts = np.array_split(np.arange(len(d.train_images)), 5)
    for i, idx in enumerate(parts, 1):
        with open(os.path.join(base, f"data_batch_{i}"), "wb") as f:
            pickle.dump({b"batch_label": f"training batch {i} of 5".encode(),
                         b"data": _chw_rows(d.train_images[idx]),
                         b"labels": d.train_labels[idx].tolist()}, f)
    with open(os.path.join(base, "test_batch"), "wb") as f:
        pickle.dump({b"batch_label": b"testing batch 1 of 1", b"data": _chw_rows(d.test_images),
                     b"labels": d.test_labels.tolist()}, f)
    return base


def write_mnist_gz(root: str, d) -> None:
    """MNIST's four gzipped idx files (magic 0x0000 08 ndim, big-endian
    dims, the bytes)."""
    import gzip
    import struct

    os.makedirs(root, exist_ok=True)
    for stem, a in (("train-images-idx3-ubyte", d.train_images[..., 0]),
                    ("train-labels-idx1-ubyte", d.train_labels),
                    ("t10k-images-idx3-ubyte", d.test_images[..., 0]),
                    ("t10k-labels-idx1-ubyte", d.test_labels)):
        a = np.ascontiguousarray(a, np.uint8)
        with gzip.open(os.path.join(root, stem + ".gz"), "wb") as f:
            f.write(struct.pack(">I", 0x0800 | a.ndim))
            f.write(struct.pack(">" + "I" * a.ndim, *a.shape))
            f.write(a.tobytes())


def write_svhn(root: str, d) -> None:
    """SVHN's ``train_32x32.mat`` / ``test_32x32.mat``: X is HWCN, y
    holds 10 for the digit 0."""
    import scipy.io

    os.makedirs(root, exist_ok=True)
    for name, x, y in (("train_32x32.mat", d.train_images, d.train_labels),
                       ("test_32x32.mat", d.test_images, d.test_labels)):
        scipy.io.savemat(os.path.join(root, name), {
            "X": x.transpose(1, 2, 3, 0), "y": np.where(y == 0, 10, y).astype(np.uint8)[:, None]})


def _same_arrays(got, want) -> bool:
    return all(getattr(got, f).dtype == getattr(want, f).dtype
               and np.array_equal(getattr(got, f), getattr(want, f))
               for f in ("train_images", "train_labels", "test_images", "test_labels"))


def _spans(trace_dir: str) -> list:
    with open(os.path.join(trace_dir, "trace_train_p0.jsonl")) as f:
        return [r for r in (json.loads(line) for line in f) if r["kind"] == "span"]


def phase_data(card: str, synthetic_p50_ms=None) -> dict:
    """Phase 25: CIFAR-10 written in its on-disk form at its real size
    (50,000 + 10,000 images from ``make_synthetic``), read back equal
    through ``prepare_data(root=...)``, then ``cli.train --data-root DIR
    --no-synthetic`` on phase 9's configuration with ``--trace``, 10
    steps: finite losses, no skipped step, K2 once a step, one ``h2d``
    span a dispatched batch, each inside a ``fetch`` span; the step p50
    beside phase 9's synthetic run, the fetch's share of it, and
    ``psl_gather``'s time for one 8 x 128 batch against numpy indexing.
    MNIST (gzipped idx) and SVHN (.mat) are written small and read back
    equal."""
    import shutil
    import tempfile

    from ps_pytorch_tpu_torch.data import gather_rows, make_synthetic, prepare_data

    t_start = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        d = make_synthetic("Cifar10", train_size=50000, test_size=10000)
        t0 = time.perf_counter()
        base = write_cifar10(root, d)
        write_s = time.perf_counter() - t0
        disk = sum(os.path.getsize(os.path.join(base, f)) for f in os.listdir(base))
        t0 = time.perf_counter()
        got = prepare_data("Cifar10", root=root, allow_synthetic=False)
        read_s = time.perf_counter() - t0
        require(not got.synthetic and _same_arrays(got, d),
                "data: the CIFAR-10 files read back differ from what was written")
        small = {}
        for name, writer, sub in (("MNIST", write_mnist_gz, "mnist"), ("SVHN", write_svhn, "svhn")):
            s = make_synthetic(name, train_size=600, test_size=100, seed=3)
            writer(os.path.join(root, sub), s)
            back = prepare_data(name, root=root, allow_synthetic=False)
            require(not back.synthetic and _same_arrays(back, s),
                    f"data: the {name} files read back differ from what was written")
            small[name] = list(back.train_images.shape)
        # one 8 x 128 batch: the native gather against numpy indexing
        idx = np.random.RandomState(0).randint(0, len(d.train_images), WORKERS * PER_WORKER)
        require(np.array_equal(gather_rows(d.train_images, idx), d.train_images[idx]),
                "data: psl_gather differs from numpy indexing")

        def host_ms(fn, reps=50):
            ts = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts)) * 1e3

        gather_ms = host_ms(lambda: gather_rows(d.train_images, idx))
        numpy_ms = host_ms(lambda: d.train_images[idx])
        tdir = os.path.join(root, "trace")
        reset_counts()
        out = _train(DATA_STEPS, ["--data-root", root, "--no-synthetic", "--trace", tdir])
        torch.cuda.synchronize()
        counts = read_counts()
    finally:
        spans = _spans(os.path.join(root, "trace")) if os.path.exists(
            os.path.join(root, "trace", "trace_train_p0.jsonl")) else []
        shutil.rmtree(root, ignore_errors=True)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    require(len(losses) == DATA_STEPS and all(np.isfinite(v) for v in losses),
            f"data: losses {losses}")
    require(out["train"]["skipped_steps"] == 0.0, "data: a step was skipped")
    require(OTHER_TREE or counts["quantize_tensors"] == DATA_STEPS,
            f"data: launches {counts}, expected one K2 call a step")
    fetch = [s for s in spans if s["name"] == "fetch"]
    h2d = [s for s in spans if s["name"] == "h2d"]
    # the first fetch dispatches two batches, each later one the next
    require(len(fetch) == DATA_STEPS and len(h2d) == DATA_STEPS + 1,
            f"data: {len(fetch)} fetch and {len(h2d)} h2d spans in {DATA_STEPS} steps")
    for s in h2d:
        require(any(f["t"] <= s["t"] and s["t"] + s["dur"] <= f["t"] + f["dur"] + 1e-6
                    and s["depth"] == f["depth"] + 1 for f in fetch),
                f"data: an h2d span outside every fetch span: {s}")
    p50 = _step_p50(hist)
    fetch_ms = float(np.median([f["dur"] for f in fetch[3:]])) * 1e3
    rec = {"card": card, "model": "ResNet18 Cifar10 from its on-disk files, f32 (TF32 off)",
           "workers": WORKERS, "batch_per_worker": PER_WORKER, "steps": DATA_STEPS,
           "files": {"cifar10_bytes": disk, "write_s": write_s, "read_s": read_s,
                     "train_images": list(got.train_images.shape),
                     "test_images": list(got.test_images.shape), **small},
           "launches": counts, "loss_first": losses[0], "loss_last": losses[-1],
           "step_ms_p50": p50 * 1e3, "synthetic_step_ms_p50": synthetic_p50_ms,
           "fetch_ms_p50": fetch_ms, "fetch_share_of_step": fetch_ms / (p50 * 1e3),
           "h2d_spans": len(h2d), "h2d_ms_p50": float(np.median([s["dur"] for s in h2d])) * 1e3,
           "gather_8x128_ms": {"psl_gather": gather_ms, "numpy": numpy_ms},
           "val": out["val"], "seconds": time.perf_counter() - t_start}
    print("phase 25 data path: CIFAR-10 files, native gather, pinned prefetch: "
          + json.dumps(rec))
    return rec


ADAPT_WIRE = ["--compress-grad", "2round", "--wire-domain", "homomorphic",
              "--bucket-bytes", "4194304"]
ADAPT_STEPS = 12
ADAPT_SLOW = [4, 5]        # the fault plan's stalled steps
ADAPT_THRESHOLD_S = 1.0    # the watchdog's threshold: a step takes ~0.2 s
ADAPT_STALL_S = 1.5


def _resnet_total() -> int:
    from ps_pytorch_tpu_torch.models import build_model, init_model
    from ps_pytorch_tpu_torch.parallel.buckets import tree_layout

    params, _ = init_model(build_model("ResNet18"), torch.Generator().manual_seed(0),
                           device="cpu")
    return tree_layout(params).total


def _sync_calls(prof) -> dict:
    """The CUDA runtime calls that block the host until the card catches
    up (a D2H read or a pageable H2D copy ends in one), and beside them the
    async copies (device-to-device ones among them)."""
    waits = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
    names = [evt.name for evt in prof.events()]
    return {"waits": sum(names.count(n) for n in waits),
            "memcpy_async": names.count("cudaMemcpyAsync")}


def _adaptive_step_checks(dev, n_buckets: int) -> dict:
    """Steps of the phase-26 wire called directly (error feedback on,
    every step's draws the same for each configuration): the full
    count's step against the static step, bit for bit, for 3 steps;
    all-int8 tags against it (the lattice scale is a quotient by the
    peak, as in JAX: 1e-6 of the update after one step, K x 1e-2 after
    three, where a payload at a half may round the other way); the host syncs of one adaptive
    step (count and tags as device tensors) against the static masked
    step's; and one K3 launch held against its plain version on the same
    payload and device divisor."""
    from torch.profiler import ProfilerActivity, profile

    from ps_pytorch_tpu_torch.data import (
        BatchIterator,
        make_preprocessor,
        make_synthetic,
        prefetch_to_device,
    )
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.ops import quantize as q
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel import collectives
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
    from ps_pytorch_tpu_torch.parallel.ps import (
        PSConfig,
        draw_step,
        init_ps_state,
        make_ps_train_step,
    )

    base = dict(num_workers=WORKERS, compress="int8_2round", wire_domain="homomorphic",
                bucket_bytes=4194304, error_feedback=True)
    cfgs = {"static": PSConfig(**base),
            "count": PSConfig(num_aggregate_min=4, num_aggregate_max=8, **base),
            "int8_tags": PSConfig(num_aggregate_min=4, num_aggregate_max=8,
                                  precision_adapt=True, **base),
            "static_masked": PSConfig(num_aggregate=5, **base)}
    model = build_model("ResNet18")
    pre = make_preprocessor("Cifar10", True)
    data = make_synthetic("Cifar10", train_size=WORKERS * PER_WORKER * 3)
    host = list(BatchIterator(data.train_images, data.train_labels, WORKERS * PER_WORKER,
                              seed=0).epoch())
    batches = list(prefetch_to_device(iter(host), device=dev))
    count8 = torch.tensor(8, dtype=torch.int32, device=dev)
    int8 = torch.full((n_buckets,), 2, dtype=torch.int32, device=dev)
    extras = {"static": {}, "count": {"agg_count": count8},
              "int8_tags": {"agg_count": count8, "prec_tags": int8}, "static_masked": {}}
    states, steps = {}, {}
    p0 = None
    for name, cfg in cfgs.items():
        tx = build_optimizer("sgd", 0.1, momentum=0.9)
        states[name] = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(1),
                                     device=dev)
        steps[name] = make_ps_train_step(model, tx, cfg, preprocess=pre, seed=2, device=dev)
        p0 = states[name].params.flat.clone()  # the same seed: the same params
    # one set of draws a step for every configuration (the adaptive
    # configurations draw a permutation, which the static step ignores)
    draws = [draw_step(cfgs["count"], 2, i, PER_WORKER, pre, model, dev) for i in range(3)]
    first_diff = None
    # bit for bit across runs needs cuDNN's deterministic algorithms
    torch.backends.cudnn.deterministic = True
    try:
        for i, batch in enumerate(batches):
            for name in ("static", "count", "int8_tags"):
                states[name], _ = steps[name](states[name], batch, draws[i], **extras[name])
            if i == 0:
                first_diff = float((states["int8_tags"].params.flat
                                    - states["static"].params.flat).abs().max())
                first_moved = float((states["static"].params.flat - p0).abs().max())
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    s, c, t = states["static"], states["count"], states["int8_tags"]

    def leaves(st):
        return [st.params.flat] + tree_leaves(st.comm_state)

    require(all(torch.equal(a, b) for a, b in zip(leaves(c), leaves(s))),
            "adaptive: the full count's params or residuals differ from the static step's")
    moved = float((s.params.flat - p0).abs().max())
    tag_diff = float((t.params.flat - s.params.flat).abs().max())
    # step 1: the scale's last bit only; later steps carry that into the
    # gradients, where a payload at a half rounds the other way and K3
    # moves it a lattice step: the parity rule's K x 1e-2 of the update
    require(first_diff <= 1e-6 * first_moved and tag_diff <= WORKERS * 1e-2 * moved,
            f"adaptive: all-int8 tags moved the params {first_diff} after step 1 (largest "
            f"update {first_moved}), {tag_diff} after 3 (largest {moved})")
    # host syncs of one step: the adaptive step's against the static masked one's
    syncs = {}
    for name, key in (("static_masked", "static_masked"), ("adaptive", "int8_tags")):
        st = states[key]
        st, _ = steps[key](st, batches[0], draws[0], **extras[key])  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            st, _ = steps[key](st, batches[1], draws[1], **extras[key])
            torch.cuda.synchronize()
        syncs[name] = _sync_calls(prof)
        syncs[name]["waits"] -= 1  # the closing synchronize
        states[key] = st
    require(syncs["adaptive"]["waits"] <= syncs["static_masked"]["waits"],
            f"adaptive: the count and tags added host waits {syncs}")
    # one K3 launch of an adaptive step, held against its plain version
    seen = []
    real = collectives.accumulate_rescale_int8

    def spy(recv, divisor):
        out = real(recv, divisor)
        if not seen:
            seen.append((recv.clone(), divisor.clone(), out.clone()))
        return out

    k3_before = q.accumulate_rescale_int8.launches
    collectives.accumulate_rescale_int8 = spy
    try:
        count5 = torch.tensor(5, dtype=torch.int32, device=dev)
        states["count"], _ = steps["count"](states["count"], batches[2], draws[2],
                                            agg_count=count5)
    finally:
        collectives.accumulate_rescale_int8 = real
    torch.cuda.synchronize()
    recv, divisor, out = seen[0]
    require(divisor.device.type == dev.type and divisor.dtype == torch.float32
            and float(divisor) == 5.0,
            f"adaptive: K3's divisor {divisor}")
    plain = q.accumulate_rescale_plain(recv, divisor)
    require(torch.equal(out, plain), "adaptive: K3 differs from its plain version")
    return {"full_count_bit_exact": True,
            "int8_tags_vs_static": {"step1_max_abs_diff": first_diff,
                                    "step1_largest_update": first_moved,
                                    "step3_max_abs_diff": tag_diff, "step3_largest_update": moved},
            "host_syncs_per_step": syncs,
            "k3_held": {"shape": list(recv.shape), "divisor": float(divisor),
                        "launches_in_step": q.accumulate_rescale_int8.launches - k3_before}}


def phase_adaptive(card: str, dev) -> dict:
    """Phase 26: ResNet18 8 x 128 on the autotune-best wire in 4 MiB
    buckets (``--compress-grad 2round --wire-domain homomorphic
    --bucket-bytes 4194304``), 12 steps through ``cli.train.main`` with
    ``--precision-adapt``, a wire budget of 0.6 of the all-int8 effective
    bytes, ``--num-aggregate-min 4 --num-aggregate-max 8`` from 8,
    ``--adapt-window 2``, the watchdog armed at 1 s and steps 4-5 stalled
    by the fault plan: the ``mask_adapt`` records the controller's rule
    implies for those stalls (down, then back), at least one
    ``precision_adapt`` record, K3 once a bucket a step and no K1 / K2
    call (round 1 quantizes onto each bucket's lattice, plain PyTorch),
    finite losses; then ``_adaptive_step_checks``."""
    import argparse
    import tempfile

    from ps_pytorch_tpu_torch.cli._flags import add_ps_flags, add_train_flags, ps_config_from
    from ps_pytorch_tpu_torch.obs.schema import validate_event
    from ps_pytorch_tpu_torch.parallel.ps import precision_hi_peak, state_plan
    from ps_pytorch_tpu_torch.resilience.elastic import AdaptiveMaskController
    from ps_pytorch_tpu_torch.resilience.precision import effective_wire_bytes

    t_start = time.perf_counter()
    parser = add_ps_flags(add_train_flags(argparse.ArgumentParser()))
    cfg0 = ps_config_from(parser.parse_args(TRAIN_ARGS + ADAPT_WIRE + ["--precision-adapt"]),
                          WORKERS)
    plan = state_plan(cfg0, _resnet_total())
    static_bytes = effective_wire_bytes([2] * plan.n_buckets, plan.sizes,
                                        precision_hi_peak(cfg0))
    budget = int(0.6 * static_bytes)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_adapt_")
    mfile = os.path.join(tmp, "m.jsonl")
    flags = ADAPT_WIRE + [
        "--precision-adapt", "--wire-budget-bytes", str(budget), "--num-aggregate", "8",
        "--num-aggregate-min", "4", "--num-aggregate-max", "8", "--adapt-window", "2",
        "--mode", "straggler", "--kill-threshold", str(ADAPT_THRESHOLD_S),
        "--fault-plan", json.dumps({"slow_steps": ADAPT_SLOW, "slow_s": ADAPT_STALL_S}),
        "--metrics-file", mfile]
    cfg = ps_config_from(parser.parse_args(TRAIN_ARGS + flags), WORKERS)
    reset_counts()
    out = _train(ADAPT_STEPS, flags)
    torch.cuda.synchronize()
    counts = read_counts()
    losses = [h["loss"] for h in out["history"]]
    require(len(losses) == ADAPT_STEPS and all(np.isfinite(v) for v in losses),
            f"adaptive: losses {losses}")
    require(out["train"]["skipped_steps"] == 0.0, "adaptive: a step was skipped")
    with open(mfile) as f:
        recs = [validate_event(json.loads(line)) for line in f]
    slow = sorted(r["step"] for r in recs if r["kind"] in ("straggler", "straggler_storm"))
    require(slow == ADAPT_SLOW, f"adaptive: the watchdog saw slow steps {slow}, the fault "
                                f"plan stalled {ADAPT_SLOW}")
    # the rule, fed the same stalls (the first step is exempt)
    want = []
    rule = AdaptiveMaskController(cfg, ADAPT_THRESHOLD_S, 2, event_sink=want.append)
    for step in range(2, ADAPT_STEPS + 1):
        rule.record(step, 2 * ADAPT_THRESHOLD_S if step in ADAPT_SLOW else 0.0)
    got = [{k: r[k] for k in ("step", "from", "to")} for r in recs if r["kind"] == "mask_adapt"]
    want = [{k: r[k] for k in ("step", "from", "to")} for r in want]
    require(got == want and min(r["to"] for r in got) < 8 and got[-1]["to"] == 8,
            f"adaptive: mask_adapt records {got}, the rule implies {want}")
    prec = [r for r in recs if r["kind"] == "precision_adapt"]
    require(len(prec) >= 1, "adaptive: no precision_adapt record")
    n_b = plan.n_buckets
    require(OTHER_TREE or counts == {**{k: 0 for k in counts},
                                     "accumulate_rescale_int8": n_b * ADAPT_STEPS},
            f"adaptive: launches {counts}, expected K3 {n_b} a step and no K1 / K2 call")
    checks = _adaptive_step_checks(dev, n_b)
    rec = {"card": card, "flags": " ".join(flags[:-2]), "steps": ADAPT_STEPS,
           "buckets": n_b, "static_int8_effective_bytes": static_bytes,
           "budget_bytes": budget, "launches": counts, "mask_adapt": got,
           "precision_adapt": [{k: r[k] for k in ("step", "changed", "effective_bytes", "n_skip",
                                                  "n_4bit", "n_int8", "n_hi")} for r in prec],
           "summary": {k: out["train"][k] for k in ("agg_count", "mask_adaptations",
                                                    "precision_adaptations",
                                                    "effective_wire_bytes")},
           "loss_first": losses[0], "loss_last": losses[-1],
           "step_ms_p50_unstalled": float(np.median(
               [h["time_cost"] for h in out["history"][2:] if h["step"] not in ADAPT_SLOW]))
           * 1e3, **checks, "seconds": time.perf_counter() - t_start}
    print("phase 26 adaptive wire (count + per-bucket precision) on ResNet18: "
          + json.dumps(rec))
    return rec


STOCH_STEPS = 3


def phase_stochastic(card: str, dev) -> dict:
    """Phase 27: ResNet18 8 x 128, 3 steps each on ``--compress-grad
    compress --quant-rounding stochastic`` and ``--compress-grad 2round
    --quant-rounding stochastic`` through ``cli.train.main``: finite
    losses and no K1 / K2 launch (stochastic rounding is plain PyTorch, as
    JAX takes no Pallas kernel there); the mean of ``dequant(quantize(x))
    - x`` over 64 of the card's draws for a 1 M-element tensor within 4
    standard errors of 0; ``pack_int4`` / ``unpack_int4`` /
    ``quantize_lattice`` on the card bit for bit the CPU's."""
    from ps_pytorch_tpu_torch.ops import quantize as q

    t_start = time.perf_counter()
    rec = {"card": card}
    for name, flags in (("int8", ["--quant-rounding", "stochastic"]),
                        ("2round", ["--compress-grad", "2round", "--quant-rounding",
                                    "stochastic"])):
        reset_counts()
        out = _train(STOCH_STEPS, flags)
        torch.cuda.synchronize()
        counts = read_counts()
        losses = [h["loss"] for h in out["history"]]
        require(len(losses) == STOCH_STEPS and all(np.isfinite(v) for v in losses),
                f"stochastic {name}: losses {losses}")
        require(out["train"]["skipped_steps"] == 0.0, f"stochastic {name}: a step was skipped")
        require(OTHER_TREE or not any(counts.values()),
                f"stochastic {name}: launches {counts}, expected none")
        rec[name] = {"flags": " ".join(flags), "launches": counts, "losses": losses,
                     "step_ms_last": out["history"][-1]["time_cost"] * 1e3}
    g = torch.Generator(device=dev).manual_seed(27)
    x = torch.rand(1 << 20, generator=g, device=dev) * 2 - 1
    total, total_sq, n = 0.0, 0.0, 0
    for _ in range(64):
        qx, s = q.quantize_int8(x, rounding="stochastic",
                                uniform=torch.rand(x.shape, generator=g, device=dev))
        e = (q.dequantize_int8(qx, s) - x).double()
        total += float(e.sum())
        total_sq += float((e * e).sum())
        n += e.numel()
    mean = total / n
    se = float(np.sqrt(max(total_sq / n - mean * mean, 0.0) / n))
    require(abs(mean) <= 4 * se, f"stochastic: mean error {mean} beyond 4 standard errors {se}")
    rec["unbiased"] = {"elements": x.numel(), "draws": 64, "mean_error": mean,
                       "standard_error": se}
    rng = np.random.RandomState(2)
    xs = torch.from_numpy((rng.randn(3, 1000, 129) * 2).astype(np.float32))
    codec = {}
    for peak in (0.0, 7.0, 127.0, 4095.0):
        for block in (0, 128):
            out_dt = torch.int16 if peak > 127 else torch.int8
            qc, sc = q.quantize_lattice(xs, torch.tensor(peak), block_size=block,
                                        hi_peak=max(int(peak), 127), out_dtype=out_dt)
            qg, sg = q.quantize_lattice(xs.to(dev), torch.tensor(peak, device=dev),
                                        block_size=block, hi_peak=max(int(peak), 127),
                                        out_dtype=out_dt)
            require(torch.equal(qg.cpu(), qc) and same_bits(sg.cpu(), sc),
                    f"stochastic: quantize_lattice peak {peak} block {block} differs on the card")
    q4 = torch.from_numpy(rng.randint(-7, 8, size=100001).astype(np.int8))
    packed = q.pack_int4(q4.to(dev))
    require(torch.equal(packed.cpu(), q.pack_int4(q4)), "stochastic: pack_int4 differs")
    require(torch.equal(q.unpack_int4(packed, q4.numel()).cpu(), q4),
            "stochastic: unpack_int4 does not invert pack_int4 on the card")
    codec = {"lattice_peaks": [0, 7, 127, 4095], "blocks": [0, 128], "pack_int4_n": q4.numel(),
             "bit_exact_vs_cpu": True}
    rec["codec"] = codec
    rec["seconds"] = time.perf_counter() - t_start
    print("phase 27 stochastic rounding and the int4 / lattice codec: " + json.dumps(rec))
    return rec


# ------------------------------------------------ phases 28-30 (the PS comm stack, the rest)

RESHAPE_FLAGS = ["--opt-placement", "sharded", "--bucket-bytes", "4194304", "--error-feedback"]


def _tree_bits_equal(a, b) -> bool:
    """Two state dicts (nested dicts of arrays) equal key for key, bit for bit."""
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_tree_bits_equal(a[k], b[k]) for k in a))
    x, y = np.asarray(a), np.asarray(b)
    return (x.shape == y.shape and x.dtype == y.dtype
            and np.array_equal(x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8)))


def phase_reshape(card: str) -> dict:
    """Phase 28: the resume-reshape on the card. ResNet18 8 x 128 ZeRO-1
    (``--opt-placement sharded --bucket-bytes 4194304``) with EF, stopped by
    the ``sigterm`` fault at step 4 (``model_step_4`` and its manifest
    written); resumed on 4 workers with ``--bucket-bytes 0``, then on 8
    with ``--bucket-bytes 2097152``. Each resume writes one
    ``resume_reshape`` record and continues the step count; the moments
    the card restored equal, bit for bit, the plain CPU reshape of the
    same file (``elastic.reshape_raw_state``, numpy), and the EF residuals'
    sum is kept as JAX's rule keeps it: every new worker holds the file's
    sum / n, which times n (a power of two) is that sum bit for bit. The
    reshape's host seconds are reported."""
    import tempfile

    from ps_pytorch_tpu_torch import checkpoint as ckpt
    from ps_pytorch_tpu_torch.cli._flags import (
        add_ps_flags,
        add_train_flags,
        ps_config_from,
        train_config_from,
    )
    from ps_pytorch_tpu_torch.obs.schema import validate_event
    from ps_pytorch_tpu_torch.resilience import elastic
    from ps_pytorch_tpu_torch.trainer import Trainer
    from ps_pytorch_tpu_torch.utils.serialization import to_state_dict

    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_reshape_")
    d = os.path.join(tmp, "models")
    first = _train(30, RESHAPE_FLAGS + ["--train-dir", d, "--fault-plan", '{"sigterm": 4}'],
                   checkpoints=True)
    require(first["trainer"].stop_requested and ckpt.latest_valid_step(d) == 4,
            f"reshape: the SIGTERM run left {ckpt.available_steps(d)}")
    parser = add_ps_flags(add_train_flags(argparse.ArgumentParser()))
    rec = {"card": card, "flags": " ".join(RESHAPE_FLAGS), "stopped_at": 4, "resumes": []}
    stop = 4
    for n, bb, until in ((4, "0", 6), (8, "2097152", 8)):
        mfile = os.path.join(tmp, f"m{n}.jsonl")
        args = parser.parse_args(TRAIN_ARGS + RESHAPE_FLAGS + [
            "--num-workers", str(n), "--bucket-bytes", bb, "--max-steps", str(until),
            "--resume", "--train-dir", d, "--metrics-file", mfile])
        t = Trainer(train_config_from(args), ps_config_from(args, n), device="cuda")
        raw = ckpt.load_checkpoint_raw(d, stop)
        src = elastic.load_geometry(d, stop)
        require(src is not None and elastic.needs_reshape(src, elastic.geometry_of(t.pcfg)),
                f"reshape: the manifest of step {stop} needs no reshape onto {n} workers")
        t0 = time.perf_counter()
        plain = elastic.reshape_raw_state(raw, src, t.pcfg, t.checkpoint_state())
        reshape_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        require(t.try_resume() == stop, f"reshape: the {n}-worker run did not resume {stop}")
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        got = to_state_dict(t.checkpoint_state())
        require(_tree_bits_equal(got["opt_state"], plain["opt_state"]),
                f"reshape: the moments restored on {n} workers differ from the plain reshape")
        # every new worker holds the file's summed residual / n (the padded
        # tails, zeros, differ in length between the carvings), so n rows
        # give back that sum exactly: n is a power of two
        total = t.state.params.layout.total
        rows = np.asarray(got["comm_state"])[:, :total]
        ef_sum = np.asarray(raw["comm_state"], np.float32).sum(0)[:total]
        require(all(_tree_bits_equal(r, rows[0]) for r in rows)
                and _tree_bits_equal(rows[0] * np.float32(n), ef_sum),
                f"reshape: the EF residuals' sum changed onto {n} workers")
        t.tcfg.resume = False
        out = t.train()
        torch.cuda.synchronize()
        with open(mfile) as f:
            events = [validate_event(json.loads(line)) for line in f]
        rr = [e for e in events if e["kind"] == "resume_reshape"]
        steps = [e["step"] for e in events if e["kind"] == "train"]
        require(len(rr) == 1 and rr[0]["from"]["num_workers"] == src.num_workers
                and rr[0]["to"]["num_workers"] == n,
                f"reshape: resume_reshape records {rr}")
        require(steps == list(range(stop + 1, until + 1)),
                f"reshape: the {n}-worker run took steps {steps}")
        require(np.isfinite(out["loss"]), f"reshape: loss {out['loss']}")
        rec["resumes"].append({
            "workers": n, "bucket_bytes": int(bb), "from_step": stop, "steps": steps,
            "from": {k: rr[0]["from"][k] for k in ("num_workers", "bucket_bytes")},
            "reshape_host_s": reshape_s, "resume_s": resume_s,
            "moments_bit_exact": True, "ef_sum_bit_exact": True, "loss_last": out["loss"]})
        stop = until
        del t
    rec["seconds"] = time.perf_counter() - t_start
    print("phase 28 resume-reshape ResNet18 8 -> 4 -> 8 workers (ZeRO-1, EF): "
          + json.dumps(rec))
    return rec


OVERLAP_WIRES = {
    "int8": ["--bucket-bytes", "4194304"],
    "2round_homomorphic": ["--compress-grad", "2round", "--wire-domain", "homomorphic",
                           "--bucket-bytes", "4194304"],
}


class _Timed:
    """A stand-in for ``ps._BucketStream`` that records, on the card, a
    timing event before and after each bucket's wire (on the side stream)
    and one when the backward ends (``finish``, on the step's stream), so
    a phase can read how much of the wire ran before the last worker's
    backward ended. Installed only while the phase measures."""

    def __init__(self, base):
        self.base = base
        self.records = []

    def __call__(self, *a, **kw):
        outer = self
        stream = self.base(*a, **kw)
        run, finish = stream._run, stream.finish

        def timed_run(b):
            side = stream.side
            start = torch.cuda.Event(enable_timing=True)
            side.wait_stream(torch.cuda.current_stream())
            start.record(side)
            run(b)
            end = torch.cuda.Event(enable_timing=True)
            end.record(side)
            outer.records[-1]["buckets"].append((start, end))

        def timed_finish():
            done = torch.cuda.Event(enable_timing=True)
            done.record(torch.cuda.current_stream())
            outer.records[-1]["backward_end"] = done
            return finish()

        self.records.append({"buckets": [], "backward_end": None})
        stream._run, stream.finish = timed_run, timed_finish
        return stream


def _allocator_counts() -> dict:
    """The caching allocator's counters a turn's run moves: cudaMalloc /
    cudaFree calls and the retries (a free of cached blocks, which
    synchronises the device, before a cudaMalloc), and the bytes it
    holds (GB)."""
    st = torch.cuda.memory_stats()
    return {"device_allocs": st.get("num_device_alloc", 0),
            "device_frees": st.get("num_device_free", 0),
            "alloc_retries": st.get("num_alloc_retries", 0),
            "reserved_gb": torch.cuda.memory_reserved() / 1e9}


def _overlap_share(records) -> dict:
    """From ``_Timed``'s events: the wire's summed event time a step and
    the share of it before the backward's end (buckets finish() sent out
    run after it)."""
    total = before = 0.0
    for r in records:
        ref = r["backward_end"]
        for start, end in r["buckets"]:
            span = start.elapsed_time(end)
            to_end = start.elapsed_time(ref)
            total += span
            before += min(max(to_end, 0.0), span)
    return {"wire_event_ms_per_step": total / max(len(records), 1),
            "share_before_backward_end": before / total if total else 0.0}


def _direct_bits(dev, flags: list, steps: int) -> dict:
    """The serial and the pipelined step of one wire called directly for
    ``steps`` steps on the same batches and draws, with EF on and cuDNN
    deterministic: params and EF residuals compared bit for bit."""
    from ps_pytorch_tpu_torch.cli._flags import add_ps_flags, add_train_flags, ps_config_from
    from ps_pytorch_tpu_torch.data import (
        BatchIterator,
        make_preprocessor,
        make_synthetic,
        prefetch_to_device,
    )
    from ps_pytorch_tpu_torch.models import build_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves
    from ps_pytorch_tpu_torch.parallel.ps import draw_step, init_ps_state, make_ps_train_step

    parser = add_ps_flags(add_train_flags(argparse.ArgumentParser()))
    model = build_model("ResNet18")
    pre = make_preprocessor("Cifar10", True)
    data = make_synthetic("Cifar10", train_size=WORKERS * PER_WORKER * steps)
    host = list(BatchIterator(data.train_images, data.train_labels, WORKERS * PER_WORKER,
                              seed=0).epoch())
    batches = list(prefetch_to_device(iter(host), device=dev))
    states = {}
    torch.backends.cudnn.deterministic = True
    try:
        for overlap in ("off", "on"):
            cfg = ps_config_from(parser.parse_args(
                TRAIN_ARGS + flags + ["--error-feedback", "--overlap", overlap]), WORKERS)
            tx = build_optimizer("sgd", 0.1, momentum=0.9)
            st = init_ps_state(model, tx, cfg, torch.Generator().manual_seed(1), device=dev)
            step = make_ps_train_step(model, tx, cfg, preprocess=pre, seed=2, device=dev)
            for i, batch in enumerate(batches):
                st, _ = step(st, batch, draw_step(cfg, 2, i, PER_WORKER, pre, model, dev))
            torch.cuda.synchronize()
            states[overlap] = [st.params.flat] + tree_leaves(st.comm_state)
            del st, step
    finally:
        torch.backends.cudnn.deterministic = False
    same = all(same_bits(a, b) for a, b in zip(states["off"], states["on"]))
    require(same, f"overlap {' '.join(flags)}: the pipelined step's params / EF residuals "
                  f"differ from the serial step's after {steps} steps")
    return {"steps": steps, "params_and_ef_bit_exact": True}


def phase_overlap(card: str, dev) -> dict:
    """Phase 29: ``--overlap on`` on the canonical config at 4 MiB buckets,
    on the per-tensor int8 wire and on the homomorphic two-round wire:
    each ``cli.train.main`` run (8 steps) in turns with the serial
    schedule, twice, the step p50 of each; one K2 call (and, homomorphic,
    one K3 launch) a bucket a step, as ``expected_launches`` implies; the
    share of the wire's event time before the last worker's backward
    ended (``_Timed``); then the serial and pipelined steps called
    directly for 5 steps with EF, params and EF residuals bit for bit.
    A 3-step block-128 pipelined run gives K1's per-bucket count."""
    from ps_pytorch_tpu_torch.cli._flags import add_ps_flags, add_train_flags, ps_config_from
    from ps_pytorch_tpu_torch.models import build_model, init_model
    from ps_pytorch_tpu_torch.parallel import ps as ps_mod

    t_start = time.perf_counter()
    resnet, _ = init_model(build_model("ResNet18"), torch.Generator().manual_seed(0),
                           device="cpu")
    parser = add_ps_flags(add_train_flags(argparse.ArgumentParser()))
    steps = 8
    rec = {"card": card}
    runs = [(name, flags) for name, flags in OVERLAP_WIRES.items()] + [
        ("block128", ["--bucket-bytes", "4194304", "--quant-block-size", "128"])]
    for name, flags in runs:
        turns = {"off": [], "on": []}
        launches, alloc = {}, {"off": [], "on": []}
        for turn in (("off", "on", "off", "on") if name != "block128" else ("on",)):
            fl = flags + ["--overlap", turn]
            cfg = ps_config_from(parser.parse_args(TRAIN_ARGS + fl), WORKERS)
            n_steps = steps if name != "block128" else 3
            want = {k: v * n_steps for k, v in expected_launches(cfg, resnet).items()}
            timed = _Timed(ps_mod._BucketStream) if turn == "on" else None
            if timed is not None:
                ps_mod._BucketStream = timed
            try:
                reset_counts()
                before = _allocator_counts()
                out = _train(n_steps, fl)
                torch.cuda.synchronize()
                got = read_counts()
                alloc[turn].append({k: v - before.get(k, 0)
                                    for k, v in _allocator_counts().items()}
                                   | {"reserved_gb_at_start": before["reserved_gb"]})
            finally:
                if timed is not None:
                    ps_mod._BucketStream = timed.base
            losses = [h["loss"] for h in out["history"]]
            require(all(np.isfinite(v) for v in losses) and len(losses) == n_steps,
                    f"overlap {name} {turn}: losses {losses}")
            require(OTHER_TREE or got == want,
                    f"overlap {name} {turn}: launches {got}, expected {want}")
            launches[turn] = got
            if name != "block128":
                turns[turn].append(_step_p50(out["history"]) * 1e3)
            if timed is not None:
                rec.setdefault(name, {})["overlap"] = _overlap_share(timed.records[3:])
        r = rec.setdefault(name, {})
        r.update({"flags": " ".join(flags), "launches_serial": launches.get("off"),
                  "launches_pipelined": launches["on"], "allocator": alloc,
                  "buckets": _pieces(ps_config_from(parser.parse_args(
                      TRAIN_ARGS + flags + ["--overlap", "on"]), WORKERS), resnet)})
        if name != "block128":
            r.update({"step_ms_p50_serial": turns["off"], "step_ms_p50_pipelined": turns["on"],
                      "pipelined_over_serial": float(np.mean(turns["on"])
                                                     / np.mean(turns["off"]))})
            r["bit_exact"] = _direct_bits(dev, flags, 5)
    rec["seconds"] = time.perf_counter() - t_start
    print("phase 29 --overlap on (pipelined bucket wire) ResNet18 8 x 128: " + json.dumps(rec))
    return rec


# the hierarchical homomorphic run's first losses against the flat
# autotune-best run's on the same weights and batches: the first equal (no
# update yet), the next two within this relative tolerance (one and two
# updates through a wire within JAX's bound of the exact mean; both climb on
# this synthetic data at lr 0.1, so later steps are reported, not held)
HIER_LOSS_RTOL = 0.02


def phase_hier(card: str, dev, flat_best=None) -> dict:
    """Phase 30: ``--dcn-hosts 2`` (a 2 x 4 grid) on the canonical config at
    ``--bucket-bytes 0``, on the dequant (3 steps, and 3 at block 128) and
    the homomorphic (10 steps) two-round wires: launches as
    ``expected_launches`` implies (K3 exactly 2 a piece on the homomorphic
    wire); one step's K3 launches at the ICI hop (divisor 4) and at the
    DCN hop (divisor 2) held against their plain versions bit for bit;
    the aggregate of ResNet18-sized gradients within JAX's bound of the
    exact mean (tests/test_compression.py:613: 3.5 * max|g| * 1.5 / 127),
    both domains; the homomorphic step p50 and losses beside phase 12's
    flat autotune-best run (``flat_best``, its record, when phase 12 ran),
    the first three losses held to it (``HIER_LOSS_RTOL``)."""
    import hashlib

    from ps_pytorch_tpu_torch.cli._flags import add_ps_flags, add_train_flags, ps_config_from
    from ps_pytorch_tpu_torch.models import build_model, init_model
    from ps_pytorch_tpu_torch.ops.quantize import accumulate_rescale_plain
    from ps_pytorch_tpu_torch.parallel import collectives
    from ps_pytorch_tpu_torch.parallel.mesh import make_hybrid_mesh

    t_start = time.perf_counter()
    resnet, _ = init_model(build_model("ResNet18"), torch.Generator().manual_seed(0),
                           device="cpu")
    parser = add_ps_flags(add_train_flags(argparse.ArgumentParser()))
    base = ["--dcn-hosts", "2", "--compress-grad", "2round", "--bucket-bytes", "0"]
    rec = {"card": card, "grid": [2, 4]}
    for name, steps, flags in (("dequant", 3, base), ("dequant_block128", 3,
                                                      base + ["--quant-block-size", "128"]),
                               ("homomorphic", 10, base + ["--wire-domain", "homomorphic"])):
        cfg = ps_config_from(parser.parse_args(TRAIN_ARGS + flags), WORKERS)
        want = {k: v * steps for k, v in expected_launches(cfg, resnet).items()}
        reset_counts()
        out = _train(steps, flags)
        torch.cuda.synchronize()
        got = read_counts()
        losses = [h["loss"] for h in out["history"]]
        require(all(np.isfinite(v) for v in losses) and len(losses) == steps,
                f"hier {name}: losses {losses}")
        require(OTHER_TREE or got == want, f"hier {name}: launches {got}, expected {want}")
        r = {"flags": " ".join(flags), "steps": steps, "launches": got, "losses": losses}
        if steps >= 10 and flat_best is not None:
            flat = flat_best["losses"]
            require(losses[0] == flat[0] and all(
                abs(a - b) <= HIER_LOSS_RTOL * abs(b) for a, b in zip(losses[1:3], flat[1:3])),
                f"hier {name}: losses {losses[:3]} not within {HIER_LOSS_RTOL} of the flat "
                f"autotune-best run's {flat[:3]}")
            r.update({"flat_autotune_best_step_ms_p50": flat_best["step_ms_p50"],
                      "flat_autotune_best_losses": flat})
        if steps >= 10:
            r["step_ms_p50"] = _step_p50(out["history"]) * 1e3
        rec[name] = r
    require(OTHER_TREE or rec["homomorphic"]["launches"]["accumulate_rescale_int8"] == 20,
            "hier homomorphic: K3 not 2 launches a piece a step")
    # one aggregate of ResNet18-sized gradients on the grid: every K3 launch
    # held against its plain version, and the bound
    total = _resnet_total()
    g = torch.Generator(device=dev).manual_seed(30)
    scale = (1.0 + 0.05 * torch.arange(WORKERS, device=dev, dtype=torch.float32))[:, None]
    grads = {"g": torch.randn((WORKERS, total), generator=g, device=dev) * scale * 1e-2}
    exact = grads["g"].double().mean(0)
    bound = 3.5 * float(grads["g"].abs().max()) * 1.5 / 127.0
    seen = []
    real = collectives.accumulate_rescale_int8

    def spy(recv, divisor):
        out = real(recv, divisor)
        seen.append((recv, float(divisor), out))
        return out

    grid = make_hybrid_mesh(2, WORKERS // 2)
    errs, digests = {}, {}
    for domain in ("homomorphic", "dequant"):
        collectives.accumulate_rescale_int8 = spy
        try:
            agg = collectives.aggregate_gradients(grads, grid, WORKERS, compress="int8_2round",
                                                  wire_domain=domain, bucket_bytes=0,
                                                  flat_output=True)
            torch.cuda.synchronize()
        finally:
            collectives.accumulate_rescale_int8 = real
        errs[domain] = float((agg[:total].double() - exact).abs().max())
        digests[domain] = hashlib.sha256(agg.cpu().numpy().tobytes()).hexdigest()
        require(errs[domain] <= bound, f"hier {domain}: error {errs[domain]} beyond the bound "
                                       f"{bound}")
    require([d for _, d, _ in seen] == [4.0, 2.0], f"hier: K3 divisors {[d for _, d, _ in seen]}")
    hops = {}
    for (recv, d, out), hop in zip(seen, ("ici", "dcn")):
        plain = accumulate_rescale_plain(recv.cpu(), d)
        require(torch.equal(out.cpu(), plain), f"hier: K3 at the {hop} hop differs from plain")
        b_ms, b_by = bound_ms(recv.numel() + out.numel(), float(recv.numel()),
                              PEAK_OPS_PER_S[torch.int8])
        hops[hop] = {"shape": list(recv.shape), "divisor": d, "max_abs_err": 0.0,
                     "ms": time_ms(lambda: real(recv, d), iters=50),
                     "bound_ms": b_ms, "bound_by": b_by}
    rec.update({"k3_hops": hops, "bound": bound, "max_err_vs_exact_mean": errs,
                "aggregate_sha256": digests,
                "seconds": time.perf_counter() - t_start})
    print("phase 30 --dcn-hosts 2 (hierarchical two-round wire) ResNet18 2 x 4: "
          + json.dumps(rec))
    return rec


# ------------------- phases 30b and 20c: the grid and synced BN over processes

GRID_PROC_STEPS = 3
GRID_PROC_BASE = ["--dcn-hosts", "2", "--compress-grad", "2round", "--bucket-bytes", "0"]
GRID_PROC_WIRES = {
    "dequant_block128": GRID_PROC_BASE + ["--quant-block-size", "128"],
    "homomorphic": GRID_PROC_BASE + ["--wire-domain", "homomorphic"],
}
# a step's calls in each process holding whole hosts of the 2 x 4 grid (one
# piece): the dequant wire's ICI round 1 stays in a host (K1's fused
# shared-scale entry over the process's hosts), its DCN round 1 shares
# scales across the processes (K1's split halves), its round 2 is K1's
# quantize_rows_many; the homomorphic round 1 shares one lattice over the
# grid (K2's split halves), then K3 at the ICI hop and at the DCN hop
GRID_PROC_LAUNCHES = {
    "dequant_block128": {"quantize_rows_scaled_many": 1, "rows_scaled_absmax": 1,
                         "quantize_rows_scaled_given": 1, "quantize_rows_many": 1},
    "homomorphic": {"tensors_absmax": 1, "quantize_tensors_given": 1,
                    "accumulate_rescale_int8": 2},
}


def _wire_launches_want(per_step: dict, steps: int) -> dict:
    """Every wire counter's launches over ``steps`` steps of ``per_step``."""
    names = list(_counters()) + list(_split_counters())
    return {k: per_step.get(k, 0) * steps for k in names}


def _grid_grads(dev) -> dict:
    """ResNet18-sized gradients of the 8 workers, ``{"g": [8, total]}``,
    magnitudes varying by worker (phase 30's)."""
    total = _resnet_total()
    g = torch.Generator(device=dev).manual_seed(30)
    scale = (1.0 + 0.05 * torch.arange(WORKERS, device=dev, dtype=torch.float32))[:, None]
    return {"g": torch.randn((WORKERS, total), generator=g, device=dev) * scale * 1e-2}


def _grid_aggregate(grid, grads, hops=None):
    """The homomorphic hierarchical wire's aggregate of ``grads`` (this
    process's rows) on ``grid``; ``hops`` collects each K3 launch's
    ``(recv, divisor, out)``."""
    import hashlib

    from ps_pytorch_tpu_torch.parallel import collectives

    real = collectives.accumulate_rescale_int8

    def spy(recv, divisor):
        out = real(recv, divisor)
        hops.append((recv, float(divisor), out))
        return out

    if hops is not None:
        collectives.accumulate_rescale_int8 = spy
    try:
        agg = collectives.aggregate_gradients(grads, grid, WORKERS, compress="int8_2round",
                                              wire_domain="homomorphic", bucket_bytes=0,
                                              flat_output=True)
        torch.cuda.synchronize()
    finally:
        collectives.accumulate_rescale_int8 = real
    return hashlib.sha256(agg.cpu().numpy().tobytes()).hexdigest()


def phase30b_child(rank: int, port: int, root: str, out_path: str) -> int:
    """One of phase 30b's two processes on the card: a gloo group, one
    host of the 2 x 4 grid, ``cli.train.main`` on each wire (the trainer
    builds the group's ``ProcessHybridAxis``); then one aggregate of
    ResNet18-sized gradients on the grid, each K3 launch held against its
    plain version. Writes its record to ``out_path``."""
    import torch.distributed as dist

    from ps_pytorch_tpu_torch.ops.quantize import accumulate_rescale_plain
    from ps_pytorch_tpu_torch.parallel.mesh import ProcessHybridAxis

    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    rec = {"rank": rank}
    try:
        for wire, flags in GRID_PROC_WIRES.items():
            reset_counts()
            reset_split_counts()
            out = _train(GRID_PROC_STEPS, flags + [
                "--train-dir", os.path.join(root, f"grid_two_{wire}"),
                "--eval-freq", str(GRID_PROC_STEPS)], checkpoints=True)
            torch.cuda.synchronize()
            axis, hist = out["trainer"].mesh, out["history"]
            require(isinstance(axis, ProcessHybridAxis) and axis.local_size == WORKERS // 2
                    and axis.dcn.local_size == 1, f"phase 30b rank {rank}: axis {axis!r}")
            step_s = sum(h["time_cost"] for h in hist)
            rec[wire] = {"losses": [h["loss"] for h in hist],
                         "launches": {**read_counts(), **read_split_counts()},
                         "step_ms_p50": _step_p50(hist, warm=1) * 1e3,
                         "host_copy_s": axis.host_copy_s, "steps_s": step_s,
                         "host_copy_share": axis.host_copy_s / step_s}
            dev = out["trainer"].device
            del out
        grid = ProcessHybridAxis(WORKERS, 2)
        grads = {"g": grid.local(_grid_grads(dev)["g"]).contiguous()}
        hops = []
        rec["aggregate_sha256"] = _grid_aggregate(grid, grads, hops)
        rec["k3_hops"] = []
        for recv, d, k3 in hops:
            require(torch.equal(k3.cpu(), accumulate_rescale_plain(recv.cpu(), d)),
                    f"phase 30b rank {rank}: K3 {list(recv.shape)} / {d} differs from plain")
            rec["k3_hops"].append({"shape": list(recv.shape), "divisor": d})
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def _spawn_children(flag: str, root: str, what: str, timeout: int = 600) -> list:
    """Two processes of this script (``flag RANK PORT ROOT OUT``) sharing
    the card; their records, in rank order."""
    port = _free_port()
    outs = [os.path.join(root, f"{flag.strip('-')}_{r}.json") for r in range(2)]
    tree = ["--package-root", PACKAGE_ROOT] if PACKAGE_ROOT is not None else []
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), flag, str(r),
                               str(port), root, outs[r]] + tree,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        require(p.returncode == 0, f"{what} process {r} failed:\n{log[-3000:]}")
    recs = []
    for path in outs:
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def _timed_case(fn, plain, xs, n_bytes: float, n_ops: float, dtype) -> dict:
    """One kernel entry at a path's shapes: bit for bit its plain version
    on CPU copies, CUDA-event time, the plain version's on the card, the
    bound."""
    got = fn(xs)
    torch.cuda.synchronize()
    want = plain([x.cpu() for x in xs])
    require(all(same_bits(a.cpu(), b) for g_, w_ in zip(got, want) for a, b in zip(g_, w_)),
            "a per-process kernel case differs from its plain version")
    b_ms, b_by = bound_ms(n_bytes, n_ops, PEAK_OPS_PER_S[dtype])
    return {"shapes": sorted({str(list(x.shape)) for x in xs}), "pieces": len(xs),
            "ms": time_ms(lambda: fn(xs), iters=50), "plain_ms": time_ms(lambda: plain(xs),
                                                                          iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}


def per_process_kernels(dev, k3_shapes) -> dict:
    """The kernels of phases 30b and 20c at the shapes one process gives
    them: K2's split halves over a 20c process's 62 leaves [4, ...]; K1's
    split halves over the 2 x 4 grid's DCN round 1 (four [1, 2 s2] pieces
    at block 128) and its round 2 (the process's [4 s2 / 128, 128] rows);
    K3 at each hop shape ``k3_shapes`` lists."""
    from ps_pytorch_tpu_torch.ops import quantize as q
    from ps_pytorch_tpu_torch.ops.quantize import accumulate_rescale_int8 as k3
    from ps_pytorch_tpu_torch.ops.quantize import accumulate_rescale_plain

    f32 = torch.float32

    def split_out(got):
        return sum(a.numel() + 4 * b.numel() + 4 * c.numel() for a, b, c in got)

    out = {}
    xs = [x[:WORKERS // 2].contiguous() for x in resnet18_step_pieces(dev)]
    n_in = sum(x.numel() for x in xs)
    out["k2_split_20c"] = _timed_case(
        lambda ys: q.quantize_tensors_given(ys, q.tensors_absmax(ys)),
        lambda ys: q.quantize_tensors_given_plain(ys, q.tensors_absmax_plain(ys)), xs,
        4 * n_in + split_out(q.quantize_tensors_given(xs, q.tensors_absmax(xs))), 4.0 * n_in,
        f32)
    total = _resnet_total()
    s2 = _slice128(_slice128(total, 4), 2)
    g = torch.Generator(device=dev).manual_seed(31)
    xs = [torch.randn((1, 2 * s2), generator=g, device=dev) * 0.01 for _ in range(4)]
    n_in = sum(x.numel() for x in xs)
    out["k1_split_30b"] = _timed_case(
        lambda ys: q.quantize_rows_scaled_given(ys, 128, q.rows_scaled_absmax(ys, 128)),
        lambda ys: q.quantize_rows_scaled_given_plain(ys, 128, q.rows_scaled_absmax_plain(ys,
                                                                                          128)),
        xs, 4 * n_in + n_in + 8 * n_in // 128, 4.0 * n_in, f32)
    xs = [torch.randn((4 * s2 // 128, 128), generator=g, device=dev) * 0.01]
    n_in = xs[0].numel()
    out["k1_round2_30b"] = _timed_case(q.quantize_rows_many, q.quantize_rows_many_plain, xs,
                                       4 * n_in + n_in + 4 * n_in // 128, 4.0 * n_in, f32)
    for shape, d in k3_shapes:
        recv = torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)
        hop = "ici" if d == 4.0 else "dcn"
        rec = _timed_case(lambda ys: [(k3(ys[0], d),)],
                          lambda ys: [(accumulate_rescale_plain(ys[0], d),)], [recv],
                          recv.numel() + shape[1], float(recv.numel()), torch.int8)
        out[f"k3_{hop}_30b"] = dict(rec, divisor=d)
    print("phases 30b / 20c kernels at the per-process shapes, bit-exact vs plain: "
          + json.dumps(out))
    return out


def phase_grid_processes(card: str, root: str, hier=None) -> dict:
    """Phase 30b: the 2 x 4 grid over processes (cuDNN deterministic; the
    caller sets it). Each wire: the stacked grid's run and NCCL at world
    size 1 (both hosts in one process, the DCN axis over a one-rank
    group), ``model_step_3`` byte for byte; then two gloo processes, one
    host each, the same bytes; each process's launches as
    ``GRID_PROC_LAUNCHES``; the grid aggregate's K3 launches in each
    process bit for bit plain, the aggregate the stacked grid's; the
    per-process kernel times; step p50s and host-copy shares beside phase
    30's stacked p50 (``hier``, its record, when it ran)."""
    from ps_pytorch_tpu_torch import checkpoint as ckpt
    from ps_pytorch_tpu_torch.parallel.mesh import (
        HybridWorkerAxis,
        ProcessHybridAxis,
        make_hybrid_mesh,
    )

    t0 = time.perf_counter()
    steps = GRID_PROC_STEPS
    rec = {"card": card, "grid": [2, 4], "steps": steps}
    faults = []  # checked after the record is printed
    for wire, flags in GRID_PROC_WIRES.items():
        r = {"flags": " ".join(flags)}
        for kind in ("stacked", "nccl"):
            extra = ["--train-dir", os.path.join(root, f"grid_{kind}_{wire}"),
                     "--eval-freq", str(steps)]
            if kind == "nccl":
                extra += ["--coordinator-address", f"localhost:{_free_port()}",
                          "--num-processes", "1", "--process-id", "0"]
            reset_counts()
            reset_split_counts()
            out = _train(steps, flags + extra, checkpoints=True)
            torch.cuda.synchronize()
            counts = {**read_counts(), **read_split_counts()}
            losses = [h["loss"] for h in out["history"]]
            require(len(losses) == steps and all(np.isfinite(losses)),
                    f"phase 30b {wire} {kind}: losses {losses}")
            mesh = out["trainer"].mesh
            require(isinstance(mesh, ProcessHybridAxis if kind == "nccl" else HybridWorkerAxis),
                    f"phase 30b {wire} {kind}: axis {mesh!r}")
            if kind == "nccl" and counts != _wire_launches_want(GRID_PROC_LAUNCHES[wire], steps):
                faults.append(f"{wire} nccl: launches {counts}")
            r[kind] = {"losses": losses, "launches": counts,
                       "step_ms_p50": _step_p50(out["history"], warm=1) * 1e3}
            del out
        r["nccl_bit_exact_vs_stacked"] = _files_equal(
            ckpt.checkpoint_path(os.path.join(root, f"grid_stacked_{wire}"), steps),
            ckpt.checkpoint_path(os.path.join(root, f"grid_nccl_{wire}"), steps))
        r["model_step_sha256"] = _sha256_of(
            ckpt.checkpoint_path(os.path.join(root, f"grid_stacked_{wire}"), steps))
        if not r["nccl_bit_exact_vs_stacked"]:
            faults.append(f"{wire}: NCCL world size 1 model_step_{steps} differs from stacked")
        rec[wire] = r
    recs = _spawn_children("--phase30b-child", root, "phase 30b")
    for wire in GRID_PROC_WIRES:
        want = _wire_launches_want(GRID_PROC_LAUNCHES[wire], steps)
        for c in recs:
            if c[wire]["launches"] != want:
                faults.append(f"{wire} rank {c['rank']}: launches {c[wire]['launches']}, "
                              f"expected {want}")
            if not all(np.isfinite(c[wire]["losses"])):
                faults.append(f"{wire} rank {c['rank']}: losses {c[wire]['losses']}")
        same = _files_equal(
            ckpt.checkpoint_path(os.path.join(root, f"grid_stacked_{wire}"), steps),
            ckpt.checkpoint_path(os.path.join(root, f"grid_two_{wire}"), steps))
        if not same:
            faults.append(f"{wire}: the two processes' model_step_{steps} differs from stacked")
        rec[wire].update({
            "bit_exact_vs_stacked": same,
            "two_processes": {k: [c[wire][k] for c in recs]
                              for k in ("launches", "step_ms_p50", "host_copy_share",
                                        "losses")}})
        if hier is not None and "step_ms_p50" in hier.get(wire, {}):
            rec[wire]["phase30_stacked_step_ms_p50"] = hier[wire]["step_ms_p50"]
    stacked_sha = _grid_aggregate(make_hybrid_mesh(2, WORKERS // 2), _grid_grads("cuda"))
    shapes = []
    for c in recs:
        if c["aggregate_sha256"] != stacked_sha:
            faults.append(f"rank {c['rank']}: the grid aggregate differs from the stacked one")
        if [h["divisor"] for h in c["k3_hops"]] != [4.0, 2.0]:
            faults.append(f"rank {c['rank']}: K3 hops {c['k3_hops']}")
        shapes = [(tuple(h["shape"]), h["divisor"]) for h in c["k3_hops"]]
    rec["aggregate_bit_exact_vs_stacked"] = all(c["aggregate_sha256"] == stacked_sha
                                                for c in recs)
    rec["k3_hop_shapes"] = [list(sh) for sh, _ in shapes]
    rec["kernels"] = per_process_kernels(torch.device("cuda"), shapes)
    rec["seconds"] = time.perf_counter() - t0
    print("phase 30b the 2 x 4 grid over processes (NCCL world size 1, two gloo processes) "
          "vs stacked: " + json.dumps(rec))
    require(not faults, "phase 30b: " + "; ".join(faults))
    return rec


SYNCED_PROC_STEPS = 3


def _synced_local_run(axis, steps: int, dev):
    """Phase 20b's configuration (ResNet18 8 x 128, synced BN under
    ``bn_mode="local"``, the int8 wire, num-aggregate 5) for ``steps``
    steps over ``axis`` (stacked, or this process's workers), from the
    seeded distinct stats rows: ``(state, losses, step seconds)``."""
    from ps_pytorch_tpu_torch.data import make_preprocessor, make_synthetic
    from ps_pytorch_tpu_torch.models import build_model, init_model
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel.buckets import tree_map
    from ps_pytorch_tpu_torch.parallel.mesh import WORKER_AXIS
    from ps_pytorch_tpu_torch.parallel.ps import PSConfig, init_ps_state, make_ps_train_step

    model = build_model("ResNet18", bn_axis_name=WORKER_AXIS)
    cfg = PSConfig(num_workers=WORKERS, bn_mode="local", compress="int8", num_aggregate=5)
    params, bs = init_model(model, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(7)
    rows = tree_map(lambda s: axis.local(s.unsqueeze(0) + 0.5 * torch.rand(
        (WORKERS,) + tuple(s.shape), generator=g)).to(dev), bs)
    d = make_synthetic("Cifar10", train_size=WORKERS * PER_WORKER * steps, test_size=8, seed=11)
    tx = build_optimizer("sgd", 0.1, momentum=0.9)
    st = init_ps_state(model, tx, cfg, params=params, batch_stats=bs, device=dev, mesh=axis)
    st.batch_stats = rows
    step = make_ps_train_step(model, tx, cfg, axis, preprocess=make_preprocessor("Cifar10", True),
                              seed=0, device=dev)
    lo, nl = axis.first * PER_WORKER, axis.local_size * PER_WORKER
    losses, times = [], []
    for i in range(steps):
        at = i * WORKERS * PER_WORKER + lo
        t0 = time.perf_counter()
        st, m = step(st, {"image": d.train_images[at:at + nl],
                          "label": d.train_labels[at:at + nl]})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    return st, losses, times


def _synced_runs(root: str, run: str, tag: str, axis) -> dict:
    """Phase 20c's two runs over ``axis``: ``cli.train --bn-mode synced``
    (checkpoint ``model_step_3`` in ``root/synced_<run>``, which every
    process of a run names), then the synced-local library run (its flat
    params and stats rows saved as ``root/local_<tag>.pt``); launches,
    losses, step p50s and peaks."""
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves

    steps = SYNCED_PROC_STEPS
    rec = {}
    reset_counts()
    reset_split_counts()
    out, peak = _peak_of(lambda base: _train(steps, [
        "--bn-mode", "synced", "--train-dir", os.path.join(root, f"synced_{run}"),
        "--eval-freq", str(steps)], checkpoints=True))
    hist = out["history"]
    mesh = out["trainer"].mesh
    step_s = sum(h["time_cost"] for h in hist)
    copy_s = getattr(mesh, "host_copy_s", 0.0)
    rec["synced"] = {"losses": [h["loss"] for h in hist],
                     "launches": {**read_counts(), **read_split_counts()},
                     "step_ms_p50": _step_p50(hist, warm=1) * 1e3, "peak_bytes": int(peak),
                     "host_copy_share": copy_s / step_s}
    del out
    reset_counts()
    reset_split_counts()
    copy0 = getattr(axis, "host_copy_s", 0.0)
    (st, losses, times), peak = _peak_of(lambda base: _synced_local_run(axis, steps, "cuda"))
    rec["local"] = {"losses": losses, "launches": {**read_counts(), **read_split_counts()},
                    "step_ms_p50": float(np.median(times[1:])) * 1e3, "peak_bytes": int(peak),
                    "host_copy_share": (getattr(axis, "host_copy_s", 0.0) - copy0) / sum(times)}
    torch.save({"params": st.params.flat.cpu(),
                "stats": [t.cpu() for t in tree_leaves(st.batch_stats)]},
               os.path.join(root, f"local_{tag}.pt"))
    return rec


def phase20c_child(rank: int, port: int, root: str, out_path: str) -> int:
    """One of phase 20c's two processes on the card: a gloo group, 4 of
    the 8 workers, the synced CLI run and the synced-local run."""
    import torch.distributed as dist

    from ps_pytorch_tpu_torch.parallel.mesh import ProcessWorkerAxis

    torch.backends.cudnn.deterministic = True
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        rec = {"rank": rank, **_synced_runs(root, "two", f"two{rank}", ProcessWorkerAxis(WORKERS))}
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(rec, f)
    return 0


def phase_synced_processes(card: str, root: str, synced_local=None) -> dict:
    """Phase 20c: synced BN over two gloo processes of 4 workers on the
    card (cuDNN deterministic; the caller sets it), against the stacked
    runs of the same seed: the synced CLI run's ``model_step_3`` and the
    synced-local run's params and stats rows; finite losses; each
    process's K2 split halves once a step and no fused K2; step p50s,
    host-copy shares and peaks beside the stacked runs' and phase 20b's
    (``synced_local``, its record, when it ran)."""
    from ps_pytorch_tpu_torch import checkpoint as ckpt
    from ps_pytorch_tpu_torch.parallel.mesh import WorkerAxis

    t0 = time.perf_counter()
    steps = SYNCED_PROC_STEPS
    stacked = _synced_runs(root, "stacked", "stacked", WorkerAxis(WORKERS))
    recs = _spawn_children("--phase20c-child", root, "phase 20c")
    want = _wire_launches_want({"tensors_absmax": 1, "quantize_tensors_given": 1}, steps)
    rec = {"card": card, "steps": steps, "workers_per_process": WORKERS // 2,
           "stacked": stacked, "two_processes": recs}
    for run in ("synced", "local"):
        require(stacked[run]["launches"]["quantize_tensors"] == steps,
                f"phase 20c stacked {run}: launches {stacked[run]['launches']}")
        for c in recs:
            require(all(np.isfinite(c[run]["losses"])), f"phase 20c {run}: losses")
            require(c[run]["launches"] == want,
                    f"phase 20c {run} rank {c['rank']}: launches {c[run]['launches']}")
    cmp = {}
    a = ckpt.checkpoint_path(os.path.join(root, "synced_stacked"), steps)
    b = ckpt.checkpoint_path(os.path.join(root, "synced_two"), steps)
    ra, rb = ckpt.load_checkpoint_raw(os.path.dirname(a), steps), ckpt.load_checkpoint_raw(
        os.path.dirname(b), steps)
    pa = np.concatenate([np.asarray(v).reshape(-1) for v in _raw_leaves(ra["params"])])
    pb = np.concatenate([np.asarray(v).reshape(-1) for v in _raw_leaves(rb["params"])])
    cmp["synced"] = {"file_bit_exact": _files_equal(a, b),
                     "max_abs_param_diff": float(np.abs(pa - pb).max())}
    sl = torch.load(os.path.join(root, "local_stacked.pt"))
    diffs, stats_exact = [], True
    for r in range(2):
        tl = torch.load(os.path.join(root, f"local_two{r}.pt"))
        diffs.append(float((tl["params"] - sl["params"]).abs().max()))
        rows = slice(r * WORKERS // 2, (r + 1) * WORKERS // 2)
        stats_exact = stats_exact and all(same_bits(t, s[rows])
                                          for t, s in zip(tl["stats"], sl["stats"]))
    cmp["local"] = {"max_abs_param_diff": max(diffs), "stats_rows_bit_exact": stats_exact}
    rec["vs_stacked"] = cmp
    if synced_local is not None:
        rec["phase20b_peak_bytes"] = synced_local["peak_bytes"]
    rec["seconds"] = time.perf_counter() - t0
    print("phase 20c synced BN over two gloo processes vs stacked, ResNet18 8 x 128: "
          + json.dumps(rec))
    require(cmp["synced"]["file_bit_exact"] and cmp["local"]["max_abs_param_diff"] == 0.0
            and stats_exact, f"phase 20c: the processes' params differ from stacked: {cmp}")
    return rec


def _raw_leaves(tree):
    """A raw checkpoint tree's array leaves, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _raw_leaves(tree[k])
    elif tree is not None:
        yield tree



# ------------------------- phases 31-34: --config-json, the profiler, tp / dp_tp / pp

AUTOTUNE_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                               "autotune_resnet18.json")
CONFIG_JSON_STEPS = 3


def phase_config_json(card: str) -> dict:
    """Phase 31: ``cli.train --config-json runs/autotune_resnet18.json``
    (the record's best candidate sets the network, dataset and wire; the
    rest is phase 12's geometry) for 3 steps with ``--profile-dir`` and
    ``--trace``: the launches ``expected_launches`` implies for the
    expanded flags (one K2 and one K3 a step, as phase 12's autotune-best
    run), a Chrome trace that names K3's kernel and the tracer's spans,
    and the capture's one-time host seconds."""
    import tempfile

    from ps_pytorch_tpu_torch.cli import train as cli_train
    from ps_pytorch_tpu_torch.cli._flags import expand_config_json, ps_config_from
    from ps_pytorch_tpu_torch.models import build_model, init_model

    require(os.path.exists(AUTOTUNE_RECORD), f"config-json: no {AUTOTUNE_RECORD}")
    owned = {"--network", "--dataset", "--compress-grad"}  # set by the record
    base = [x for i in range(0, len(TRAIN_ARGS), 2) if TRAIN_ARGS[i] not in owned
            for x in TRAIN_ARGS[i:i + 2]]
    steps = CONFIG_JSON_STEPS
    with tempfile.TemporaryDirectory() as root:
        argv = base + ["--max-steps", str(steps), "--no-checkpoints", "--config-json",
                       AUTOTUNE_RECORD, "--profile-dir", os.path.join(root, "prof"),
                       "--trace", os.path.join(root, "trace")]
        parser = cli_train.build_parser()
        cfg = ps_config_from(parser.parse_args(expand_config_json(parser, list(argv))),
                             WORKERS)
        resnet, _ = init_model(build_model("ResNet18"), torch.Generator().manual_seed(0),
                               device="cpu")
        want = {k: v * steps for k, v in expected_launches(cfg, resnet).items()}
        reset_counts()
        res = cli_train.main(argv)
        torch.cuda.synchronize()
        got = read_counts()
        losses = [h["loss"] for h in res["history"]]
        require(len(losses) == steps and all(np.isfinite(v) for v in losses),
                f"config-json: losses {losses}")
        require(got == want, f"config-json: launches {got}, expected {want}")
        require(got["accumulate_rescale_int8"] == steps and got["quantize_tensors"] == steps,
                f"config-json: not one K3 and one K2 call a step: {got}")
        pw = res["trainer"].profile_window
        require(pw.trace_path is not None and os.path.exists(pw.trace_path),
                "config-json: no profiler trace written")
        with open(pw.trace_path) as f:
            events = json.load(f)["traceEvents"]
        k3 = [e for e in events if "accum_rescale" in e.get("name", "")
              and e.get("cat") == "kernel"]
        names = {e.get("name") for e in events}
        spans = sorted({"fetch", "dispatch", "h2d"} & names)
        require(len(k3) >= 1, "config-json: the trace names no K3 kernel")
        require(spans == ["dispatch", "fetch", "h2d"], f"config-json: spans {spans}")
        rec = {"card": card, "flags": " ".join(base) + f" --max-steps {steps} --config-json "
               "runs/autotune_resnet18.json --profile-dir DIR --trace DIR",
               "record_best": cfg.compress + " " + cfg.wire_domain,
               "launches": got, "losses": losses,
               "step_ms": [h["time_cost"] * 1e3 for h in res["history"]],
               "window": [pw.start, pw.stop], "capture_host_s": pw.host_s,
               "trace_bytes": os.path.getsize(pw.trace_path), "trace_events": len(events),
               "k3_kernel_events": len(k3), "k3_kernel": k3[0]["name"], "spans": spans}
    print("phase 31 cli.train --config-json autotune record, --profile-dir: "
          + json.dumps(rec))
    return rec


LM_SCHEME_STEPS = 8
# (name, flags, attention calls a step: depth for tp and dp_tp, (M + S - 1)
# depth / S for pp)
LM_SCHEMES = [
    ("tp", ["--parallelism", "tp", "--num-shards", "4", "--shard-vocab"], LM_DEPTH),
    ("dp_tp", ["--parallelism", "dp_tp", "--num-dp", "2", "--num-shards", "4"], LM_DEPTH),
    ("pp", ["--parallelism", "pp", "--num-shards", "2", "--num-microbatches", "4"],
     (4 + 2 - 1) * LM_DEPTH // 2),
]


def phase_lm_schemes(card: str, lm1=None) -> dict:
    """Phase 32: LM-1's model (LM_ARGS, bf16, remat, flash) under ``tp 4
    --shard-vocab``, ``dp_tp 2 x 4`` and ``pp 2 x 4 microbatches``, 8 steps
    each through ``cli.train_lm.main``: finite losses, the last below the
    first, K4 (normalized) 2 x calls, K5 and K6 calls a step (remat runs
    the forward twice); the step p50 beside phase 15's dp_sp one (``lm1``).
    Then ``cli.evaluate_lm --once`` on the tp run's checkpoint."""
    import tempfile

    from ps_pytorch_tpu_torch.cli import evaluate_lm, train_lm

    steps, batch, seq = LM_SCHEME_STEPS, 8, 1024
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for name, flags, calls in LM_SCHEMES:
            extra = ["--train-dir", root] if name == "tp" else []
            reset_flash_counts()
            res = train_lm.main(LM_ARGS + ["--dtype", "bfloat16", "--seq-len", str(seq),
                                           "--batch-size", str(batch), "--max-steps",
                                           str(steps), *flags, *extra])
            torch.cuda.synchronize()
            got = read_flash_counts()
            want = {"flash_fwd": 2 * calls * steps, "flash_partial": 0,
                    "flash_bwd_dq": calls * steps, "flash_bwd_dkv": calls * steps}
            losses = [h_["loss"] for h_ in res["history"]]
            require(len(losses) == steps and all(np.isfinite(v) for v in losses),
                    f"LM {name}: losses {losses}")
            require(losses[-1] < losses[0], f"LM {name}: loss did not fall: {losses}")
            require(got == want, f"LM {name}: launches {got}, expected {want}")
            times = [h_["time_cost"] for h_ in res["history"][2:]]
            p50 = float(np.median(times))
            out[name] = {
                "card": card, "layout": res["layout"], "flags": " ".join(flags),
                "steps": steps, "launches": got, "attention_calls_per_step": calls,
                "losses": losses, "step_ms_p50": p50 * 1e3, "step_ms_min": min(times) * 1e3,
                "step_ms_max": max(times) * 1e3, "tokens_per_s": batch * seq / p50,
                "dp_sp_step_ms_p50": lm1["step_ms_p50"] if lm1 else None,
                "params": res["params"]}
            print(f"phase 32 LM-1 {name}: " + json.dumps(out[name]), flush=True)
        t0 = time.perf_counter()
        ev = evaluate_lm.main(["--device", "cuda", "--model-dir", root, "--once"])
        ev_s = time.perf_counter() - t0
    (r,) = ev.values()
    require(r["step"] == steps and np.isfinite(r["perplexity"]),
            f"evaluate_lm on the tp checkpoint: {r}")
    out["evaluate_lm"] = {"step": r["step"], "loss": r["loss"],
                          "perplexity": r["perplexity"], "seconds": ev_s}
    print("phase 32 cli.evaluate_lm --once on the tp checkpoint: "
          + json.dumps(out["evaluate_lm"]))
    return out


def phase_lm_schemes_held(dev) -> dict:
    """Phase 33: one f32 step (TF32 off) of tp 4 (vocab-parallel) and of
    pp 2 x 2 microbatches at depth 2, flash, remat: the card (kernels)
    against the CPU (plain versions) from the same params and tokens,
    under phase 17's rule (loss rtol 1e-5; params rtol 2e-4 / atol 2e-5),
    each with its launch counts."""
    from ps_pytorch_tpu_torch import on_device
    from ps_pytorch_tpu_torch.cli.train_lm import make_synthetic_tokens
    from ps_pytorch_tpu_torch.models import TransformerConfig, init_transformer
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel import pp, tp
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves

    depth = 2
    cfg = TransformerConfig(vocab_size=256, dim=256, depth=depth, heads=4, max_seq_len=256,
                            attention_impl="flash", remat=True)
    plain = init_transformer(cfg, torch.Generator().manual_seed(9), device="cpu")
    tokens = torch.from_numpy(make_synthetic_tokens(256, 4, 256, seed=3))
    n, (s, m) = 4, (2, 2)
    cases = {
        "tp": (tp.shard_params_tp(cfg, tp.to_tp_layout(cfg, plain), tp.make_tp_mesh(n), True),
               lambda tx: tp.make_tp_train_step(cfg, tx, tp.make_tp_mesh(n), True), depth),
        "pp": (pp.to_pp_layout(cfg, plain),
               lambda tx: pp.make_pp_train_step(cfg, tx, pp.make_pp_mesh(s), m),
               (m + s - 1) * depth // s),
    }
    out = {}
    for name, (params, make_step, calls) in cases.items():
        res = {}
        for d in ("cpu", dev):
            tx = build_optimizer("sgd", 0.1, momentum=0.9)
            p = on_device(params, torch.device(d))
            reset_flash_counts()
            p2, _, loss = make_step(tx)(p, tx.init(p), tokens.to(d))
            leaves = [x.detach().cpu() for x in tree_leaves(p2)]
            res[torch.device(d).type] = (leaves, float(loss), read_flash_counts())
        (pc, lc, _), (pg, lg, counts) = res["cpu"], res[torch.device(dev).type]
        require(abs(lg - lc) <= 1e-5 * abs(lc), f"held LM {name}: loss {lg} vs CPU {lc}")
        worst = 0.0
        for a, b in zip(pg, pc):
            excess = (a - b).abs() - (2e-5 + 2e-4 * b.abs())
            worst = max(worst, float((a - b).abs().max()))
            require(bool((excess <= 0).all()), f"held LM {name}: params off by {worst}")
        want = {"flash_fwd": 2 * calls, "flash_partial": 0, "flash_bwd_dq": calls,
                "flash_bwd_dkv": calls}
        require(counts == want, f"held LM {name}: launches {counts}, expected {want}")
        out[name] = {"loss_cpu": lc, "loss_cuda": lg, "max_abs_param_diff": worst,
                     "launches": counts}
    print("phase 33 LM tp 4 / pp 2 step held on the card vs CPU: " + json.dumps(out))
    return out


def phase_flash_shard_kernels(dev) -> dict:
    """Phase 34: K4 (normalized), K5 and K6 (input-dtype gradients, as
    ``flash_attention``'s backward runs them) against their plain versions
    at the shapes phase 32 gives them: a tp 4 shard's heads folded into
    the batch, [8 x 4, 1024, 2, 64], and a pp tick's two stages' rows,
    [2 x 2, 1024, 8, 64] (also pp_moe's tick in phase 35), as head splits
    of one fused projection, causal, bf16 and f32, and phase 35's dp_tp_pp
    tick (2 stages x 2 tp shards x 2 dp rows of 4 heads, [8, 1024, 4, 64])
    in bf16; each twice (the same bits), timed beside the bound and aten's
    attention (``_aten_yardsticks``). Then phase 35's ep_sp 2 x 2 ring:
    K4-partial, K5 and K6 with the f32 gradients the ring takes
    (``_partial_case``) at both hops' offsets. It runs beside phase 14:
    after phase 24 a whole run's short profiler traces often come back
    without their kernel records (PERF.md section 7)."""
    from ps_pytorch_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_plain,
        flash_fwd,
        flash_fwd_plain,
    )

    cases = [("tp_bf16", 32, 2, torch.bfloat16), ("pp_bf16", 4, 8, torch.bfloat16),
             ("dp_tp_pp_bf16", 8, 4, torch.bfloat16),
             ("tp_f32", 32, 2, torch.float32), ("pp_f32", 4, 8, torch.float32)]
    t, d = 1024, 64
    scale = d ** -0.5
    g = torch.Generator(device=dev).manual_seed(34)
    out = {}
    for name, b, h, dt in cases:
        qkv = torch.randn((b, t, 3, h, d), generator=g, device=dev).to(dt)
        q, k, v = qkv.unbind(2)  # the blocks' layout: strided head splits
        do = torch.randn((b, t, h, d), generator=g, device=dev).to(dt)
        o, lse = flash_fwd(q, k, v, causal=True)
        o2, lse2 = flash_fwd(q, k, v, causal=True)
        op, lsep = flash_fwd_plain(q, k, v, True, scale)
        delta = (do.float() * op.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, lsep, delta, True, scale)
        dq, (dk, dv) = flash_bwd_dq(*bwd), flash_bwd_dkv(*bwd)
        dq2, (dk2, dv2) = flash_bwd_dq(*bwd), flash_bwd_dkv(*bwd)
        want = flash_bwd_plain(*bwd)
        torch.cuda.synchronize()
        require(torch.equal(o, o2) and torch.equal(lse, lse2)
                and torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2),
                f"{name}: a kernel changed between two runs")
        bf16 = dt == torch.bfloat16
        err = (o.float() - op.float()).abs()
        lim = (2e-2 + 1e-2 * op.float().abs()) if bf16 else torch.full_like(err, 1e-5)
        require(bool((err <= lim).all()), f"{name}: K4 o off by {float(err.max())}")
        lse_err = float((lse - lsep).abs().max())
        require(lse_err <= (1e-4 if bf16 else 1e-5), f"{name}: K4 lse off by {lse_err}")
        errs = {"o": float(err.max()), "lse": lse_err}
        for key, got, ref in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
            errs[key] = _near(f"{name} {key}", got, ref, 1e-2 if bf16 else 5e-5)[0]
        pairs = kept_pairs(b, h, t, t, True, 0, 0)
        elt, act, stat = q.element_size(), b * t * h * d, b * h * t * 4
        rate = TF32X3_OPS_PER_S if dt == torch.float32 else PEAK_OPS_PER_S[dt]
        bounds = {"fwd": bound_ms(4 * act * elt + stat, 4.0 * d * pairs, rate),
                  "dq": bound_ms(5 * act * elt + 2 * stat, 6.0 * d * pairs, rate),
                  "dkv": bound_ms(6 * act * elt + 2 * stat, 8.0 * d * pairs, rate)}
        iters, plain_iters = (50, 10) if not bf16 else (ITERS, 20)
        fwd = lambda: flash_fwd(q, k, v, causal=True)
        rec = {"shape": [b, t, h, d], "dtype": str(dt).replace("torch.", ""),
               "max_abs_err": errs}
        dev_ms, kernels = _device_route(f"{name} K4", fwd, dt)
        rec["fwd"] = {"ms": time_ms(fwd, iters), "device_ms": dev_ms, "device_kernels": kernels,
                      "plain_ms": time_ms(lambda: flash_fwd_plain(q, k, v, True, scale),
                                          iters=plain_iters),
                      "bound_ms": bounds["fwd"][0], "bound_by": bounds["fwd"][1]}
        plain_bwd_ms = time_ms(lambda: flash_bwd_plain(*bwd), iters=plain_iters)
        for part, family, fn in (("dq", "flash_dq", lambda: flash_bwd_dq(*bwd)),
                                 ("dkv", "flash_dkv", lambda: flash_bwd_dkv(*bwd))):
            dev_ms, kernels = _device_route(f"{name} {part}", fn, dt, family)
            rec[part] = {"ms": time_ms(fn, iters), "device_ms": dev_ms,
                         "device_kernels": kernels, "plain_ms": plain_bwd_ms,
                         "bound_ms": bounds[part][0], "bound_by": bounds[part][1]}
        lib = _aten_yardsticks(q, k, v, do, scale, True, iters)
        rec["fwd"]["library_ms"] = lib["fwd_ms"]
        rec["fwd"]["library_device_ms"] = lib["fwd_device_ms"]
        for part in ("dq", "dkv"):
            rec[part]["library_ms"] = lib["bwd_ms"]
            rec[part]["library_device_ms"] = lib["bwd_device_ms"]
        out[name] = rec
        print(f"phase 34 {name}: " + json.dumps(rec), flush=True)
    # phase 35's ep_sp ring: batch 8 over 2 expert shards and 1024 tokens
    # over 2 sequence shards, so a hop is one call over [2 x 8, 512, 8, 64],
    # rows shard-major; hop 0 meets the shard's own block (the diagonal),
    # hop 1 block (i + 1) % 2, all in shard 0's future and all in shard 1's
    # past (aten there: shard 1's rows, every key kept)
    n_sp, rows, t_loc = 2, 8, 512
    me = torch.arange(n_sp, device=dev)
    q_off = (me * t_loc).repeat_interleave(rows)
    for shift in range(n_sp):
        name = f"ep_sp_ring_hop{shift}_bf16"
        k_off = (((me + shift) % n_sp) * t_loc).repeat_interleave(rows)
        out[name] = rec = _partial_case(
            name, n_sp * rows, t_loc, 8, torch.bfloat16, q_off, k_off, g,
            slice(None) if shift == 0 else slice(rows, None), shift == 0)
        print(f"phase 34 {name}: " + json.dumps(rec), flush=True)
    return out


# ------------------------- phases 35-36: the MoE schemes and the 3-D grid

# (name, flags or None for the dp_tp_pp library run, launches a step of
# flash_fwd (K4 normalized), flash_partial (K4's partial triple), flash_bwd_dq
# (K5), flash_bwd_dkv (K6)): with remat the forward runs twice
#   moe: one attention call a block over every shard's rows: 2 L, 0, L, L;
#   ep_sp: the ring over n_sp = 2, one call a hop a block: 0, 2 L n_sp, L n_sp,
#     L n_sp;
#   pp_moe and dp_tp_pp: every stage's (and column's) block in one call a tick,
#     (M + S - 1) L / S = (4 + 2 - 1) 6 / 2 = 15 calls: 30, 0, 15, 15
_TICKS = (4 + 2 - 1) * LM_DEPTH // 2
MOE_SCHEMES = [
    ("moe_top1", ["--parallelism", "moe", "--num-shards", "4"],
     (2 * LM_DEPTH, 0, LM_DEPTH, LM_DEPTH)),
    ("moe_top2", ["--parallelism", "moe", "--num-shards", "4", "--top-k", "2"],
     (2 * LM_DEPTH, 0, LM_DEPTH, LM_DEPTH)),
    ("ep_sp", ["--parallelism", "ep_sp", "--num-shards", "2", "--num-sp", "2"],
     (0, 2 * LM_DEPTH * 2, LM_DEPTH * 2, LM_DEPTH * 2)),
    ("pp_moe", ["--parallelism", "pp_moe", "--num-shards", "2", "--num-ep", "2",
                "--num-microbatches", "4"], (2 * _TICKS, 0, _TICKS, _TICKS)),
    ("dp_tp_pp", None, (2 * _TICKS, 0, _TICKS, _TICKS)),
]
MOE_ARGS = ["--num-experts", "8", "--capacity-factor", "1.25"]


def _launches_want(per_step: tuple, steps: int) -> dict:
    return dict(zip(("flash_fwd", "flash_partial", "flash_bwd_dq", "flash_bwd_dkv"),
                    (c * steps for c in per_step)))


def _dp_tp_pp_run(steps: int, batch: int, seq: int) -> dict:
    """LM-1's model (bf16, remat, flash) on the dp_tp_pp library at 2 x 2 x
    2 with 4 microbatches a dp column, timed as ``cli.train_lm`` times a
    logged step (a host read before and after), on its corpus and SGD."""
    from ps_pytorch_tpu_torch.cli.train_lm import make_synthetic_tokens
    from ps_pytorch_tpu_torch.models import TransformerConfig
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel import dp_tp_pp
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves

    cfg = TransformerConfig(vocab_size=2048, dim=512, depth=LM_DEPTH, heads=8,
                            max_seq_len=seq, remat=True, attention_impl="flash",
                            compute_dtype=torch.bfloat16)
    mesh = dp_tp_pp.make_mesh_3d(2, 2, 2)
    tx = build_optimizer("sgd", 0.01, momentum=0.9)
    params, opt = dp_tp_pp.init_3d_state(cfg, tx, torch.Generator().manual_seed(1), mesh,
                                         device="cuda")
    step = dp_tp_pp.make_3d_train_step(cfg, tx, mesh, num_microbatches=4)
    corpus = make_synthetic_tokens(2048, 512, seq, seed=2)
    rng = np.random.RandomState(3)
    hist = []
    for _ in range(steps):
        tok = torch.from_numpy(corpus[rng.randint(0, len(corpus), batch)]).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, dp_tp_pp.shard_tokens_3d(tok, mesh))
        loss = float(loss)
        torch.cuda.synchronize()
        hist.append({"loss": loss, "time_cost": time.perf_counter() - t0})
    return {"history": hist, "layout": "dp 2 x pp 2 x tp 2 (4 microbatches)",
            "params": sum(int(x.numel()) for x in tree_leaves(params))}


def phase_moe_schemes(card: str, lm1=None) -> dict:
    """Phase 35: LM-1's model (LM_ARGS: bf16, remat, flash, seq 1024, batch
    8) with 8 experts at capacity factor 1.25, 8 steps each, through
    ``cli.train_lm.main`` under ``moe --num-shards 4`` (top-1 and
    ``--top-k 2``), ``ep_sp 2 x 2`` (the flash ring) and ``pp_moe 2 x 2 x 4
    microbatches``, and the dp_tp_pp library at 2 x 2 x 2 (4
    microbatches): finite losses, the last below the first, a finite
    ``aux_loss`` in every MoE record, the flash launches of MOE_SCHEMES a
    step exactly; the step p50 beside phase 15's dp_sp p50 (``lm1``) and
    each run's peak device memory above its start. Then ``cli.evaluate_lm
    --once --generate 8`` on the top-1 moe run's checkpoint: a finite
    perplexity."""
    import tempfile

    from ps_pytorch_tpu_torch.cli import evaluate_lm, train_lm

    steps, batch, seq = LM_SCHEME_STEPS, 8, 1024
    out = {}
    with tempfile.TemporaryDirectory() as root:
        for name, flags, per_step in MOE_SCHEMES:
            extra = ["--train-dir", root] if name == "moe_top1" else []
            reset_flash_counts()
            if flags is None:
                res, peak = _peak_of(lambda base: _dp_tp_pp_run(steps, batch, seq))
            else:
                res, peak = _peak_of(lambda base: train_lm.main(
                    LM_ARGS + MOE_ARGS + ["--dtype", "bfloat16", "--seq-len", str(seq),
                                          "--batch-size", str(batch), "--max-steps",
                                          str(steps), *flags, *extra]))
            torch.cuda.synchronize()
            got, want = read_flash_counts(), _launches_want(per_step, steps)
            hist = res["history"]
            losses = [h_["loss"] for h_ in hist]
            require(len(losses) == steps and all(np.isfinite(v) for v in losses),
                    f"LM {name}: losses {losses}")
            require(losses[-1] < losses[0], f"LM {name}: loss did not fall: {losses}")
            require(got == want, f"LM {name}: launches {got}, expected {want}")
            auxes = [h_.get("aux_loss") for h_ in hist]
            if flags is not None:
                require(all(a is not None and np.isfinite(a) for a in auxes),
                        f"LM {name}: aux_loss {auxes}")
            times = [h_["time_cost"] for h_ in hist[2:]]
            p50 = float(np.median(times))
            out[name] = {
                "card": card, "layout": res["layout"],
                "flags": " ".join(flags) if flags else "library dp_tp_pp.make_3d_train_step",
                "steps": steps, "launches": got, "launches_per_step": dict(zip(want, per_step)),
                "losses": losses, "aux_loss": auxes if flags else None,
                "step_ms_p50": p50 * 1e3, "step_ms_min": min(times) * 1e3,
                "step_ms_max": max(times) * 1e3, "tokens_per_s": batch * seq / p50,
                "dp_sp_step_ms_p50": lm1["step_ms_p50"] if lm1 else None,
                "peak_bytes": peak, "params": res["params"]}
            print(f"phase 35 LM-1 {name}: " + json.dumps(out[name]), flush=True)
        t0 = time.perf_counter()
        ev = evaluate_lm.main(["--device", "cuda", "--model-dir", root, "--once",
                               "--generate", "8"])
        ev_s = time.perf_counter() - t0
    (r,) = ev.values()
    require(r["step"] == steps and np.isfinite(r["perplexity"]),
            f"evaluate_lm on the moe checkpoint: {r}")
    require(np.asarray(r["samples"]).shape == (2, 16), f"evaluate_lm samples: {r}")
    out["evaluate_lm"] = {"step": r["step"], "loss": r["loss"],
                          "perplexity": r["perplexity"], "seconds": ev_s}
    print("phase 35 cli.evaluate_lm --once --generate 8 on the moe checkpoint: "
          + json.dumps(out["evaluate_lm"]))
    return out


def _record_dispatch(log: list):
    """Wrap the MoE gate: each call's dispatch tensor (the expert choices
    and slots) and, on the CPU, its inputs go to ``log``. Returns the undo."""
    from ps_pytorch_tpu_torch.parallel import moe

    orig = moe._gate_and_dispatch

    def rec(x2d, wg, capacity, top_k=1):
        out = orig(x2d, wg, capacity, top_k)
        log.append((out[0].detach().cpu(), x2d.detach().cpu(), wg.detach().cpu(), top_k))
        return out

    moe._gate_and_dispatch = rec
    return lambda: setattr(moe, "_gate_and_dispatch", orig)


def _smallest_margins(log: list) -> tuple:
    """The smallest top-1 / top-2 (and top-2 / top-3 for top-2 routing)
    probability gaps over the recorded gate inputs (f64), rows with an
    exact tie left out."""
    m1 = m2 = float("inf")
    for _, x2d, wg, top_k in log:
        p = torch.softmax(x2d.double() @ wg.double(), dim=-1).sort(-1, descending=True)[0]
        g1, g2 = p[..., 0] - p[..., 1], p[..., 1] - p[..., 2]
        if (g1 > 0).any():
            m1 = min(m1, float(g1[g1 > 0].min()))
        if top_k == 2 and (g2 > 0).any():
            m2 = min(m2, float(g2[g2 > 0].min()))
    return m1, m2


def phase_moe_schemes_held(dev) -> dict:
    """Phase 36: one f32 step (TF32 off) at depth 2 (flash, remat) of moe 4
    shards top-2 at capacity factor 1.0 (tokens drop), ep_sp 2 x 2 (the
    flash ring), pp_moe 2 x 2 x 2 microbatches and dp_tp_pp 2 x 2 x 2 (2
    microbatches): the card (kernels) against the CPU (plain versions)
    from the same params and tokens, under phase 33's rule (loss rtol
    1e-5; params rtol 2e-4 / atol 2e-5); every gate call's dispatch (the
    expert choices) equal, and the launch counts exact."""
    from ps_pytorch_tpu_torch import on_device
    from ps_pytorch_tpu_torch.cli.train_lm import make_synthetic_tokens
    from ps_pytorch_tpu_torch.models import TransformerConfig, init_transformer
    from ps_pytorch_tpu_torch.optim import build_optimizer
    from ps_pytorch_tpu_torch.parallel import dp_tp_pp, ep_sp, moe, pp, pp_moe
    from ps_pytorch_tpu_torch.parallel.buckets import tree_leaves

    depth = 2
    cfg = TransformerConfig(vocab_size=256, dim=256, depth=depth, heads=4, max_seq_len=256,
                            attention_impl="flash", remat=True)
    tokens = torch.from_numpy(make_synthetic_tokens(256, 4, 256, seed=3))
    top2 = moe.MoEConfig(num_experts=8, capacity_factor=1.0, top_k=2)
    mcfg = moe.MoEConfig(num_experts=8)
    plain = moe.init_moe_params(cfg, mcfg, torch.Generator().manual_seed(9), device="cpu")
    dense = init_transformer(cfg, torch.Generator().manual_seed(9), device="cpu")
    m_ep, m_es = moe.make_ep_mesh(4), ep_sp.make_mesh_ep_sp(2, 2)
    m_pm, m_3d = pp_moe.make_mesh_pp_moe(2, 2), dp_tp_pp.make_mesh_3d(2, 2, 2)
    ticks = (2 + 2 - 1) * depth // 2
    # name: (params, step(tx), shard(tokens), flash launches of the step)
    cases = {
        "moe_top2_drops": (moe.shard_params_moe(cfg, plain, m_ep),
                           lambda tx: moe.make_moe_train_step(cfg, top2, tx, m_ep),
                           lambda t: moe.shard_moe_batch(t, m_ep),
                           (2 * depth, 0, depth, depth)),
        "ep_sp": (moe.shard_params_moe(cfg, plain, m_es.ep),
                  lambda tx: ep_sp.make_ep_sp_train_step(cfg, mcfg, tx, m_es),
                  lambda t: ep_sp.shard_tokens_ep_sp(t, m_es),
                  (0, 2 * depth * 2, depth * 2, depth * 2)),
        "pp_moe": (pp_moe.shard_params_pp_moe(cfg, pp.to_pp_layout(cfg, plain), m_pm),
                   lambda tx: pp_moe.make_pp_moe_train_step(cfg, mcfg, tx, m_pm, 2),
                   lambda t: pp_moe.shard_tokens_pp_moe(t, m_pm),
                   (2 * ticks, 0, ticks, ticks)),
        "dp_tp_pp": (dp_tp_pp.shard_params_3d(cfg, dp_tp_pp.to_3d_layout(cfg, dense), m_3d),
                     lambda tx: dp_tp_pp.make_3d_train_step(cfg, tx, m_3d, 2),
                     lambda t: dp_tp_pp.shard_tokens_3d(t, m_3d),
                     (2 * ticks, 0, ticks, ticks)),
    }
    out = {}
    for name, (params, make_step, shard, per_step) in cases.items():
        res = {}
        for d in ("cpu", dev):
            tx = build_optimizer("sgd", 0.1, momentum=0.9)
            p = on_device(params, torch.device(d))
            log = []
            undo = _record_dispatch(log)
            try:
                reset_flash_counts()
                p2, _, loss, *aux = make_step(tx)(p, tx.init(p), shard(tokens.to(d)))
            finally:
                undo()
            leaves = [x.detach().cpu() for x in tree_leaves(p2)]
            res[torch.device(d).type] = (leaves, float(loss), read_flash_counts(), log,
                                         [float(a) for a in aux])
        (pc, lc, _, logc, auxc), (pg, lg, counts, logg, auxg) = (
            res["cpu"], res[torch.device(dev).type])
        m1, m2 = _smallest_margins(logc)
        require(len(logc) == len(logg) and all(torch.equal(a[0], b[0])
                                               for a, b in zip(logc, logg)),
                f"held LM {name}: the card's expert choices differ from the CPU's "
                f"(smallest top-1 margin {m1}, top-2 {m2})")
        require(abs(lg - lc) <= 1e-5 * abs(lc), f"held LM {name}: loss {lg} vs CPU {lc}")
        for a, b in zip(auxg, auxc):
            require(abs(a - b) <= 1e-5 * abs(b), f"held LM {name}: aux {a} vs CPU {b}")
        worst = 0.0
        for a, b in zip(pg, pc):
            excess = (a - b).abs() - (2e-5 + 2e-4 * b.abs())
            worst = max(worst, float((a - b).abs().max()))
            require(bool((excess <= 0).all()), f"held LM {name}: params off by {worst}")
        want = _launches_want(per_step, 1)
        require(counts == want, f"held LM {name}: launches {counts}, expected {want}")
        out[name] = {"loss_cpu": lc, "loss_cuda": lg, "aux_cpu": auxc, "aux_cuda": auxg,
                     "max_abs_param_diff": worst, "launches": counts,
                     "gate_calls": len(logc),
                     "smallest_top1_margin": m1 if m1 != float("inf") else None,
                     "smallest_top2_margin": m2 if m2 != float("inf") else None}
    print("phase 36 MoE schemes and dp_tp_pp step held on the card vs CPU: "
          + json.dumps(out))
    return out


# phase 37: bench.py's serve model (_DEC_DEFAULTS, bench.py:120-125) as
# cli.train_lm writes it, and the serving CLI's traffic (phase 5's shapes)
SERVE_LM_ARGS = ["--vocab-size", "2048", "--dim", "512", "--depth", "6", "--heads", "8",
                 "--seq-len", "256", "--batch-size", "8", "--dtype", "bfloat16",
                 "--max-steps", "4", "--eval-freq", "2", "--log-interval", "1",
                 "--device", "cuda"]
SERVE_CLI_ARGS = ["--int8-kv", "--dtype", "bfloat16", "--slots", "8", "--requests", "32",
                  "--rate", "100", "--prompt-min", "64", "--prompt-max", "128",
                  "--new-min", "64", "--new-max", "128", "--device", "cuda"]


def _serve_cli_run(name: str, model_dir: str, extra: list, tmp: str) -> dict:
    """One ``cli.serve.main`` run with ``--events`` and ``--trace``: every
    record validated, K1's KV entry held to 6 launches a prefill and a
    tick (the warmup's included: the counts are reset just before the
    call), no K4 and no other K1 entry; the engine read through a
    recording subclass of the CLI's ServingEngine."""
    from ps_pytorch_tpu_torch.cli import serve as cli_serve
    from ps_pytorch_tpu_torch.obs import validate_event
    from ps_pytorch_tpu_torch.ops import quantize as qz

    events = os.path.join(tmp, f"{name}.events.jsonl")
    trace = os.path.join(tmp, f"{name}.trace")
    made = []

    class Recorded(cli_serve.ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    k1 = ["quantize_kv_write", "quantize_rows", "quantize_rows_many", "quantize_rows_scaled_many"]
    plain_engine, cli_serve.ServingEngine = cli_serve.ServingEngine, Recorded
    try:
        reset_flash_counts()
        for n in k1:
            getattr(qz, n).launches = 0
        summary = cli_serve.main(["--model-dir", model_dir, *SERVE_CLI_ARGS, "--events", events,
                                  "--trace", trace, *extra])
        torch.cuda.synchronize()
        launches = {**read_flash_counts(), **{n: getattr(qz, n).launches for n in k1}}
    finally:
        cli_serve.ServingEngine = plain_engine
    (engine,) = made
    depth = engine.cfg.depth
    recs = [json.loads(line) for line in open(events)]
    for r in recs:
        validate_event(dict(r))
    terminal = ("request_done", "request_shed", "deadline_expired")
    rids = sorted(r["rid"] for r in recs if r["kind"] in terminal)
    require(rids == list(range(32)), f"phase 37 {name}: terminal records for rids {rids}")
    counts = engine.outcome_counts
    require(sum(counts.values()) == summary["requests_submitted"] == 32,
            f"phase 37 {name}: outcome_counts {counts}")
    require(launches["quantize_kv_write"] == depth * (engine.n_prefills + engine.n_decode_steps),
            f"phase 37 {name}: K1's KV entry launched {launches['quantize_kv_write']} times, "
            f"expected {depth} x ({engine.n_prefills} prefills + {engine.n_decode_steps} ticks)")
    require(all(launches[n] == 0 for n in k1[1:]) and all(
        launches[n] == 0 for n in ("flash_fwd", "flash_partial", "flash_bwd_dq",
                                   "flash_bwd_dkv")),
            f"phase 37 {name}: other kernels launched on the serving CLI: {launches}")
    spans = [json.loads(line) for line in open(os.path.join(trace, "trace_serve_p0.jsonl"))]
    drains = [(sp["outcome"], sp["dur"]) for sp in spans if sp.get("name") == "rollover_drain"]
    swaps = [sp["dur"] for sp in spans if sp.get("name") == "rollover_swap"]
    keys = ("tokens_per_sec", "p50_token_latency_s", "p99_token_latency_s", "p50_ttft_s",
            "p99_ttft_s", "requests_completed", "requests_shed", "requests_expired",
            "new_tokens", "weights_step", "elapsed_s")
    return {"summary": {k: summary[k] for k in keys}, "rollovers": summary["rollovers"],
            "rollover_aborts": [{k: a[k] for k in ("from_step", "staged_step", "reason")}
                                for a in summary["rollover_aborts"]],
            "outcome_counts": dict(counts), "prefills": engine.n_prefills,
            "decode_steps": engine.n_decode_steps, "launches": launches,
            "events": len(recs), "drain_s": drains, "swap_s": swaps}


def _serve_f32_rollover_exact(tmp: str, dev) -> dict:
    """An f32 d256 x 2 model's checkpoints at steps 2 and 4 (cli.train_lm
    on the card) served from step 2 with a poll every 2 ticks, 12
    requests on 4 slots: each completion's tokens are the per-sequence
    ``generate`` on the weights of its ``weights_step`` (a divergence only
    on a near-tie, as phase 6)."""
    from ps_pytorch_tpu_torch.checkpoint import load_checkpoint_raw
    from ps_pytorch_tpu_torch.cli import train_lm
    from ps_pytorch_tpu_torch.models import generate
    from ps_pytorch_tpu_torch.parallel.buckets import tree_map
    from ps_pytorch_tpu_torch.serve import Request, ServeConfig, ServingEngine
    from ps_pytorch_tpu_torch.serve.engine import checkpoint_model

    d = os.path.join(tmp, "f32")
    train_lm.main(["--vocab-size", "2048", "--dim", "256", "--depth", "2", "--heads", "4",
                   "--seq-len", "256", "--batch-size", "8", "--max-steps", "4", "--eval-freq",
                   "2", "--log-interval", "4", "--device", "cuda", "--train-dir", d])
    engine = ServingEngine.from_checkpoint(d, ServeConfig(slots=4, max_len=256,
                                                          max_prompt_len=64),
                                           step=2, device=dev)
    engine.warmup()
    rng = np.random.RandomState(5)
    reqs = [Request(rid=i, prompt=rng.randint(0, 2048, int(p)).astype(np.int32),
                    max_new_tokens=int(n))
            for i, (p, n) in enumerate(zip(rng.randint(2, 64, 12), rng.randint(8, 48, 12)))]
    outs = engine.decode_requests(reqs, poll_every=2)
    require([r["to_step"] for r in engine.rollovers] == [4],
            f"phase 37 f32: rollovers {engine.rollovers}")
    weights = {}
    for step in (2, 4):
        cfg, params = checkpoint_model(load_checkpoint_raw(d, step), None)
        weights[step] = (cfg, tree_map(lambda x: x.to(dev), params))
    mismatches = []
    for c, r in zip(outs, reqs):
        cfg, params = weights[c.weights_step]
        want = generate(cfg, params, torch.from_numpy(r.prompt)[None], r.max_new_tokens,
                        max_len=256, device=dev)[0, len(r.prompt):].cpu().numpy()
        got = np.asarray(c.tokens)
        if not np.array_equal(got, want):
            i = int(np.nonzero(got != want)[0][0])
            margin = _top2_margin(cfg, params, r.prompt, i, dev)
            mismatches.append({"rid": r.rid, "index": i, "top2_margin": margin})
            require(margin < 1e-4, f"phase 37 f32: rid {r.rid} diverges at new token {i} "
                    f"with top-2 margin {margin}")
    by_step = {s: sum(c.weights_step == s for c in outs) for s in (2, 4)}
    require(by_step[2] > 0 and by_step[4] > 0, f"phase 37 f32: completions by step {by_step}")
    return {"requests": len(reqs), "completions_by_step": by_step,
            "mismatches_on_near_ties": mismatches}


def phase_serve_cli(card: str) -> dict:
    """Phase 37: the serving CLI on the card. ``cli.train_lm`` writes
    checkpoints at steps 2 and 4 of bench.py's serve model (d512 x 6, 8
    heads, vocab 2048, bf16); ``cli.serve --int8-kv --dtype bfloat16
    --slots 8 --requests 32 --rate 100`` then runs from step 2 with
    ``--poll-interval 0.05`` (one rollover, to 4), on a copy of the
    directory with ``--fault-plan '{"rollover_corrupt": [4]}'`` (one
    abort, served on 2 throughout), and with ``--slo-budget`` and
    ``--traffic-spike`` (sheds; every request accounted for). Then the
    f32 d256 x 2 engine's tokens against ``generate`` across a rollover."""
    import shutil
    import tempfile

    from ps_pytorch_tpu_torch.cli import train_lm

    dev = torch.device("cuda")
    rec = {"card": card, "model": "d512x6 vocab2048 bf16 (bench.py _DEC_DEFAULTS)",
           "traffic": " ".join(SERVE_CLI_ARGS)}
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "lm")
        train_lm.main(SERVE_LM_ARGS + ["--train-dir", d])
        steps = sorted(int(f.rsplit("_", 1)[1]) for f in os.listdir(d)
                       if f.startswith("model_step_"))
        require(steps == [2, 4], f"phase 37: checkpoints {steps}")
        shutil.copytree(d, os.path.join(tmp, "lm_copy"))
        roll = _serve_cli_run("rollover", d, ["--step", "2", "--poll-interval", "0.05"], tmp)
        require([(r["from_step"], r["to_step"]) for r in roll["rollovers"]] == [(2, 4)]
                and roll["summary"]["weights_step"] == 4 and not roll["rollover_aborts"]
                and roll["summary"]["requests_completed"] == 32
                and len(roll["swap_s"]) == 1,
                f"phase 37 rollover: {roll['rollovers']} {roll['rollover_aborts']}")
        abort = _serve_cli_run("abort", os.path.join(tmp, "lm_copy"),
                               ["--step", "2", "--poll-interval", "0.05", "--fault-plan",
                                '{"rollover_corrupt": [4]}'], tmp)
        require(abort["rollovers"] == [] and abort["summary"]["weights_step"] == 2
                and [(a["reason"], a["staged_step"]) for a in abort["rollover_aborts"]]
                == [("corrupt_staged", 4)] and abort["summary"]["requests_completed"] == 32,
                f"phase 37 abort: {abort['rollovers']} {abort['rollover_aborts']}")
        # the spike starts after the first window closed with admissions
        # (the controller's drain-rate evidence)
        shed = _serve_cli_run("slo_spike", d, ["--slo-budget", "0.05", "--admit-window", "0.1",
                                               "--traffic-spike", "10,0.15,1"], tmp)
        require(shed["outcome_counts"]["shed"] >= 1,
                f"phase 37 slo_spike: nothing shed {shed['outcome_counts']}")
        rec.update({"rollover": roll, "abort": abort, "slo_spike": shed,
                    "f32_exact": _serve_f32_rollover_exact(tmp, dev)})
    print("phase 37 serving CLI rollover / abort / shedding: " + json.dumps(rec))
    return rec


def phase_compressed_checkpoint(card: str) -> dict:
    """Phase 38: phase 12b's ResNet18 8 x 128 run with
    ``--compress-checkpoints``: ``model_step_5`` and ``model_step_10`` in
    the ``PSCK`` form, their trailers verify, step 10 restores to the live
    state bit for bit, ``--resume`` continues at 11 (K2 once a step) and
    ``cli.evaluate --once`` reads the files. Timed, in turns with the
    plain form (twice each): a save's host half and background write,
    load + restore, the bytes on disk."""
    import tempfile

    from ps_pytorch_tpu_torch import checkpoint as ckpt
    from ps_pytorch_tpu_torch.cli import evaluate as cli_evaluate
    from ps_pytorch_tpu_torch.ops import codec

    rec = {"card": card}
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "models")
        ck = ["--train-dir", d, "--eval-freq", "5", "--compress-checkpoints"]
        reset_counts()
        first = _train(10, ck, checkpoints=True)
        torch.cuda.synchronize()
        require(read_counts()["quantize_tensors"] == 10,
                f"phase 38: launches {read_counts()} in 10 steps")
        require(ckpt.available_steps(d) == [5, 10], f"phase 38: files {os.listdir(d)}")
        for step in (5, 10):
            with open(ckpt.checkpoint_path(d, step), "rb") as f:
                require(f.read(4) == ckpt.COMPRESSED_MAGIC, f"phase 38: step {step} not PSCK")
            ckpt.verify_checkpoint(d, step)
        trainer = first["trainer"]
        times = {"plain": [], "psck": []}
        for rnd in range(2):
            for form in ("plain", "psck"):
                out = os.path.join(tmp, f"timed_{form}_{rnd}")
                t0 = time.perf_counter()
                trainer._ckpt.save(trainer.checkpoint_state(), out, 10, form == "psck")
                host_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                trainer._ckpt.wait()
                write_s = time.perf_counter() - t0
                times[form].append({"save_host_s": host_s, "save_write_s": write_s,
                                    "bytes": os.path.getsize(ckpt.checkpoint_path(out, 10))})
        # load + restore from each form (the trainer reads its train_dir)
        load = {}
        try:
            for form, src in (("psck", d), ("plain", os.path.join(tmp, "timed_plain_1"))):
                trainer.tcfg.train_dir = src
                t0 = time.perf_counter()
                restored = trainer._restore_step(10)
                torch.cuda.synchronize()
                load[form] = time.perf_counter() - t0
                require(_state_bits(restored, trainer.state),
                        f"phase 38: step 10 restored from the {form} file differs from "
                        f"the live state")
        finally:
            trainer.tcfg.train_dir = d
        t0 = time.perf_counter()
        raw = open(ckpt.checkpoint_path(d, 10), "rb").read()[4:-8]
        plain_bytes = len(codec.decompress_bytes(raw))
        decode_s = time.perf_counter() - t0

        reset_counts()
        res = _train(12, ck + ["--resume"], checkpoints=True)
        torch.cuda.synchronize()
        steps = [h["step"] for h in res["history"]]
        resume_launches = read_counts()["quantize_tensors"]
        require(steps == [11, 12] and resume_launches == 2,
                f"phase 38 resume: steps {steps}, launches {read_counts()}")
        ev = cli_evaluate.main(["--model-dir", d, "--network", "ResNet18", "--dataset",
                                "Cifar10", "--once", "--device", "cuda"])
        require(list(ev) == [12] and all(np.isfinite(list(ev[12].values()))),
                f"phase 38: cli.evaluate on the PSCK files {ev}")
    rec.update({"files": [5, 10, 12], "times": times, "load_restore_s": load,
                "codec_decode_s": decode_s, "msgpack_bytes": plain_bytes,
                "ratio": times["psck"][-1]["bytes"] / times["plain"][-1]["bytes"],
                "resume_steps": steps, "resume_launches": resume_launches,
                "evaluator": ev[12]})
    print("phase 38 compressed checkpoints ResNet18: " + json.dumps(rec))
    return rec


# ------------------------------------------------ phase 39: pscheck on the card

# every kernel entry's launch counter, by entry name (a tape's kernel node
# names its entry)
_QUANT_ENTRIES = ("quantize_tensors", "quantize_rows_scaled_many", "quantize_rows_many",
                  "quantize_rows", "quantize_kv_write", "accumulate_rescale_int8",
                  "tensors_absmax", "quantize_tensors_given", "rows_scaled_absmax",
                  "quantize_rows_scaled_given")
_FLASH_ENTRIES = ("flash_fwd", "flash_partial", "flash_bwd_dq", "flash_bwd_dkv")


def _entry_counters() -> dict:
    import importlib

    from ps_pytorch_tpu_torch.ops import quantize as q

    # the module: ``ops.flash_attention`` is the function the package re-exports
    fa = importlib.import_module("ps_pytorch_tpu_torch.ops.flash_attention")
    return {**{n: getattr(q, n) for n in _QUANT_ENTRIES},
            **{n: getattr(fa, n) for n in _FLASH_ENTRIES}}


def _collective_rows(r) -> list:
    return [(c.kind, c.axes, c.dtype, c.bytes, c.feeds_params) for c in r.collectives]


def phase_pscheck(card: str, phase9_p50_ms=None, keep=None) -> dict:
    """Phase 39: the registry recorded on the card, held against the
    committed artifact and against the same registry on the CPU; the
    canonical ResNet18 step recorded and timed with no tape active.
    ``keep`` (a dict) receives the card's and the CPU's records and the
    canonical one, for phase 40."""
    from ps_pytorch_tpu_torch.check import get_contracts, load_contract, run_checks, trace_spec
    from ps_pytorch_tpu_torch.check.contracts import canonical_spec
    from ps_pytorch_tpu_torch.check.core import DEFAULT_CONTRACT

    t_phase = time.perf_counter()
    counters = _entry_counters()
    specs = get_contracts()
    results, nodes = [], {}
    for spec in specs:
        before = {k: fn.launches for k, fn in counters.items()}
        r = trace_spec(spec, device="cuda")
        torch.cuda.synchronize()
        grew = {k: fn.launches - before[k] for k, fn in counters.items()
                if fn.launches != before[k]}
        mine = {k.split(":", 1)[1]: v for k, v in r.kernels.items()}
        require(mine == grew, f"phase 39 {spec.name}: kernel nodes {mine} but launches {grew}")
        results.append(r)
        nodes[spec.name] = r.kernels
    card_s = time.perf_counter() - t_phase
    findings = run_checks(results, load_contract(DEFAULT_CONTRACT))
    require(not findings, "phase 39 findings on the card: "
            + "; ".join(f"{f.config}: {f.rule} {f.message}" for f in findings[:10]))
    t_cpu = time.perf_counter()
    cpu_results = []
    for r in results:
        c = trace_spec(r.spec, device="cpu")
        cpu_results.append(c)
        require(r.summary == c.summary and _collective_rows(r) == _collective_rows(c),
                f"phase 39 {r.spec.name}: card rows {_collective_rows(r)} != CPU rows "
                f"{_collective_rows(c)}")
    cpu_s = time.perf_counter() - t_cpu
    by_kernel = {}
    for per in nodes.values():
        for k, v in per.items():
            by_kernel[k] = by_kernel.get(k, 0) + v
    for want in ("K1:quantize_kv_write", "K2:quantize_tensors", "K3:accumulate_rescale_int8"):
        require(by_kernel.get(want, 0) > 0, f"phase 39: no {want} node on the registry's tapes "
                                            f"({by_kernel})")
    # the canonical step: recorded, then timed with no tape
    canon = canonical_spec()
    t_canon = time.perf_counter()
    rc = trace_spec(canon, device="cuda")
    torch.cuda.synchronize()
    canon_s = time.perf_counter() - t_canon
    reg = next(r for r in results if r.spec.name == "ps_resnet18_int8_replicated_bucketed")
    require(rc.summary == reg.summary,
            f"phase 39 canonical rows {rc.summary} != registry's {reg.summary}")
    built = canon.build(torch.device("cuda"))
    step, (state, batch, draws) = built.step, built.args
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, draws)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    require(np.isfinite(float(metrics["loss"])), "phase 39 canonical step: loss not finite")
    if keep is not None:
        keep.update(card=results, cpu=cpu_results, canonical=rc)
    rec = {"card": card, "configs": len(results), "findings": 0,
           "kernel_nodes": by_kernel, "card_record_s": card_s, "cpu_record_s": cpu_s,
           "canonical": {"name": canon.name, "record_s": canon_s, "rows": rc.summary,
                         "kernels": rc.kernels,
                         "step_ms_p50_no_tape": float(np.median(times[3:])) * 1e3,
                         "step_ms_min_no_tape": min(times[3:]) * 1e3},
           "phase9_step_ms_p50": phase9_p50_ms,
           "seconds": time.perf_counter() - t_phase}
    print("phase 39 pscheck on the card: " + json.dumps(rec))
    return rec


def _numerics_events(rep) -> dict:
    """A NumericsReport event for event, each scale-root set by its size
    (the roots are node ids of the analyzer's own graph)."""
    def strip(e):
        d = dict(vars(e))
        for k in ("roots", "scale_roots"):
            if k in d:
                d[k] = len(d[k])
        return tuple(sorted((k, repr(v)) for k, v in d.items()))

    return {"sites": [strip(e) for e in rep.sites], "dequants": [strip(e) for e in rep.dequants],
            "accums": [strip(e) for e in rep.accums], "narrows": [strip(e) for e in rep.narrows],
            "residuals": [strip(e) for e in rep.residuals], "axis_sizes": rep.axis_sizes}


def phase_numerics(card: str, kept: dict) -> dict:
    """Phase 40: PSC111-114 over phase 39's records on the card; each
    report the CPU's, event for event; the canonical step through the
    four rules."""
    from ps_pytorch_tpu_torch.check.rules import (
        psc111_scale_provenance,
        psc112_error_feedback,
        psc113_capacity,
        psc114_downcast,
    )

    def numerics_findings(r):
        return (psc111_scale_provenance(r) + psc112_error_feedback(r) + psc113_capacity(r)
                + psc114_downcast(r))

    t0 = time.perf_counter()
    counts = {"sites": 0, "dequants": 0, "accums": 0, "narrows": 0, "residuals": 0}
    for r, c in zip(kept["card"], kept["cpu"]):
        require(r.spec.name == c.spec.name, "phase 40: phase 39's records out of order")
        if r.spec.numerics is None:
            continue
        found = numerics_findings(r)
        require(not found, f"phase 40 {r.spec.name}: " + "; ".join(
            f"{f.rule} {f.message}" for f in found[:5]))
        mine, cpu = _numerics_events(r.numerics), _numerics_events(c.numerics)
        for key in mine:
            require(mine[key] == cpu[key], f"phase 40 {r.spec.name}: the card's {key} differ "
                                           f"from the CPU's")
        for key in counts:
            counts[key] += len(mine[key])
    canon = kept["canonical"]
    found = numerics_findings(canon)
    require(not found and canon.numerics is not None,
            "phase 40 canonical step: " + "; ".join(f"{f.rule} {f.message}" for f in found[:5]))
    rec = {"card": card, "configs": sum(1 for r in kept["card"] if r.spec.numerics is not None),
           "findings": 0, "events": counts,
           "canonical": {"name": canon.spec.name, "sites": len(canon.numerics.sites),
                         "accums": [(a.kind, a.dtype, a.multiplier, a.peak_out, a.capacity)
                                    for a in canon.numerics.accums[:1]],
                         "n_accums": len(canon.numerics.accums)},
           "seconds": time.perf_counter() - t0}
    print("phase 40 psnumerics on the card: " + json.dumps(rec))
    return rec


def _uses(knobs: dict) -> dict:
    """Which quantize kernels a knob point launches on the stacked card:
    K2 on a per-tensor int8 wire (both rounds of the dequant two-round
    wire), K1 on a block-scaled one, K3 on the homomorphic two-round
    wire."""
    q = knobs["compress"] in ("int8", "int8_2round")
    block = knobs["quant_block_size"] > 0
    return {"K2": q and not block, "K1": q and block,
            "K3": knobs["compress"] == "int8_2round" and knobs["wire_domain"] == "homomorphic"}


AUTOTUNE_PROBE_STEPS = 4


def phase_autotune(card: str) -> dict:
    """Phase 41: ``tools.autotune`` on the card, its best flag line
    through ``cli.train --config-json``, and ``cli.tune``'s two sweeps."""
    import tempfile

    from ps_pytorch_tpu_torch.cli import train as cli_train
    from ps_pytorch_tpu_torch.cli import tune as cli_tune
    from ps_pytorch_tpu_torch.obs.schema import validate_event
    from ps_pytorch_tpu_torch.tools import autotune

    smi_name, smi_power = (x.strip() for x in nvidia_smi_line().split(",", 1))
    kind = torch.cuda.get_device_name(0)
    named = ("ps_resnet18_int8_replicated_bucketed4096k",
             "ps_resnet18_int8_2round_replicated_bucketed_homomorphic")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "autotune_resnet18.json")
        t0 = time.perf_counter()
        rc = autotune.main(["--model", "resnet18", "--probe-top", "3", "--probe-steps",
                            str(AUTOTUNE_PROBE_STEPS), "--probe", ",".join(named),
                            "--out", out])
        search_s = time.perf_counter() - t0
        require(rc == 0, f"phase 41: tools.autotune exited {rc}")
        with open(out) as f:
            rec = json.load(f)
        validate_event(dict(rec))
        validate_event(dict(rec["run"]))
        prof = rec["hardware_profile"]
        require(prof["name"] == smi_name and prof["power_limit"] == smi_power,
                f"phase 41: profile {prof['name']} / {prof['power_limit']}, nvidia-smi "
                f"{smi_name} / {smi_power}")
        probes = [c for c in rec["candidates"] if "probe" in c]
        require(len(probes) == 3 + len(set(named) - {c["name"] for c in probes[:3]})
                and set(named) <= {c["name"] for c in probes},
                f"phase 41: probes {[c['name'] for c in probes]}")
        for name in named:
            got = next(c["probe"]["launches"] for c in probes if c["name"] == name)
            require(got["K2"] == AUTOTUNE_PROBE_STEPS
                    and got["K3"] == (AUTOTUNE_PROBE_STEPS if "homomorphic" in name else 0),
                    f"phase 41 {name}: probe launches {got}, not one K2 (and K3) a step")
        for c in probes:
            p = c["probe"]
            require(p["platform"] == "gpu" and p["device_kind"] == kind,
                    f"phase 41 {c['name']}: probe backend {p['platform']} {p['device_kind']}")
            for k, used in _uses(c["knobs"]).items():
                n = p["launches"][k]
                require((n > 0) == used and n % AUTOTUNE_PROBE_STEPS == 0,
                        f"phase 41 {c['name']}: {k} launched {n} times over "
                        f"{AUTOTUNE_PROBE_STEPS} steps (knobs {c['knobs']})")
        stages = sorted({p["stage"] for p in rec["pruned"]})
        require(stages == ["config", "contract"], f"phase 41: prune stages {stages}")
        # the best candidate's flags through cli.train --config-json, 2 steps
        owned = set(rec["best"]["flags"])
        base = [x for i in range(0, len(TRAIN_ARGS), 2) if TRAIN_ARGS[i] not in owned
                for x in TRAIN_ARGS[i:i + 2]]
        steps = 2
        reset_counts()
        t0 = time.perf_counter()
        res = cli_train.main(base + ["--max-steps", str(steps), "--no-checkpoints",
                                     "--config-json", out])
        torch.cuda.synchronize()
        best_s = time.perf_counter() - t0
        best_launches = read_counts()
        losses = [h["loss"] for h in res["history"]]
        require(len(losses) == steps and all(np.isfinite(v) for v in losses),
                f"phase 41 best flag line: losses {losses}")
        want = {k: v for k, v in _uses(rec["best"]["knobs"]).items() if v}
        k_of = {"K2": "quantize_tensors", "K3": "accumulate_rescale_int8"}
        for k in want:
            if k in k_of:
                require(best_launches[k_of[k]] > 0,
                        f"phase 41 best flag line: no {k} launch ({best_launches})")
        # cli.tune: 2 learning rates x 4 steps of ResNet18, the int8 wire
        reset_counts()
        t0 = time.perf_counter()
        scores = cli_tune.main(["--device", "cuda", "--network", "ResNet18", "--dataset",
                                "Cifar10", "--num-workers", str(WORKERS), "--batch-size", "128",
                                "--max-steps", "4", "--lr-grid", "0.1", "0.01",
                                "--compress-grad", "compress", "--score-window", "2",
                                "--train-dir", os.path.join(root, "tune")])
        torch.cuda.synchronize()
        tune_s = time.perf_counter() - t0
        tune_launches = read_counts()
        require(set(scores) == {0.1, 0.01} and all(np.isfinite(v) for v in scores.values()),
                f"phase 41 cli.tune: scores {scores}")
        require(tune_launches["quantize_tensors"] == 2 * 4,
                f"phase 41 cli.tune: K2 launches {tune_launches}, not one a step")
        # cli.tune --workload lm: 2 x 2 steps, attention on K4-K6
        reset_flash_counts()
        t0 = time.perf_counter()
        lm_scores = cli_tune.main(["--device", "cuda", "--workload", "lm", "--max-steps", "2",
                                   "--batch-size", "4", "--lr-grid", "0.1", "0.01",
                                   "--score-window", "2", "--lm-attention-impl", "flash"])
        torch.cuda.synchronize()
        lm_s = time.perf_counter() - t0
        lm_launches = read_flash_counts()
        require(set(lm_scores) == {0.1, 0.01}
                and all(np.isfinite(v) for v in lm_scores.values()),
                f"phase 41 cli.tune lm: scores {lm_scores}")
        require(lm_launches["flash_fwd"] + lm_launches["flash_partial"] > 0
                and lm_launches["flash_bwd_dq"] > 0 and lm_launches["flash_bwd_dkv"] > 0,
                f"phase 41 cli.tune lm: flash launches {lm_launches}")
    top = [{"rank": c["rank"], "name": c["name"],
            "modeled_step_ms": c["cost"]["modeled_step_s"] * 1e3,
            "modeled_step_probe_ms": c["cost"].get("modeled_step_probe_s", 0) * 1e3 or None,
            "measured_step_ms": c["probe"]["measured_step_s"] * 1e3 if "probe" in c else None,
            "overlap_fraction_spans": c["probe"]["overlap_fraction_spans"]
            if "probe" in c else None,
            "update_path_ops": c["cost"]["update_path_ops"], "comm_ms": c["cost"]["comm_s"] * 1e3,
            "probe_launches": c["probe"]["launches"] if "probe" in c else None}
           for c in rec["candidates"] if c["rank"] < 6 or "probe" in c]
    out_rec = {"card": card, "profile": prof, "n_points": rec["n_points"],
               "n_candidates": rec["n_candidates"], "n_pruned": rec["n_pruned"],
               "pruned": [(p["name"], p["stage"], p["rules"]) for p in rec["pruned"]],
               "best": rec["best"]["name"], "best_flag_line": rec["best"]["flag_line"],
               "gate": rec["gate"], "default_modeled_step_ms":
                   rec["default"]["cost"]["modeled_step_s"] * 1e3 if rec["default"] else None,
               "top": top, "search_s": search_s,
               "best_run": {"losses": losses, "launches": best_launches,
                            "step_ms": [h["time_cost"] * 1e3 for h in res["history"]],
                            "seconds": best_s},
               "tune": {"scores": scores, "launches": tune_launches, "seconds": tune_s},
               "tune_lm": {"scores": lm_scores, "launches": lm_launches, "seconds": lm_s},
               "seconds": time.perf_counter() - t_phase}
    print("phase 41 autotune on the card: " + json.dumps(out_rec))
    return out_rec


def phase_lint(card: str) -> dict:
    """Phase 42: the port's pslint gate on this machine, which has no JAX:
    ``python -m ps_pytorch_tpu_torch.lint ps_pytorch_tpu_torch chip_smoke.py
    --baseline lint_baseline_torch.json`` from this tree's root, in a
    process of its own. Exit 0 and no new finding, or the phase fails; its
    seconds and the findings it counted (baselined ones included)."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "ps_pytorch_tpu_torch.lint", "ps_pytorch_tpu_torch",
           "chip_smoke.py", "--baseline", "lint_baseline_torch.json", "--format", "json"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0,
            f"phase 42: the lint gate exited {proc.returncode}: "
            f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    require(out["new"] == [], f"phase 42: new findings {out['new']}")
    rec = {"card": card, "command": " ".join(cmd[1:]), "exit": proc.returncode,
           "seconds": seconds, "findings": len(out["findings"]), "new": len(out["new"]),
           "baselined": out["baselined"], "stale": len(out["stale"]),
           "axes_source": out["axes_source"]}
    print("phase 42 pslint gate on the port: " + json.dumps(rec))
    return rec


# phase 43's captured window: steps [2, 4) of a 3-step run (the window
# closes when the run ends)
TRACE_STEPS, TRACE_START, TRACE_CAPTURED = 3, 2, 2


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output kept: (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def phase_trace_front_end(card: str) -> dict:
    """Phase 43: the trace front end on the port. Phase 29's configuration
    (ResNet18 8 x 128, the int8 wire in 4 MiB buckets), ``--overlap on``
    and then serial, each 3 steps through ``cli.train.main`` with
    ``--trace`` and ``--profile-dir`` (steps 2-3 captured): the port's
    ``tools.trace_report`` merges each span stream and its
    ``--require-phases fetch,dispatch,sync`` exits 0; ``tools.overlap_report
    trace`` finds device events in both profiles, and in the pipelined one
    a ``bucket_reduce_o*`` range per bucket a captured step (11) with every
    K2 launch of the captured steps inside one; both reports printed, their
    overlap fractions reported, not gated. Then ``analysis.scaling_bench``
    on LeNet (1024 a worker) and ResNet18 (128 a worker) at 1 / 2 / 4 / 8
    stacked workers, 3 timed steps after 2 warm-up ones, and
    ``tools.dcn_scaling`` at 1 and 2 gloo processes sharing the card (LeNet,
    4 workers a process, 5 steps): each record carries the card's name and
    power limit."""
    import tempfile

    from ps_pytorch_tpu_torch.analysis import scaling_bench
    from ps_pytorch_tpu_torch.cli._flags import add_ps_flags, add_train_flags, ps_config_from
    from ps_pytorch_tpu_torch.models import build_model, init_model
    from ps_pytorch_tpu_torch.tools import dcn_scaling, overlap_report, trace_report

    t_start = time.perf_counter()
    resnet, _ = init_model(build_model("ResNet18"), torch.Generator().manual_seed(0),
                           device="cpu")
    parser = add_ps_flags(add_train_flags(argparse.ArgumentParser()))
    rec, reports = {"card": card}, {}
    with tempfile.TemporaryDirectory() as root:
        for name, overlap in (("pipelined", "on"), ("serial", "off")):
            d = os.path.join(root, name)
            flags = OVERLAP_WIRES["int8"] + ["--overlap", overlap]
            cfg = ps_config_from(parser.parse_args(TRAIN_ARGS + flags), WORKERS)
            buckets = _pieces(cfg, resnet)
            t0 = time.perf_counter()
            reset_counts()
            out = _train(TRACE_STEPS, flags + [
                "--trace", os.path.join(d, "trace"), "--profile-dir", os.path.join(d, "prof"),
                "--profile-start", str(TRACE_START), "--profile-steps", str(TRACE_CAPTURED)])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            losses = [h["loss"] for h in out["history"]]
            require(len(losses) == TRACE_STEPS and all(np.isfinite(v) for v in losses),
                    f"phase 43 {name}: losses {losses}")
            rc, text = _quiet(trace_report.main, [
                os.path.join(d, "trace"), "--require-phases", "fetch,dispatch,sync",
                "--out", os.path.join(d, "merged.json")])
            require(rc == 0, f"phase 43 {name}: trace_report --require-phases exited {rc}")
            summary = json.loads(text)
            rep = overlap_report.run_trace(argparse.Namespace(profile_dir=os.path.join(d, "prof")))
            require("error" not in rep, f"phase 43 {name}: overlap trace: {rep.get('error')}")
            k2 = [v for k, v in rep["port_kernels"].items()
                  if "absmax_many_kernel" in k or "quantize_many_kernel" in k]
            k2_launches = sum(v["launches"] for v in k2)
            k2_inside = sum(v["in_bucket_reduce"] for v in k2)
            if name == "pipelined":
                require(len(rep["per_bucket"] or []) == buckets == 11
                        and rep["n_bucket_ranges"] == buckets * TRACE_CAPTURED,
                        f"phase 43: {rep['n_bucket_ranges']} bucket_reduce ranges in "
                        f"{len(rep['per_bucket'] or [])} rows, expected {buckets} a captured "
                        f"step over {TRACE_CAPTURED}")
                require(k2_launches == 2 * buckets * TRACE_CAPTURED and k2_inside == k2_launches,
                        f"phase 43: {k2_inside} of {k2_launches} K2 launches inside a bucket's "
                        f"range, expected all {2 * buckets * TRACE_CAPTURED}")
            else:
                require(rep["n_bucket_ranges"] == 0 and k2_launches == 2 * TRACE_CAPTURED,
                        f"phase 43 serial: {rep['n_bucket_ranges']} bucket ranges, "
                        f"{k2_launches} K2 launches")
            reports[name] = {k: v for k, v in rep.items()
                             if k not in ("top_compute_events", "top_skipped_events")}
            reports[name]["trace_file"] = os.path.basename(rep["trace_file"])
            reports[name]["top_skipped_events"] = rep["top_skipped_events"][:4]
            rec[name] = {"buckets": buckets, "train_s": train_s, "losses": losses,
                         "launches": read_counts(), "k2_launches_captured": k2_launches,
                         "k2_inside_bucket_ranges": k2_inside,
                         "overlap_fraction": rep["overlap_fraction"],
                         "profile_host_s": out["trainer"].profile_window.host_s,
                         "spans": {k: summary["phases"][k] for k in ("fetch", "dispatch", "sync")},
                         "nesting_ok": summary["nesting_ok"]}
    print("phase 43 overlap trace reports, pipelined and serial: " + json.dumps(reports))
    t0 = time.perf_counter()
    scaling = {}
    for net, ds, batch in (("LeNet", "MNIST", 1024), ("ResNet18", "Cifar10", 128)):
        res, _ = _quiet(scaling_bench.main, [
            "--network", net, "--dataset", ds, "--batch-size", str(batch),
            "--workers", "1", "2", "4", "8", "--steps", "3"])
        require(res["card"] == card and res["platform"] == "cuda"
                and all(np.isfinite(r["images_per_sec"]) for r in res["rows"]),
                f"phase 43 scaling_bench {net}: {res}")
        scaling[net] = res
    rec["scaling_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dcn, _ = _quiet(dcn_scaling.main, ["--hosts", "1", "2", "--network", "LeNet", "--steps", "5",
                                       "--per-host-devices", "4", "--device", "cuda",
                                       "--timeout", "300"])
    require(dcn["card"] == card and dcn["contention"]
            and all(np.isfinite(r["images_per_sec"]) for r in dcn["rows"]),
            f"phase 43 dcn_scaling: {dcn}")
    rec.update({"dcn_s": time.perf_counter() - t0, "scaling": scaling, "dcn_scaling": dcn,
                "seconds": time.perf_counter() - t_start})
    print("phase 43 trace front end, scaling and DCN records: " + json.dumps(rec))
    return rec


RUNS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs")
LONGCONTEXT_SEQ, LONGCONTEXT_SHARDS = 8192, 8


def phase_longcontext(card: str) -> dict:
    """Phase 44: ``tools.longcontext_check`` at T=8192 on 8 stacked shards,
    f32, at ``--heads 1`` (the JAX record's shape) and ``--heads 8`` (LM-1's
    heads): the causal flash ring's value and dq / dk / dv within the JAX
    tool's tolerances of the full-attention oracle, through K4's partial
    triple (one launch a hop: 2 x 8, the value's ring and the gradient's
    forward), K5 and K6 (8 each), all on the f32 route; the tool's counts
    and this script's counters agree. Errors beside JAX's CPU record."""
    from ps_pytorch_tpu_torch.tools import longcontext_check

    with open(os.path.join(RUNS, "longcontext_t8192_cpu.json")) as f:
        jax_rec = json.load(f)
    want = {"flash_partial": 2 * LONGCONTEXT_SHARDS, "flash_bwd_dq": LONGCONTEXT_SHARDS,
            "flash_bwd_dkv": LONGCONTEXT_SHARDS}
    t_start = time.perf_counter()
    rec = {"card": card, "jax_cpu_errors": [c["max_abs_err"] for c in jax_rec["checks"]]}
    for heads in (1, 8):
        t0 = time.perf_counter()
        reset_flash_counts()
        rep, _ = longcontext_check.run_check(seq=LONGCONTEXT_SEQ, dim=64, heads=heads,
                                             devices=LONGCONTEXT_SHARDS, device="cuda")
        torch.cuda.synchronize()
        counts = read_flash_counts()
        require(rep["all_pass"], f"phase 44 heads {heads}: {rep['checks']}")
        require(rep["kernels"] == want and counts == dict(want, flash_fwd=0),
                f"phase 44 heads {heads}: launches {rep['kernels']} / {counts}, expected {want}")
        rec[f"heads{heads}"] = {"errors": [c["max_abs_err"] for c in rep["checks"]],
                                "oracle_max_abs": [c["oracle_max_abs"] for c in rep["checks"]],
                                "launches": rep["kernels"], "report": rep,
                                "seconds": time.perf_counter() - t0}
    rec["seconds"] = time.perf_counter() - t_start
    print("phase 44 long-context check, T=8192 x 8 shards: " + json.dumps(rec))
    return rec


# the link rates phase 45 gives (no default exists): NVLink 4's 900 GB/s
# both ways a card (H100 SXM), one way; one 400 Gb/s NIC a host
GIVEN_ICI_GBS, GIVEN_DCN_GBS = 450.0, 50.0


def phase_predicted_scaling(card: str) -> dict:
    """Phase 45: ``tools.predicted_scaling`` on ResNet18 at 8 and 16 stacked
    workers, every mode, the rates given (``--ici-gbs 450 --dcn-gbs 50``)
    and t1 measured on the card: the contract cross-check holds, no
    failure, each rate labelled given, t1 measured; one K2 launch a tape
    kernel node; each row's bytes by kind within 1% of JAX's committed
    ``runs/predicted_scaling.json`` (HLO bytes), printed beside them with
    the row's tape kernel nodes."""
    from ps_pytorch_tpu_torch.tools import predicted_scaling

    with open(os.path.join(RUNS, "predicted_scaling.json")) as f:
        jax_rows = {(r["workers"], r["mode"]): r for r in json.load(f)["rows"]}
    t0 = time.perf_counter()
    reset_counts()
    rep, _ = _quiet(predicted_scaling.main, [
        "--workers", "8", "16", "--ici-gbs", str(GIVEN_ICI_GBS),
        "--dcn-gbs", str(GIVEN_DCN_GBS)])
    torch.cuda.synchronize()
    launches = read_counts()
    m = rep["model"]
    require(rep["contract_check"] is not None and rep["contract_check"]["ok"]
            and not rep["failures"] and len(rep["rows"]) == 8,
            f"phase 45: contract {rep['contract_check']}, failures {rep['failures']}")
    require(m["t1_source"].startswith(f"measured on {card}") and m["ici_source"].startswith(
        "given") and m["dcn_source"].startswith("given"), f"phase 45: sources {m}")
    nodes = sum(r["kernel_nodes"].get("K2:quantize_tensors", 0) for r in rep["rows"])
    require(launches["quantize_tensors"] == nodes and nodes > 0,
            f"phase 45: {launches['quantize_tensors']} K2 launches for {nodes} tape nodes")
    for r in rep["rows"]:
        # the ring factors price the buffers JAX's record gives (an
        # all-gather's result): each kind's bytes within 1% of its HLO's
        jax_kinds = jax_rows[(r["workers"], r["mode"])]["by_kind"]
        require(set(r["by_kind"]) == set(jax_kinds) and all(
            abs(v["bytes"] / jax_kinds[k]["bytes"] - 1) < 0.01 for k, v in r["by_kind"].items()),
            f"phase 45 {r['workers']} / {r['mode']}: bytes {r['by_kind']}, JAX's {jax_kinds}")
    rows = [{"workers": r["workers"], "mode": r["mode"], "kernel_nodes": r["kernel_nodes"],
             "n_collectives": r["n_collectives"], "record_seconds": r["record_seconds"],
             "bytes_by_kind": {k: v["bytes"] for k, v in r["by_kind"].items()},
             "jax_hlo_bytes_by_kind": {k: v["bytes"] for k, v in jax_rows.get(
                 (r["workers"], r["mode"]), {}).get("by_kind", {}).items()},
             "efficiency_no_overlap": r["efficiency_no_overlap"],
             "efficiency_full_overlap": r["efficiency_full_overlap"]} for r in rep["rows"]]
    rec = {"card": card, "model": m, "rows": rows, "launches": launches,
           "seconds": time.perf_counter() - t0}
    print("phase 45 predicted scaling, ResNet18 at 8 and 16 workers: " + json.dumps(rec))
    return rec


def phase_convergence(card: str) -> dict:
    """Phase 46: ``tools.convergence --suite r04 --steps 20 --eval-freq 10``
    on the card (ResNet18 2 x 128 on the real-digits CIFAR-10 stand-in,
    the polling evaluator beside each trainer): every leg's losses finite,
    the evaluator logged steps 10 and 20; each leg's K1-K3 launches, the
    int8 leg's one K2 call a step, the none leg's none."""
    import tempfile

    from ps_pytorch_tpu_torch.tools import convergence

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        rc, _ = _quiet(convergence.main, [
            "--suite", "r04", "--steps", "20", "--eval-freq", "10", "--out-dir", out,
            "--poll-interval", "1", "--wait-timeout", "120", "--leg-timeout", "300"])
        with open(os.path.join(out, "convergence_legs.json")) as f:
            rep = json.load(f)
    require(rc == 0 and rep["ok"], f"phase 46: exit {rc}: {rep['legs']}")
    legs = {leg["leg"]: leg for leg in rep["legs"]}
    for name, leg in legs.items():
        require(leg["losses_finite"] and {10, 20} <= set(leg["eval_steps"]),
                f"phase 46 {name}: losses finite {leg['losses_finite']}, evaluator steps "
                f"{leg['eval_steps']}")
    require(set(legs["none"]["launches"].values()) == {0}
            and legs["int8"]["launches"]["quantize_tensors"] == 20,
            f"phase 46: launches {({k: v['launches'] for k, v in legs.items()})}")
    rec = {"card": card, "seconds": time.perf_counter() - t0,
           "legs": {name: {k: leg[k] for k in ("launches", "eval_steps", "step_s_p50",
                                                "seconds", "train_flags")}
                    for name, leg in legs.items()},
           "summary": rep["merged"]["compression_convergence.json"]}
    print("phase 46 convergence legs, r04 at 20 steps: " + json.dumps(rec))
    return rec


def main(argv=None) -> int:
    global OTHER_TREE, PACKAGE_ROOT
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run alone (2, 3, 4, 5, 7, 8, 9, 11, 12, 12b, "
                         "14, 18, 19, 20, 20b, 20c, 21, 22, 23, 24, 24b, 25, 26, 27, 28, 29, 30, "
                         "30b, 31, "
                         "32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46; 2 "
                         "on this tree only; 22 runs 9 first, 24 runs 24b and 23 first, "
                         "40 runs 39 first)")
    ap.add_argument("--package-root", default=None,
                    help="directory holding the ps_pytorch_tpu_torch package to time")
    children = {"phase24_child": phase24_child, "phase30b_child": phase30b_child,
                "phase20c_child": phase20c_child}
    for name in children:
        ap.add_argument("--" + name.replace("_", "-"), nargs=4, default=None,
                        metavar=("RANK", "PORT", "DIR", "OUT"), help=argparse.SUPPRESS)
    ap.add_argument("--split-child", default=None, metavar="OUT", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.package_root is not None:
        PACKAGE_ROOT = os.path.abspath(args.package_root)
        sys.path.insert(0, PACKAGE_ROOT)
        OTHER_TREE = True
    for name, child in children.items():
        if getattr(args, name) is not None:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            rank, port, root, out = getattr(args, name)
            return child(int(rank), int(port), root, out)
    if args.split_child is not None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return split_child(args.split_child)
    from ps_pytorch_tpu_torch.ops.flash_attention import flash_fwd, flash_fwd_plain

    # f32 comparisons on the card need full f32 products: TF32 off for
    # matmuls and for cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi)
    print(f"phase 1 device: {card} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | tf32 off")

    def deterministic(fn):
        """``fn(root)`` in a scratch directory with cuDNN's deterministic
        algorithms (phase 23's rule: runs of one seed comparable bit for
        bit)."""
        import tempfile

        torch.backends.cudnn.deterministic = True
        try:
            with tempfile.TemporaryDirectory() as root:
                return fn(root)
        finally:
            torch.backends.cudnn.deterministic = False

    def procs(two: bool) -> tuple:
        """Phases 23 and (``two``) 24 in one scratch directory: 24 holds
        its files against 23's stacked ones."""
        def run(root):
            nccl = phase_nccl_one(smi, root)
            return nccl, (phase_two_processes(smi, root, nccl) if two else None)

        return deterministic(run)

    if args.phases is not None:
        import ps_pytorch_tpu_torch

        print(f"package: {os.path.dirname(os.path.abspath(ps_pytorch_tpu_torch.__file__))}")
        ran = {}  # phases 9's and 12's records, for phases 25's and 30's comparisons
        alone = {2: phase_build,
                 3: lambda: print("phase 3 KV pool write: "
                                  + json.dumps(kv_pool_write_case(dev))),
                 4: lambda: phase_k4(flash_fwd, flash_fwd_plain, dev),
                 5: lambda: phase_serve(card, dev),
                 7: lambda: print("phase 7 K2 wire step: "
                                  + json.dumps(wire_step_case(dev, 0))),
                 8: lambda: print("phase 8 K1 block-128 wire step, rounds 1 and 2: "
                                  + json.dumps({"round1": wire_step_case(dev, 128),
                                                "round2": round2_step_case(dev)})),
                 9: lambda: ran.setdefault(9, phase_train(smi)),
                 11: lambda: phase_k3(dev),
                 12: lambda: ran.setdefault(12, phase_train_wires(smi)),
                 "12b": lambda: phase_checkpoint(smi),
                 14: lambda: phase_flash_train_kernels(dev),
                 18: lambda: phase_vgg(smi),
                 19: lambda: phase_bf16(smi, phase_train(smi)),
                 20: lambda: phase_held_vgg(dev),
                 "20b": lambda: ran.setdefault("20b", phase_synced_local(smi)),
                 "20c": lambda: deterministic(lambda root: phase_synced_processes(
                     smi, root, ran.get("20b"))),
                 21: lambda: phase_events(smi),
                 22: lambda: phase_adam(smi, phase_train(smi)),
                 23: lambda: procs(False),
                 24: lambda: (phase_split(dev), procs(True)),
                 "24b": lambda: phase_split(dev),
                 25: lambda: phase_data(smi, ran[9]["step_ms_p50"] if 9 in ran else None),
                 26: lambda: phase_adaptive(smi, dev),
                 27: lambda: phase_stochastic(smi, dev),
                 28: lambda: phase_reshape(smi),
                 29: lambda: phase_overlap(smi, dev),
                 30: lambda: ran.setdefault(30, phase_hier(smi, dev, ran[12]["autotune_best"]
                                                           if 12 in ran else None)),
                 "30b": lambda: deterministic(lambda root: phase_grid_processes(
                     smi, root, ran.get(30))),
                 31: lambda: phase_config_json(smi),
                 32: lambda: phase_lm_schemes(smi),
                 33: lambda: phase_lm_schemes_held(dev),
                 34: lambda: phase_flash_shard_kernels(dev),
                 35: lambda: phase_moe_schemes(smi),
                 36: lambda: phase_moe_schemes_held(dev),
                 37: lambda: phase_serve_cli(smi),
                 38: lambda: phase_compressed_checkpoint(smi),
                 39: lambda: phase_pscheck(smi, ran[9]["step_ms_p50"] if 9 in ran else None),
                 40: lambda: phase_numerics(smi, _kept_pscheck(smi)),
                 41: lambda: phase_autotune(smi),
                 42: lambda: phase_lint(smi),
                 43: lambda: phase_trace_front_end(smi),
                 44: lambda: phase_longcontext(smi),
                 45: lambda: phase_predicted_scaling(smi),
                 46: lambda: phase_convergence(smi)}

        def _kept_pscheck(smi_):
            kept = {}
            phase_pscheck(smi_, None, kept)
            return kept
        alone = {str(k): v for k, v in alone.items()}
        phases = args.phases.split(",")
        require(set(phases) <= set(alone), f"--phases: {phases} not all in {sorted(alone)}")
        require(not ("2" in phases and OTHER_TREE), "--phases: 2 checks this tree's kernels")
        for n in phases:
            t0 = time.perf_counter()
            alone[n]()
            PHASE_SECONDS[n] = time.perf_counter() - t0
        print_phase_seconds(t_main)
        print_captures()
        return 0

    def timed(label, fn, *args):
        """``fn(*args)``, its wall seconds kept under the phase's label."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            PHASE_SECONDS[label] = time.perf_counter() - t0

    timed("2", phase_build)

    k1 = timed("3", phase_k1, dev)
    k4 = timed("4", phase_k4, flash_fwd, flash_fwd_plain, dev)
    serve = timed("5", phase_serve, card, dev)
    timed("6", phase_exact, dev)
    k2 = timed("7", phase_k2, dev)
    k1s = timed("8", phase_k1_scaled, dev)
    train = timed("9", phase_train, smi)
    timed("10", phase_held, dev)
    k3 = timed("11", phase_k3, dev)
    wires = timed("12", phase_train_wires, smi)
    ckpt_rec = timed("12b", phase_checkpoint, smi)
    timed("13", phase_held_wires, dev)
    fk = timed("14", phase_flash_train_kernels, dev)
    shard_k = timed("34", phase_flash_shard_kernels, dev)
    lm1 = timed("15", phase_lm, smi, "phase 15 LM-1 train_lm dp 1 x sp 1 flash", 20, 1, 8, 1024)
    lm1_f32 = timed("15b", phase_lm, smi, "phase 15b LM-1 f32 train_lm dp 1 x sp 1 flash", 8,
                    1, 8, 1024, "float32")
    timed("16", phase_lm, smi, "phase 16 LM-ring train_lm dp 1 x sp 4 flash", 5, 4, 2, 8192)
    held = timed("17", phase_lm_held, dev)
    vgg = timed("18", phase_vgg, smi)
    bf16 = timed("19", phase_bf16, smi, train)
    timed("20", phase_held_vgg, dev)
    synced_local = timed("20b", phase_synced_local, smi)
    synced_proc = timed("20c", deterministic,
                        lambda root: phase_synced_processes(smi, root, synced_local))
    events = timed("21", phase_events, smi)
    timed("22", phase_adam, smi, train)
    split = timed("24b", phase_split, dev)
    nccl, two = timed("23,24", procs, True)
    data = timed("25", phase_data, smi, train["step_ms_p50"])
    adapt = timed("26", phase_adaptive, smi, dev)
    stoch = timed("27", phase_stochastic, smi, dev)
    timed("28", phase_reshape, smi)
    overlap = timed("29", phase_overlap, smi, dev)
    hier = timed("30", phase_hier, smi, dev, wires["autotune_best"])
    grid_proc = timed("30b", deterministic,
                      lambda root: phase_grid_processes(smi, root, hier))
    cfg_json = timed("31", phase_config_json, smi)
    schemes = timed("32", phase_lm_schemes, smi, lm1)
    timed("33", phase_lm_schemes_held, dev)
    moe_runs = timed("35", phase_moe_schemes, smi, lm1)
    timed("36", phase_moe_schemes_held, dev)
    serve_cli = timed("37", phase_serve_cli, smi)
    psck = timed("38", phase_compressed_checkpoint, smi)
    kept = {}
    pscheck = timed("39", phase_pscheck, smi, train["step_ms_p50"], kept)
    timed("40", phase_numerics, smi, kept)
    del kept
    tune = timed("41", phase_autotune, smi)
    timed("42", phase_lint, smi)
    timed("43", phase_trace_front_end, smi)
    longctx = timed("44", phase_longcontext, smi)
    pscale = timed("45", phase_predicted_scaling, smi)
    conv = timed("46", phase_convergence, smi)

    def moe_launches(counter):
        """Phase 35's launches of one flash entry in each run (8 steps)."""
        return {"launches_moe_schemes": {name: moe_runs[name]["launches"][counter]
                                         for name, _, _ in MOE_SCHEMES}}

    def shard_shapes(part):
        """Phase 34's figures of one kernel at the shapes the LM schemes
        give it (tp, pp, dp_tp_pp; ep_sp's ring hops)."""
        return {case: {"shape": rec["shape"], "max_abs_err": rec["max_abs_err"],
                       **{k: rec[part][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                    "bound_by", "library_ms",
                                                    "library_device_ms")}}
                for case, rec in shard_k.items() if part in rec}

    def shard_times(part):
        """Phase 34's figures at the LM schemes' shapes, phase 32's launches."""
        return {
            "launches_" + scheme: schemes[scheme]["launches"][
                {"fwd": "flash_fwd", "dq": "flash_bwd_dq", "dkv": "flash_bwd_dkv"}[part]]
            for scheme in ("tp", "dp_tp", "pp")} | {"shard_shapes": shard_shapes(part)}

    ring_cases = list(fk.values()) + [rec for case, rec in shard_k.items()
                                      if case.startswith("ep_sp_ring")]

    def flash_entry(name, source, site, part):
        rec = fk["lm1_bf16"][part]
        key = {"partial": ("pv", "m", "l"), "dq": ("dq",), "dkv": ("dk", "dv")}[part]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": f"ps_pytorch_tpu/ops/flash_attention.py:{site}",
            "launches": lm1["launches"][name],
            # phase 14's cases and phase 34's ring hops (the same f32 gradients)
            "max_abs_err": max(c["max_abs_err"][k] for c in ring_cases for k in key),
            "ms": rec["ms"], "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        }
        # the f32 route at LM-1 (cli.train_lm's default dtype), launches
        # from phase 15b
        f32 = fk["lm1_f32"][part]
        entry["f32"] = {
            "launches": lm1_f32["launches"][name],
            "max_abs_err": max(c["max_abs_err"][k] for n_, c in fk.items()
                               if n_.endswith("f32") for k in key),
            **{k: f32[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "library_device_ms")}}
        if part in ("dq", "dkv"):  # the backward at tp, dp_tp, pp and ep_sp's shapes
            entry.update(shard_times(part))
        else:  # ep_sp's ring hops
            entry["shard_shapes"] = shard_shapes(part)
        # phase 35: the MoE schemes (ep_sp's ring takes the partial triple)
        entry.update(moe_launches(name))
        # phase 41: cli.tune --workload lm (2 learning rates x 2 steps)
        entry["launches_cli_tune_lm"] = tune["tune_lm"]["launches"][name]
        # phase 44: the T=8192 long-context check on 8 shards (f32), each head count
        entry["f32"]["launches_longcontext_t8192"] = {
            f"heads{h}": longctx[f"heads{h}"]["launches"][name] for h in (1, 8)}
        return entry

    def probe_launches(k):
        """Phase 41: the K launches of the autotune probes (4 steps each)."""
        return sum(t["probe_launches"][k] for t in tune["top"] if t["probe_launches"])

    def grid_launches(wire, name):
        """Phase 30b's launches of one entry in each gloo process (3 steps),
        and in its NCCL run at world size 1."""
        return {"launches_grid_processes": [la[name] for la in
                                            grid_proc[wire]["two_processes"]["launches"]],
                "launches_grid_nccl_one": grid_proc[wire]["nccl"]["launches"][name]}

    def synced_launches(name):
        """Phase 20c's launches of one entry in each gloo process (3 synced
        CLI steps, 3 synced-local steps)."""
        return {"launches_synced_processes": {run: [c[run]["launches"][name]
                                                    for c in synced_proc["two_processes"]]
                                              for run in ("synced", "local")}}

    def split_entry(name, source, site, rec, wire, absmax, given, **extra):
        """A split route: launches from phase 23's NCCL run of its wire
        (each half once a step; the quantize half is the entry's count),
        phase 24's per process beside them; times at the ResNet18 step."""
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": f"ps_pytorch_tpu/ops/quantize.py:{site}",
            "launches": nccl[wire]["launches_nccl"][given],
            "launches_absmax_half": nccl[wire]["launches_nccl"][absmax],
            "launches_two_processes": [la[given] for la in two[wire]["launches"]],
            "max_abs_err": rec["max_abs_err"],
            **{k: rec[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                   "fused_ms", "fused_device_ms", "halves",
                                   "two_pass_floor_ms")},
            "library_ms": None, **extra,
        }

    kernels = [
        {
            "name": "quantize_kv_write", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/quantize_rows.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:101",
            "launches": serve["launches"]["quantize_kv_write"],
            # phase 37: cli.serve --int8-kv, each run (6 a prefill and a tick)
            "launches_serve_cli": {name: serve_cli[name]["launches"]["quantize_kv_write"]
                                   for name in ("rollover", "abort", "slo_spike")},
            # phase 39: the registry's tapes (serve_decode_int8kv)
            "launches_pscheck": pscheck["kernel_nodes"].get("K1:quantize_kv_write", 0),
            "max_abs_err": max(k1[c]["max_abs_err"] for c in ("prefill", "decode")),
            # a decode tick's write (most of the serve run's launches)
            **{k: k1["decode"][k] for k in ("ms", "device_us", "plain_ms", "bound_ms",
                                            "bound_by")},
            "library_ms": None,
            "empty_launch_device_us": k1["empty_launch_floor"]["device_us"],
            "prefill": {k: k1["prefill"][k] for k in ("ms", "device_us", "plain_ms",
                                                      "bound_ms", "bound_by")},
        },
        {
            "name": "quantize_rows_many", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/quantize_rows.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:101",
            "launches": wires["2round_dequant_block128"]["launches"]["quantize_rows_many"],
            "max_abs_err": k1s["resnet18_round2"]["max_abs_err"],
            **{k: k1s["resnet18_round2"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                     "bound_by")},
            "library_ms": None,
            # phase 30b: the DCN hop's round 2 over one process's workers
            **grid_launches("dequant_block128", "quantize_rows_many"),
            "per_process": grid_proc["kernels"]["k1_round2_30b"],
        },
        {
            "name": "quantize_rows_scaled_many", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/quantize_rows.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:101",
            "launches": train["block128"]["launches"]["quantize_rows_scaled_many"],
            # phases 26-27: the lattice and stochastic round 1 take no kernel
            "launches_adaptive": adapt["launches"]["quantize_rows_scaled_many"],
            "launches_stochastic": {k: stoch[k]["launches"]["quantize_rows_scaled_many"]
                                    for k in ("int8", "2round")},
            # phase 29's block-128 run at 4 MiB buckets (one call a bucket a
            # step), phase 30's hierarchical block-128 dequant run
            "launches_pipelined": overlap["block128"]["launches_pipelined"][
                "quantize_rows_scaled_many"],
            "launches_hier": hier["dequant_block128"]["launches"]["quantize_rows_scaled_many"],
            # phase 30b: the ICI round 1 inside each process's host
            **grid_launches("dequant_block128", "quantize_rows_scaled_many"),
            "launches_autotune_probes": probe_launches("K1"),
            "max_abs_err": max(k1s["max_abs_err"], k1s["resnet18_step"]["max_abs_err"]),
            "ms": k1s["resnet18_step"]["ms"], "plain_ms": k1s["resnet18_step"]["plain_ms"],
            "bound_ms": k1s["resnet18_step"]["bound_ms"],
            "bound_by": k1s["resnet18_step"]["bound_by"], "library_ms": None,
        },
        {
            "name": "quantize_tensors", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/quantize_tensor.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:78",
            "launches": train["launches"]["quantize_tensors"],
            # phase 12b's resumed run (steps 11-15), and phases 18, 19, 21
            "launches_checkpoint_resume": ckpt_rec["resume_launches"]["quantize_tensors"],
            "launches_vgg16": vgg["VGG16"]["launches"]["quantize_tensors"],
            # phase 20b: ResNet18 synced BN under bn_mode local (5 steps)
            "launches_synced_local": synced_local["launches"]["quantize_tensors"],
            "launches_resnet18_bf16": bf16["bf16"]["launches"]["quantize_tensors"],
            "launches_event_stream": events["launches"]["quantize_tensors"],
            # phase 25's run from the CIFAR-10 files; phases 26-27: none
            "launches_data_path": data["launches"]["quantize_tensors"],
            "launches_adaptive": adapt["launches"]["quantize_tensors"],
            "launches_stochastic": {k: stoch[k]["launches"]["quantize_tensors"]
                                    for k in ("int8", "2round")},
            # phase 29's last pipelined int8 run, phase 30's hierarchical dequant run
            "launches_pipelined": overlap["int8"]["launches_pipelined"]["quantize_tensors"],
            "launches_hier": hier["dequant"]["launches"]["quantize_tensors"],
            "launches_config_json": cfg_json["launches"]["quantize_tensors"],
            # phase 38: the --compress-checkpoints run's resumed steps 11-12
            "launches_compressed_resume": psck["resume_launches"],
            # phase 39: the registry's tapes (every int8 / int8_2round spec)
            "launches_pscheck": pscheck["kernel_nodes"].get("K2:quantize_tensors", 0),
            # phase 41: the autotune probes, the best flag line's 2 steps, cli.tune
            "launches_autotune_probes": probe_launches("K2"),
            "launches_autotune_best_run": tune["best_run"]["launches"]["quantize_tensors"],
            "launches_cli_tune": tune["tune"]["launches"]["quantize_tensors"],
            # phase 45: the recorded ResNet18 steps (one a tape node); phase 46:
            # the r04 legs' 20 steps each
            "launches_predicted_scaling": pscale["launches"]["quantize_tensors"],
            "launches_convergence_r04": {name: leg["launches"]["quantize_tensors"]
                                         for name, leg in conv["legs"].items()},
            "max_abs_err": max(r["max_abs_err"] for r in k2.values()),
            "ms": k2["resnet18_step"]["ms"], "plain_ms": k2["resnet18_step"]["plain_ms"],
            "bound_ms": k2["resnet18_step"]["bound_ms"],
            "bound_by": k2["resnet18_step"]["bound_by"], "library_ms": None,
        },
        {
            "name": "accumulate_rescale", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/accum_rescale.cu",
            "replaces": "ps_pytorch_tpu/ops/quantize.py:424",
            "launches": wires["autotune_best"]["launches"]["accumulate_rescale_int8"],
            # phase 26: one a bucket a step, dividing by the device count
            "launches_adaptive": adapt["launches"]["accumulate_rescale_int8"],
            # phase 29's pipelined homomorphic run (one a bucket a step),
            # phase 30's hierarchical homomorphic run (two a piece a step)
            "launches_pipelined": overlap["2round_homomorphic"]["launches_pipelined"][
                "accumulate_rescale_int8"],
            "launches_hier": hier["homomorphic"]["launches"]["accumulate_rescale_int8"],
            # phase 30b: two a step in each process, at the per-process hop shapes
            **grid_launches("homomorphic", "accumulate_rescale_int8"),
            "per_process_hops": {hop: grid_proc["kernels"][f"k3_{hop}_30b"]
                                 for hop in ("ici", "dcn")},
            # phase 31's run from the committed autotune record
            "launches_config_json": cfg_json["launches"]["accumulate_rescale_int8"],
            # phase 39: the registry's tapes (the homomorphic two-round specs)
            "launches_pscheck": pscheck["kernel_nodes"].get("K3:accumulate_rescale_int8", 0),
            # phase 41: the autotune probes and the best flag line's 2 steps
            "launches_autotune_probes": probe_launches("K3"),
            "launches_autotune_best_run": tune["best_run"]["launches"]["accumulate_rescale_int8"],
            "max_abs_err": max(r["max_abs_err"] for r in k3.values()),
            **{k: k3["resnet18_fused"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                    "bound_by")},
            "library_ms": None,
            # phase 11: the grid's hop shapes and the views at odd offsets
            "hop_shapes": {name: k3[name] for name, _, _ in GRID_K3_HOPS},
            "offset_views": {f"offset{o}": k3[f"resnet18_fused_offset{o}"]
                             for o in K3_VIEW_OFFSETS},
        },
        {
            "name": "flash_fwd", "route": "cuda",
            "source": "ps_pytorch_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "ps_pytorch_tpu/ops/flash_attention.py:199",
            "launches": serve["launches"]["flash_fwd"],
            "max_abs_err": k4["prefill_bf16"]["max_abs_err"],
            "ms": k4["prefill_bf16"]["ms"],
            "plain_ms": k4["prefill_bf16"]["plain_ms"],
            "bound_ms": k4["prefill_bf16"]["bound_ms"],
            "bound_by": k4["prefill_bf16"]["bound_by"],
            "library_ms": k4["prefill_bf16"]["library_ms"],
            # the f32 route at the prefill shape; launches from phase 17's
            # f32 Ulysses step
            "f32": {
                "launches": held["ulysses"]["launches"]["flash_fwd"],
                "max_abs_err": max(r["max_abs_err"] for r in k4.values()
                                   if r["dtype"] == "float32"),
                **{k: k4["prefill_f32"][k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "library_device_ms")}},
            # phases 32 and 34: the tp / dp_tp / pp runs and shapes
            **shard_times("fwd"),
            # phase 35: the MoE schemes and the dp_tp_pp library run
            **moe_launches("flash_fwd"),
        },
        split_entry("quantize_tensors_split", "ps_pytorch_tpu_torch/csrc/quantize_tensor.cu",
                    78, split["k2"], "compress", "tensors_absmax", "quantize_tensors_given",
                    # phase 30b's homomorphic round 1, phase 20c's synced runs
                    **grid_launches("homomorphic", "quantize_tensors_given"),
                    **synced_launches("quantize_tensors_given"),
                    per_process=grid_proc["kernels"]["k2_split_20c"]),
        split_entry("quantize_rows_scaled_split", "ps_pytorch_tpu_torch/csrc/quantize_rows.cu",
                    101, split["k1"], "block128", "rows_scaled_absmax",
                    "quantize_rows_scaled_given",
                    # phase 30b's DCN round 1, shared across the processes
                    **grid_launches("dequant_block128", "quantize_rows_scaled_given"),
                    per_process=grid_proc["kernels"]["k1_split_30b"]),
        flash_entry("flash_partial", "ps_pytorch_tpu_torch/csrc/flash_fwd.cu", 199, "partial"),
        flash_entry("flash_bwd_dq", "ps_pytorch_tpu_torch/csrc/flash_bwd.cu", 319, "dq"),
        flash_entry("flash_bwd_dkv", "ps_pytorch_tpu_torch/csrc/flash_bwd.cu", 337, "dkv"),
    ]
    print_phase_seconds(t_main)
    print_captures()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
