#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --wrapper-times   # only the LIF wrappers' host cost
    python3 chip_smoke.py --train-restart   # only phase 12d
    python3 chip_smoke.py --moe-repeat      # only phase 15's MoE repeat
    python3 chip_smoke.py --mesh            # only phase 16
    python3 chip_smoke.py --dryrun          # only phase 17
    python3 chip_smoke.py --flash-backward  # phase 12a's backward, timed
    python3 chip_smoke.py --flash-backward-times    # the timings alone
    python3 chip_smoke.py --flash-backward-split    # their kernels' split
    python3 chip_smoke.py --flash-backward-digests  # unchanged routes' bits
    python3 chip_smoke.py --rope            # the RoPE kernel, held and timed

Phases, each of which fails the run loudly:

1. print the card's name and power limit and the torch/CUDA versions; build
   every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, started together) and print ptxas' report of each kernel
   (registers, static shared memory, spill stores and loads) and every
   spill;
2. hold each kernel against its plain PyTorch version on the card:
   ``link_traffic`` at the reference kernel-test shapes, the PPO rollout
   shape of the main path, a 16x16 torus and a hierarchical mesh — exactly
   on integer weights (partial sums below 2^24), within rtol=1e-5, atol=1e-3
   on float weights; ``delta_cost`` at the reference kernel-test shape, the
   SA path's shape, all-padding rows, R=K=1, a 16x16 torus and a 32x32 mesh
   — exactly on integer volumes, and on the graph's own volumes within 1e-5
   of each chain's sum of absolute terms; ``sa_chains`` (the whole device SA
   in one launch) bit for bit against its plain version, the Python loop,
   on integer-volume graphs whose costs stay below 2^24 (64 chains on the
   8x8 mesh, 16 on the 16x16 mesh whose hop table stays in L2); ``lif`` bit
   for bit at every LIF
   state shape of the Spike-VGG16 and Spike-ResNet18 training paths (batch
   8) and the reference test's shapes, float32 and bfloat16, hard and soft
   reset; ``spike_matmul`` at the im2col shapes of Spike-VGG16's spiking
   convs and the reference sweep, densities 0, 0.15 and 1, and with 75% of
   the input channels silent, within rtol=atol=1e-4 (and within 1e-4 +
   1e-4 x each product's sum of absolute terms), with its count of skipped
   tiles exact, and on float32 weights log-uniform over 1e-3 ... 1e3 and
   on spikes of {0, 0.5, 1, 2}; ``spike_conv``
   against ``F.conv2d`` (TF32 off) at stride 1 and 2; ``flash_attention``
   at the reference sweep's shapes (float32, window None and 37, and the
   bfloat16 case), the served internlm2-1.8b prefill (B4, H16, Hkv 8,
   S2048, D128, bf16, causal), h2o-danube's (H32, Hkv 8, D80, S4608,
   window 4096), S off the 64-row tile, D=256 and non-causal input, and
   the bf16 tensor-core kernel at D = 16, 20, 48, 96, 256, S = 1, 77 and
   4608, windows of 37 and 4096 past S, non-causal, GQA rep 1, 2 and 4,
   within rtol=atol=1e-5 in float32 and 1e-2 in bfloat16, each bf16 call
   counted as a tensor-core launch and no float32 one;
   ``link_traffic_routes`` (the route gather fused into the segment sum)
   exactly on integer volumes at the PPO shape (int64 and int32 pair
   indices), on a degraded 8x8 mesh and on a table with n_links > 8192, and
   on the main path's volumes within rtol=1e-5, atol=1e-3;
   ``lif_backward`` at every LIF state shape of both training paths, hard
   and soft reset: float32 rect bit for bit at alpha 2 and 3, with g_u
   absent, g_s absent and need_s false; sigmoid and atan in float32 within
   rtol=1e-5, atol=1e-6; bfloat16 within 2^-5 of each result's largest
   magnitude;
3. hold ``evaluate_batch(backend="cuda")`` against the numpy float64 backend
   on the main path's graph for 256 random placements, and ``delta_cost``
   over ``swap_tables`` against the numpy ``delta_comm_cost`` along a
   200-swap stream on the same graph;
4. drive the PPO path: ``deploy_model(spike_vgg16(), NoC(8, 8, ...),
   method="ppo", objective="latency")`` with its defaults (``device="cuda"``,
   ``backend="cuda"``, 40 PPO iterations at batch 256); check the plan
   against the host evaluate, and that the scorer launched
   ``link_traffic_routes`` once an iteration (40) and ``link_traffic``
   never;
5. drive the device SA path: the same ``deploy_model`` with ``method="sa",
   backend="device", restarts=64`` (5000 steps): one ``sa_chains`` launch
   and no ``delta_cost`` launch; check the plan against the host evaluate
   and against ``restarts=1``; on the same draws at that shape, hold
   ``sa_chains`` against the loop that launches ``delta_cost`` once a step
   (best slots, best costs and the five trajectories bit-identical; the
   number of identical chains printed) and time both and the plain loop;
   profile one search (the kernel's device time and its share of the
   place stage);
6. drive the device GA (``method="ga", backend="device"``, pop 64, 99
   generations), the multilevel V-cycle on a 1024-node layered DAG over a
   32x32 mesh with a device SA coarse level (its device SA calls counted
   from the recorder's ``sa.device`` events; exactly one ``sa_chains``
   launch per call, no ``delta_cost`` launch), and one short run of each
   host search on the card;
7. drive BPTT training at full width: ``snn.bptt.train_step`` of
   ``spike_vgg16()`` (T=4) at batch 8, 5 steps from one set of seeded
   weights (52 LIF launches a step, and as many LIF backward launches), and
   of ``spike_resnet18()`` (68 a step), 3 steps; loss, wall and launches per
   step and one profiled step each; the same training in six alternating
   turns with the fused backward and with its plain version: step wall
   (median and mean of 12 steps each), kernels per step and busy share of
   each; then each
   first step again through the LIF kernels (forward and backward) and
   through their plain versions with deterministic cuDNN: loss, logits,
   spikes and gradients
   bit-identical (a gradient may differ only behind an op that PyTorch
   reports as nondeterministic on the card, and then within rtol 1e-4,
   atol 1e-6);
8. drive the event-driven conv path: the input spikes of every spiking conv
   of one Spike-VGG16 forward (4 timesteps) through ``kernels.ops.spike_conv``
   (48 launches), each held against the float32 cuDNN conv;
9. time each kernel at its path's shapes beside its bound, its plain version
   and one PyTorch library call where one exists: ``ms``, ``plain_ms`` and
   ``library_ms`` are the per-call time of back-to-back eager calls under
   CUDA events, host overhead included (the definition of every slice);
   ``device_ms``, ``plain_device_ms`` and ``library_device_ms`` are device
   time from CUDA events around replays of a CUDA graph of 100 calls. The
   ``lif``, ``lif_backward`` and ``spike_matmul`` rows sum one Spike-VGG16
   timestep's calls (13 LIF states, with each shape's device time against
   its bound and the wrappers' host microseconds a call; 12 spiking-conv
   products with the path's own spikes). The ``link_traffic_routes`` row
   is one PPO scorer call (the main path's inputs) against PyTorch's
   composite of the gather and ``scatter_add``, with its registers and
   resident blocks per SM; ``link_traffic`` keeps its row at the unfused
   shape with phase 4's count of its launches, 0.
   The ``sa_chains`` row is one whole search at phase 5's shape: ``ms``
   eager, ``device_ms`` CUDA events around one call, the kernel's own
   device time from the profiler and per step, and ptxas' registers,
   shared memory and spills (``delta_cost`` stays in the line with phase
   5's count of its launches, 0: no path runs it now).
   The ``flash_attention`` row is one layer's attention of the served
   prefill, against ``F.scaled_dot_product_attention``, measured after
   phase 10 (10 calls to a graph), with the float32 route (the CUDA-core
   kernel) against float32 SDPA at the smoke configs' prefill shape and at
   the served shape. Both rows add the achieved rate
   (``achieved_tflops``; ``achieved_tb_per_s`` for the bytes-bound
   ``spike_matmul``) and ``vs_library``, device time over the library
   call's; h2o-danube's attention shape is timed on a line of its own;
10. serve LMs at full width through ``launch.serve.generate`` (seeded bf16
    weights, greedy): ``internlm2-1.8b`` (all 24 layers) at batch 4, prompt
    2048, 32 tokens (24 flash launches, all on the tensor-core kernel), and
    ``h2o-danube-1.8b`` cut to 4 layers at batch 1, prompt 4608 (past its
    4096 window), 8 tokens; time to first token, decode per token,
    tokens/s, peak device memory, one profiled prefill (the tensor-core
    kernel's share of its device time) and decode step; the prefill again
    through the attention's plain version
    (last-position logits within relative L2 5e-2) and prefill + decode
    against ``forward`` on the same tokens (the same tolerance);
11. drive the placement front end on the card: ``deploy_model(spike_vgg16(),
    NoC(8, 8, ...), method="policy", objective="latency")`` with its
    defaults (batch 64, 40 iterations: 40 ``link_traffic_routes`` launches,
    no ``link_traffic``, the best latency against the host evaluate within
    rtol 1e-5; the place stage and the policy's sample, score and update
    times); phase 4's PPO with ``device_discretize=True`` (every rollout's
    placements from the resolver on the card equal the numpy resolver's on
    the same cells, 40 calls of 256 x 64; the best plan against the host
    evaluate; whether the history equals phase 4's, demanded only when a
    second host-resolver run repeats phase 4, else the ops PyTorch reports
    as nondeterministic; ``ppo.discretize`` for both resolvers); the PPO
    plan's ``flow_report`` (byte-hops and hottest link equal to the host
    evaluate); ``run_scenario`` at ``benchmarks/fault_replace.py``'s
    configuration with a quarter of its budgets (S-VGG16 on hier 2x2:4x4,
    budget 1024 of 4096, deploy budget 16384 of 65536, threshold 0.02,
    migration weight 0.12, warm t0 0.005, the busiest inter-chip link
    dropped, ``compare_cold=True``), its objectives the
    host evaluate's, identical with the recorder on and off at a sixteenth
    of the budgets (a replacement included), with
    replacements, moved MB, maximum degradation, wall and scorer calls a
    second; the placement service at ``benchmarks/service.py``'s full
    configuration (S-ResNet18 on 4x4, balanced, SA budget 12000): cold, hit
    and warm near-miss p50s, a fused batch of 4 seeds bit-identical to 4
    serial runs, the cache saved, reloaded and hit, one ``POST /deploy`` to
    a localhost server; ``python -m repro_torch.deploy --smoke`` and
    ``report --method sa --backend device`` as subprocesses on the card,
    the report's one device search counted from its trace's ``sa.device``
    events and, in process, one ``sa_chains`` launch per search;
12. LM training: (a) the flash backward kernel against its plain version
    at the trained internlm2-1.8b layer (B2, H16, Hkv 8, S4096, D128, bf16,
    causal), h2o-danube's (B1, H32, D80, S4608, window 4096), the smoke
    configs' float32 shape with and without a window, odd S and D in both
    dtypes, D=256, and the bf16 route past D 128 (the wide tensor-core
    kernels) at D 130, 136, 200, 224, 256 under causal, non-causal and
    windowed masks, GQA 4:1 at D 192, S = 1 and S = 65 (float32 within
    1e-4 of each gradient's largest magnitude, bf16 within relative L2
    2e-2; at S = 1, where dq and dk cancel to rounding, those two as in
    float32), each run twice bit-identical and every bf16 call a
    tensor-core launch, with a digest of its gradients;
    the forward's lse against the plain version's (float32 1e-5, bf16
    1e-4, of 1 + max |lse|) and its output bit-identical with and without
    lse; the backward's times (eager and CUDA-graph device time) against
    its bound, its plain version and the backward of
    ``F.scaled_dot_product_attention`` (its device time from a graph of the
    backward alone), and one call's three kernels under the profiler;
    (b) ``launch.train.main`` at
    internlm2-1.8b's full width and depth, 6 steps of 2 x 4096 tokens:
    each step's synchronised wall, tokens/s, loss and flash launches (48
    forward, all on the tensor cores, and 24 backward calls a step under
    ``remat="full"``) and RoPE kernel launches (96 forward, 48 inverse; as
    ``_rope_calls_a_step`` says in every training run of phases 12, 14,
    15 and 16), losses finite and falling, peak device memory, the
    last step under torch.profiler (busy share, top kernels, the flash
    backward's share); then 2 steps with ``--grad-compression int8_ef``;
    the RoPE kernel bit for bit against its plain version at that step's
    q and k both ways, and timed (the ``rope`` row); (c) one step's loss
    and gradients at full width, depth cut to 2, through the kernels and
    through their plain versions, RoPE's included (every gradient leaf
    within relative L2 5e-2; the RoPE kernel launched on the kernel route
    only); (d) the launcher at the smoke config,
    6 steps straight against 3, a checkpoint and a relaunch to 6, under
    deterministic algorithms: the step-6 checkpoints bit-identical (in a
    child process, ``--train-restart``, which alone gets
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``);
13. serve the MLA and MoE families: first the bf16 flash kernel at the
    three served prefill shapes (minicpm3's D 96 with H = Hkv 40, qwen3's
    D 128 with 32/4 heads, deepseek's D 192 with H = Hkv 128; B4, S2048,
    causal) against its plain version (1e-2) and timed like phase 9's row
    (its ``served_shapes`` entries); then, through
    ``launch.serve.generate`` at batch 4, 2048-token prompts, 32 greedy
    tokens, seeded bf16 weights and the published capacity factor (1.25):
    ``minicpm3-4b`` (62 MLA + dense layers) and ``qwen3-moe-30b-a3b`` (48
    attention + MoE layers, 61 GB of weights drawn in chunks) at full
    width and depth, ``deepseek-v3-671b`` at full width with its depth cut
    61 -> 4 (3 dense MLA layers, 1 MoE layer; its MTP weights drawn).
    Each as phase 10 (one tensor-core flash launch per layer, kernel vs
    plain prefill within relative L2 5e-2, time to first token, decode per
    token, profiled prefill and decode step), and two ``generate`` calls
    must give equal tokens; decode against ``forward`` runs on a dropless
    copy of the MoE configs (capacity factor E/k) at batch 1; the share of
    the prefill's assignments dropped at 1.25; each model's peak device
    memory below the card's; one ``[families]`` JSON line a model;
14. serve and train the recurrent families: the bf16 flash kernel at
    zamba2-2.7b's shared-block prefill shape (B4, H = Hkv 32, S2048, D 160)
    against its plain version (1e-2) and timed as phase 13's shapes; then
    zamba2-2.7b (54 Mamba2 layers and 9 applications of the shared
    attention + MLP block, bf16) and xlstm-125m (12 mLSTM/sLSTM layers,
    float32) at full width and depth through ``launch.serve.generate`` at
    batch 4, 2048-token prompts, 32 greedy tokens, each as phase 13
    (zamba2: one tensor-core flash launch per application, 9 a prefill,
    kernel vs plain on every application's q, k, v and on the logits;
    decode vs ``forward`` over the first 2048 tokens after a 1920-token
    prefill, since the SSD scan takes whole 128-token chunks; xlstm: no
    attention, decode vs ``forward`` within 1e-3 over 2048 tokens in whole
    64-token mLSTM chunks, and printed, not held, after a 2020-token
    prefill, which runs as one chunk), two ``generate`` calls
    equal; then ``launch.train.main`` for 4 steps of each, zamba2 at 2 x
    4096 tokens (``train_4k``, batch cut 256 -> 2), xlstm at 2 x 1024 (its
    host-bound sLSTM loop): losses finite and falling, zamba2
    with 18 forward (9 recomputed under ``remat="full"``) and 9 backward
    flash calls a step, its last step profiled; zamba2's gradients at 12
    Mamba2 layers and 2 applications, 2 x 4096 tokens: with float32
    weights, the kernel route against the plain attention (every leaf
    within relative L2 5e-2); in bf16, each application's flash backward,
    kernel vs plain on the q, k, v, out, dO and lse it got in the kernel
    route (1e-2), beside how far dq, dk, dv move when out and lse come from
    the plain forward, and the model's bf16 kernel-vs-plain gradients
    (printed, not held); the flash backward at D 160 (B2, H32,
    S4096, the wide tensor-core kernels) timed against SDPA's backward
    (``trained_shapes`` of its row). Phases 2 and 12a hold the kernels at
    those D 160 shapes against their plain versions; every training run of
    phases 12, 14 and 15 holds each backward call to be a tensor-core
    launch;
15. the enc-dec family and MLA/MoE training: the bf16 flash kernel at
    seamless-m4t-medium's encoder shape (B4, H = Hkv 16, S2048, D 64,
    non-causal) against its plain version (1e-2) and timed against
    non-causal SDPA (a ``served_shapes`` entry), its backward there
    (tensor cores) within relative L2 2e-2, twice bit-identical;
    seamless-m4t-medium at published width and depth (12 + 12 layers,
    bf16, seeded weights) served by ``encdec.prefill`` + ``decode_step``
    at 4 x (2048 source frames + a 2048-token prompt), 32 greedy tokens:
    36 tensor-core flash launches a prefill (12 encoder, 12 decoder self,
    12 cross), each application's kernel output against the plain version
    on its own q, k, v (1e-2), the last-position logits through the plain
    attention and every decode step's logits against ``decode_train``
    (relative L2 5e-2), two runs equal, time to first token, decode ms, a
    profiled prefill and decode step, peak memory (one ``[encdec]`` JSON
    line); ``launch.train.main`` for 4 steps of 4 x 4096 (2048 frames +
    2048 tokens a row): 72 forward (36 recomputed) and 36 backward flash
    calls a step, losses finite and falling, the last step profiled; its
    gradients at 2 + 2 layers, 2 x 4096, kernel route vs plain with
    float32 weights (every leaf within 5e-2) and each bf16 application's
    backward on its own inputs (1e-2); the non-causal backward timed
    against SDPA's (``trained_shapes``); then ``launch.train.main`` for 4
    steps of 2 x 4096 at full width: minicpm3-4b at full depth (124 / 62
    flash calls a step), qwen3-moe-30b-a3b cut 48 -> 6 layers (12 / 6) and
    deepseek-v3-671b cut 61 -> 3 dense MLA layers with its MTP layer (7 /
    4; its CE falling and its MTP term finite), each step's wall, tokens/s,
    busy share and peak (one JSON line a run); deepseek's trained layer
    (B2, H = Hkv 128, S4096, D 192, causal) through the wide tensor-core
    backward timed against SDPA's backward (``trained_shapes``; its plain
    version untimed, its float32 scores 17 GB a tensor, and held in phase
    12a in slices); qwen3's step twice from the seed under deterministic
    algorithms, every parameter bit-identical (a child process,
    ``--moe-repeat``);
16. training on a device mesh, in a child process (``--mesh``) that joins a
    one-rank NCCL group and builds the 1 x 1 mesh over ``("data",
    "model")``: (a) ``launch.train --mesh 1x1`` at internlm2-1.8b's full
    width, 4 steps of 2 x 4096 tokens (DTensor parameters, a sharded batch,
    the step in a mesh context), 48 forward and 24 backward flash launches
    a step and 96 forward and 48 inverse RoPE launches (the DTensors rotate
    on their local shards), against the unsharded launcher at the same seed
    on the same rows (a sharded batch draws row r from shard r): losses and
    final parameters bit-identical or not, and within relative 1e-6; step
    wall, tokens/s, peak memory and busy share of both, so DTensor's host
    overhead shows; (b) qwen3-moe-30b-a3b at 6 of 48 layers, one forward
    and backward of 2 x 4096 with every ``moe_apply`` on the
    expert-parallel path (an all-to-all on the model axis's group) against
    the single-device path, routes pinned to the latter's: loss and every
    gradient within relative 1e-6 and the dropped assignments of each layer
    identical; (c) internlm2-1.8b at full width, depth cut to 2, laid out
    by ``BASE_RULES``, saved and restored through ``shardings=``, bit for
    bit; (d) ``batch_for_step`` on the mesh against the rows drawn on the
    host, exactly; (e) sequence-parallel attention at phi3-medium-14b's
    attention shape, 1 x 4096 bf16 in 4 sequence shards, each shard through
    ``layers._SeqShardAttention`` (r + 1 flash calls a shard, forward and
    backward) against one kernel call over the whole sequence, within
    ``ATTN_REL_TOL``;
17. the mesh analysed without running it, in a child process
    (``--dryrun``): (a) ``launch.cells.build_cell`` for internlm2-1.8b at
    full width, a 2 x 4096 train step on a 1 x 1 mesh of a one-rank world
    of the ``fake`` backend, traced on fake card tensors
    (``Cell.trace``) unrolled and with its layers folded
    (``models.loop``: three of 24 traced, the middle one counted 22
    times), then the same step for real on a one-rank NCCL mesh, laid out
    alike: the folded trace's flash and RoPE ops, each times its count,
    against the real step's launch counts (equal), its FLOPs against the
    unrolled trace's (equal) and its matrix-product FLOPs against
    ``FlopCounterMode`` on the real step (within relative 1e-6), its
    predicted peak against ``torch.cuda.max_memory_allocated`` (within
    ``DRYRUN_PEAK_TOL``) and its roofline fraction against the measured
    step wall (printed); (b) ``launch.dryrun.run_cell`` at full width on a
    256-rank fake world, the ``(16, 16)`` production mesh, for
    internlm2-1.8b, qwen3-moe-30b-a3b, zamba2-2.7b and xlstm-125m at
    ``train_4k``, folded (each record's summary, trace seconds on the
    host's CPU, ops recorded and the unrolled count they stand for); every
    flash op of internlm2's and qwen3-moe's takes its rank's own query
    heads (1 and 2 of 16 and 32) and the one kv head they read
    (``DRYRUN_FLASH_HEADS``); xlstm-125m's cell on the 512-rank
    ``(2, 16, 16)`` world takes at most ``DRYRUN_XLSTM_MULTIPOD`` of the
    pod record's FLOPs a device (its scans split over (row, head) pairs);
    (c)
    qwen3's traffic graph (``core.gpu_adapter.
    traffic_from_trace``) on ``nvlink_cluster((4, 8))``, 256 GPUs: the
    rank order against ``optimize_device_order`` by simulated annealing
    with the card's scorer, and the repair of
    ``benchmarks/tpu_placement.py``'s scrambled order by the population
    SA. ``dryrun_launches`` in the ``kernels`` line: each kernel's
    launches in (a)'s counted step and (c)'s searches; null for a kernel
    neither runs.

Every path starts with all launch counts set to 0 (the flash kernel's
tensor-core count too) and reads them just after. The ``kernels`` line
lists ``flash_attention_backward`` (phase 12b's launches, phase 12a's
times) beside the eight kernels of the earlier phases.

``--flash-backward`` runs phase 12a's backward sweep alone and times the
backward at every trained shape (``BWD_TIMED``: internlm2-1.8b, qwen3-moe,
minicpm3-4b, seamless's encoder and decoder, zamba2-2.7b, deepseek-v3)
against SDPA's backward, with each kernel's device time a call from the
profiler in a child process (``--flash-backward-split``, which the whole
run starts in phase 12 too). ``--flash-backward-times`` runs those timings
alone; ``--flash-backward-digests`` prints a digest of the gradients at
every sweep case on the routes the wgmma kernels did not change (float32
at every D; bf16 past D 128). Copied into an older checkout, either of the
last two measures that checkout's kernels on the same inputs.

``--rope`` builds the RoPE kernel (ptxas' report), holds it bit for bit
against its plain version at internlm2-1.8b's training shapes (q
``[32, 4096, 16, 128]`` and k ``[32, 4096, 8, 128]``, bf16, positions
``[4096]``, theta 1e6) in both directions, and times both directions there
(eager ms a call under CUDA events, device ms a call from a CUDA graph of
the calls, the profiler's kernel ms) beside their bound (x read once, y
written once at 3.35 TB/s) and the plain version's ms; one ``[rope]`` JSON
line a shape and direction.

``--wrapper-times`` runs nothing but the host microseconds a call of the LIF
wrappers at the 13 Spike-VGG16 state shapes (eager ms minus CUDA-graph
device ms, the same inputs every call), one JSON line per wrapper; it needs
only ``lif_step_kernel`` (``lif_backward_kernel`` where the package has
it), so a copy of this script placed in an older checkout measures that
checkout's wrappers in the same call.
Prints a ``{"kernels": [...]}`` JSON line and, last, ``{"ok": true,
"device": {...}}``. Exits non-zero without a result when CUDA is absent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
FULL_NOC = dict(link_bw=8e9, core_flops=25.6e9, hop_latency=2e-8)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def _route_ids(topo, graph, placements):
    """[B, E*max_hops] int32 link ids and float32 volumes of every edge of
    every placement, as the scorer hands them to the kernel."""
    import numpy as np
    import torch
    from repro_torch.core.noc_batch import batched_noc
    b = batched_noc(topo)
    t = b.tables
    src, dst, vol = graph.edge_arrays()
    P = np.asarray(placements, np.int64)
    ids = t.route_links[P[:, src], P[:, dst]].reshape(P.shape[0], -1)
    w = np.broadcast_to(vol[None, :, None],
                        (P.shape[0], src.size, t.max_hops)).reshape(
                            P.shape[0], -1)
    return (torch.as_tensor(np.ascontiguousarray(ids, np.int32)),
            torch.as_tensor(np.ascontiguousarray(w, np.float32)), t.n_links)


def _scorer_inputs(topo, graph, placements, dev):
    """The fused kernel's inputs as the scorer builds them: ``idx`` [B, E]
    int64 pair indices, the topology's route table [n*n, max_hops] int32 on
    the card, float32 volumes [E], n_links."""
    import numpy as np
    import torch
    from repro_torch.core.noc_batch import batched_noc
    b = batched_noc(topo)
    src, dst, vol = graph.edge_arrays()
    P = np.asarray(placements, np.int64)
    idx = torch.as_tensor(np.ascontiguousarray(
        P[:, src] * b.tables.n_cores + P[:, dst]), device=dev)
    return (idx, b.device_tables(dev).routes,
            torch.as_tensor(vol, dtype=torch.float32, device=dev),
            b.tables.n_links)


def _check_link_traffic_routes(dev, rng, noc, graph):
    """Phase 2, ``link_traffic_routes`` part: the fused route gather and
    segment sum against its plain version, exactly on integer volumes
    (partial sums below 2^24) at the PPO shape (8x8 mesh, B 256, E 310,
    H 14) with int64 and int32 pair indices, on a degraded 8x8 mesh (two
    links and a core dropped, detour routes) and on a synthetic table with
    n_links = 20000 (three tiles of the link axis); and on the main path's
    own volumes (sums above 2^24) within rtol=1e-5, atol=1e-3. Returns
    (that max abs error, the main path's inputs)."""
    import numpy as np
    import torch
    from repro_torch.core import random_dag
    from repro_torch.core.topology import degrade
    from repro_torch.kernels.noc_segsum import (link_traffic_routes,
                                                link_traffic_routes_plain)

    def check(label, idx, routes, vol, n_links, exact=True):
        got = link_traffic_routes(idx, routes, vol, n_links)
        torch.cuda.synchronize()
        want = link_traffic_routes_plain(idx, routes, vol, n_links)
        err = (got - want).abs().max().item()
        ok = (torch.equal(got, want) if exact else
              torch.allclose(got, want, rtol=1e-5, atol=1e-3))
        print(f"[kernel] link_traffic_routes {label} idx "
              f"{str(idx.dtype)[6:]} {tuple(idx.shape)} routes "
              f"{tuple(routes.shape)} -> {n_links}: max_abs_err={err!r} "
              f"({'exact' if exact else 'rtol=1e-5, atol=1e-3'}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"link_traffic_routes disagrees with its "
                                 f"plain version on {label}")
        return err

    main = _scorer_inputs(noc, graph, _random_placements(
        rng, graph.n, noc.n_cores, 256), dev)
    idx, routes, vol, n_links = main
    ints = torch.as_tensor(rng.integers(0, 16, vol.numel()),
                           dtype=torch.float32, device=dev)
    check("PPO shape, integer volumes", idx, routes, ints, n_links)
    check("PPO shape, integer volumes", idx.int(), routes, ints, n_links)
    main_err = check("PPO shape, the graph's volumes", idx, routes, vol,
                     n_links, exact=False)
    bad = degrade(noc, links=(5, 40), nodes=(27,))
    g_bad = random_dag(50, p=0.2, seed=3)
    d_idx, d_routes, _, d_links = _scorer_inputs(
        bad, g_bad, np.stack([rng.permutation(bad.alive_cores())[:g_bad.n]
                              for _ in range(256)]), dev)
    d_ints = torch.as_tensor(rng.integers(0, 16, d_idx.shape[1]),
                             dtype=torch.float32, device=dev)
    check("degraded 8x8 (links 5, 40 and core 27 dropped; a 50-node DAG), "
          "integer volumes", d_idx, d_routes, d_ints, d_links)
    P, H, wide = 4096, 14, 20000
    w_routes = rng.integers(0, wide + 1, (P, H))
    w_routes[:, H // 2:][rng.random((P, H - H // 2)) < 0.5] = wide
    check("synthetic table, n_links > 8192, integer volumes",
          torch.as_tensor(rng.integers(0, P, (64, 310)), device=dev),
          torch.as_tensor(w_routes, dtype=torch.int32, device=dev), ints,
          wide)
    return main_err, main


def _random_placements(rng, n, n_cores, B):
    import numpy as np
    return np.stack([rng.permutation(n_cores)[:n] for _ in range(B)])


def _delta_scale(sb, db, sa, da, vol, hops):
    """[R] sum of |vol * (hops_after - hops_before)| per chain: the float32
    summation error of any order is bounded by a small multiple of it."""
    C = hops.shape[0]
    flat = hops.reshape(-1)
    return (vol * (flat[sa.long() * C + da.long()]
                   - flat[sb.long() * C + db.long()]).abs()).sum(1)


def _time_ms(fn, reps: int = 200, warmup: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check_delta_cost(dev, graph, noc, rng):
    """Phase 2, ``delta_cost`` half: the kernel against its plain version.
    Returns the main path's max abs error on the graph's own volumes."""
    import numpy as np
    import torch
    from repro_torch.core import NoC
    from repro_torch.core.noc_batch import build_incident_tables
    from repro_torch.kernels.delta_cost import delta_cost, delta_cost_plain

    inc = build_incident_tables(graph)
    K_main = 2 * inc.max_degree

    def rand_hops(C):
        return rng.integers(0, 9, (C, C)).astype(np.float32)

    def grid_hops(rows, cols, torus=False):
        return NoC(rows, cols, torus=torus).hops_matrix().astype(np.float32)

    def graph_vols(R, K):
        """Incident volumes of random node pairs, as ``_swap_delta`` lays
        them out: [R, 2 * max_degree] float32 (0 on padding)."""
        nodes = rng.integers(0, graph.n, (R, 2))
        return inc.vol[nodes].reshape(R, -1)[:, :K].astype(np.float32)

    main_hops = noc.hops_matrix().astype(np.float32)
    cases = [("kernel-test (4, 23, 32)", 4, 23, rand_hops(32), None),
             (f"SA path (64, {K_main}, 64)", 64, K_main, main_hops,
              graph_vols(64, K_main)),
             ("all-padding rows (8, 40, 64)", 8, 40, main_hops,
              np.zeros((8, 40), np.float32)),
             ("R=1 K=1 (1, 1, 64)", 1, 1, main_hops, None),
             ("torus 16x16 (64, 32, 256)", 64, 32, grid_hops(16, 16, True),
              None),
             ("mesh 32x32 (1024, 1024, 1024)", 1024, 1024,
              grid_hops(32, 32), None)]
    main_err = None
    for name, R, K, hops, own_vol in cases:
        C = hops.shape[0]
        ids = [torch.as_tensor(rng.integers(0, C, (R, K)), dtype=torch.int32,
                               device=dev) for _ in range(4)]
        hops_d = torch.as_tensor(hops, device=dev)
        kinds = [("int", rng.integers(0, 40, (R, K)).astype(np.float32))]
        if own_vol is not None:
            kinds = [("int", np.round(own_vol / max(own_vol.max(), 1) * 40)
                      .astype(np.float32)), ("graph", own_vol)]
        for kind, vol in kinds:
            args = ids + [torch.as_tensor(vol, device=dev), hops_d]
            got = delta_cost(*args)
            torch.cuda.synchronize()
            want = delta_cost_plain(*args)
            err = (got - want).abs().max().item()
            if kind == "int":
                ok = torch.equal(got, want)
                tol = "exact"
            else:
                scale = _delta_scale(*args)
                ok = bool(((got - want).abs() <= 1e-5 * scale + 1e-6).all())
                tol = (f"<= 1e-5 * sum|terms| (max {scale.max().item()!r}; "
                       f"volumes up to {float(vol.max())!r})")
                if name.startswith("SA path"):
                    main_err = err
            print(f"[kernel] delta_cost {name} {kind} volumes: "
                  f"max_abs_err={err!r} {tol} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"delta_cost disagrees with its plain "
                                     f"version on {name} ({kind} volumes)")
    return main_err


def _check_sa_chains(dev):
    """Phase 2, ``sa_chains`` part: one launch against its plain version
    (the loop with ``delta_cost_plain``) on integer-volume graphs whose
    costs and deltas stay below 2^24, so every float32 sum is exact in any
    order and the two agree bit for bit: 64 chains on the 8x8 mesh (hop
    table in shared memory) and 16 on the 16x16 mesh (C=256, hop table
    read from L2)."""
    import numpy as np
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import topology
    from repro_torch.kernels.delta_cost import (sa_chains, sa_chains_plain,
                                                sa_layout)
    for spec, n, p, R, iters in [("mesh:8x8", 64, 0.1, 64, 1000),
                                 ("mesh:16x16", 120, 0.05, 16, 500)]:
        g = graph_mod.random_dag(n, p=p, seed=n)
        g = graph_mod.LogicalGraph(np.round(g.adj), g.compute, g.memory)
        noc = topology.parse_topology(spec)
        args, kw = _sa_args(g, noc, dev, iters, restarts=R, seed=1)
        got = sa_chains(*args, **kw)
        want = sa_chains_plain(*args, **kw)
        same = _same_chains(got, want)
        top = float(want[2][0].max())
        layout = sa_layout(args[0].shape[1], n, args[3].shape[1],
                           args[6].shape[0])
        print(f"[kernel] sa_chains {spec} (R={R}, {iters} steps, n={n}; "
              f"shared memory {layout[0]} bytes, hops in shared memory "
              f"{layout[1]}, incident tables {layout[2]}): {sum(same)} of {R} "
              f"chains bit-identical to the plain loop (costs up to {top!r} "
              f"< 2^24) {'ok' if all(same) and top < 2 ** 24 else 'MISMATCH'}")
        if not all(same) or top >= 2 ** 24:
            raise AssertionError(f"sa_chains disagrees with its plain version "
                                 f"on {spec}")


def _check_delta_stream(dev, graph, noc, rng, n_swaps: int = 200):
    """Phase 3, second half: ``delta_cost`` over the swap tables of
    ``swap_tables`` along a swap stream, against the numpy
    ``delta_comm_cost``."""
    import torch
    from repro_torch.core.noc_batch import (batched_noc,
                                            build_incident_tables,
                                            delta_comm_cost)
    from repro_torch.kernels.delta_cost import delta_cost, swap_tables

    inc = build_incident_tables(graph)
    hops = batched_noc(noc).tables.hops
    tabs = [torch.as_tensor(inc.other, device=dev),
            torch.as_tensor(inc.vol, dtype=torch.float32, device=dev),
            torch.as_tensor(inc.is_src, device=dev)]
    hops_d = torch.as_tensor(hops, dtype=torch.float32, device=dev)
    slots = rng.permutation(noc.n_cores)
    before = delta_cost.launches
    worst = 0.0
    for _ in range(n_swaps):
        i, j = (int(x) for x in rng.integers(0, slots.size, 2))
        got = delta_cost(*swap_tables(
            torch.as_tensor(slots[None], dtype=torch.int32, device=dev),
            torch.tensor([i], device=dev), torch.tensor([j], device=dev),
            *tabs, graph.n), hops_d).item()
        want = delta_comm_cost(noc, graph, slots, i, j, inc)
        a, b = min(i, graph.n), min(j, graph.n)
        scale = float((inc.vol[a].sum() + inc.vol[b].sum()) * hops.max())
        worst = max(worst, abs(got - want) / max(scale, 1.0))
        if abs(got - want) > 1e-5 * scale + 1e-6:
            raise AssertionError(f"delta_cost {got!r} != delta_comm_cost "
                                 f"{want!r} on swap ({i}, {j})")
        slots[i], slots[j] = slots[j], slots[i]
    if delta_cost.launches - before != n_swaps:
        raise AssertionError("the swap stream did not launch delta_cost "
                             "once per swap")
    print(f"[delta] delta_cost over swap_tables (cuda) vs delta_comm_cost "
          f"(numpy float64) over {n_swaps} swaps on the main path's graph: "
          f"max |err| / (incident volume x max hops) {worst!r} "
          f"(tolerance 1e-5) ok")


# a kernel's counts of its launches on a route or in a direction, beside
# ``launches`` (RoPE's ``backward_launches`` are its inverse rotations)
ROUTE_COUNTS = ("tensor_core", "wgmma", "backward")


def _reset_counts(kernels) -> None:
    for fn in kernels:
        fn.launches = 0
        for route in ROUTE_COUNTS:
            if hasattr(fn, f"{route}_launches"):
                setattr(fn, f"{route}_launches", 0)


def _counts(kernels) -> dict:
    out = {fn.__name__: fn.launches for fn in kernels}
    out.update({f"{fn.__name__}.{route}": getattr(fn, f"{route}_launches")
                for fn in kernels for route in ROUTE_COUNTS
                if hasattr(fn, f"{route}_launches")})
    return out


def _ptxas_report(name: str, log: str) -> list:
    """One line per kernel of ptxas' report in ``log``: registers, static
    shared memory, spill stores and loads (dynamic shared memory is set at
    launch). Returns one dict per kernel: its short name, registers, static
    shared memory and spills."""
    import re
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"fn": m.group(1)}
            entries.append(cur)
        elif cur is not None:
            if "spill stores" in line:
                st = re.search(r"(\d+) bytes spill stores", line)
                ld = re.search(r"(\d+) bytes spill loads", line)
                cur["spill"] = (int(st.group(1)), int(ld.group(1)))
            if "registers" in line:
                r = re.search(r"Used (\d+) registers", line)
                sm = re.search(r"(\d+) bytes smem", line)
                cur["regs"] = int(r.group(1))
                cur["smem"] = int(sm.group(1)) if sm else 0
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            e["fn"] for e in entries), capture_output=True, text=True,
            check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = [e["fn"] for e in entries]
    report = []
    for e, fn in zip(entries, names):
        st, ld = e.get("spill", (0, 0))
        short = re.sub(r"\(.*\)$", "", fn.replace("(anonymous namespace)::",
                                                  ""))
        print(f"[build] {name}: {short}: {e.get('regs')} registers, "
              f"{e.get('smem', 0)} bytes static smem, spill stores {st} "
              f"bytes, spill loads {ld} bytes")
        report.append({"kernel": short, "registers": e.get("regs"),
                       "static_smem": e.get("smem", 0), "spill_stores": st,
                       "spill_loads": ld})
    return report


def _sa_path(vgg, noc, kernels):
    """Phase 5: ``deploy_model`` through the device SA at restarts=64 (one
    ``sa_chains`` launch, no ``delta_cost`` launch) and 1, the kernel against
    the loop that launches ``delta_cost`` once a step on the same draws, and
    a profile of one search. Returns (launches, plan, check)."""
    import torch
    from repro_torch.core.noc_batch import validate_placements
    from repro_torch.deploy import deploy_model
    from repro_torch.obs import Recorder

    iters = 5000
    rec = Recorder()
    _reset_counts(kernels)
    t0 = time.perf_counter()
    plan = deploy_model(vgg, noc, method="sa", backend="device", restarts=64,
                        recorder=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(kernels)
    res = plan.placement
    print("[sa] report " + json.dumps(plan.report()))
    print(f"[sa] deploy_model(method='sa', backend='device', restarts=64): "
          f"wall {wall!r} s; place stage {plan.stage_times_s['place']!r} s "
          f"= {plan.stage_times_s['place'] / iters * 1e3!r} ms per step "
          f"over {iters} steps; stage times "
          f"{json.dumps(plan.stage_times_s)}; launches {launches}")
    if launches["sa_chains"] != 1 or launches["delta_cost"] != 0:
        raise AssertionError(f"SA path launched sa_chains "
                             f"{launches['sa_chains']} times and delta_cost "
                             f"{launches['delta_cost']} times, not 1 and 0")
    validate_placements(noc, res.placement, plan.graph.n)
    summary = [e["attrs"] for e in rec.events if e["name"] == "sa.device"]
    steps = [e for e in rec.events if e["name"] == "sa.iter"]
    if len(summary) != 1 or len(steps) != iters:
        raise AssertionError("SA recorder replay is incomplete")
    dev_best = summary[0]["best_cost"]
    if not math.isclose(dev_best, res.comm_cost, rel_tol=1e-4):
        raise AssertionError(f"winning chain's float32 best cost "
                             f"{dev_best!r} != host evaluate "
                             f"{float(res.comm_cost)!r} (rtol 1e-4)")
    print(f"[sa] winning chain {summary[0]['best_chain']}: device best cost "
          f"{dev_best!r} (float32) vs host evaluate {float(res.comm_cost)!r}; "
          f"mean chain best {summary[0]['chain_best_mean']!r} ok")
    t0 = time.perf_counter()
    one = deploy_model(vgg, noc, method="sa", backend="device", restarts=1)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    c1 = float(one.placement.comm_cost)
    if c1 < res.comm_cost * (1 - 1e-4):
        raise AssertionError(f"restarts=1 comm cost {c1!r} beats "
                             f"restarts=64 {float(res.comm_cost)!r}")
    print(f"[sa] restarts=1: comm cost {c1!r} (wall {wall1!r} s, place "
          f"{one.stage_times_s['place']!r} s) >= restarts=64 "
          f"{float(res.comm_cost)!r} ok")
    check = _check_sa_chains_vs_loop(plan.graph, noc, iters)
    _profile_sa_search(plan.graph, noc, iters, plan.stage_times_s["place"])
    return launches, plan, check


def _sa_args(graph, noc, dev, iters, restarts=64, refresh_every=256, seed=0):
    """The device SA's ``_sa_chains`` arguments for one search, with
    ``simulated_annealing_device``'s defaults."""
    from repro_torch.core.placement import device_search
    return device_search._sa_setup(
        graph, noc, iters=iters, t0=0.05, t_end_frac=1e-3, seed=seed,
        init=None, restarts=restarts, t0_spread=1.0,
        refresh_every=refresh_every, device=dev)


def _same_chains(got, want) -> list:
    """Per chain: best slots, best cost and all five trajectory columns
    bit-identical between two ``sa_chains`` results."""
    same = (got[0] == want[0]).all(dim=1) & (got[1] == want[1])
    for a, b in zip(got[2], want[2]):
        same &= (a == b).all(dim=0)
    return same.tolist()


def _check_sa_chains_vs_loop(graph, noc, iters):
    """Phase 5: ``sa_chains`` (one launch) against the plain loop launching
    the standalone ``delta_cost`` kernel once a step, on the same draws at
    the SA path's shape (64 chains, ``iters`` steps): bit-identical best
    slots, best costs and trajectories. Times both, and the plain loop with
    ``delta_cost_plain`` (the kernel's plain version)."""
    import torch
    from repro_torch.kernels.delta_cost import (delta_cost, delta_cost_plain,
                                                sa_chains, sa_chains_plain)
    dev = torch.device("cuda")
    args, kw = _sa_args(graph, noc, dev, iters)
    runs = {}
    for label, fn in [
            ("kernel", lambda: sa_chains(*args, **kw)),
            ("loop+delta_cost", lambda: sa_chains_plain(
                *args, delta_fn=delta_cost, **kw)),
            ("plain", lambda: sa_chains_plain(*args, delta_fn=delta_cost_plain,
                                              **kw))]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        runs[label] = (out, start.elapsed_time(end))
    got, want = runs["kernel"][0], runs["loop+delta_cost"][0]
    same = _same_chains(got, want)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip((got[1], *got[2]), (want[1], *want[2])))
    plain_same = sum(_same_chains(got, runs["plain"][0]))
    print(f"[sa-check] sa_chains vs the loop launching delta_cost once a step "
          f"(64 chains, {iters} steps, the same draws): {sum(same)} of "
          f"{len(same)} chains bit-identical (best slots, best cost and the "
          f"five trajectories); max abs difference {err!r}; sa_chains "
          f"{runs['kernel'][1]!r} ms, loop+delta_cost "
          f"{runs['loop+delta_cost'][1]!r} ms, plain loop (delta_cost_plain) "
          f"{runs['plain'][1]!r} ms (CUDA events, one call each); against the "
          f"plain loop {plain_same} of {len(same)} chains bit-identical "
          f"(its row sums add in another order)")
    if not all(same):
        raise AssertionError(f"sa_chains differs from the delta_cost loop in "
                             f"{len(same) - sum(same)} chains")
    return dict(args=args, kw=kw, max_abs_err=err,
                ms=runs["kernel"][1], loop_kernel_ms=runs["loop+delta_cost"][1],
                plain_ms=runs["plain"][1], chains_identical=sum(same))


def _profile_sa_search(graph, noc, iters, place_s):
    """torch.profiler over one device SA search at restarts=64: the
    ``sa_chains`` kernel's device time, its share of phase 5's place stage,
    and the host-clock wall and device work around it."""
    import torch
    from repro_torch.core.placement import device_search
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    device_search.simulated_annealing_device(graph, noc, iters=20,
                                             restarts=64)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        device_search.simulated_annealing_device(graph, noc, iters=iters,
                                                 restarts=64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us == 0.0:
        print(f"[sa-profile] {iters} steps: wall {wall!r} s; device time "
              "not measured (the profiler recorded no device events)")
        return
    n_kernels = sum(e.count for e in kernels)
    sa_us = sum(e.self_device_time_total for e in kernels
                if "sa_chains" in e.key)
    print(f"[sa-profile] one search, {iters} steps at restarts=64 (whole "
          f"call, set-up included): wall {wall!r} s; device kernel time "
          f"{dev_us / 1e6!r} s (busy share {dev_us / 1e6 / wall!r}); "
          f"{n_kernels} kernels; sa_chains {sa_us / 1e3!r} ms = "
          f"{sa_us / iters!r} us per step, {sa_us / 1e6 / place_s!r} of "
          f"phase 5's place stage ({place_s!r} s)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"[sa-profile] kernel x{e.count} "
              f"{e.self_device_time_total / 1e3:.4f} ms {e.key[:90]}")
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"[sa-profile] host op x{e.count} "
              f"{e.self_cpu_time_total / 1e3:.3f} ms self CPU {e.key}")


def _other_paths(vgg, noc, graph, kernels):
    """Phase 6: device GA, multilevel on a 1024-node DAG, host searches."""
    import numpy as np
    import torch
    from repro_torch.core import LogicalGraph, NoC
    from repro_torch.core.graph import layered_dag
    from repro_torch.core.noc_batch import validate_placements
    from repro_torch.core.placement import optimize_placement, zigzag
    from repro_torch.deploy import deploy_model
    from repro_torch.obs import Recorder

    _reset_counts(kernels)
    t0 = time.perf_counter()
    ga = deploy_model(vgg, noc, method="ga", backend="device")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    validate_placements(noc, ga.placement.placement, ga.graph.n)
    zig = float(noc.evaluate(ga.graph, zigzag(ga.graph.n, noc)).comm_cost)
    if ga.placement.comm_cost > zig:
        raise AssertionError(f"device GA {float(ga.placement.comm_cost)!r} is worse "
                             f"than zigzag {zig!r}")
    print(f"[ga] deploy_model(method='ga', backend='device') pop 64, 99 "
          f"generations: comm cost {float(ga.placement.comm_cost)!r} <= zigzag "
          f"{zig!r}; wall {wall!r} s, place {ga.stage_times_s['place']!r} s; "
          f"launches {_counts(kernels)} ok")

    # the 1024-node layered DAG of the multilevel benchmark, ids shuffled
    g = layered_dag(32, 32, seed=0)
    perm = np.random.default_rng(1).permutation(g.n)
    big = LogicalGraph(g.adj[np.ix_(perm, perm)], g.compute[perm],
                       g.memory[perm])
    mesh = NoC(32, 32)
    rec = Recorder()
    _reset_counts(kernels)
    t0 = time.perf_counter()
    ml = optimize_placement(big, mesh, method="multilevel", backend="device",
                            coarsen_to=64, refine_iters=3, iters=2000,
                            recorder=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(kernels)
    validate_placements(mesh, ml.placement, big.n)
    # each device SA call replays one sa.device summary event
    sa_calls = sum(e["name"] == "sa.device" for e in rec.events)
    if sa_calls < 1 or launches["sa_chains"] != sa_calls or \
            launches["delta_cost"] != 0:
        raise AssertionError(f"multilevel made {sa_calls} device SA calls "
                             f"and launched sa_chains "
                             f"{launches['sa_chains']} and delta_cost "
                             f"{launches['delta_cost']} times")
    print(f"[ml] multilevel (device SA coarse level, 2000 steps) on {big.n} "
          f"nodes over 32x32: comm cost {float(ml.comm_cost)!r}; wall {wall!r} "
          f"s; {sa_calls} coarse SA calls, sa_chains launches "
          f"{launches['sa_chains']} (one per call); launches {launches} ok")

    for method, kw in [("random_search", dict(budget=200)),
                       ("simulated_annealing", dict(budget=300)),
                       ("greedy", {}),
                       ("population_random_search",
                        dict(budget=256, pop_size=64)),
                       ("population_simulated_annealing",
                        dict(budget=640, pop_size=16)),
                       ("genetic", dict(budget=640, pop_size=32))]:
        t0 = time.perf_counter()
        r = optimize_placement(graph, noc, method=method, **kw)
        validate_placements(noc, r.placement, graph.n)
        if not math.isfinite(r.comm_cost):
            raise AssertionError(f"{method}: comm cost is not finite")
        print(f"[host] {method} {kw} (backend cuda): valid, comm cost "
              f"{float(r.comm_cost)!r}, {time.perf_counter() - t0!r} s ok")


def _kernel_device_ms(fn, name: str, reps: int = 3) -> float | None:
    """Device time of the kernels whose name holds ``name``, per call of
    ``fn``, from torch.profiler over ``reps`` calls (None when it records
    no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name in e.key)
    return us / 1e3 / reps if us else None


def _time_sa_chains(check, launches, ptxas, card):
    """Phase 9, ``sa_chains`` row, at the SA path's shape (64 chains, 5000
    steps, the Spike-VGG16 graph on the 8x8 mesh): eager per-call time,
    CUDA events around one whole search, the kernel's own device time from
    the profiler and per step, the bound, and ptxas' registers, shared
    memory and spills."""
    import torch
    from repro_torch.kernels.delta_cost import (CHAINS_PER_BLOCK, sa_chains,
                                                sa_layout)
    args, kw = check["args"], check["kw"]
    slots0, hops, inc_other, e_src = args[0], args[6], args[3], args[7]
    (R, S), C, D, E = slots0.shape, hops.shape[0], inc_other.shape[1], \
        e_src.shape[0]
    iters, n, refresh = kw["iters"], kw["n"], kw["refresh_every"]

    def call():
        return sa_chains(*args, **kw)
    ms = _time_ms(call, reps=5, warmup=1)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    call()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end)
    kernel_ms = _kernel_device_ms(call, "sa_chains")
    n_bytes = (R * iters * (4 + 4 + 4)          # draws i, j, u read once
               + R * iters * (3 * 4 + 2)        # trajectories written once
               + 2 * R * S * 4 + 2 * R * 4      # slots0, best_slots; t0, best
               + C * C * 4 + (n + 1) * D * 9 + E * 12)
    n_ops = R * iters * 3 * 2 * D + R * (iters // refresh + 1) * 2 * E
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    us_step = None if kernel_ms is None else kernel_ms * 1e3 / iters
    cycles = None if us_step is None else us_step * float(clock)  # us x MHz
    regs = [e for e in ptxas if "sa_chains" in e["kernel"]]
    row = {
        "name": "sa_chains", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_cost.cu",
        "replaces": "src/repro/kernels/delta_cost.py:67",
        "replaces_loop": "src/repro/core/placement/device_search.py:145",
        "launches": launches, "max_abs_err": check["max_abs_err"],
        "ms": ms, "plain_ms": check["plain_ms"],
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "device_ms": device_ms,
        "kernel_device_ms": kernel_ms, "us_per_step": us_step,
        "cycles_per_step_at_max_clock": cycles,
        "loop_with_delta_cost_ms": check["loop_kernel_ms"],
        "chains_identical_to_loop": check["chains_identical"],
        "chains_per_block": CHAINS_PER_BLOCK,
        "dynamic_smem": sa_layout(S, n, D, C)[0], "ptxas": regs,
        "calls": f"one search: {R} chains x {iters} steps, Spike-VGG16 "
                 f"({n} slices) on the 8x8 mesh",
    }
    print(f"[time] sa_chains ({R} chains, {iters} steps, n={n}, D={D}, "
          f"C={C}, E={E}): per call {ms!r} ms, one search under CUDA events "
          f"{device_ms!r} ms, kernel device {kernel_ms!r} ms = {us_step!r} us "
          f"per step ({cycles!r} cycles at the max SM clock {clock} MHz); "
          f"{CHAINS_PER_BLOCK} chains a block; plain loop "
          f"{check['plain_ms']!r} ms, "
          f"loop with delta_cost {check['loop_kernel_ms']!r} ms; bound "
          f"{row['bound_ms']!r} ms ({n_bytes} bytes, {n_ops} flops); "
          f"ptxas {regs}; no single PyTorch call computes this function "
          f"(library_ms null); card {card}")
    return row


def _time_link_traffic_routes(main, launches, err, ptxas, card):
    """Phase 9, ``link_traffic_routes`` row, at the PPO rollout shape with
    the main path's own inputs (int64 pair indices, as the scorer builds
    them): the kernel, its plain version and PyTorch's own composite (the
    route gather, then ``torch.scatter_add`` into n_links + 1 bins, with the
    per-hop volumes built once outside the timing); the kernel's registers
    (ptxas) and resident blocks per SM (CUDA's occupancy calculator)."""
    import torch
    from repro_torch.kernels.noc_segsum import (link_traffic_routes,
                                                link_traffic_routes_plain,
                                                routes_occupancy)
    idx, routes, vol, n_links = main
    (B, E), H = idx.shape, routes.shape[1]
    routes64 = routes.long()
    w_hops = vol[None, :, None].expand(B, E, H).reshape(B, -1).contiguous()
    base = torch.zeros(B, n_links + 1, device=idx.device)
    fns = (lambda: link_traffic_routes(idx, routes, vol, n_links),
           lambda: link_traffic_routes_plain(idx, routes, vol, n_links),
           lambda: torch.scatter_add(base, 1, routes64[idx].view(B, -1),
                                     w_hops))
    dev_ms = [_graph_ms(f) for f in fns]
    ms = [_time_ms(f) for f in fns]
    # bytes this call must move: idx once, the route rows it names once
    # (L2-resident across the B rows), vol, the output; one add per hop
    # that lands on a link
    rows_touched = int(torch.unique(idx).numel())
    n_bytes = (idx.numel() * idx.element_size() + rows_touched * H * 4
               + E * 4 + B * n_links * 4)
    n_ops = int((routes[idx] < n_links).sum().item())
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    regs = [e["registers"] for e in ptxas
            if "link_traffic_routes_kernel<long long>" in e["kernel"]]
    blocks = routes_occupancy(idx.dtype, E, n_links)
    threads = min(512, 32 * max(2, -(-E // 32)))
    row = {
        "name": "link_traffic_routes", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/noc_segsum.cu",
        "replaces": "src/repro/kernels/noc_segsum.py:54",
        "note": "link_traffic_pallas with the route gather that feeds it "
                "(src/repro/core/noc_batch.py:527) fused in",
        "launches": launches, "max_abs_err": err,
        "ms": ms[0], "plain_ms": ms[1], "bound_ms": max(tb, to) * 1e3,
        "bound_by": "bytes" if tb >= to else "operations",
        "library_ms": ms[2], "device_ms": dev_ms[0],
        "plain_device_ms": dev_ms[1], "library_device_ms": dev_ms[2], "library_device_ms": dev_ms[2],
        "library": "routes[idx] then torch.scatter_add (two launches)",
        "registers": regs[0] if regs else None,
        "threads_per_block": threads, "blocks_per_sm": blocks,
        "resident_warps_per_sm": blocks * threads // 32,
    }
    print(f"[time] link_traffic_routes idx {tuple(idx.shape)} int64, routes "
          f"{tuple(routes.shape)} -> {n_links}: kernel {ms[0]!r} ms, plain "
          f"{ms[1]!r} ms, gather + scatter_add {ms[2]!r} ms (per call); "
          f"device {dev_ms[0]!r}, {dev_ms[1]!r}, {dev_ms[2]!r} ms; bound "
          f"{row['bound_ms']!r} ms ({n_bytes} bytes: {rows_touched} route "
          f"rows touched; {n_ops} adds); {row['registers']} registers, "
          f"{threads} threads a block, {blocks} blocks ("
          f"{row['resident_warps_per_sm']} warps) resident per SM of 64 "
          f"warps, {B} blocks on 132 SMs; card {card}")
    return row


def _profile_calls(fn, label: str, kernel: str, reps: int = 5) -> dict:
    """torch.profiler over ``reps`` calls of ``fn``: the device time a call
    of each kernel whose name holds ``kernel``, by name. Returns ``{kernel
    name: ms a call}``, or None when no device events came back."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    own = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and kernel in e.key
           and e.self_device_time_total > 0]
    if not own:
        print(f"[{label}-profile] {reps} calls: device time not measured "
              "(the profiler recorded no device events)")
        return None
    split = {re.search(rf"\w*{kernel}\w*(<[^>]*>)?", e.key).group(0):
             e.self_device_time_total / 1e3 / reps for e in own}
    print(f"[{label}-profile] device ms a call over {reps} calls, by "
          f"kernel: {json.dumps(split)}")
    return split


def _graph_ms(fn, reps: int = 100, replays: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times under CUDA events. Host overhead
    (Python, argument checks, launch calls) is left out."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)

# ---- the SNN slice: LIF and spike-matmul kernels, BPTT training ---------------

REFERENCE_LIF_SHAPES = [(128,), (7, 13), (2, 9, 9, 8), (256, 128)]
REFERENCE_MM_SHAPES = [(32, 64, 16), (70, 200, 90), (128, 384, 256),
                       (1, 128, 128)]


def _lif_state_shapes(cfg, batch: int = 8):
    """NCHW shapes of every LIF state of ``cfg`` at ``batch``, in the order
    a timestep visits them."""
    from repro_torch.snn.models import _shapes
    return [(b, c, h, w) for (b, h, w, c) in _shapes(cfg, batch).values()]


def _vgg_conv_shapes(cfg, batch: int = 8):
    """(name, M, K, N, stride) of the im2col product of each spiking conv of
    Spike-VGG16 (every conv but the analog stem)."""
    from repro_torch.snn.models import ConvBNLif, MaxPool
    out, h = [], cfg.in_res
    for b in cfg.blocks:
        if isinstance(b, MaxPool):
            h = -(-h // b.stride)
        elif isinstance(b, ConvBNLif):
            out.append((b.name, batch * h * h, b.k * b.k * b.cin, b.cout))
    return out[1:]


def _mm_scale(spikes, w):
    """|spikes| @ |w|, each product's sum of absolute terms: the float32
    error of any summation order is bounded by a small multiple of it.
    ``spike_matmul`` is held to rtol=atol=1e-4 of the plain result and,
    relative to this scale, to |got - want| <= 1e-4 + 1e-4 * scale."""
    import torch
    return torch.matmul(spikes.float().abs(), w.float().abs())


def _check_lif(dev, rng, vgg, resnet):
    """Phase 2, ``lif`` part: the kernel against its plain version, bit for
    bit, at every LIF state shape of the two training paths (batch 8) and
    the reference kernel test's shapes, hard and soft reset, float32 and
    bfloat16."""
    import numpy as np
    import torch
    from repro_torch.kernels.lif import lif_step_kernel, lif_step_plain
    shapes = sorted(set(_lif_state_shapes(vgg) + _lif_state_shapes(resnet))
                    | set(REFERENCE_LIF_SHAPES), key=lambda s: -math.prod(s))
    n_cases = 0
    for shape in shapes:
        n = math.prod(shape)
        base = [rng.standard_normal(n) * 1.5, rng.random(n) < 0.3,
                rng.standard_normal(n)]
        for dtype in (torch.float32, torch.bfloat16):
            u, s, c = (torch.as_tensor(a.astype(np.float32), device=dev)
                       .to(dtype).reshape(shape) for a in base)
            for reset in ("hard", "soft"):
                got = lif_step_kernel(u, s, c, reset=reset)
                torch.cuda.synchronize()
                want = lif_step_plain(u, s, c, reset=reset)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"lif kernel != plain at {shape} "
                                         f"{dtype} {reset}")
                n_cases += 1
    print(f"[kernel] lif: bit-identical to its plain version in {n_cases} "
          f"cases ({len(shapes)} shapes from {shapes[0]} to {shapes[-1]}, "
          "float32 and bfloat16, hard and soft reset) ok")
    return 0.0


def _check_lif_backward(dev, rng, vgg, resnet):
    """Phase 2, ``lif_backward`` part: the fused backward against its plain
    version at every LIF state shape of the two training paths (batch 8),
    hard and soft reset: float32 rect bit for bit at alpha 2 and 3 with
    every cotangent present; with ``g_u`` absent, with ``g_s`` absent, and
    with ``need_s`` false, bit for bit; sigmoid and atan in float32 within
    rtol=1e-5, atol=1e-6; bfloat16 (rect, sigmoid, atan) within 2^-5 of
    each result's largest magnitude. Returns the path's max abs error
    (float32 rect)."""
    import numpy as np
    import torch
    from repro_torch.kernels.lif import (lif_backward_kernel,
                                         lif_backward_plain, lif_step_plain)
    shapes = sorted(set(_lif_state_shapes(vgg) + _lif_state_shapes(resnet)),
                    key=lambda s: -math.prod(s))
    n_exact = n_tol = n_tol_same = 0
    worst = {}
    for shape in shapes:
        n = math.prod(shape)
        raw = [rng.standard_normal(n), rng.standard_normal(n),
               rng.standard_normal(n) * 1.5, rng.random(n) < 0.3,
               rng.standard_normal(n)]
        for dtype in (torch.float32, torch.bfloat16):
            gu, gs, u, s, c = (torch.as_tensor(a.astype(np.float32),
                                               device=dev).to(dtype)
                               .reshape(shape) for a in raw)
            un = lif_step_plain(u, s, c)[0]
            for reset in ("hard", "soft"):
                cases = []
                if dtype == torch.float32:
                    cases += [("exact", (gu, gs), dict(alpha=a))
                              for a in (2.0, 3.0)]
                    cases += [("exact", (None, gs), {}),
                              ("exact", (gu, None), {}),
                              ("exact", (gu, gs), dict(need_s=False))]
                    cases += [("tol", (gu, gs), dict(surrogate=k))
                              for k in ("sigmoid", "atan")]
                else:
                    cases += [("tol", (gu, gs), dict(surrogate=k))
                              for k in ("rect", "sigmoid", "atan")]
                for kind, cot, kw in cases:
                    kw = dict(kw, reset=reset)
                    got = lif_backward_kernel(*cot, u, s, un, **kw)
                    torch.cuda.synchronize()
                    want = lif_backward_plain(*cot, u, s, un, **kw)
                    label = (f"{shape} {str(dtype)[6:]} {reset} "
                             f"{kw.get('surrogate', 'rect')} "
                             f"{'g_u' if cot[0] is not None else '-'}/"
                             f"{'g_s' if cot[1] is not None else '-'} "
                             f"{kw}")
                    pairs = [(a, b) for a, b in zip(got, want)
                             if b is not None]
                    if (len(pairs) != sum(b is not None for b in got)
                            or any(a.dtype != dtype for a, _ in pairs)):
                        raise AssertionError(f"lif_backward returned other "
                                             f"outputs than plain: {label}")
                    if kind == "exact":
                        if not all(torch.equal(a, b) for a, b in pairs):
                            raise AssertionError(
                                f"lif_backward kernel != plain at {label}")
                        n_exact += 1
                        continue
                    key = (str(dtype)[6:], kw["surrogate"])
                    for a, b in pairs:
                        a, b = a.float(), b.float()
                        err = (a - b).abs().max().item()
                        worst[key] = max(worst.get(key, 0.0), err)
                        if dtype == torch.float32:
                            ok = torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                        else:
                            ok = err <= 2**-5 * b.abs().max().item()
                        if not ok:
                            raise AssertionError(
                                f"lif_backward outside its tolerance at "
                                f"{label}: max_abs_err {err!r}")
                    n_tol += 1
                    n_tol_same += all(torch.equal(a, b) for a, b in pairs)
    print(f"[kernel] lif_backward: bit-identical to its plain version in "
          f"{n_exact} float32 cases ({len(shapes)} shapes from {shapes[0]} "
          f"to {shapes[-1]}, hard and soft reset, rect at alpha 2 and 3, "
          f"g_u absent, g_s absent, need_s false) ok")
    worst = {f"{d}/{k}": v for (d, k), v in worst.items()}
    print(f"[kernel] lif_backward: {n_tol} cases within tolerance (sigmoid "
          f"and atan in float32, rtol=1e-5 atol=1e-6; rect, sigmoid and atan "
          f"in bfloat16, 2^-5 of the largest magnitude), {n_tol_same} of "
          f"them bit-identical; max_abs_err by dtype/surrogate {worst} ok")
    return 0.0


def _conv_weights(rng, shape):
    """float32 N(0, 1/3) draws: the 3x3 conv weights' initial scale."""
    import numpy as np
    return (rng.standard_normal(shape) / np.sqrt(3)).astype(np.float32)


def _check_spike_matmul(dev, rng, vgg):
    """Phase 2, ``spike_matmul`` part: the kernel against its plain version
    (float32 cuBLAS, TF32 off) at the im2col shapes of Spike-VGG16's
    spiking convs and the reference sweep, densities 0, 0.15 and 1;
    float32 weights over six decades and spikes of {0, 0.5, 1, 2}; a
    structured case with 75% silent input channels; the kernel's own count
    of skipped tiles against the count the spikes imply; ``spike_conv``
    against ``F.conv2d`` (TF32 off) at stride 1 and 2."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.spike_matmul import (spike_matmul_kernel,
                                                  spike_matmul_plain,
                                                  zero_tiles)
    from repro_torch.snn import layers

    def check(label, sp, w):
        skipped = torch.zeros(1, dtype=torch.int64, device=dev)
        got = spike_matmul_kernel(sp, w, skipped=skipped)
        torch.cuda.synchronize()
        want = spike_matmul_plain(sp, w)
        scale = _mm_scale(sp, w)
        err = (got - want).abs()
        ratio = (err / (1e-4 + 1e-4 * scale)).max().item()
        outside = int((err > 1e-4 + 1e-4 * want.abs()).sum().item())
        n_skip, expect = int(skipped.item()), zero_tiles(sp, w.shape[1])
        ok = outside == 0 and ratio <= 1 and n_skip == expect
        print(f"[kernel] spike_matmul {label}: max_abs_err="
              f"{err.max().item()!r}, {outside} of {err.numel()} outside "
              f"rtol=atol=1e-4, max err / (1e-4 + 1e-4 sum|terms|) {ratio!r}; "
              f"skipped tiles {n_skip} (spikes imply {expect}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"spike_matmul disagrees on {label}")

    shapes = [(f"VGG {name}", M, K, N)
              for name, M, K, N in _vgg_conv_shapes(vgg)]
    shapes += [(f"reference {m}x{k}x{n}", m, k, n)
               for m, k, n in REFERENCE_MM_SHAPES]
    for label, M, K, N in shapes:
        w = torch.as_tensor(_conv_weights(rng, (K, N)), device=dev)
        for density in (0.0, 0.15, 1.0):
            sp = torch.as_tensor((rng.random((M, K)) < density)
                                 .astype(np.float32), device=dev)
            check(f"{label} ({M}, {K}, {N}) density {density}", sp, w)
    # float32 weights over six decades, which a single bf16 pass of the
    # weights would miss by up to 2^-9 of each term; spikes of other values
    # that bf16 represents exactly
    for M, K, N in [(128, 4608, 512), (8192, 576, 64)]:
        w = torch.as_tensor((10.0 ** rng.uniform(-3, 3, (K, N)))
                            .astype(np.float32), device=dev)
        sp = torch.as_tensor((rng.random((M, K)) < 0.15)
                             .astype(np.float32), device=dev)
        check(f"weights log-uniform over 1e-3..1e3 ({M}, {K}, {N})", sp, w)
    sp = ((rng.random((512, 2304)) < 0.3)
          * rng.choice([0.5, 1.0, 2.0], (512, 2304))).astype(np.float32)
    check("spikes of {0, 0.5, 1, 2} (512, 2304, 256)",
          torch.as_tensor(sp, device=dev),
          torch.as_tensor(_conv_weights(rng, (2304, 256)), device=dev))
    sp = (rng.random((512, 256, 9)) < 0.2).astype(np.float32)
    sp[:, rng.permutation(256)[:192]] = 0.0        # 75% silent channels
    w = torch.as_tensor(_conv_weights(rng, (2304, 256)), device=dev)
    check("75% silent channels (512, 2304, 256)",
          torch.as_tensor(sp.reshape(512, 2304), device=dev), w)
    for stride in (1, 2):
        sp = torch.as_tensor((rng.random((8, 16, 16, 128)) < 0.15)
                             .astype(np.float32), device=dev)
        w = torch.as_tensor(_conv_weights(rng, (3, 3, 128, 256)), device=dev)
        got = ops.spike_conv(sp, w, stride)
        with layers.fp32_convs():
            want = layers.conv2d({"w": w.permute(3, 2, 0, 1).contiguous()},
                                 sp.permute(0, 3, 1, 2).contiguous(), stride)
        want = want.permute(0, 2, 3, 1)
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=1e-4, atol=1e-4)
        print(f"[kernel] spike_conv [8, 16, 16, 128] * [3, 3, 128, 256] "
              f"stride {stride} vs F.conv2d (TF32 off): max_abs_err={err!r} "
              f"(rtol=atol=1e-4) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"spike_conv disagrees at stride {stride}")


def _batch(cfg, seed: int, dev, batch: int = 8):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    x = rng.random((batch, cfg.in_res, cfg.in_res, cfg.in_ch), np.float32)
    y = rng.integers(0, cfg.n_classes, batch)
    return torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)


@contextlib.contextmanager
def _recording(forward, backward):
    """Within the scope, ``snn.neurons.lif_step`` runs ``forward`` and
    ``backward`` (the kernels or their plain versions) and every spike
    tensor it returns is recorded, as are the logits of
    ``snn.bptt.loss_fn``'s rollout."""
    from repro_torch.snn import bptt, neurons
    rec = {"spikes": [], "logits": []}
    real = neurons._lif_forward, neurons._lif_backward, bptt.model_rollout

    def lif(*args, **kw):
        u, s = forward(*args, **kw)
        rec["spikes"].append(s)
        return u, s

    def rollout(*args, **kw):
        logits, rate = real[2](*args, **kw)
        rec["logits"].append(logits.detach())
        return logits, rate

    neurons._lif_forward, neurons._lif_backward, bptt.model_rollout = (
        lif, backward, rollout)
    try:
        yield rec
    finally:
        neurons._lif_forward, neurons._lif_backward, bptt.model_rollout = real


@contextlib.contextmanager
def _lif_backward_as(backward):
    """Within the scope, ``snn.neurons.lif_step``'s backward is ``backward``."""
    from repro_torch.snn import neurons
    real, neurons._lif_backward = neurons._lif_backward, backward
    try:
        yield
    finally:
        neurons._lif_backward = real


def _profile_step(step, label: str, kernel: str = "lif_kernel"):
    """torch.profiler over one call of ``step``: wall, device kernel time,
    busy share, kernel count and the share of the kernels whose name holds
    ``kernel``. Returns ``{"wall", "busy", "kernels"}`` (None when the
    profiler recorded no device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us == 0.0:
        print(f"[{label}-profile] one step: wall {wall!r} s; device time not "
              "measured (the profiler recorded no device events)")
        return None
    own_us = sum(e.self_device_time_total for e in kernels
                 if kernel in e.key)
    n = sum(e.count for e in kernels)
    print(f"[{label}-profile] one step under the profiler: wall {wall!r} s; "
          f"device kernel time {dev_us / 1e6!r} s (busy share "
          f"{dev_us / 1e6 / wall!r}); {n} kernels; {kernel} "
          f"{own_us / 1e6!r} s ({own_us / dev_us!r} of device time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[{label}-profile] kernel x{e.count} "
              f"{e.self_device_time_total / 1e3:.3f} ms {e.key[:90]}")
    return {"wall": wall, "busy": dev_us / 1e6 / wall, "kernels": n}


def _train_path(cfg, label, steps, dev, kernels, lifs_per_step):
    """Phase 7: ``train_step`` at full width, batch 8, ``steps`` times from
    one set of weights; loss, wall and LIF launches per step (the backward
    kernel once per forward launch); one profiled step. Then the same
    training on with the fused backward and with its plain version in six
    alternating turns of 2 steps each (kernel first, then plain first, ...):
    step wall, and one profiled step each for kernels per step and busy
    share. Returns the LIF
    launches of the run: (forward, backward)."""
    import torch
    from repro_torch.kernels.lif import lif_backward_kernel, lif_backward_plain
    from repro_torch.snn.bptt import make_optimizer, train_step
    from repro_torch.snn.models import init_model
    net = init_model(cfg, torch.Generator().manual_seed(0), device=dev)
    opt = make_optimizer(net)
    x, y = _batch(cfg, 0, dev)
    losses, walls = [], []
    _reset_counts(kernels)
    for _ in range(steps):
        t0 = time.perf_counter()
        net, opt, m = train_step(net, opt, x, y, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = _counts(kernels)
    print(f"[{label}] train_step x{steps} (batch 8, T={cfg.T}, AdamW lr 1e-3, "
          f"clip 1.0): losses {losses}; spike rate "
          f"{float(m['spike_rate'])!r}; wall per step {walls} s (after the "
          f"first: mean {sum(walls[1:]) / (steps - 1)!r} s); launches "
          f"{launches}")
    want = lifs_per_step * cfg.T * steps
    fwd, bwd = launches["lif_step_kernel"], launches["lif_backward_kernel"]
    if fwd != want or bwd != want:
        raise AssertionError(f"{label}: {fwd} LIF and {bwd} LIF backward "
                             f"launches, not {want} each")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: loss is not finite: {losses}")
    print(f"[{label}] lif launches per step {fwd // steps} and lif_backward "
          f"launches per step {bwd // steps} = {lifs_per_step} LIFs x "
          f"T={cfg.T} ok")
    _profile_step(lambda: train_step(net, opt, x, y, cfg), label)

    backward = {"kernel": lif_backward_kernel, "plain": lif_backward_plain}
    walls = {"kernel": [], "plain": []}
    for turn in range(6):
        for name in ("kernel", "plain")[::1 if turn % 2 == 0 else -1]:
            with _lif_backward_as(backward[name]):
                for _ in range(2):
                    t0 = time.perf_counter()
                    net, opt, m = train_step(net, opt, x, y, cfg)
                    torch.cuda.synchronize()
                    walls[name].append(time.perf_counter() - t0)
    prof = {}
    for name in ("kernel", "plain"):
        with _lif_backward_as(backward[name]):
            prof[name] = _profile_step(
                lambda: train_step(net, opt, x, y, cfg),
                f"{label}-{name}-backward")
        print(f"[{label}] {name} LIF backward: step wall {walls[name]} s "
              f"(median {statistics.median(walls[name])!r} s, mean "
              f"{statistics.fmean(walls[name])!r} s)"
              + ("" if prof[name] is None else
                 f"; profiled step: {prof[name]['kernels']} kernels, busy "
                 f"share {prof[name]['busy']!r}, wall "
                 f"{prof[name]['wall']!r} s"))
    if prof["kernel"] is not None and prof["plain"] is not None:
        saved = prof["plain"]["kernels"] - prof["kernel"]["kernels"]
        print(f"[{label}] the fused backward saves {saved} kernels a step, "
              f"{saved / (lifs_per_step * cfg.T)!r} per LIF backward")
        if saved <= 0:
            raise AssertionError(f"{label}: the fused backward launches no "
                                 "fewer kernels a step than the plain one")
    return fwd, bwd


def _kernel_vs_plain_step(cfg, label, dev):
    """The first training step through the LIF kernels (forward and
    backward) and through their plain versions on the card, same weights
    and batch, deterministic cuDNN: loss, logits, every spike tensor and
    every gradient. Returns the names of the gradients that differ."""
    import torch
    from repro_torch.kernels.lif import (lif_backward_kernel,
                                         lif_backward_plain, lif_step_kernel,
                                         lif_step_plain)
    from repro_torch.snn.bptt import loss_and_grads
    from repro_torch.snn.models import init_model
    net = init_model(cfg, torch.Generator().manual_seed(0), device=dev)
    x, y = _batch(cfg, 0, dev)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        runs = []
        for forward, backward in ((lif_step_kernel, lif_backward_kernel),
                                  (lif_step_plain, lif_backward_plain)):
            with _recording(forward, backward) as rec:
                loss, ce, rate, grads = loss_and_grads(net, cfg, x, y)
                torch.cuda.synchronize()
            runs.append((loss, rec["logits"], rec["spikes"], grads))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags
    (l_k, lg_k, sp_k, g_k), (l_p, lg_p, sp_p, g_p) = runs
    forward_same = (torch.equal(l_k, l_p) and len(lg_k) == len(lg_p) == 1
                    and torch.equal(lg_k[0], lg_p[0])
                    and len(sp_k) == len(sp_p)
                    and all(torch.equal(a, b) for a, b in zip(sp_k, sp_p)))
    if not forward_same:
        raise AssertionError(f"{label}: the kernel path's forward (loss, "
                             "logits, spikes) differs from the plain path's")
    names = [n for n, _ in net.named_parameters()]
    differ = [n for n, a, b in zip(names, g_k, g_p) if not torch.equal(a, b)]
    print(f"[{label}] kernel path (LIF forward and backward kernels) vs "
          f"plain path, first step, deterministic cuDNN: loss "
          f"{l_k.item()!r} and logits bit-identical, {len(sp_k)} spike "
          f"tensors bit-identical; gradients bit-identical for "
          f"{len(names) - len(differ)} of {len(names)} parameters")
    return differ, dict(zip(names, zip(g_k, g_p)))


def _nondeterministic_ops(cfg, dev):
    """The ops of one training step that PyTorch reports as having no
    deterministic implementation on the card."""
    import warnings
    import torch
    from repro_torch.snn.bptt import loss_and_grads
    from repro_torch.snn.models import init_model
    net = init_model(cfg, torch.Generator().manual_seed(0), device=dev)
    x, y = _batch(cfg, 0, dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loss_and_grads(net, cfg, x, y)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(".")[0] for w in caught
                   if "deterministic" in str(w.message)})


def _spike_conv_path(vgg, dev, kernels):
    """Phase 9: the event-driven conv path. One Spike-VGG16 forward records
    the input spikes of every spiking conv at each timestep; each goes
    through ``kernels.ops.spike_conv`` (im2col + the spike-matmul kernel)
    and is held against the float32 cuDNN conv of the same spikes. Returns
    (launches, max abs error, the recorded (spikes, HWIO weight) pairs of the
    first timestep)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.snn import layers
    from repro_torch.snn.models import (ConvBNLif, MaxPool, init_model,
                                        init_state, model_step)
    net = init_model(vgg, torch.Generator().manual_seed(0), device=dev)
    x, _ = _batch(vgg, 0, dev)
    inputs = []
    with torch.no_grad():
        state = init_state(vgg, 8, device=dev)
        for t in range(vgg.T):
            state, _ = model_step(net, vgg, state, x)
            h = None
            for b in vgg.blocks:
                if isinstance(b, MaxPool):
                    h = layers.max_pool(h, b.k, b.stride)
                elif isinstance(b, ConvBNLif):
                    if h is not None:
                        w = net[b.name]["conv"]["w"].detach()
                        inputs.append((t, b.name, h.permute(0, 2, 3, 1)
                                       .contiguous(),
                                       w.permute(2, 3, 1, 0).contiguous()))
                    h = state[b.name][1]
    worst, density = 0.0, []
    _reset_counts(kernels)
    outs = [ops.spike_conv(sp, w, 1) for _, _, sp, w in inputs]
    torch.cuda.synchronize()
    launches = _counts(kernels)
    for (t, name, sp, w), got in zip(inputs, outs):
        with layers.fp32_convs():
            want = layers.conv2d({"w": w.permute(3, 2, 0, 1).contiguous()},
                                 sp.permute(0, 3, 1, 2).contiguous())
        want = want.permute(0, 2, 3, 1)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"spike_conv of {name} at t={t} disagrees "
                                 f"with F.conv2d: max_abs_err {err!r}")
        worst = max(worst, err)
        density.append(sp.mean().item())
    if launches["spike_matmul_kernel"] != len(inputs):
        raise AssertionError("the spike-conv path did not launch "
                             "spike_matmul once per conv")
    print(f"[spike_conv] Spike-VGG16 spiking convs x T={vgg.T} through "
          f"ops.spike_conv: {len(inputs)} convs, launches {launches}; input "
          f"spike density {min(density)!r}..{max(density)!r}; max_abs_err "
          f"vs F.conv2d (TF32 off) {worst!r} (rtol=atol=1e-4) ok")
    first = [(name, sp, w) for t, name, sp, w in inputs if t == 0]
    return launches["spike_matmul_kernel"], worst, first


def _time_snn_kernels(dev, rng, vgg, first_convs, card, lif_launches,
                      mm_launches, mm_err, bwd_err):
    """Phase 9, SNN rows: one timestep's worth of each kernel on the
    Spike-VGG16 path, summed over its calls (13 LIF states, forward and
    backward; 12 spiking-conv im2col products with the path's own spikes
    and weights). ``lif_launches`` is (forward, backward)."""
    import numpy as np
    import torch
    from repro_torch.kernels.lif import (lif_backward_kernel,
                                         lif_backward_plain, lif_step_kernel,
                                         lif_step_plain)
    from repro_torch.kernels.ops import im2col
    from repro_torch.kernels.spike_matmul import (spike_matmul_kernel,
                                                  spike_matmul_plain)
    # (name, kernel, plain, tensors a call reads, bytes an element, flops an
    # element): the forward reads u, s, I and writes u', s'; the backward
    # (hard reset, rect, every cotangent present and every output asked
    # for, as at 0 < t < T - 1) reads g_u, g_s, u, s, u' and writes d_u,
    # d_s, g, and does 11 flops (subtract, compare, divide, 6 multiplies,
    # 2 adds/subtracts)
    specs = [("lif", lif_step_kernel, lif_step_plain, 3, 20, 5),
             ("lif_backward", lif_backward_kernel, lif_backward_plain, 5, 32,
              11)]
    rows = []
    for name, kern, plain, n_in, per_byte, per_op in specs:
        tot = dict(ms=0.0, plain=0.0, dev=0.0, plain_dev=0.0, bytes=0, ops=0)
        for shape in _lif_state_shapes(vgg):
            n = math.prod(shape)
            # enough input sets to exceed the 50 MB L2 cache, used in turn,
            # so every call reads its inputs from device memory, as the
            # training step's tensors (written a layer or a timestep
            # earlier) are
            draws = [rng.standard_normal, lambda k: rng.random(k) < 0.2,
                     rng.standard_normal]
            if n_in == 5:
                draws = [rng.standard_normal] * 2 + draws[:2] + [
                    lambda k: rng.standard_normal(k) + 1.0]
            sets = [[torch.as_tensor(d(n).astype(np.float32), device=dev)
                     .reshape(shape) for d in draws]
                    for _ in range(max(2, -(-64_000_000 // (per_byte * n))))]
            turn = itertools.cycle(sets)
            fns = (lambda: kern(*next(turn)), lambda: plain(*next(turn)))
            d_k, d_p = (_graph_ms(f) for f in fns)
            m_k, m_p = (_time_ms(f) for f in fns)
            tot["ms"] += m_k
            tot["plain"] += m_p
            tot["dev"] += d_k
            tot["plain_dev"] += d_p
            tot["bytes"] += per_byte * n
            tot["ops"] += per_op * n
            bound = per_byte * n / HBM_BYTES_PER_S * 1e3
            print(f"[time] {name} {shape}: kernel {m_k!r} ms, plain {m_p!r} "
                  f"ms (per call); device {d_k!r}, {d_p!r} ms; bytes bound "
                  f"{bound!r} ms (bound / device time {bound / d_k!r}); host "
                  f"{(m_k - d_k) * 1e3!r} us a call")
        tb, to = tot["bytes"] / HBM_BYTES_PER_S, tot["ops"] / FP32_OPS_PER_S
        calls = len(_lif_state_shapes(vgg))
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lif.cu",
            "replaces": "src/repro/kernels/lif.py:38",
            "launches": lif_launches[0 if name == "lif" else 1],
            "max_abs_err": 0.0 if name == "lif" else bwd_err,
            "ms": tot["ms"], "plain_ms": tot["plain"],
            "bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": None, "device_ms": tot["dev"],
            "plain_device_ms": tot["plain_dev"], "library_device_ms": None,
            "calls": f"sum over the {calls} LIF states of one Spike-VGG16 "
                     "timestep",
            "host_us_per_call": (tot["ms"] - tot["dev"]) * 1e3 / calls,
        }
        if name == "lif_backward":
            row["note"] = ("the backward of lif_step_pallas's update, which "
                           "the reference leaves to JAX autodiff")
        rows.append(row)
        print(f"[time] {name}, one VGG16 timestep ({calls} calls): kernel "
              f"{tot['ms']!r} ms, plain {tot['plain']!r} ms; device "
              f"{tot['dev']!r}, {tot['plain_dev']!r} ms; bound "
              f"{row['bound_ms']!r} ms ({tot['bytes']} bytes, {tot['ops']} "
              f"flops); host {row['host_us_per_call']!r} us a call (ms - "
              f"device ms); no single PyTorch call computes this function "
              f"(library_ms null); card {card}")

    tot = dict(ms=0.0, plain=0.0, lib=0.0, dev=0.0, plain_dev=0.0,
               lib_dev=0.0, bytes=0, ops=0, dense_ops=0)
    for name, sp, w in first_convs:
        lhs, rhs = im2col(sp, w)
        (M, K), cout = lhs.shape, rhs.shape[1]
        fns = (lambda: spike_matmul_kernel(lhs, rhs),
               lambda: spike_matmul_plain(lhs, rhs),
               lambda: torch.matmul(lhs, rhs))
        d = [_graph_ms(f) for f in fns]
        m = [_time_ms(f, reps=50) for f in fns]
        nnz = int((lhs != 0).sum().item())
        for key, val in zip(("ms", "plain", "lib"), m):
            tot[key] += val
        for key, val in zip(("dev", "plain_dev", "lib_dev"), d):
            tot[key] += val
        tot["bytes"] += 4 * (M * K + K * cout + M * cout)
        tot["ops"] += 2 * nnz * cout
        tot["dense_ops"] += 2 * M * K * cout
        print(f"[time] spike_matmul {name} ({M}, {K}, {cout}), spike density "
              f"{nnz / (M * K)!r}: kernel {m[0]!r} ms, plain {m[1]!r} ms, "
              f"torch.matmul {m[2]!r} ms (per call); device {d[0]!r}, "
              f"{d[1]!r}, {d[2]!r} ms")
    tb, to = tot["bytes"] / HBM_BYTES_PER_S, tot["ops"] / FP32_OPS_PER_S
    mm_row = {
        "name": "spike_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spike_matmul.cu",
        "replaces": "src/repro/kernels/spike_matmul.py:52",
        "launches": mm_launches, "max_abs_err": mm_err,
        "ms": tot["ms"], "plain_ms": tot["plain"],
        "bound_ms": max(tb, to) * 1e3,
        "bound_by": "bytes" if tb >= to else "operations",
        "library_ms": tot["lib"], "device_ms": tot["dev"],
        "plain_device_ms": tot["plain_dev"],
        "library_device_ms": tot["lib_dev"],
        "calls": "sum over the 12 spiking convs of one Spike-VGG16 timestep",
        "achieved_tb_per_s": tot["bytes"] / tot["dev"] / 1e9,
        "vs_library": tot["dev"] / tot["lib_dev"],
    }
    print(f"[time] spike_matmul, one VGG16 timestep (12 calls, the path's "
          f"spikes): kernel {tot['ms']!r} ms, plain {tot['plain']!r} ms, "
          f"torch.matmul (TF32 off) {tot['lib']!r} ms; device "
          f"{tot['dev']!r}, {tot['plain_dev']!r}, {tot['lib_dev']!r} ms; "
          f"bound {mm_row['bound_ms']!r} ms ({tot['bytes']} bytes, "
          f"{tot['ops']} flops the spikes need; dense would be "
          f"{tot['dense_ops']} = {tot['dense_ops'] / FP32_OPS_PER_S * 1e3!r} "
          f"ms); kernel {mm_row['achieved_tb_per_s']!r} TB/s, "
          f"{mm_row['vs_library']!r}x torch.matmul's device time; card "
          f"{card}")
    return rows + [mm_row]


# ---- the LM serving slice: the flash-attention kernel, prefill and decode ----

BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores (data sheet)
# (s, d, h, hkv) of the reference's kernel sweep (tests/test_kernels.py)
REFERENCE_FLASH_SHAPES = [(128, 64, 4, 4), (160, 48, 4, 2), (256, 128, 2, 1)]
SERVED = dict(batch=4, prompt_len=2048, gen_len=32)   # internlm2-1.8b
DANUBE = dict(batch=1, prompt_len=4608, gen_len=8, layers=4)
# kernel vs plain: float32 within a reordered float32 sum; bfloat16 within
# about two roundings of the output at bfloat16's 2^-8 relative step
FLASH_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the bf16 model's logits through two routes (kernel vs plain attention;
# decode vs forward): relative L2 error, since 24 layers of bf16 rounding
# (unit roundoff 2^-9) in other places random-walk to about 1e-2
LOGITS_REL_TOL = 5e-2
# one layer's attention, kernel vs plain on the model's own q, k, v: relative
# L2 of bf16 outputs from float32 sums (a few roundings at 2^-9)
ATTN_REL_TOL = 1e-2


def _check_flash(dev):
    """Phase 2, ``flash_attention`` part: the kernel against its plain
    version. Returns the max abs error at the served prefill shape."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(0)

    def case(name, b, h, hkv, s, d, window, dtype, causal=True):
        q = (torch.randn(b, h, s, d, generator=gen, device=dev) * 0.5)
        k = (torch.randn(b, hkv, s, d, generator=gen, device=dev) * 0.5)
        v = torch.randn(b, hkv, s, d, generator=gen, device=dev)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        tc_before = flash_attention_kernel.tensor_core_launches
        got = flash_attention_kernel(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tc = flash_attention_kernel.tensor_core_launches - tc_before
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        err = (got.float() - want.float()).abs().max().item()
        ok = (got.dtype == dtype and bool(torch.isfinite(got).all())
              and torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol)
              and tc == (dtype == torch.bfloat16))
        print(f"[kernel] flash_attention {name} B{b} H{h} Hkv{hkv} S{s} D{d} "
              f"window {window} causal {causal} {dtype}: max_abs_err={err!r} "
              f"(rtol=atol={tol}); tensor-core launches {tc} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version on {name}")
        return err

    for s, d, h, hkv in REFERENCE_FLASH_SHAPES:
        for window in (None, 37):
            case("reference sweep", 2, h, hkv, s, d, window, torch.float32)
    case("reference bf16", 1, 2, 2, 128, 64, None, torch.bfloat16)
    case("S off the tile", 2, 4, 2, 200, 80, 50, torch.float32)
    case("S off the tile", 1, 3, 1, 77, 16, 5, torch.bfloat16)
    case("D=256", 2, 4, 2, 200, 256, None, torch.float32)
    case("non-causal", 2, 4, 2, 192, 32, None, torch.float32, causal=False)
    case("h2o-danube", 1, 32, 8, 4608, 80, 4096, torch.bfloat16)
    # the bf16 tensor-core kernel over its head-dim buckets, sequence
    # lengths, windows, masks and GQA ratios
    bf16 = torch.bfloat16
    case("tensor cores D=16 rep 1", 2, 4, 4, 200, 16, None, bf16)
    case("tensor cores D=48 rep 2", 2, 4, 2, 77, 48, 37, bf16)
    case("tensor cores D=96 rep 4 non-causal", 1, 8, 2, 200, 96, None, bf16,
         causal=False)
    case("tensor cores S=1 rep 4", 2, 4, 1, 1, 128, None, bf16)
    case("tensor cores D=256 window 37", 1, 4, 2, 200, 256, 37, bf16)
    case("tensor cores D=256 non-causal", 1, 2, 2, 77, 256, None, bf16,
         causal=False)
    case("tensor cores window 4096 past S", 2, 4, 2, 200, 80, 4096, bf16)
    case("tensor cores S=4608 D=128 window 4096", 1, 4, 1, 4608, 128, 4096,
         bf16)
    case("tensor cores D=20 (element-wise loads)", 1, 2, 1, 77, 20, None,
         bf16)
    case("zamba2 shared block prefill D=160", *ZAMBA2_PREFILL_ATTN[1:], None,
         bf16)
    return case("served internlm2 prefill", SERVED["batch"], 16, 8,
                SERVED["prompt_len"], 128, None, torch.bfloat16)


@contextlib.contextmanager
def _attention_route(forward, backward=None):
    """Within the scope, the model's causal self-attention on the card runs
    ``forward`` and, when given, ``backward`` (the kernels or their plain
    versions)."""
    from repro_torch.models import layers
    real = layers._flash_forward, layers._flash_backward
    layers._flash_forward = forward
    layers._flash_backward = backward or real[1]
    try:
        yield
    finally:
        layers._flash_forward, layers._flash_backward = real


@contextlib.contextmanager
def _plain_rope():
    """Within the scope, the model's RoPE runs the torch ops both ways
    (``rope_plain``, and with ``inverse`` its gradient) inside its autograd
    Function, where the kernel ran."""
    from repro_torch.kernels.rope import rope_plain
    from repro_torch.models import layers
    real = layers._rope_kernel

    def plain(x, positions, theta, inverse=False):
        return rope_plain(x, positions, theta, inverse)
    layers._rope_kernel = plain
    try:
        yield
    finally:
        layers._rope_kernel = real


def _rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _prefill_last(params, cfg, prompts, attention=None):
    """The last position's prefill logits ``[B, V]`` of ``prompts``, the
    attention through ``attention`` where given (else the model's own)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize
    with (_attention_route(attention) if attention is not None
          else contextlib.nullcontext()):
        cache = materialize(lm.cache_specs(cfg, *prompts.shape),
                            device=prompts.device)
        logits, _ = lm.prefill(params, cfg, prompts, cache)
        torch.cuda.synchronize()
    return logits[:, -1]


@contextlib.contextmanager
def _recording_routes(sink):
    """Within the scope, every MoE routing appends its top-k ids ``[T, k]``
    to ``sink``, in call order."""
    from repro_torch.models import moe
    real = moe._route

    def route(p, xf, cfg):
        out = real(p, xf, cfg)
        sink.append(out[1])
        return out
    moe._route = route
    try:
        yield
    finally:
        moe._route = real


@contextlib.contextmanager
def _pinned_routes(pick):
    """Within the scope, the i-th MoE routing call takes the top-k ids
    ``pick(i)`` instead of its own: the gates are its own softmax at those
    ids, renormalised as ``moe._route`` does, and so are density and mean
    probability. Top-k routing is discontinuous: where two experts' router
    probabilities nearly tie, a bf16 difference anywhere upstream swaps a
    token's expert and with it about 1/k of its MLP output. A comparison of
    two routes through a MoE model pins the routing to one of them, so that
    it measures the arithmetic the two routes share."""
    import torch
    from repro_torch.models import moe
    real = moe._route
    calls = []

    def route(p, xf, cfg):
        ids = pick(len(calls))
        calls.append(ids)
        probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
        top_p = probs.gather(1, ids)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        density = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts
                                 ).float() / ids.numel()
        return top_p, ids, density, probs.mean(dim=0)
    moe._route = route
    try:
        yield
    finally:
        moe._route = real


def _layerwise_attention(params, prefill_last):
    """One prefill through the flash kernel (``prefill_last(params,
    attention)``); at every application the plain version also runs on the
    same q, k, v. Returns each application's ``(causal, relative L2 error
    of the kernel's output against the plain one's)``."""
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    errs = []

    def both(q, k, v, *, causal, window, out, lse):
        flash_attention_kernel(q, k, v, causal=causal, window=window,
                               out=out, lse=lse)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        errs.append((causal, _rel_err(out, want)))
        return out
    prefill_last(params, both)
    return errs


def _noisy_embedding(params, seed: int = 5):
    """``params`` with the embedding table times ``1 + 2^-8 z`` (z standard
    normal, seeded), rounded back to its dtype: one rounding's worth of
    noise in the model's input."""
    import torch
    table = params["embed"]["table"]
    gen = torch.Generator(device=table.device).manual_seed(seed)
    noise = torch.randn(table.shape, generator=gen, device=table.device)
    noisy = (table.float() * noise.mul_(2 ** -8).add_(1)).to(table.dtype)
    return {**params, "embed": {"table": noisy}}


def _dropped(routes, moe_cfg) -> int:
    """Assignments past their expert's capacity over recorded routings
    (each ``[T, k]`` top-k ids): sum over experts of ``count - capacity``
    where positive, as ``moe._dispatch`` drops them."""
    import torch
    from repro_torch.models.moe import _capacity
    return sum(int((torch.bincount(ids.reshape(-1),
                                   minlength=moe_cfg.n_experts)
                    - _capacity(ids.shape[0], moe_cfg)).clamp_min(0).sum())
               for ids in routes)


def _routes_differ(a, b) -> float:
    """Share of (layer, token) top-k id sets that differ between two
    recordings of the same calls."""
    n = sum(x.shape[0] for x in a)
    d = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
            for x, y in zip(a, b))
    return d / max(n, 1)


def _decode_vs_forward(params, cfg, toks, prompt_len):
    """Prefill over ``toks[:, :prompt_len]`` and one decode step a token
    after it, each position's logits against ``forward``'s over all of
    ``toks``: relative L2 errors, one a position. A MoE model (at batch 1)
    routes prefill and decode by the ids ``forward`` chose for the same
    positions (``_pinned_routes``)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize
    b, total = toks.shape
    ids = []
    with _recording_routes(ids):
        full, _ = lm.forward(params, cfg, toks)
    n_moe = len(ids)
    if n_moe and b != 1:
        raise ValueError("pinned routes need batch 1 (positions = rows)")

    def pick(i):
        layer, step = i % n_moe, i // n_moe
        lo = 0 if step == 0 else prompt_len + step - 1
        return ids[layer][lo:prompt_len + step]
    with (_pinned_routes(pick) if n_moe else contextlib.nullcontext()):
        cache = materialize(lm.cache_specs(cfg, b, total), device=toks.device)
        logits, cache = lm.prefill(params, cfg, toks[:, :prompt_len], cache)
        seen = [logits[:, -1].clone()]
        for i in range(prompt_len, total - 1):
            logits, cache = lm.decode_step(params, cfg, cache,
                                           toks[:, i:i + 1], i)
            seen.append(logits[:, -1].clone())
    del cache
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t.float()).all()) for t in seen):
        raise AssertionError(f"{cfg.name}: logits are not finite")
    return [_rel_err(got, full[:, prompt_len - 1 + i])
            for i, got in enumerate(seen)]


def _attention_layers(cfg) -> int:
    """Causal self-attentions one forward of ``cfg`` runs: its attention and
    MLA layers, and each application of a hybrid model's shared block."""
    n = sum(s.count for s in cfg.segments if s.kind in ("attn", "mla"))
    return n + (cfg.n_layers // cfg.hybrid_period if cfg.hybrid_period
                else 0)


def _drawn(specs, dev, out):
    """``specs`` drawn on the card from seed 0, in their dtypes; their
    count, bytes, the drawing's seconds and peak device memory go into
    ``out``."""
    import torch
    from repro_torch.models.specs import materialize, n_params, param_bytes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = materialize(specs, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    out.update(parameters=n_params(specs), param_bytes=param_bytes(specs),
               materialize_s=time.perf_counter() - t0,
               materialize_peak_bytes=torch.cuda.max_memory_allocated())
    return params


def _below_card(label, peak):
    """Raises unless ``peak`` bytes are below the card's memory."""
    import torch
    total = torch.cuda.mem_get_info()[1]
    if peak >= total:
        raise AssertionError(f"{label}: peak {peak} bytes, not below the "
                             f"card's {total}")


def _serve_main(label, kernels, n_attn, generate, prompts, gen_len, vocab,
                out, strict=True, again=contextlib.nullcontext):
    """The main path of phases 10, 13, 14 and 15: ``generate()`` once, as a
    user calls it (greedy tokens ``[B, P + gen_len]``), the kernel counts
    set to 0 just before and read just after: one flash launch, on the
    tensor cores, per attention of the prefill (``n_attn``); the prompt
    kept and every token in the vocabulary. Then ``generate()`` again,
    under ``again()``: with ``strict`` its tokens must equal the first
    call's. Returns the first call's tokens; ``out`` gets the peak, the
    flash launches and whether the two calls agreed."""
    import torch
    prompts = torch.as_tensor(prompts).cpu()
    b, p = prompts.shape
    _reset_counts(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = generate()
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    launches = _counts(kernels)
    out["generate_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["flash"] = flash = launches["flash_attention_kernel"]
    tensor_core = launches["flash_attention_kernel.tensor_core"]
    print(f"[{label}] generate batch {b}, prompt {p}, {gen_len} greedy "
          f"tokens: wall {wall_first!r} s (first call); peak device memory "
          f"{out['generate_peak_bytes']} bytes; launches {launches}")
    if flash != n_attn or tensor_core != n_attn:
        raise AssertionError(f"{label}: {flash} flash launches, "
                             f"{tensor_core} on the tensor cores, not one "
                             f"per attention of the prefill ({n_attn})")
    if (tuple(toks.shape) != (b, p + gen_len)
            or not torch.equal(toks[:, :p].cpu(), prompts)
            or int(toks.min()) < 0 or int(toks.max()) >= vocab):
        raise AssertionError(f"{label}: generate returned bad tokens")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with again():
        toks2 = generate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["repeat_equal"] = torch.equal(toks, toks2)
    print(f"[{label}] generate again: wall {wall!r} s, "
          f"{b * gen_len / wall!r} new tokens/s end to end (prefill "
          f"included); tokens equal to the first call's: "
          f"{out['repeat_equal']}")
    if strict and not out["repeat_equal"]:
        raise AssertionError(f"{label}: two generate calls gave different "
                             f"tokens")
    return toks


def _profile_serving(label, prefill, decode, out):
    """One profiled ``prefill()`` and ``decode()`` step: each one's busy
    share and kernels go into ``out``."""
    for part, step in (("prefill", prefill), ("decode", decode)):
        prof = _profile_step(step, f"{label}-{part}", "flash_fwd_mma_kernel")
        out[f"{part}_busy"] = None if prof is None else prof["busy"]
        out[f"{part}_kernels"] = None if prof is None else prof["kernels"]


def _serve_path(cfg, label, batch, prompt_len, gen_len, dev, kernels,
                check_cfg=None, check_batch=None, strict=False,
                check_tokens=None, decode_tol=None, read_tokens=None):
    """Phases 10, 13 and 14: serve ``cfg`` at full width through
    ``launch.serve.generate`` (seeded weights in the config's dtype,
    greedy), with the flash kernel's launches (one a causal self-attention
    of the prefill; ``_serve_main``); time to first token and decode per
    token from the pieces ``generate`` runs; one profiled prefill and
    decode step; the attention's routes compared (``_attention_routes_
    agree``; skipped for a model without attention); prefill + decode
    against ``forward`` on the first ``check_batch`` rows of the generated
    tokens, under ``check_cfg`` (default: ``cfg`` and the whole batch; a
    MoE model's routes pinned to ``forward``'s), or on their first
    ``total`` tokens with a ``prompt``-token prefill where ``check_tokens =
    (total, prompt)`` is given (Mamba2's chunked scan needs lengths in whole
    chunks), within ``decode_tol`` where given (else the kernel-vs-plain
    tolerance), and printed, not held, at ``read_tokens = (total, prompt)``
    where given. With ``strict``, two ``generate`` calls must give equal
    tokens. A MoE model's share of dropped assignments is read from the
    second call. Returns a dict of the results (``flash`` is the main
    run's flash launches, ``rel`` the kernel-vs-plain error)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize
    out = {"model": cfg.name, "layers": cfg.n_layers, "batch": batch,
           "prompt_len": prompt_len, "gen_len": gen_len}
    params = _drawn(lm.lm_specs(cfg), dev, out)
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers "
          f"{[(g.kind, g.mlp, g.count) for g in cfg.segments]}, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}, kv heads {cfg.n_kv_heads}, "
          f"d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
          f"{cfg.window}, mla {cfg.mla}, moe {cfg.moe}, mtp {cfg.mtp}; "
          f"{out['parameters']} parameters, {out['param_bytes']} bytes "
          f"({cfg.param_dtype}), drawn on the card in "
          f"{out['materialize_s']!r} s, peak device memory while drawing "
          f"{out['materialize_peak_bytes']} bytes")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (batch, prompt_len))
    n_attn = _attention_layers(cfg)

    def gen(prm):
        return generate(prm, cfg, prompts, gen_len, device=dev)
    routes = []
    toks = _serve_main(label, kernels, n_attn, lambda: gen(params), prompts,
                       gen_len, cfg.vocab, out, strict,
                       lambda: _recording_routes(routes))
    if cfg.moe is not None:
        pre = [ids for ids in routes if ids.shape[0] == batch * prompt_len]
        dec = [ids for ids in routes if ids.shape[0] == batch]
        total = sum(ids.numel() for ids in pre)
        out["prefill_dropped_share"] = _dropped(pre, cfg.moe) / total
        out["decode_dropped"] = _dropped(dec, cfg.moe)
        print(f"[{label}] MoE at capacity factor "
              f"{cfg.moe.capacity_factor}: prefill dropped "
              f"{_dropped(pre, cfg.moe)} of {total} assignments "
              f"({out['prefill_dropped_share']!r}) over {len(pre)} MoE "
              f"layers; decode dropped {out['decode_dropped']} over "
              f"{len(dec)} layer steps")

    # time to first token and decode per token: the steps generate takes
    pt = torch.as_tensor(prompts, device=dev)
    gen_toks = toks[:, prompt_len:]
    with torch.inference_mode():
        cache = materialize(lm.cache_specs(cfg, batch, prompt_len + gen_len),
                            device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = lm.prefill(params, cfg, pt, cache)
        first = torch.argmax(logits[:, -1], dim=-1)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        steps = []
        for i in range(gen_len):
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(params, cfg, cache,
                                           gen_toks[:, i:i + 1],
                                           prompt_len + i)
            torch.argmax(logits[:, -1], dim=-1)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        step_s = sum(steps[1:]) / max(len(steps) - 1, 1)
        out.update(ttft_s=ttft, decode_ms=step_s * 1e3)
        print(f"[{label}] time to first token (prefill of {batch} x "
              f"{prompt_len} and the argmax) {ttft!r} s; decode "
              f"{step_s * 1e3!r} ms per token step (mean after the first; "
              f"first {steps[0] * 1e3!r} ms), {batch / step_s!r} tokens/s "
              f"at batch {batch}; first token equal to generate's: "
              f"{torch.equal(first, gen_toks[:, 0])}")
        _profile_serving(
            label, lambda: lm.prefill(params, cfg, pt, cache),
            lambda: lm.decode_step(params, cfg, cache, gen_toks[:, -1:],
                                   prompt_len + gen_len - 1), out)
        del cache

        rel = tol = None
        if n_attn:
            rel, tol = _attention_routes_agree(
                params, cfg, label,
                lambda prm, attention=None: _prefill_last(prm, cfg, pt,
                                                          attention),
                gen, gen_toks, n_attn, out)

        # prefill + decode against forward on the same tokens
        ccfg = check_cfg or cfg
        cb = check_batch or batch
        total, check_prompt = check_tokens or (toks.shape[1], prompt_len)
        tol = decode_tol or tol
        errs = _decode_vs_forward(params, ccfg, toks[:cb, :total],
                                  check_prompt)
        out["decode_vs_forward_rel"] = max(errs)
        how = ("" if ccfg is cfg else
               f" under a dropless copy of the config (capacity factor "
               f"{ccfg.moe.capacity_factor}), batch {cb}, routed by "
               f"forward's ids (the main run's capacity drops assignments "
               f"in prefill and forward but none in decode)")
        print(f"[{label}] prefill of {check_prompt} + decode logits vs "
              f"forward over {total} tokens{how}: relative L2 error max "
              f"{max(errs)!r}, mean {sum(errs) / len(errs)!r} over "
              f"{len(errs)} positions (tolerance {tol!r})")
        if not max(errs) <= tol:
            raise AssertionError(f"{label}: decode disagrees with forward")
        if read_tokens:
            total, check_prompt = read_tokens
            errs = _decode_vs_forward(params, ccfg, toks[:cb, :total],
                                      check_prompt)
            out["decode_vs_forward_read"] = [check_prompt, total, max(errs)]
            print(f"[{label}] prefill of {check_prompt} + decode logits vs "
                  f"forward over {total} tokens: relative L2 error max "
                  f"{max(errs)!r}, mean {sum(errs) / len(errs)!r} over "
                  f"{len(errs)} positions (printed, not held)")
    out["phase_peak_bytes"] = max(torch.cuda.max_memory_allocated(),
                                  out["materialize_peak_bytes"])
    out["rel"] = rel
    del params
    torch.cuda.empty_cache()
    return out


def _attention_routes_agree(params, cfg, label, prefill_last, generate,
                            gen_toks, n_attn, out):
    """The serving phases' attention checks, through ``prefill_last(params,
    attention=None)`` (the last position's prefill logits, the attention
    through ``attention`` where given) and ``generate(params)`` (greedy
    tokens ending in ``gen_toks``): each of the prefill's ``n_attn``
    attention applications, kernel output against the plain version on
    the same q, k, v, within ``ATTN_REL_TOL``; the last-position logits
    through the kernel against the plain attention, within the larger of
    ``LOGITS_REL_TOL`` and the model's own response to one bf16 rounding
    of noise in its embedding (a MoE model's routes pinned to the kernel
    prefill's); the plain route's greedy tokens beside the kernel's,
    printed. Returns ``(rel, tol)``."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_plain
    moe_cfg = getattr(cfg, "moe", None)
    # the kernel against its plain version on the model's own q, k, v at
    # every application of the prefill (each input from the kernel route)
    errs = _layerwise_attention(params, prefill_last)
    worst = max(e for _, e in errs)
    out["attention_rel_max"] = worst
    by_kind = "".join(
        f", {kind} max {max(e for c, e in errs if c == causal)!r}"
        for kind, causal in (("causal", True), ("non-causal", False))
        if any(c == causal for c, _ in errs))
    print(f"[{label}] each prefill attention, kernel vs plain on the same "
          f"q, k, v: relative L2 max {worst!r}{by_kind}, mean "
          f"{sum(e for _, e in errs) / len(errs)!r} over {len(errs)} "
          f"applications (tolerance {ATTN_REL_TOL})")
    if len(errs) != n_attn or not worst <= ATTN_REL_TOL:
        raise AssertionError(f"{label}: the flash kernel disagrees with "
                             f"its plain version on the model's q, k, v "
                             f"({len(errs)} applications of {n_attn})")

    # the whole prefill through the plain attention; a MoE model's
    # routes pinned to the kernel prefill's
    kernel_ids, plain_ids = [], []
    with _recording_routes(kernel_ids):
        kernel_logits = prefill_last(params)

    def pinned():
        return (_pinned_routes(lambda i: kernel_ids[i]) if kernel_ids
                else contextlib.nullcontext())
    if moe_cfg is not None:
        with _recording_routes(plain_ids):
            free = prefill_last(params, flash_attention_plain)
        out["routes_differ"] = _routes_differ(kernel_ids, plain_ids)
        out["kernel_vs_plain_rel_unpinned"] = _rel_err(kernel_logits,
                                                       free)
        print(f"[{label}] prefill through the plain attention with its "
              f"own routing: {out['routes_differ']!r} of the (layer, "
              f"token) top-{moe_cfg.top_k} sets differ from the kernel "
              f"prefill's; last-position logits relative L2 "
              f"{out['kernel_vs_plain_rel_unpinned']!r} (not gated: "
              f"top-k routing is discontinuous)")
        del free
    with pinned():
        plain_logits = prefill_last(params, flash_attention_plain)
    # the model's own response to one bf16 rounding of its input: the
    # plain prefill again with the embedding table perturbed by 2^-8
    # relative noise, rounded to bf16
    with pinned():
        noisy_logits = prefill_last(_noisy_embedding(params),
                                    flash_attention_plain)
    del kernel_ids, plain_ids
    out["input_rounding_rel"] = _rel_err(noisy_logits, plain_logits)
    tol = max(LOGITS_REL_TOL, out["input_rounding_rel"])
    out["logits_tol"] = tol
    rel = _rel_err(kernel_logits, plain_logits)
    mx = (kernel_logits.float() - plain_logits.float()).abs().max()
    same_tok = torch.equal(kernel_logits.argmax(-1),
                           plain_logits.argmax(-1))
    out["kernel_vs_plain_rel"] = rel
    print(f"[{label}] prefill last-position logits, kernel vs plain "
          f"attention{'' if moe_cfg is None else ' (routes pinned)'}: "
          f"relative L2 error {rel!r}, max abs {mx.item()!r} (logits up "
          f"to {plain_logits.float().abs().max().item()!r}); greedy "
          f"first token equal: {same_tok}; the plain prefill with one "
          f"bf16 rounding of noise in the embedding moves them by "
          f"{out['input_rounding_rel']!r}; tolerance {tol!r} (the "
          f"larger of {LOGITS_REL_TOL} and that)")
    if not rel <= tol:
        raise AssertionError(f"{label}: kernel and plain prefill logits "
                             f"differ by {rel!r}")
    del noisy_logits
    with _attention_route(flash_attention_plain):
        plain_toks = generate(params)
    agree = (plain_toks[:, -gen_toks.shape[1]:] == gen_toks).float().mean()
    print(f"[{label}] greedy tokens through the plain attention equal to "
          f"the kernel path's: {agree.item()!r} of {gen_toks.numel()} (not "
          f"gated: random-weight bf16 logits tie)")
    return rel, tol


def _time_flash(dev, card, launches, err):
    """Phase 9, ``flash_attention`` row: one layer's attention at the served
    prefill shape (B4, H16, Hkv8, S2048, D128, bf16, causal) through the
    kernel, its plain version and ``F.scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain,
                                                     visible_pairs)
    b, h, hkv, s, d = SERVED["batch"], 16, 8, SERVED["prompt_len"], 128
    gen = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    fns = (lambda: flash_attention_kernel(q, k, v),
           lambda: flash_attention_plain(q, k, v),
           lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True))
    lib_err = (fns[2]().float() - fns[1]().float()).abs().max().item()
    dev_ms = [_graph_ms(f, reps=10, replays=5) for f in fns]
    ms = [_time_ms(f, reps=20, warmup=3) for f in fns]
    pairs = visible_pairs(s) * b * h
    n_ops = 4 * d * pairs                 # q.k and p.v, 2 flops per MAC
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())   # q, k, v, out
    t_ops, t_bytes = n_ops / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:80",
        "launches": launches, "max_abs_err": err,
        "ms": ms[0], "plain_ms": ms[1],
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": ms[2], "device_ms": dev_ms[0],
        "plain_device_ms": dev_ms[1], "library_device_ms": dev_ms[2], "library_device_ms": dev_ms[2],
        "calls": "one layer's attention of the internlm2-1.8b prefill "
                 "(B4, H16, Hkv8, S2048, D128, bf16, causal)",
    }
    row["achieved_tflops"] = n_ops / dev_ms[0] / 1e9
    row["vs_library"] = dev_ms[0] / dev_ms[2]
    print(f"[time] flash_attention B{b} H{h} Hkv{hkv} S{s} D{d} bf16 causal: "
          f"kernel {ms[0]!r} ms, plain {ms[1]!r} ms, "
          f"scaled_dot_product_attention {ms[2]!r} ms (per call); device "
          f"{dev_ms[0]!r}, {dev_ms[1]!r}, {dev_ms[2]!r} ms; bound "
          f"{row['bound_ms']!r} ms ({n_ops} flops over {pairs} visible "
          f"pairs at {BF16_OPS_PER_S:.3g} flop/s; {n_bytes} bytes); kernel "
          f"{row['achieved_tflops']!r} TFLOP/s, {row['vs_library']!r}x "
          f"SDPA's device time; SDPA vs plain max_abs {lib_err!r}; card "
          f"{card}")
    _time_flash_danube(dev, card)
    row["float32"] = [_time_flash_f32(dev, card, *shape) for shape in
                      [(2, 4, 2, 40, 16), (b, h, hkv, s, d)]]
    return row


def _time_flash_f32(dev, card, b, h, hkv, s, d):
    """The float32 route (the CUDA-core kernel) at one causal shape against
    its plain version and float32 ``F.scaled_dot_product_attention``:
    device times from CUDA-graph replay and per-call times."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain,
                                                     visible_pairs)
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(b, h, s, d, generator=gen, device=dev)
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    fns = (lambda: flash_attention_kernel(q, k, v),
           lambda: flash_attention_plain(q, k, v),
           lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True))
    lib_err = (fns[2]() - fns[1]()).abs().max().item()
    reps = 10 if s > 1024 else 100
    dev_ms = [_graph_ms(f, reps=reps, replays=5) for f in fns]
    ms = [_time_ms(f, reps=reps, warmup=3) for f in fns]
    n_ops = 4 * d * visible_pairs(s) * b * h
    n_bytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    bound = max(n_ops / FP32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3
    shape = f"B{b} H{h} Hkv{hkv} S{s} D{d} float32 causal"
    print(f"[time] flash_attention {shape}: kernel {ms[0]!r} ms, plain "
          f"{ms[1]!r} ms, scaled_dot_product_attention {ms[2]!r} ms (per "
          f"call); device {dev_ms[0]!r}, {dev_ms[1]!r}, {dev_ms[2]!r} ms; "
          f"bound {bound!r} ms ({n_ops} flops at {FP32_OPS_PER_S:.3g} "
          f"flop/s, {n_bytes} bytes); {dev_ms[0] / dev_ms[2]!r}x SDPA's "
          f"device time; SDPA vs plain max_abs {lib_err!r}; card {card}")
    return {"shape": shape, "ms": ms[0], "plain_ms": ms[1],
            "library_ms": ms[2], "device_ms": dev_ms[0],
            "plain_device_ms": dev_ms[1], "library_device_ms": dev_ms[2],
            "bound_ms": bound}


def _time_flash_danube(dev, card):
    """One layer's attention of the h2o-danube prefill (B1, H32, Hkv 8,
    S4608, D80, bf16, causal, window 4096) through the kernel, its plain
    version and ``F.scaled_dot_product_attention`` with the same mask as a
    boolean ``attn_mask``; printed on a line of its own."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain,
                                                     visible_pairs)
    b, h, hkv, s, d, win = 1, 32, 8, DANUBE["prompt_len"], 80, 4096
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    i = torch.arange(s, device=dev)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - win)
    fns = (lambda: flash_attention_kernel(q, k, v, window=win),
           lambda: flash_attention_plain(q, k, v, window=win),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True))
    dev_ms = [_graph_ms(f, reps=4, replays=3) for f in fns]
    n_ops = 4 * d * visible_pairs(s, True, win) * b * h
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bound = max(n_ops / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3
    print(f"[time] flash_attention h2o-danube B{b} H{h} Hkv{hkv} S{s} D{d} "
          f"bf16 causal window {win}: device kernel {dev_ms[0]!r} ms, plain "
          f"{dev_ms[1]!r} ms, scaled_dot_product_attention(attn_mask) "
          f"{dev_ms[2]!r} ms; bound {bound!r} ms ({n_ops} flops); kernel "
          f"{n_ops / dev_ms[0] / 1e9!r} TFLOP/s, {dev_ms[0] / dev_ms[2]!r}x "
          f"the library call; card {card}")


# ---- the MLA and MoE serving slice: minicpm3, qwen3-moe, deepseek-v3 -----------

FAMILIES = dict(batch=4, prompt_len=2048, gen_len=32)
# deepseek-v3-671b's depth cut 61 -> 4 for one card (671e9 parameters do
# not fit 80 GB): its 3 dense MLA layers and 1 of its 58 MoE layers
DEEPSEEK_DEPTH = ((3, "dense"), (1, "moe"))
# (model, B, H, Hkv, S, D) of each served model's prefill attention: MLA's
# q/k head dim (nope + rope) with V padded to it, and qwen3's GQA
FAMILY_FLASH_SHAPES = [("minicpm3-4b", 4, 40, 40, 2048, 96),
                       ("qwen3-moe-30b-a3b", 4, 32, 4, 2048, 128),
                       ("deepseek-v3-671b", 4, 128, 128, 2048, 192)]


def _flash_at(dev, card, model, b, h, hkv, s, d, causal=True):
    """The bf16 flash kernel at one served prefill shape (causal, or not):
    held against its plain version (max abs 1e-2, and relative L2
    ``ATTN_REL_TOL``: with q and k at scale 0.5 the softmax is nearly
    uniform over a non-causal row and the outputs small, so a missing kv
    tile shows in the relative error first), one tensor-core launch; then
    timed beside its bound, the plain version and
    ``F.scaled_dot_product_attention`` (eager per call and CUDA-graph
    device time). Returns its entry of the ``flash_attention`` row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain,
                                                     visible_pairs)
    gen = torch.Generator(device=dev).manual_seed(4)
    q = (torch.randn(b, h, s, d, generator=gen, device=dev) * 0.5).bfloat16()
    k = (torch.randn(b, hkv, s, d, generator=gen, device=dev) * 0.5
         ).bfloat16()
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev).bfloat16()
    tc = flash_attention_kernel.tensor_core_launches
    got = flash_attention_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tc = flash_attention_kernel.tensor_core_launches - tc
    want = flash_attention_plain(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs().max().item()
    rel = _rel_err(got, want)
    tol = FLASH_TOL["bfloat16"]
    shape = (f"B{b} H{h} Hkv{hkv} S{s} D{d} bf16 "
             f"{'causal' if causal else 'non-causal'}")
    ok = (tc == 1 and bool(torch.isfinite(got.float()).all())
          and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
          and rel <= ATTN_REL_TOL)
    print(f"[kernel] flash_attention {model} prefill {shape}: max_abs_err="
          f"{err!r} (rtol=atol={tol}), relative L2 {rel!r} (tolerance "
          f"{ATTN_REL_TOL}), output max abs "
          f"{want.float().abs().max().item()!r}; tensor-core launches {tc} "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {model}'s prefill shape")
    del got, want
    fns = (lambda: flash_attention_kernel(q, k, v, causal=causal),
           lambda: flash_attention_plain(q, k, v, causal=causal),
           lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                  enable_gqa=True))
    dev_ms = [_graph_ms(f, reps=3, replays=3) for f in fns]
    ms = [_time_ms(f, reps=5, warmup=2) for f in fns]
    pairs = visible_pairs(s, causal) * b * h
    n_ops = 4 * d * pairs
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = n_ops / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    entry = {"model": model, "shape": shape, "max_abs_err": err,
             "rel_l2": rel, "ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2],
             "device_ms": dev_ms[0], "plain_device_ms": dev_ms[1],
             "library_device_ms": dev_ms[2],
             "bound_ms": max(t_ops, t_bytes) * 1e3,
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "achieved_tflops": n_ops / dev_ms[0] / 1e9,
             "vs_library": dev_ms[0] / dev_ms[2]}
    print(f"[time] flash_attention {model} prefill {shape}: kernel "
          f"{ms[0]!r} ms, plain {ms[1]!r} ms, scaled_dot_product_attention "
          f"{ms[2]!r} ms (per call); device {dev_ms[0]!r}, {dev_ms[1]!r}, "
          f"{dev_ms[2]!r} ms; bound {entry['bound_ms']!r} ms ({n_ops} flops "
          f"over {pairs} visible pairs; {n_bytes} bytes); kernel "
          f"{entry['achieved_tflops']!r} TFLOP/s, {entry['vs_library']!r}x "
          f"SDPA's device time; card {card}")
    return entry


def _serve_families(dev, card, kernels, flash_row):
    """Phase 13: the flash kernel at the three served prefill shapes (added
    to ``flash_row``), then minicpm3-4b and qwen3-moe-30b-a3b at full width
    and depth and deepseek-v3-671b at full width, depth 4, served through
    ``launch.serve.generate`` at batch 4, 2048-token prompts, 32 greedy
    tokens, seeded bf16 weights and the published capacity factor; the MoE
    models' decode against ``forward`` on a dropless copy at batch 1."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Segment
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[families] device memory at the start: {free} bytes free of "
          f"{total}, {torch.cuda.memory_allocated()} allocated by torch")
    flash_row["served_shapes"] = [_flash_at(dev, card, *shape)
                                  for shape in FAMILY_FLASH_SHAPES]
    gc.collect()
    torch.cuda.empty_cache()
    deepseek = get_config("deepseek-v3-671b")
    deepseek = dataclasses.replace(deepseek, segments=tuple(
        Segment("mla", mlp, n) for n, mlp in DEEPSEEK_DEPTH))
    results = []
    for cfg, label in ((get_config("minicpm3-4b"), "serve-minicpm3"),
                       (get_config("qwen3-moe-30b-a3b"), "serve-qwen3-moe"),
                       (deepseek, "serve-deepseek")):
        check = check_batch = None
        if cfg.moe is not None:
            check = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
            check_batch = 1
        res = _serve_path(cfg, label, FAMILIES["batch"],
                          FAMILIES["prompt_len"], FAMILIES["gen_len"], dev,
                          kernels, check, check_batch, strict=True)
        gc.collect()
        torch.cuda.empty_cache()
        _below_card(label, res["phase_peak_bytes"])
        res["card"] = card
        print(f"[families] {json.dumps(res)}")
        results.append(res)
    return results


# ---- the recurrent families: zamba2-2.7b (Mamba2 + shared attention) and
# xlstm-125m ---------------------------------------------------------------

RECURRENT = dict(batch=4, prompt_len=2048, gen_len=32)
# zamba2's decode against forward: forward's SSD needs S % 128 == 0, so a
# 1920-token prefill and 127 decode steps over the first 2048 tokens
ZAMBA2_CHECK = (2048, 1920)
# xlstm-125m is float32 throughout: decode vs forward within 1e-3 (relative
# L2), the same sums in another order through 12 recurrent layers. The
# mLSTM's parallel form runs a length that is not a multiple of its chunk
# (64) as one chunk, whose cumulative log-gates over ~2000 steps lose
# float32 digits in their differences (2080 tokens: 2.2e-3), so forward
# runs 2048 tokens in whole chunks, after a 1984-token prefill; a
# 2020-token prefill (one chunk) against that forward is printed
XLSTM_CHECK = (2048, 1984)
XLSTM_READ = (2048, 2020)
XLSTM_DECODE_TOL = 1e-3
# zamba2's shared block attention: head dim 5120 / 32 = 160, H = Hkv 32;
# (model, B, H, Hkv, S, D) of the served prefill, (B, H, Hkv, S, D) trained
ZAMBA2_PREFILL_ATTN = ("zamba2-2.7b", 4, 32, 32, 2048, 160)
ZAMBA2_TRAINED = (2, 32, 32, 4096, 160)
# train_4k with the batch cut 256 -> 2, as internlm2's run; xlstm-125m's
# sequence also cut 4096 -> 1024: its sLSTM runs one step at a time from
# the host, 34.6 s a step at 2 x 4096 on an H100 80GB HBM3 at 700 W
TRAIN_ZAMBA2 = dict(arch="zamba2-2.7b", steps=4, batch=2, seq=4096)
TRAIN_XLSTM = dict(arch="xlstm-125m", steps=4, batch=2, seq=1024)
# the kernel-vs-plain gradients at a depth cut: 12 Mamba2 layers and 2
# applications of the shared block
ZAMBA2_GRAD_LAYERS = 12


def _route_gradients(dev, cut, run, label, n_apps):
    """Phases 14 and 15, the gradient checks of ``cut`` (a full-width depth
    cut, bf16) at ``run``'s batch x seq: with float32 weights, the kernel
    route against the plain one, every leaf within ``LOGITS_REL_TOL``; in
    bf16 the same comparison printed, not held, while each of the
    ``n_apps`` flash backward calls is held, kernel vs plain on the q, k,
    v, out, dO and lse it got in the kernel route, within
    ``ATTN_REL_TOL``. Printed beside it: how far the plain
    backward's dq, dk, dv move when out and lse come from the plain
    forward instead (dv = P^T dO reads neither out nor, beyond a scale,
    lse; dq and dk read out through delta = rowsum(dO * out)), and K's and
    Q's mean over positions against their spread about it (a mean that
    the exact dS rows, summing to 0, cancel in dq = dS K and dk = dS^T Q)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_backward_plain,
        flash_attention_plain)
    _train_kernel_vs_plain(dev, _float32(cut), run, f"{label}-route")
    saved = []

    def recording(q, k, v, out, dout, lse, **kw):
        saved.append(([t.clone() for t in (q, k, v, out, dout, lse)],
                      {n: kw[n] for n in ("causal", "window") if n in kw}))
        return flash_attention_backward_kernel(q, k, v, out, dout, lse, **kw)
    _train_kernel_vs_plain(dev, cut, run, f"{label}-route-bf16",
                           backward=recording, held=False)
    if len(saved) != n_apps:
        raise AssertionError(f"{label}-backward: {len(saved)} flash "
                             f"backward calls, not {n_apps}")

    def mean_ratio(t):
        t = t.float()
        mean = t.mean(dim=2, keepdim=True)
        spread = (t - mean).square().sum(-1).mean(-1).sqrt()
        return (mean[:, :, 0].norm(dim=-1) / spread).median().item()
    for g, ((q, k, v, out, dout, lse), kw) in enumerate(saved):
        got = flash_attention_backward_kernel(q, k, v, out, dout, lse, **kw)
        want = flash_attention_backward_plain(q, k, v, out, dout, lse, **kw)
        lse_plain = torch.empty_like(lse)
        out_plain = flash_attention_plain(q, k, v, lse=lse_plain, **kw)
        moved = flash_attention_backward_plain(q, k, v, out_plain, dout,
                                               lse_plain, **kw)
        torch.cuda.synchronize()
        errs = [_rel_err(a, b) for a, b in zip(got, want)]
        shift = [_rel_err(a, b) for a, b in zip(moved, want)]
        print(f"[{label}-backward] application {g}, B{q.shape[0]} "
              f"H{q.shape[1]} S{q.shape[2]} D{q.shape[3]} bf16 "
              f"{'causal' if kw.get('causal', True) else 'non-causal'}: "
              f"kernel vs "
              f"plain on the kernel route's inputs, relative L2 dq/dk/dv "
              f"{errs} (tolerance {ATTN_REL_TOL}); the plain backward with "
              f"the plain forward's out and lse moves dq/dk/dv by {shift}, "
              f"out itself by {_rel_err(out, out_plain)!r}; median over "
              f"heads of |mean over positions| / spread: K "
              f"{mean_ratio(k)!r}, Q {mean_ratio(q)!r}")
        if not max(errs) <= ATTN_REL_TOL:
            raise AssertionError(f"{label}-backward: application {g}'s "
                                 "flash backward disagrees with its plain "
                                 "version")
        del got, want, moved, out_plain
    del saved
    torch.cuda.empty_cache()


def _recurrent_families(dev, card, kernels, flash_row, bwd_row, bwd_err,
                        splits):
    """Phase 14: the flash kernel at zamba2's D 160 prefill shape against
    its plain version and timed (added to ``flash_row``); zamba2-2.7b (54
    Mamba2 layers, 9 applications of the shared attention block) and
    xlstm-125m (12 mLSTM/sLSTM layers, float32) at full width and depth,
    served through ``launch.serve.generate`` at batch 4, 2048-token
    prompts, 32 greedy tokens, and trained through ``launch.train.main``
    for 4 steps (zamba2 at 2 x 4096 tokens, xlstm at 2 x 1024); zamba2's
    gradients through the kernels
    against the plain attention at 12 layers; the flash backward at D 160
    timed (added to ``bwd_row``)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Segment
    gc.collect()
    torch.cuda.empty_cache()
    flash_row.setdefault("served_shapes", []).append(
        _flash_at(dev, card, *ZAMBA2_PREFILL_ATTN))
    zamba2, xlstm = get_config("zamba2-2.7b"), get_config("xlstm-125m")
    for cfg, label, kw in (
            (zamba2, "serve-zamba2", dict(check_tokens=ZAMBA2_CHECK)),
            (xlstm, "serve-xlstm", dict(check_tokens=XLSTM_CHECK,
                                        decode_tol=XLSTM_DECODE_TOL,
                                        read_tokens=XLSTM_READ))):
        res = _serve_path(cfg, label, RECURRENT["batch"],
                          RECURRENT["prompt_len"], RECURRENT["gen_len"], dev,
                          kernels, strict=True, **kw)
        gc.collect()
        torch.cuda.empty_cache()
        _below_card(label, res["phase_peak_bytes"])
        res["card"] = card
        print(f"[recurrent] {json.dumps(res)}")

    torch.cuda.reset_peak_memory_stats()
    bwd_launches = _train_lm_path(
        dev, kernels, TRAIN_ZAMBA2, "train-zamba2",
        int8_ef=False)["flash_attention_backward_kernel"]
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(zamba2, segments=(
        Segment("mamba2", "none", ZAMBA2_GRAD_LAYERS),))
    _route_gradients(dev, cut, TRAIN_ZAMBA2, "train-zamba2",
                     cut.n_layers // cut.hybrid_period)
    entry = _time_flash_backward(dev, card, bwd_launches, bwd_err,
                                 ZAMBA2_TRAINED, "zamba2-2.7b",
                                 split=splits[_split_key("zamba2-2.7b",
                                                         True)])
    bwd_row["trained_shapes"] = [{k: entry[k] for k in BWD_ENTRY_KEYS}]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _train_lm_path(dev, kernels, TRAIN_XLSTM, "train-xlstm", profile=False,
                   int8_ef=False)


# ---- the enc-dec family (seamless-m4t-medium) and MLA/MoE training ----------

# seamless-m4t-medium served: the reference's prefill split of a sequence
# (launch/cells.py), s // 2 source frames and s // 2 prompt tokens, cut
# from prefill_32k to s = 4096, batch 4, 32 greedy tokens
SEAMLESS = dict(batch=4, src_len=2048, prompt_len=2048, gen_len=32)
# its attention, D 64 with H = Hkv 16: (model, B, H, Hkv, S, D) of the
# served encoder (non-causal), and (B, H, Hkv, S, D) of the backward timed
SEAMLESS_ATTN = ("seamless-m4t-medium", 4, 16, 16, 2048, 64)
SEAMLESS_BWD = (4, 16, 16, 2048, 64)
# train_4k with the batch cut 256 -> 4: rows of 2048 frames + 2048 tokens
TRAIN_SEAMLESS = dict(arch="seamless-m4t-medium", steps=4, batch=4, seq=4096)
# the kernel-vs-plain gradients at a depth cut of 2 + 2 layers, 2 x 4096
SEAMLESS_GRAD = dict(batch=2, seq=4096)
SEAMLESS_GRAD_LAYERS = 2
# MLA and MoE training, 4 steps of 2 x 4096 (train_4k, batch cut 256 -> 2)
# at full width: (arch, label, depth cut or None). qwen3-moe-30b-a3b's 61
# GB of weights leave no room for AdamW moments on one card, so 48 -> 6
# layers; one deepseek-v3 MoE layer (256 experts) is 11e9 parameters, so
# deepseek keeps its 3 dense MLA layers (61 -> 3) and its MTP layer
TRAIN_FAMILIES = [("minicpm3-4b", "train-minicpm3", None),
                  ("qwen3-moe-30b-a3b", "train-qwen3-moe", ("attn", "moe", 6)),
                  ("deepseek-v3-671b", "train-deepseek", ("mla", "dense", 3))]
TRAIN_FAMILY_RUN = dict(steps=4, batch=2, seq=4096)
# (name, (B, H, Hkv, S, D)) of the causal attention each phase-15 model
# trains, held in phase 12a's backward sweep beside SEAMLESS_BWD (the
# encoder's, non-causal): seamless's decoder self-attention, MLA's q/k
# head dim with V padded to it, qwen3's GQA
DEEPSEEK_TRAINED = (2, 128, 128, 4096, 192)
FAMILY_TRAINED = [
    ("trained seamless decoder self-attention", SEAMLESS_BWD),
    ("trained minicpm3-4b layer", (2, 40, 40, 4096, 96)),
    ("trained qwen3-moe layer", (2, 32, 4, 4096, 128)),
    ("trained deepseek-v3 layer", DEEPSEEK_TRAINED)]
# the keys of a trained_shapes entry of the flash_attention_backward row
BWD_ENTRY_KEYS = ("calls", "launches", "max_abs_err", "ms", "plain_ms",
                  "bound_ms", "bound_by", "library_ms", "device_ms",
                  "plain_device_ms", "library_device_ms", "achieved_tflops",
                  "vs_library")
# deepseek's kernel-vs-plain gradients at its trained cut (3 dense MLA
# layers + MTP), 1 x 2048: the plain route's dense float32 scores at
# 2 x 4096 and 128 heads would be 17 GB a tensor
DEEPSEEK_GRAD = dict(batch=1, seq=2048)


def _encdec_generate(params, cfg, frames, prompts, gen_len, clock=False):
    """Greedy generation with the model's own serving entry points, as the
    token server's ``generate`` runs an LM: one ``encdec.prefill`` of the
    source and the prompt, then ``gen_len`` ``decode_step`` calls (the last
    one's logits unused). Returns ``(tokens [B, P + gen_len], logits)``,
    ``logits`` the prefill's last position and every step's ``[B, V]``;
    with ``clock``, also the synchronised time to the first token and each
    step's time."""
    import torch
    from repro_torch.models import encdec
    from repro_torch.models.specs import materialize
    b, p = prompts.shape
    cache = materialize(encdec.cache_specs(cfg, b, p + gen_len,
                                           frames.shape[1]),
                        device=prompts.device)
    out, seen, steps = [prompts], [], []
    t0 = time.perf_counter()
    logits, cache = encdec.prefill(params, cfg, frames, prompts, cache)
    for i in range(gen_len):
        seen.append(logits[:, -1])
        tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        out.append(tok)
        if clock:
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
        logits, cache = encdec.decode_step(params, cfg, cache, tok, p + i)
    seen.append(logits[:, -1])
    toks = torch.cat(out, dim=1)
    if clock:
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        return toks, seen, steps[0], steps[1:]
    return toks, seen


def _encdec_prefill_last(params, cfg, frames, prompts, attention=None):
    """The last position's prefill logits ``[B, V]``, the attention through
    ``attention`` where given."""
    import torch
    from repro_torch.models import encdec
    from repro_torch.models.specs import materialize
    with (_attention_route(attention) if attention is not None
          else contextlib.nullcontext()):
        cache = materialize(encdec.cache_specs(cfg, *prompts.shape,
                                               frames.shape[1]),
                            device=prompts.device)
        logits, _ = encdec.prefill(params, cfg, frames, prompts, cache)
        torch.cuda.synchronize()
    return logits[:, -1]


def _chunked_cross_share(params, cfg, frames, prompts, decode_ms, label):
    """Phase 15b: the share of a decode step, and of a prefill whose prompt
    is half the source's length, that cross-attention on the reference's
    chunked route (``layers._Flash``, ``S_q != S_kv``) takes: each
    decoder layer's cross-attention at that query length over the source,
    timed alone (eager per call under CUDA events, host work included;
    random bf16 q, k, v), times the layers, over the step's time (the
    decode step's from the clocked run; the prefill's timed the same
    way). Prefill and training with ``S_dec == S_enc`` run no ``_Flash``
    (every attention is a kernel launch)."""
    import torch
    from repro_torch.models import encdec, layers
    from repro_torch.models.specs import materialize
    b, src = frames.shape[:2]
    gen = torch.Generator(device=frames.device).manual_seed(6)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=frames.device,
                           dtype=torch.bfloat16)
    xk = draw(b, src, cfg.n_kv_heads, cfg.d_head)
    xv = draw(b, src, cfg.n_kv_heads, cfg.d_head)
    half = prompts[:, :prompts.shape[1] // 2]
    cache = materialize(encdec.cache_specs(cfg, b, half.shape[1], src),
                        device=frames.device)
    prefill_ms = _time_ms(lambda: encdec.prefill(params, cfg, frames, half,
                                                 cache), reps=3, warmup=1)
    del cache
    out = {}
    for part, s_q, step_ms in (("decode", 1, decode_ms),
                               ("prefill", half.shape[1], prefill_ms)):
        q = draw(b, s_q, cfg.n_heads, cfg.d_head)
        one = _time_ms(lambda: layers.blockwise_attention(
            q, xk, xv, causal=False, q_chunk=cfg.q_chunk,
            k_chunk=cfg.k_chunk), reps=10 if s_q > 1 else 50, warmup=2)
        out[part] = cfg.n_dec_layers * one / step_ms
        print(f"[{label}] {part} at {s_q}-token queries over {src} source "
              f"frames: cross-attention on the chunked route {one!r} ms a "
              f"layer, x {cfg.n_dec_layers} layers of a {step_ms!r} ms "
              f"{part}: share {out[part]!r}")
    return out


def _serve_encdec(dev, card, kernels):
    """Phase 15b: seamless-m4t-medium at published width and depth (bf16,
    seeded weights) served by ``encdec.prefill`` + ``decode_step``: 4 rows
    of 2048 source frames and a 2048-token prompt, 32 greedy tokens. One
    tensor-core flash launch per attention of the prefill (12 encoder, 12
    decoder self, 12 cross) and two runs giving equal tokens
    (``_serve_main``); time to first token and decode ms a step; the
    chunked cross-attention's share; profiled prefill and decode step; the
    attention routes compared (``_attention_routes_agree``); every decode
    step's logits against ``decode_train`` over the same tokens
    (``LOGITS_REL_TOL``); peak memory."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.models.specs import materialize
    label = "serve-seamless"
    cfg = get_config("seamless-m4t-medium")
    b, src, p, g = (SEAMLESS[k] for k in ("batch", "src_len", "prompt_len",
                                           "gen_len"))
    out = {"model": cfg.name, "layers": [cfg.n_enc_layers, cfg.n_dec_layers],
           "batch": b, "src_len": src, "prompt_len": p, "gen_len": g}
    params = _drawn(encdec.encdec_specs(cfg), dev, out)
    print(f"[{label}] {cfg.name}: {cfg.n_enc_layers} encoder + "
          f"{cfg.n_dec_layers} decoder layers, d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}, d_head {cfg.d_head}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; n_params {out['parameters']}, "
          f"{out['param_bytes']} bytes ({cfg.param_dtype}), drawn in "
          f"{out['materialize_s']!r} s")
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.standard_normal((b, src, cfg.d_model))
                             .astype(np.float32), device=dev)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (b, p)),
                              device=dev)
    n_attn = cfg.n_enc_layers + 2 * cfg.n_dec_layers

    def gen(prm):
        return _encdec_generate(prm, cfg, frames, prompts, g)[0]
    with torch.inference_mode():
        # the main path: one greedy generation, as a user runs it
        toks = _serve_main(label, kernels, n_attn, lambda: gen(params),
                           prompts, g, cfg.vocab, out)
        again, seen, ttft, steps = _encdec_generate(params, cfg, frames,
                                                    prompts, g, clock=True)
        step_s = statistics.fmean(steps[1:])
        out.update(ttft_s=ttft, decode_ms=step_s * 1e3)
        print(f"[{label}] again, synchronised: time to first token (encoder, "
              f"prefill of {b} x {p} and the argmax) {ttft!r} s; decode "
              f"{step_s * 1e3!r} ms a step (mean after the first; first "
              f"{steps[0] * 1e3!r} ms), {b / step_s!r} tokens/s at batch "
              f"{b}; tokens equal to the first call's: "
              f"{torch.equal(toks, again)}")
        if not torch.equal(toks, again):
            raise AssertionError(f"{label}: two runs gave different tokens")
        out["chunked_cross_share"] = _chunked_cross_share(
            params, cfg, frames, prompts, out["decode_ms"], label)
        cache = materialize(encdec.cache_specs(cfg, b, p + g, src),
                            device=dev)
        _profile_serving(
            label, lambda: encdec.prefill(params, cfg, frames, prompts,
                                          cache),
            lambda: encdec.decode_step(params, cfg, cache, toks[:, -1:],
                                       p + g - 1), out)
        del cache
        _attention_routes_agree(
            params, cfg, label,
            lambda prm, attention=None: _encdec_prefill_last(
                prm, cfg, frames, prompts, attention),
            gen, toks[:, p:], n_attn, out)

        # prefill + decode against decode_train over the same tokens
        hidden = encdec.decode_train_hidden(params, cfg, toks,
                                            encdec.encode(params, cfg,
                                                          frames))
        dec = [_rel_err(got, hidden[:, p - 1 + i] @ params["head"])
               for i, got in enumerate(seen)]
        del hidden, seen
        out["decode_vs_train_rel"] = max(dec)
        print(f"[{label}] prefill + decode logits vs decode_train over "
              f"{p + g} tokens: relative L2 max {max(dec)!r}, mean "
              f"{statistics.fmean(dec)!r} over {len(dec)} positions "
              f"(tolerance {LOGITS_REL_TOL})")
        if not max(dec) <= LOGITS_REL_TOL:
            raise AssertionError(f"{label}: decode disagrees with "
                                 "decode_train")
    out["phase_peak_bytes"] = max(torch.cuda.max_memory_allocated(),
                                  out["materialize_peak_bytes"])
    out["card"] = card
    del params
    torch.cuda.empty_cache()
    _below_card(label, out["phase_peak_bytes"])
    print(f"[encdec] {json.dumps(out)}")
    return out


def _encdec_and_families(dev, card, kernels, flash_row, bwd_row, bwd_errs,
                         splits):
    """Phase 15: the flash kernels at seamless's D 64 shapes, non-causal
    (forward held and timed against SDPA, added to ``flash_row``; the
    backward held in phase 12a's sweep, its max abs error ``bwd_err``);
    seamless-m4t-
    medium served (``_serve_encdec``) and trained through
    ``launch.train.main`` (4 steps of 4 x 4096: 72 forward and 36 backward
    flash calls a step), its gradients at 2 + 2 layers kernel vs plain;
    the non-causal backward timed (added to ``bwd_row``); then minicpm3-4b,
    qwen3-moe-30b-a3b (6 layers) and deepseek-v3-671b (3 layers + MTP)
    trained 4 steps of 2 x 4096 each; deepseek's gradients kernel vs plain
    at its cut; qwen3's step twice under deterministic algorithms, bit for
    bit (in a child process)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Segment
    gc.collect()
    torch.cuda.empty_cache()
    flash_row.setdefault("served_shapes", []).append(
        _flash_at(dev, card, *SEAMLESS_ATTN, causal=False))
    gc.collect()
    torch.cuda.empty_cache()
    _serve_encdec(dev, card, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bwd_launches = _train_lm_path(
        dev, kernels, TRAIN_SEAMLESS, "train-seamless",
        int8_ef=False)["flash_attention_backward_kernel"]
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(get_config("seamless-m4t-medium"),
                              n_enc_layers=SEAMLESS_GRAD_LAYERS,
                              n_dec_layers=SEAMLESS_GRAD_LAYERS)
    _route_gradients(dev, cut, SEAMLESS_GRAD, "train-seamless",
                     cut.n_enc_layers + 2 * cut.n_dec_layers)
    entry = _time_flash_backward(dev, card, bwd_launches,
                                 bwd_errs["trained seamless encoder"],
                                 SEAMLESS_BWD, "seamless-m4t-medium",
                                 causal=False,
                                 split=splits[_split_key(
                                     "seamless-m4t-medium", False)])
    bwd_row.setdefault("trained_shapes", []).append(
        {k: entry[k] for k in BWD_ENTRY_KEYS})
    for arch, label, depth in TRAIN_FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, segments=(Segment(*depth),))
        bwd_launches = _train_lm_path(
            dev, kernels, dict(TRAIN_FAMILY_RUN, arch=arch), label,
            int8_ef=False, cfg=cfg)["flash_attention_backward_kernel"]
    # deepseek's trained layer (D 192, 128 heads) through the wide
    # tensor-core backward, against SDPA's backward
    gc.collect()
    torch.cuda.empty_cache()
    entry = _time_flash_backward(dev, card, bwd_launches,
                                 bwd_errs["trained deepseek-v3 layer"],
                                 DEEPSEEK_TRAINED, "deepseek-v3-671b",
                                 plain=False,
                                 split=splits[_split_key("deepseek-v3-671b",
                                                         True)])
    bwd_row["trained_shapes"].append({k: entry[k] for k in BWD_ENTRY_KEYS})
    # a second witness for deepseek's run, whose MTP term grows as the
    # reference's does at 128 heads (tests/test_torch_train.py)
    gc.collect()
    torch.cuda.empty_cache()
    _route_gradients(dev, cfg, DEEPSEEK_GRAD, "train-deepseek",
                     _flash_calls_a_step(cfg)[1])
    gc.collect()
    torch.cuda.empty_cache()
    _child("--moe-repeat", "moe-repeat")


def _moe_repeat(dev):
    """Phase 15 (``--moe-repeat``, in a child process): qwen3-moe-30b-a3b at
    full width, ``TRAIN_FAMILIES``' 6 layers, one training step of 2 x 4096
    through ``launch.train.main`` twice from the same seeded state under
    ``torch.use_deterministic_algorithms(True)``: losses and every
    parameter after the step equal bit for bit (the MoE dispatch's and
    combine's gathers run a deterministic scatter-add backward)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.lm import Segment
    from repro_torch.models.specs import tree_leaves
    arch, _, depth = TRAIN_FAMILIES[1]
    cfg = dataclasses.replace(get_config(arch), segments=(Segment(*depth),))
    argv = ["--arch", arch, "--steps", "1", "--batch",
            str(TRAIN_FAMILY_RUN["batch"]), "--seq",
            str(TRAIN_FAMILY_RUN["seq"])]
    torch.use_deterministic_algorithms(True)
    runs, losses = [], []
    for _ in range(2):
        rec = []
        out = io.StringIO()
        with _recorded_train_steps(rec), _launcher_config(cfg), \
                contextlib.redirect_stdout(out):
            params = train.main(argv)
        losses.append(rec[0]["loss"])
        runs.append([(path, t.detach().cpu()) for path, t in
                     tree_leaves(params)])
        del params
        torch.cuda.empty_cache()
    differ = ["/".join(p) for (p, a), (_, b) in zip(*runs)
              if not torch.equal(a, b)]
    print(f"[moe-repeat] {arch} depth {cfg.n_layers}, one step of "
          f"{argv[-3]} x {argv[-1]} twice from the seed under deterministic "
          f"algorithms: losses {losses!r}; {len(runs[0])} parameter leaves "
          f"after the step, differing: {differ}")
    if differ or losses[0] != losses[1] or len(runs[0]) != len(runs[1]):
        raise AssertionError("moe-repeat: the MoE training step does not "
                             "repeat bit for bit")


def _wrapper_host_times(dev, card) -> None:
    """``--wrapper-times``: host microseconds a call of each LIF wrapper at
    the 13 Spike-VGG16 state shapes, eager ``ms`` minus CUDA-graph device
    ``ms`` of the same call, inputs reused (cached or not, the host work is
    the same)."""
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import lif as lif_mod
    from repro_torch.snn import spike_vgg16
    _build.build([lif_mod.KERNEL])
    rng = np.random.default_rng(0)
    specs = [("lif_step_kernel", lif_mod.lif_step_kernel, 3)]
    if hasattr(lif_mod, "lif_backward_kernel"):
        specs.append(("lif_backward_kernel", lif_mod.lif_backward_kernel, 5))
    for name, fn, n_in in specs:
        host = []
        for shape in _lif_state_shapes(spike_vgg16()):
            args = [torch.as_tensor(rng.standard_normal(math.prod(shape))
                                    .astype(np.float32), device=dev)
                    .reshape(shape) for _ in range(n_in)]
            d = _graph_ms(lambda: fn(*args))
            m = _time_ms(lambda: fn(*args), reps=500)
            host.append((m - d) * 1e3)
        print(json.dumps({"wrapper": name, "host_us_per_call": host,
                          "mean_us": sum(host) / len(host), "card": card}))


# ---- the placement front end: policy, device resolver, flow report, runtime,
# service and the CLI ------------------------------------------------------------

# benchmarks/fault_replace.py's full configuration and operating point
FAULT_REPLACE = dict(budget=4096, deploy_budget=65536, threshold=0.02,
                     migration_weight=0.12, warm_t0=0.005)
# phase 11d runs that scenario at this share of its budgets (its model,
# NoC and fault whole): at the full budgets its host-bound searches took
# 120-218 s of the script's 1200 s
RUNTIME_BUDGET_CUT = 4
# benchmarks/service.py's full configuration
SERVICE = dict(budget=12000, fuse_rows=4, near_miss_seed=777, hit_repeats=300,
               cold_repeats=3, warm_repeats=3)


def _span_totals(rec, prefix: str) -> dict:
    out: dict = {}
    for ev in rec.events:
        if ev["kind"] == "span" and ev["name"].startswith(prefix):
            out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"]
    return out


def _policy_path(vgg, noc, kernels):
    """Phase 11a: ``deploy_model(method="policy", objective="latency")`` with
    its defaults (batch 64, 40 iterations) on the card: one
    ``link_traffic_routes`` launch an iteration, none of ``link_traffic``,
    and the best rollout's float32 latency against the host evaluate."""
    import torch
    from repro_torch.core.noc_batch import validate_placements
    from repro_torch.deploy import as_objective, deploy_model
    from repro_torch.obs import Recorder
    rec = Recorder()
    _reset_counts(kernels)
    t0 = time.perf_counter()
    plan = deploy_model(vgg, noc, method="policy", objective="latency",
                        recorder=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(kernels)
    res = plan.placement
    validate_placements(noc, res.placement, plan.graph.n)
    host = as_objective("latency").from_metrics(
        noc.evaluate(plan.graph, res.placement), noc)
    best = res.history[-1]["best_cost"]
    print(f"[policy] deploy_model(method='policy', objective='latency'): "
          f"wall {wall!r} s; stage times {json.dumps(plan.stage_times_s)}; "
          f"phase totals over {len(res.history)} iterations (host clock, "
          f"each phase ends in a sync): {json.dumps(_span_totals(rec, 'policy.'))}; "
          f"launches {launches}")
    if not math.isclose(best, host, rel_tol=1e-5):
        raise AssertionError(f"policy: best rollout latency {best!r} (cuda "
                             f"scorer) != host evaluate {host!r}")
    if (len(res.history) != 40 or launches["link_traffic_routes"] != 40
            or launches["link_traffic"] != 0):
        raise AssertionError(f"policy ran {len(res.history)} iterations "
                             f"and {launches} kernel launches, not 40 "
                             "link_traffic_routes launches and no "
                             "link_traffic launch")
    print(f"[policy] best latency {best!r} s (cuda) vs host evaluate "
          f"{host!r} s ok; link_traffic_routes 40, link_traffic 0 ok")


def _ppo_nondeterministic_ops(vgg, noc):
    """The ops of one PPO deploy that PyTorch reports as having no
    deterministic implementation on the card."""
    import warnings
    import torch
    from repro_torch.deploy import deploy_model
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            deploy_model(vgg, noc, method="ppo", objective="latency",
                         budget=2)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(".")[0] for w in caught
                   if "deterministic" in str(w.message)})


def _ppo_device_resolver(vgg, noc, kernels, host_plan, host_phases):
    """Phase 11b: phase 4's PPO with ``device_discretize=True``. Every
    rollout's placements from the resolver on the card equal the numpy
    resolver's on the same cells; the best plan matches the host evaluate;
    the history is held against phase 4's host-resolver run where the card
    shows PPO to repeat itself. Returns the plan."""
    import numpy as np
    import torch
    from repro_torch.core.placement import ppo as ppo_mod
    from repro_torch.core.placement.discretize_batch import \
        resolve_collisions_batch
    from repro_torch.deploy import as_objective, deploy_model
    from repro_torch.device import resolve_device
    from repro_torch.obs import Recorder
    calls = []
    real = ppo_mod.make_torch_resolver

    def recording(rows, cols, priority=None, device=None):
        resolve = real(rows, cols, priority, device=device)

        def resolve_and_keep(cells):
            out = resolve(cells)
            calls.append((np.array(cells), out))
            return out
        return resolve_and_keep

    rec = Recorder()
    ppo_mod.make_torch_resolver = recording
    try:
        _reset_counts(kernels)
        t0 = time.perf_counter()
        plan = deploy_model(vgg, noc, method="ppo", objective="latency",
                            device_discretize=True, recorder=rec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ppo_mod.make_torch_resolver = real
    launches = _counts(kernels)
    for it, (cells, out) in enumerate(calls):
        want = resolve_collisions_batch(cells, noc.rows, noc.cols)
        if out.device.type != resolve_device(None).type or \
                not np.array_equal(out.cpu().numpy(), want):
            raise AssertionError(f"device resolver differs from numpy on "
                                 f"rollout {it} (or left the card)")
    if len(calls) != 40 or calls[0][0].shape != (256, plan.graph.n):
        raise AssertionError(f"device resolver ran {len(calls)} times")
    res = plan.placement
    host = as_objective("latency").from_metrics(
        noc.evaluate(plan.graph, res.placement), noc)
    best = res.history[-1]["best_cost"]
    if not math.isclose(best, host, rel_tol=1e-5) or \
            launches["link_traffic_routes"] != 40:
        raise AssertionError(f"PPO (device resolver): best {best!r} vs host "
                             f"{host!r}; launches {launches}")
    phases = _span_totals(rec, "ppo.")
    print(f"[ppo-dev] device resolver == numpy resolver on all {len(calls)} "
          f"rollouts of {calls[0][0].shape} cells ok; best latency {best!r} "
          f"vs host {host!r} ok; wall {wall!r} s; launches {launches}")
    print(f"[ppo-dev] ppo.discretize over 40 iterations: device resolver "
          f"{phases['ppo.discretize']!r} s, host resolver (phase 4) "
          f"{host_phases['ppo.discretize']!r} s (host clock; both bin on the "
          f"host)")
    same = res.history == host_plan.placement.history and np.array_equal(
        res.placement, host_plan.placement.placement)
    print(f"[ppo-dev] whole history equal to phase 4's host-resolver run: "
          f"{same}")
    if not same:
        again = deploy_model(vgg, noc, method="ppo", objective="latency")
        repeats = again.placement.history == host_plan.placement.history
        ops = _ppo_nondeterministic_ops(vgg, noc)
        print(f"[ppo-dev] a second host-resolver run repeats phase 4: "
              f"{repeats}; ops PyTorch reports as nondeterministic on the "
              f"card: {ops}")
        if repeats:
            raise AssertionError("PPO repeats itself on the card but the "
                                 "device resolver changed its history")
    return plan


def _flow_of(plan, noc):
    """Phase 11c: the flow report of a plan, byte-hops and hottest link
    equal to the host evaluate."""
    from repro_torch.obs import flow_report
    rep = flow_report(noc, plan.graph, plan.placement)
    m = noc.evaluate(plan.graph, plan.placement.placement)
    if rep.byte_hops != m.comm_cost or rep.max_link != m.max_link:
        raise AssertionError(f"flow report {rep.byte_hops!r}/"
                             f"{rep.max_link!r} != host evaluate "
                             f"{m.comm_cost!r}/{m.max_link!r}")
    print(f"[flow] PPO plan: byte_hops {rep.byte_hops!r}, max_link "
          f"{rep.max_link!r} == host evaluate; {rep.n_active_links} of "
          f"{rep.n_links} links active, gini {rep.gini!r}, cov {rep.cov!r} ok")


def _runtime_path(kernels):
    """Phase 11d: ``run_scenario`` at benchmarks/fault_replace.py's
    configuration, its budgets cut by ``RUNTIME_BUDGET_CUT``: S-VGG16 on
    hier 2x2:4x4, the busiest inter-chip link of the seeded deployment
    dropped at step 2, ``compare_cold=True``, with the recorder (deploying
    itself); every objective it records is the host evaluate's. At a
    sixteenth of the full budgets, with the busiest
    inter-chip link of that budget's deployment dropped, the scenario runs
    twice, with the recorder (deploying itself) and without (on that
    deployment): both results must be identical, with a replacement."""
    import numpy as np
    import torch
    from repro_torch.core import HierarchicalMesh
    from repro_torch.core.topology import degrade
    from repro_torch.deploy import as_objective, deploy_model, run_scenario
    from repro_torch.obs import Recorder
    from repro_torch.snn import spike_vgg16
    fr = FAULT_REPLACE
    budget, deploy_budget = (fr["budget"] // RUNTIME_BUDGET_CUT,
                             fr["deploy_budget"] // RUNTIME_BUDGET_CUT)
    hm = HierarchicalMesh(2, 2, 4, 4, **FULL_NOC)
    cfg = spike_vgg16(n_classes=10, in_res=32, T=4)
    t0 = time.perf_counter()
    plan = deploy_model(cfg, hm, method="simulated_annealing", seed=0,
                        budget=deploy_budget, schedule="none")
    deploy_s = time.perf_counter() - t0

    def busiest_interchip_link(plan):
        m = hm.evaluate(plan.graph, plan.placement.placement)
        loads = np.zeros(hm.n_links)
        for label, vol in m.link_traffic.items():
            loads[hm.link_id_of(label)] = vol
        return m, int(np.argmax(np.where(hm.interchip_mask(), loads, -1.0)))
    m, lid = busiest_interchip_link(plan)
    kw = dict(method="simulated_annealing", objective="comm_cost",
              budget=budget, deploy_budget=deploy_budget,
              migration_weight=fr["migration_weight"],
              warm_kw={"t0": fr["warm_t0"]}, seed=0,
              threshold=fr["threshold"], compare_cold=True,
              cold_budget=deploy_budget)
    scenario = f"steps=6;fault=link:{lid}@2"
    rec = Recorder()
    _reset_counts(kernels)
    t0 = time.perf_counter()
    on = run_scenario(cfg, hm, scenario, recorder=rec, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(kernels)
    cut = dict(kw, budget=fr["budget"] // 16,
               deploy_budget=fr["deploy_budget"] // 16,
               cold_budget=fr["deploy_budget"] // 16)
    t0 = time.perf_counter()
    cut_plan = deploy_model(cfg, hm, method="simulated_annealing", seed=0,
                            budget=cut["deploy_budget"], schedule="none")
    # the cut deployment's own busiest link, so that the pair recovers
    cut_scenario = f"steps=6;fault=link:{busiest_interchip_link(cut_plan)[1]}@2"
    cut_on = run_scenario(cfg, hm, cut_scenario, recorder=Recorder(), **cut)
    cut_off = run_scenario(cfg, hm, cut_scenario, plan=cut_plan, **cut)
    cut_s = time.perf_counter() - t0
    identical = cut_on.to_dict() == cut_off.to_dict()
    calls = rec.counters.get("noc_batch.dispatches", 0)
    print(f"[runtime] hier 2x2:4x4 S-VGG16, budgets {budget} (deploy "
          f"{deploy_budget}), link {lid} dropped at step 2: "
          f"replacements {on.n_replacements}, cold fallbacks "
          f"{on.n_cold_fallbacks}, moved {on.moved_state_bytes / 1e6!r} MB, "
          f"max degradation {on.max_degradation!r}, final objective "
          f"{on.final_objective!r}; wall {wall!r} s (first deployment "
          f"{deploy_s!r} s); {calls} scorer calls = {calls / wall!r} a "
          f"second; launches {launches}")
    print("[runtime] recoveries " + json.dumps(on.recoveries))
    print(f"[runtime] budgets / 16 ({cut['budget']}, deploy "
          f"{cut['deploy_budget']}), {cut_scenario}: replacements "
          f"{cut_on.n_replacements}, final objective "
          f"{cut_on.final_objective!r}; result identical with the recorder "
          f"on and off: {identical} ({cut_s!r} s for both and the "
          f"deployment)")
    if not identical:
        raise AssertionError("run_scenario differs with the recorder on and "
                             "off on the card")
    if cut_on.n_replacements < 1:
        raise AssertionError("the recorder on/off pair made no replacement")
    obj = as_objective("comm_cost")
    final = degrade(hm, links=on.samples[-1]["faults"]["links"])
    host_final = obj.from_metrics(
        final.evaluate(on.final_graph, on.final_placement), final)
    host_initial = float(m.comm_cost)
    first = on.samples[0]["objective"]
    after = [r["objective_after"] for r in on.recoveries]
    if on.final_objective != host_final or first != host_initial or \
            (after and after[-1] != host_final):
        raise AssertionError(f"runtime objectives: initial {first!r} vs "
                             f"host {host_initial!r}, final "
                             f"{on.final_objective!r} vs host "
                             f"{host_final!r}, last recovery {after}")
    print("[runtime] initial, recovered and final objectives equal the host "
          "evaluate ok")
    for r in on.recoveries:
        cold = r["cold_reference"]
        print(f"[runtime] recovery at step {r['t']}: warm "
              f"{r['objective_after']!r} vs cold reference "
              f"{cold['objective']!r} (ratio "
              f"{r['objective_after'] / cold['objective']!r}), moved "
              f"{r['moved_state_bytes']!r} vs {cold['moved_state_bytes']!r} "
              "bytes")


def _service_path():
    """Phase 11e: the placement service at benchmarks/service.py's full
    configuration (S-ResNet18 on a 4x4 mesh, balanced, SA budget 12000,
    comm_cost) on the card: cold, hit and warm latencies, a fused batch of
    4 seeds bit-identical to 4 serial runs, the cache saved and reloaded to
    a hit, and one POST /deploy to a localhost server."""
    import tempfile
    import threading
    import numpy as np
    from repro_torch.core import NoC
    from repro_torch.deploy import (DeployRequest, PlacementService,
                                    PlanCache, execute_request)
    from repro_torch.deploy.service import make_server, request_over_http
    from repro_torch.obs import bench_percentiles
    from repro_torch.snn import spike_resnet18
    sv = SERVICE
    noc = NoC(4, 4, **FULL_NOC)
    cfg = spike_resnet18(n_classes=10, in_res=32, T=4)

    def req(seed):
        return DeployRequest.from_call(
            cfg, noc, partition_strategy="balanced",
            method="simulated_annealing", objective="comm_cost",
            schedule="none", budget=sv["budget"], seed=seed)

    cold = []
    cold_lat = bench_percentiles(
        lambda: cold.append(PlacementService().submit(req(len(cold)))),
        repeats=sv["cold_repeats"], warmup=0)
    if not all(r.status == "miss" for r in cold):
        raise AssertionError("service: cold requests were not misses")
    svc = PlacementService()
    svc.submit(req(0))
    hit = bench_percentiles(lambda: svc.submit(req(0)),
                            repeats=sv["hit_repeats"])
    if svc.submit(req(0)).placement != cold[0].placement:
        raise AssertionError("service: a hit differs from the cold plan")
    donor_plan = execute_request(req(0))
    warm_resps = []

    def warm_once():
        # a fresh cache holding only the donor, so every repeat starts
        # from the same donor
        cache = PlanCache()
        cache.put(req(0), donor_plan)
        resp = PlacementService(cache=cache).submit(req(sv["near_miss_seed"]))
        if resp.status != "warm":
            raise AssertionError(f"service: near miss was {resp.status}")
        warm_resps.append(resp)
    warm = bench_percentiles(warm_once, repeats=sv["warm_repeats"],
                             warmup=0)
    warm_resp = warm_resps[0]
    seeds = [100 + i for i in range(sv["fuse_rows"])]
    t0 = time.perf_counter()
    fused = PlacementService().submit_batch([req(s) for s in seeds])
    fused_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = [execute_request(req(s)) for s in seeds]
    serial_s = time.perf_counter() - t0
    for s, f, p in zip(seeds, fused, serial):
        if not (f.fused and f.placement == p.placement.placement.tolist()
                and f.objective_cost == p.placement.objective_cost):
            raise AssertionError(f"service: fused row of seed {s} differs "
                                 "from its serial run on the card")
    with tempfile.TemporaryDirectory() as td:
        path = str(Path(td) / "plans.json")
        svc.cache.save(path)
        reloaded = PlacementService(cache=PlanCache.load(path)).submit(req(0))
    if reloaded.status != "hit" or reloaded.placement != cold[0].placement:
        raise AssertionError("service: the reloaded cache did not hit")
    entry = svc.cache.get(cold[0].cache_key)
    server, queue = make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        over_http = request_over_http(url, req(0))
    finally:
        server.shutdown()
        server.server_close()
        queue.close()
        thread.join(timeout=30)
    if over_http.status != "hit" or over_http.placement != cold[0].placement:
        raise AssertionError("service: POST /deploy did not return the "
                             "cached plan")
    print(f"[service] S-ResNet18 on 4x4, SA budget {sv['budget']}: cold p50 "
          f"{cold_lat['p50']!r} s, hit p50 {hit['p50']!r} s "
          f"({hit['n']} hits), warm near miss p50 {warm['p50']!r} s "
          f"({warm_resp.attempts} attempts, cost "
          f"{warm_resp.objective_cost!r} vs donor "
          f"{donor_plan.placement.objective_cost!r}); cold cost "
          f"{cold[0].objective_cost!r}; entry device {entry['device']}, "
          f"backend {entry['resolved_backend']}")
    print(f"[service] fused batch of {len(seeds)} seeds {fused_s!r} s vs "
          f"serial {serial_s!r} s: every row bit-identical ok; cache saved, "
          f"reloaded, hit ok; POST /deploy on localhost {over_http.status} "
          f"in {over_http.latency_s!r} s service-side, the cached plan ok")


def _cli_path(kernels):
    """Phase 11f: ``python -m repro_torch.deploy --smoke`` and ``report
    --method sa --backend device`` as subprocesses on the card (the
    report's trace holds one ``sa.device`` event, one search through the
    kernel), then the same report in process with one ``sa_chains`` launch
    per ``sa.device`` event."""
    import os
    import tempfile
    from repro_torch.deploy import cli
    from repro_torch.obs import read_jsonl
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    report = ["report", "--method", "sa", "--backend", "device",
              "--cores", "64"]
    with tempfile.TemporaryDirectory() as td:
        trace = str(Path(td) / "report.jsonl")
        for argv in (["--smoke"], report + ["--trace", trace]):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-m", "repro_torch.deploy",
                                  *argv], cwd=root, env=env,
                                 capture_output=True, text=True, timeout=600)
            if out.returncode != 0:
                raise AssertionError(f"python -m repro_torch.deploy {argv} "
                                     f"failed:\n{out.stderr[-3000:]}")
            print(f"[cli] python -m repro_torch.deploy {' '.join(argv)}: "
                  f"exit 0 in {time.perf_counter() - t0!r} s; last lines: "
                  + " | ".join(out.stdout.strip().splitlines()[-3:]))
        searches = [e for e in read_jsonl(trace) if e["name"] == "sa.device"]
        if len(searches) != 1 or not searches[0]["attrs"]["use_pallas"]:
            raise AssertionError(f"report ran {len(searches)} device SA "
                                 "searches, not one through the kernel")
        _reset_counts(kernels)
        trace2 = str(Path(td) / "report2.jsonl")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(report + ["--trace", trace2])
        launches = _counts(kernels)
        n = sum(e["name"] == "sa.device" for e in read_jsonl(trace2))
    if n != 1 or launches["sa_chains"] != n or launches["delta_cost"] != 0:
        raise AssertionError(f"report: {n} sa.device events, launches "
                             f"{launches}")
    print(f"[cli] report --method sa --backend device: {n} device SA search, "
          f"sa_chains launches {launches['sa_chains']} (one per search), "
          f"delta_cost {launches['delta_cost']} ok")


def _placement_front_end(vgg, noc, kernels, ppo_plan, ppo_phases):
    """Phase 11: the placement front end on the card."""
    t0 = time.perf_counter()
    _policy_path(vgg, noc, kernels)
    plan = _ppo_device_resolver(vgg, noc, kernels, ppo_plan, ppo_phases)
    _flow_of(plan, noc)
    _runtime_path(kernels)
    _service_path()
    _cli_path(kernels)
    print(f"[front-end] phase 11 in {time.perf_counter() - t0!r} s")


# ---- the LM training slice: the flash backward kernel, LM training ------------

TRAIN = dict(arch="internlm2-1.8b", steps=6, batch=2, seq=4096)
# the trained internlm2-1.8b layer's attention: [B, H, Hkv, S, D]
TRAINED = (TRAIN["batch"], 16, 8, TRAIN["seq"], 128)
# flash backward vs plain: float32 within 1e-4 of each gradient's largest
# magnitude plus 1e-5 where a gradient cancels to rounding; bfloat16 within
# relative L2 2e-2 (float32 arithmetic on bf16 inputs, one rounding each)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the forward's lse against the plain version's: float32 1e-5; the
# tensor-core kernel keeps m in log2 units, so bf16 within 1e-4
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def _bwd_case(dev, b, h, hkv, s, d, window, dtype, seed=0, causal=True):
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=gen, device=dev) * 0.5
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev) * 0.5
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    dout = torch.randn(b, h, s, d, generator=gen, device=dev)
    q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
    lse = torch.empty(b, h, s, device=dev)
    out = flash_attention_kernel(q, k, v, causal=causal, window=window,
                                 lse=lse)
    return q, k, v, out, dout, lse


def _bwd_err(got, want, dtype) -> float:
    """The backward's error against its plain version, the worst of dq, dk,
    dv: in float32 the max abs error over the gradient's largest magnitude
    (magnitudes below 0.1 count as 0.1, so a gradient that cancels to
    rounding is held to 1e-5 absolute); in bfloat16 the relative L2
    error."""
    if dtype == "float32":
        return max(((g - w).abs().max()
                    / w.abs().max().clamp(min=0.1)).item()
                   for g, w in zip(got, want))
    return max(_rel_err(g, w) for g, w in zip(got, want))


def _backward_plain_sliced(q, k, v, out, dout, lse, *, causal=True,
                           window=None):
    """``flash_attention_backward_plain`` one batch row and a few whole kv
    head groups at a time, each slice's dense float32 ``[heads, S, S]``
    tensors at most ``2^26`` elements (256 MiB) where a group allows: the
    same sums as the whole call, whose scores at deepseek's trained shape
    would be 17 GB a tensor. Returns ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain)
    b, h, s, _ = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    g = max(1, min(hkv, (1 << 26) // (rep * s * s)))
    grads = [torch.empty_like(t) for t in (q, k, v)]
    for i in range(b):
        for j in range(0, hkv, g):
            hs, ks = slice(j * rep, (j + g) * rep), slice(j, j + g)
            flash_attention_backward_plain(
                q[i:i + 1, hs], k[i:i + 1, ks], v[i:i + 1, ks],
                out[i:i + 1, hs], dout[i:i + 1, hs], lse[i:i + 1, hs],
                causal=causal, window=window, dq=grads[0][i:i + 1, hs],
                dk=grads[1][i:i + 1, ks], dv=grads[2][i:i + 1, ks])
    return tuple(grads)


@contextlib.contextmanager
def _held_backward(sink, calls):
    """Within the scope the model's attention runs the flash kernels, as
    on the main path, and its first ``calls`` backward calls are each held
    against the plain version on the same q, k, v, out, dO and lse
    (``_backward_plain_sliced``): ``(shape, causal, [relative L2 of dq,
    dk, dv])`` is appended to ``sink``. The kernel is launched once a
    call, as without the scope."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_kernel)

    def checked(q, k, v, out, dout, lse, *, causal=True, window=None, **kw):
        got = flash_attention_backward_kernel(q, k, v, out, dout, lse,
                                              causal=causal, window=window,
                                              **kw)
        if len(sink) < calls:
            want = _backward_plain_sliced(q, k, v, out, dout, lse,
                                          causal=causal, window=window)
            sink.append((tuple(q.shape) + (k.shape[1],), causal,
                         [_rel_err(a, w) for a, w in zip(got, want)]))
        return got
    with _attention_route(flash_attention_kernel, checked):
        yield


def _bwd_sweep():
    """Phase 12a's backward cases: (name, B, H, Hkv, S, D, window, dtype,
    causal). Every trained shape of phases 12, 14 and 15; then the bf16
    tensor-core route past D 128 over its buckets (D 130 with element-wise
    loads, 136, 200, 224, 256), masks, GQA 4:1 and S off the 64-row tile;
    then the wgmma route up to D 128 at D 32 and 96 (padded to 64-column
    chunks), a window, non-causal, GQA 8:1, S = 1 and S off the tile (the
    trained shapes at D 64, 96 and 128 take it too; "odd S and D" in bf16,
    D 20, keeps the mma.sync kernels)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    return [("trained internlm2 layer",) + TRAINED + (None, bf16, True),
            ("trained zamba2 shared block",) + ZAMBA2_TRAINED
            + (None, bf16, True),
            ("trained seamless encoder",) + SEAMLESS_BWD
            + (None, bf16, False),
            *((name,) + shape + (None, bf16, True) for name, shape in
              FAMILY_TRAINED),
            ("h2o-danube", 1, 32, 8, 4608, 80, 4096, bf16, True),
            ("smoke configs", 2, 4, 2, 128, 16, None, f32, True),
            ("smoke configs window 24", 2, 4, 2, 128, 16, 24, f32, True),
            ("odd S and D", 1, 4, 2, 77, 20, 5, f32, True),
            ("odd S and D", 1, 4, 2, 77, 20, 5, bf16, True),
            ("D=256", 1, 4, 2, 100, 256, 37, f32, True),
            ("wide D 130", 1, 4, 2, 200, 130, None, bf16, True),
            ("wide D 136 window", 2, 4, 4, 300, 136, 50, bf16, True),
            ("wide D 200 non-causal", 1, 4, 2, 130, 200, None, bf16, False),
            ("wide D 224", 1, 8, 8, 257, 224, None, bf16, True),
            ("wide D 256 window", 1, 4, 2, 333, 256, 37, bf16, True),
            ("wide GQA 4:1 D 192", 2, 16, 4, 512, 192, None, bf16, True),
            ("wide S=1 D 192", 2, 8, 2, 1, 192, None, bf16, True),
            ("wide S=65 D 160", 1, 4, 2, 65, 160, None, bf16, True),
            ("wgmma D 32 S=65", 1, 4, 2, 65, 32, None, bf16, True),
            ("wgmma D 64 window", 2, 4, 2, 300, 64, 50, bf16, True),
            ("wgmma D 96 non-causal S=77", 1, 4, 4, 77, 96, None, bf16,
             False),
            ("wgmma GQA 8:1 D 128 window", 1, 16, 2, 333, 128, 100, bf16,
             True),
            ("wgmma S=1 D 128", 2, 8, 2, 1, 128, None, bf16, True)]


def _digest(tensors) -> str:
    """The first 16 hex digits of a SHA-256 over the tensors' bytes."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _backward_digests(dev):
    """``--flash-backward-digests``: a digest of dq, dk, dv at every case of
    the sweep on a route the wgmma kernels left as it was (float32 at every
    D; bf16 past D 128), from the kernel alone, so a copy of this script in
    an older checkout prints that checkout's bits on the same inputs."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel)
    for name, b, h, hkv, s, d, window, dtype, causal in _bwd_sweep():
        if dtype == torch.bfloat16 and d <= 128:
            continue
        args = _bwd_case(dev, b, h, hkv, s, d, window, dtype, causal=causal)
        got = flash_attention_backward_kernel(*args, causal=causal,
                                              window=window)
        torch.cuda.synchronize()
        print(f"[digest] flash_attention_backward {name} B{b} H{h} Hkv{hkv} "
              f"S{s} D{d} window {window} {dtype} causal {causal}: "
              f"{_digest(got)}")
        del args, got


def _check_flash_backward(dev):
    """Phase 12a: the flash backward kernel against its plain version over
    the sweep (every trained shape of phases 12, 14 and 15 among it),
    deterministic, every bf16 call a tensor-core launch; the forward's lse
    against the plain version's; the forward's output bit-identical with
    and without lse; every bf16 call up to D 128 (D a multiple of 8: every
    case but "odd S and D") a wgmma launch. Returns the max abs error of
    each case, by name."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_kernel,
        flash_attention_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    errs = {}
    fn = flash_attention_backward_kernel
    for name, b, h, hkv, s, d, window, dtype, causal in _bwd_sweep():
        args = _bwd_case(dev, b, h, hkv, s, d, window, dtype, causal=causal)
        kw = dict(causal=causal, window=window)
        tc, wg = fn.tensor_core_launches, fn.wgmma_launches
        got = flash_attention_backward_kernel(*args, **kw)
        again = flash_attention_backward_kernel(*args, **kw)
        tc = fn.tensor_core_launches - tc
        wg = fn.wgmma_launches - wg
        want_wg = 2 if dtype == bf16 and d <= 128 and d % 8 == 0 else 0
        torch.cuda.synchronize()
        want = _backward_plain_sliced(*args, **kw)
        key = str(dtype).split(".")[1]
        err = _bwd_err(got, want, key)
        cancel, note = 0.0, ""
        if s == 1:
            # each row sees itself alone: p = 1 and dp = delta, so dq and dk
            # cancel to rounding in both versions and are held as float32
            # holds them (1e-5 absolute); dv (= dO) as every gradient
            err = _bwd_err(got[2:], want[2:], key)
            cancel = _bwd_err(got[:2], want[:2], "float32")
            note = (f"; S = 1: dv alone, dq and dk {cancel!r} (max abs over "
                    f"max, tolerance {BWD_TOL['float32']})")
        per = [_rel_err(g, w) for g, w in zip(got, want)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        ok = (err <= BWD_TOL[key] and cancel <= BWD_TOL["float32"] and same
              and finite and tc == (2 if dtype == bf16 else 0)
              and wg == want_wg)
        print(f"[kernel] flash_attention_backward {name} B{b} H{h} Hkv{hkv} "
              f"S{s} D{d} window {window} {dtype}"
              f"{'' if causal else ' non-causal'}: error {err!r} "
              f"({'relative L2' if key == 'bfloat16' else 'max abs over max'}"
              f", tolerance {BWD_TOL[key]}; dq, dk, dv relative L2 {per}"
              f"{note}); a "
              f"second run bit-identical: {same}; tensor-core launches {tc} "
              f"of 2, wgmma {wg} of {want_wg}; digest {_digest(got)} "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"flash_attention_backward disagrees with "
                                 f"its plain version on {name}")
        errs.setdefault(name, max((g.float() - w.float()).abs().max().item()
                                  for g, w in zip(got, want)))
        del args, got, again, want
    # lse, and the output with and without it
    for name, b, h, hkv, s, d, window, dtype in [
            ("smoke configs", 2, 4, 2, 128, 16, 24, f32),
            ("odd S and D", 1, 4, 2, 77, 20, 5, f32),
            ("served internlm2 prefill", SERVED["batch"], 16, 8,
             SERVED["prompt_len"], 128, None, f32),
            ("served internlm2 prefill", SERVED["batch"], 16, 8,
             SERVED["prompt_len"], 128, None, bf16),
            ("h2o-danube", 1, 32, 8, 4608, 80, 4096, bf16)]:
        q, k, v, out, _, lse = _bwd_case(dev, b, h, hkv, s, d, window, dtype)
        plain = torch.empty_like(lse)
        flash_attention_plain(q, k, v, window=window, lse=plain)
        without = flash_attention_kernel(q, k, v, window=window)
        torch.cuda.synchronize()
        key = str(dtype).split(".")[1]
        err = (lse - plain).abs().max().item()
        same = torch.equal(out, without)
        ok = err <= LSE_TOL[key] * (1 + plain.abs().max().item()) and same
        print(f"[kernel] flash_attention lse {name} B{b} H{h} Hkv{hkv} S{s} "
              f"D{d} window {window} {dtype}: max abs error {err!r} "
              f"(tolerance {LSE_TOL[key]} x (1 + max |lse| "
              f"{plain.abs().max().item()!r})); output bit-identical without "
              f"lse: {same} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"flash_attention lse disagrees on {name}")
    return errs


# the RoPE calls of internlm2-1.8b's training step (b32s4k): q and k of a
# layer, bf16, positions [4096], its published theta
ROPE_TIMED = [("internlm2 q", (32, 4096, 16, 128)),
              ("internlm2 k", (32, 4096, 8, 128))]
# those of the main path's step (phase 12, ``TRAIN``), at the registry's
# theta
ROPE_MAIN = [(f"trained internlm2 {name}",
              (TRAIN["batch"], TRAIN["seq"], heads, 128))
             for name, heads in (("q", 16), ("k", 8))]


def _rope_rows(dev, card, calls, theta) -> list:
    """The RoPE kernel at each ``(label, shape)`` of ``calls`` (bf16,
    positions ``[S]``): held bit for bit against ``rope_plain`` in both
    directions (the inverse also against autograd through the plain ops),
    then each direction timed against its bound (x read once, y written
    once) and the plain version. One dict a shape and direction."""
    import torch
    from repro_torch.kernels import rope as rp
    rows = []
    for label, shape in calls:
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(shape, generator=gen, device=dev).bfloat16()
        d = torch.randn(shape, generator=gen, device=dev).bfloat16()
        positions = torch.arange(shape[1], device=dev)
        xg = x.detach().requires_grad_()
        want = rp.rope_plain(xg, positions, theta)
        (grad,) = torch.autograd.grad(want, xg, d)
        got = rp.rope_kernel(x, positions, theta)
        back = rp.rope_kernel(d, positions, theta, inverse=True)
        torch.cuda.synchronize()
        if not (torch.equal(got.view(torch.int16), want.view(torch.int16))
                and torch.equal(back.view(torch.int16),
                                grad.view(torch.int16))):
            raise AssertionError(f"rope: the kernel departs from its plain "
                                 f"version at {label} {shape}")
        del xg, want, grad, got, back
        bound_ms = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
        for inverse in (False, True):
            t = x if not inverse else d

            def kernel(t=t, inverse=inverse):
                return rp.rope_kernel(t, positions, theta, inverse=inverse)

            def plain(t=t, inverse=inverse):
                return rp.rope_plain(t, positions, theta, inverse)

            row = {"call": label, "shape": list(shape),
                   "direction": "inverse" if inverse else "forward",
                   "bit_identical": True,
                   "ms": _time_ms(kernel, reps=50),
                   "device_ms": _graph_ms(kernel, reps=20, replays=10),
                   "profiler_kernel_ms": _kernel_device_ms(kernel,
                                                           "rope_kernel"),
                   "bound_ms": bound_ms,
                   "plain_ms": _time_ms(plain, reps=10, warmup=2),
                   "plain_device_ms": _graph_ms(plain, reps=5, replays=4),
                   "card": card}
            row["roofline_pct"] = 100 * bound_ms / row["device_ms"]
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def _time_rope(dev, card, launches) -> dict:
    """Phase 12, ``rope`` row: the kernel at the main path's q and k
    (``ROPE_MAIN``), held and timed by :func:`_rope_rows`; the row's times
    are q's forward, every shape and direction under ``calls``.
    ``launches`` is the main run's ``_counts``: the kernel's launches both
    ways, the inverse apart."""
    from repro_torch.configs import get_config
    calls = _rope_rows(dev, card, ROPE_MAIN,
                       get_config(TRAIN["arch"]).rope_theta)
    q = calls[0]
    for row in calls:
        print("[rope] " + json.dumps(row))
    return {
        "name": "rope", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rope.cu",
        "replaces": "none: RoPE is plain JAX (src/repro/models/layers.py:38)",
        "launches": launches["rope_kernel"] + launches["rope_kernel.backward"],
        "inverse_launches": launches["rope_kernel.backward"],
        "max_abs_err": 0.0, "bit_identical": True,
        "ms": q["ms"], "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "device_ms": q["device_ms"],
        "plain_device_ms": q["plain_device_ms"], "library_device_ms": None,
        "calls": calls,
        "path": "the main path's training step (phase 12): q and k of every "
                "attention, forward, recomputed and inverse, from "
                "models.layers._Rope; every attention that calls apply_rope "
                "on the card, a mesh's local shards included (phase 16)"}


def _rope_phase():
    """``--rope``: the RoPE kernel alone. Builds it (ptxas' report), holds
    it and times it at ``ROPE_TIMED`` (:func:`_rope_rows`)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import rope as rp
    dev = torch.device("cuda")
    card = _card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build([rp.KERNEL])
    print(f"[build] {rp.KERNEL}: {time.perf_counter() - t0:.2f} s")
    _ptxas_report(rp.KERNEL, _build.build_log(rp.KERNEL))
    for row in _rope_rows(dev, card, ROPE_TIMED, 1e6):
        print("[rope] " + json.dumps(row))


def _flash_backward_phase():
    """``--flash-backward``: phase 12a's backward checks alone. Builds the
    flash kernels (ptxas' report of each), holds the backward against its
    plain version over the sweep (``_check_flash_backward``) and times it at
    every trained shape against SDPA's backward (``BWD_TIMED``)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build([fa.KERNEL])
    print(f"[build] {fa.KERNEL}: {time.perf_counter() - t0:.2f} s")
    report = _ptxas_report(fa.KERNEL, _build.build_log(fa.KERNEL))
    spills = [e["kernel"] for e in report
              if e["spill_stores"] or e["spill_loads"]]
    print(f"[build] kernels that spill: {spills if spills else 'none'}")
    errs = _check_flash_backward(dev)
    _time_trained_backwards(dev, card, errs, _backward_splits())


# (sweep name, shape, model, causal, plain timed) of every trained shape
# that --flash-backward times against SDPA's backward: the wgmma route's
# (D 64, 96, 128), then the wide route's; the plain version only where its
# dense float32 scores stay small
BWD_TIMED = [
    ("trained internlm2 layer", TRAINED, "internlm2-1.8b", True, True),
    ("trained qwen3-moe layer", (2, 32, 4, 4096, 128), "qwen3-moe-30b-a3b",
     True, False),
    ("trained minicpm3-4b layer", (2, 40, 40, 4096, 96), "minicpm3-4b",
     True, False),
    ("trained seamless encoder", SEAMLESS_BWD, "seamless-m4t-medium", False,
     True),
    ("trained seamless decoder self-attention", SEAMLESS_BWD,
     "seamless-m4t-medium", True, True),
    ("trained zamba2 shared block", ZAMBA2_TRAINED, "zamba2-2.7b", True,
     True),
    ("trained deepseek-v3 layer", DEEPSEEK_TRAINED, "deepseek-v3-671b", True,
     False)]


def _split_key(model, causal) -> str:
    return f"{model} {'causal' if causal else 'non-causal'}"


def _backward_splits() -> dict:
    """The pre-pass / dQ / dK-dV device time a call at every ``BWD_TIMED``
    shape, ``{_split_key: {kernel: ms}}``, from torch.profiler in a child
    process (``--flash-backward-split``): inside the whole script, after
    its earlier profiles, a profile of a few calls of these kernels comes
    back empty or partial, while a fresh process records every one of
    them."""
    out = _child("--flash-backward-split", "flash-backward-split")
    line = next(x for x in out.splitlines() if x.startswith("[split] "))
    return json.loads(line.split(" ", 1)[1])


def _flash_backward_split():
    """``--flash-backward-split``: ``_backward_splits``'s child. Profiles
    5 calls of the backward at every ``BWD_TIMED`` shape on phase 12a's
    inputs and prints the splits as one ``[split] {...}`` line."""
    import gc
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel)
    dev = torch.device("cuda")
    splits = {}
    for _, (b, h, hkv, s, d), model, causal, _ in BWD_TIMED:
        args = _bwd_case(dev, b, h, hkv, s, d, None, torch.bfloat16, seed=1,
                         causal=causal)
        splits[_split_key(model, causal)] = _profile_calls(
            lambda: flash_attention_backward_kernel(*args, causal=causal),
            f"{model}-flash-backward", "flash_bwd")
        del args
        gc.collect()
        torch.cuda.empty_cache()
    print("[split] " + json.dumps(splits))


def _time_trained_backwards(dev, card, errs=None, splits=None):
    """The backward at every shape of ``BWD_TIMED`` against SDPA's backward
    (``_time_flash_backward``), each case's error from ``errs`` (phase 12a's;
    null without it) and its split from ``splits``."""
    import gc
    import torch
    for name, shape, model, causal, plain in BWD_TIMED:
        gc.collect()
        torch.cuda.empty_cache()
        _time_flash_backward(dev, card, None,
                             None if errs is None else errs[name], shape,
                             model, causal=causal, plain=plain,
                             split=(splits or {}).get(
                                 _split_key(model, causal)))


def _flash_backward_times():
    """``--flash-backward-times``: the timings of ``--flash-backward``
    alone, through the wrapper and nothing newer, so that a copy of this
    script in an older checkout times that checkout's kernels at the same
    shapes."""
    import torch
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card_line()
    print(card)
    _time_trained_backwards(dev, card)


def _sdpa_backward_graph_ms(q, k, v, dout, reps: int, replays: int,
                            causal: bool = True) -> float:
    """Device time of the backward of ``F.scaled_dot_product_attention(
    is_causal=causal, enable_gqa=True)`` alone: its forward runs once on a side
    stream, outside the graph; autograd runs each backward kernel on the
    stream of its forward, so capturing on that stream records the backward
    and nothing else. ``reps`` backward calls in one graph, replayed
    ``replays`` times under CUDA events."""
    import torch
    import torch.nn.functional as F
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=True)
        for _ in range(3):
            torch.autograd.grad(out, leaves, dout, retain_graph=True)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            torch.autograd.grad(out, leaves, dout, retain_graph=True)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def _time_flash_backward(dev, card, launches, err, shape=TRAINED,
                         model="internlm2-1.8b", causal=True, plain=True,
                         split=None):
    """Phases 12a, 14 and 15, ``flash_attention_backward`` row: one layer's
    attention backward at a trained shape (default internlm2-1.8b's: B2,
    H16, Hkv 8, S4096, D128, bf16, causal) through the kernel, its plain
    version (not where ``plain`` is false: its times are null and the
    library's error is taken against the kernel, which phase 12a holds
    against the plain version) and the backward of
    ``F.scaled_dot_product_attention(is_causal=causal, enable_gqa=True)``
    on the same tensors, timed alone; ``split`` (``_backward_splits``) is
    the kernels' device ms a call, by kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_backward_plain,
        visible_pairs)
    b, h, hkv, s, d = shape
    mask = "causal" if causal else "non-causal"
    q, k, v, out, dout, lse = _bwd_case(dev, b, h, hkv, s, d, None,
                                        torch.bfloat16, seed=1,
                                        causal=causal)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                             enable_gqa=True)
    fns = (lambda: flash_attention_backward_kernel(q, k, v, out, dout, lse,
                                                   causal=causal),
           lambda: flash_attention_backward_plain(q, k, v, out, dout, lse,
                                                  causal=causal),
           lambda: torch.autograd.grad(lib_out, leaves, dout,
                                       retain_graph=True))
    lib_err = max(_rel_err(a, b_) for a, b_ in
                  zip(fns[2](), fns[1 if plain else 0]()))
    ms = [_time_ms(fns[0], reps=10, warmup=2),
          _time_ms(fns[1], reps=3, warmup=1) if plain else None,
          _time_ms(fns[2], reps=10, warmup=2)]
    # device time from graph replay; the library's backward is captured
    # alone, on the stream its forward ran on (see _sdpa_backward_graph_ms)
    dev_ms = [_graph_ms(fns[0], reps=5, replays=3),
              _graph_ms(fns[1], reps=1, replays=2) if plain else None,
              _sdpa_backward_graph_ms(q, k, v, dout, reps=5, replays=3,
                                      causal=causal)]
    if not plain:
        print(f"[time] flash_attention_backward {model}: the plain version "
              f"is not timed (plain_ms null): its dense float32 [B, H, S, S] "
              f"scores are {b * h * s * s * 4} bytes a tensor at this shape; "
              f"phase 12a holds the kernel against it in slices")
    pairs = visible_pairs(s, causal) * b * h
    n_ops = 10 * d * pairs      # q.k, dout.v, p^T dout, ds k, ds^T q
    n_bytes = (2 * (3 * q.numel() + 2 * out.numel() + 3 * k.numel())
               + 4 * lse.numel())   # q, k, v, out, dout, lse; dq, dk, dv
    t_ops, t_bytes = n_ops / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    row = {
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/models/layers.py:168",
        "launches": launches, "max_abs_err": err,
        "ms": ms[0], "plain_ms": ms[1],
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": ms[2], "device_ms": dev_ms[0],
        "plain_device_ms": dev_ms[1], "library_device_ms": dev_ms[2],
        "calls": f"one layer's attention backward of {model} training "
                 f"(B{b}, H{h}, Hkv{hkv}, S{s}, D{d}, bf16, {mask}): the "
                 f"delta pre-pass, dQ and dK/dV kernels",
    }
    row["achieved_tflops"] = n_ops / dev_ms[0] / 1e9
    row["vs_library"] = dev_ms[0] / dev_ms[2]
    # the call's three kernels (pre-pass, dQ, dK/dV), device ms a call
    row["device_split_ms"] = split
    print(f"[time] flash_attention_backward {model} B{b} H{h} Hkv{hkv} S{s} "
          f"D{d} bf16 {mask}: kernel {ms[0]!r} ms, plain {ms[1]!r} ms, SDPA backward "
          f"{ms[2]!r} ms (per call); device (graph) kernel {dev_ms[0]!r}, "
          f"plain {dev_ms[1]!r}, SDPA backward {dev_ms[2]!r} ms; kernel "
          f"device time {row['vs_library']!r}x SDPA backward's; bound "
          f"{row['bound_ms']!r} ms ({n_ops} flops over {pairs} visible pairs "
          f"at {BF16_OPS_PER_S:.3g} flop/s; {n_bytes} bytes); kernel "
          f"{row['achieved_tflops']!r} TFLOP/s; SDPA vs "
          f"{'plain' if plain else 'kernel'} relative L2 {lib_err!r}; device "
          f"ms a call by kernel {json.dumps(split)}; card {card}")
    return row


@contextlib.contextmanager
def _recorded_train_steps(rec, profile_at=None, label="train-lm"):
    """Within the scope, every step ``launch.train.main`` takes is
    synchronised and recorded in ``rec``: wall, loss, ce, the flash
    forward / backward launches and the RoPE kernel's forward / inverse
    launches it made; step ``profile_at`` runs under torch.profiler (its
    wall is recorded apart)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_kernel)
    from repro_torch.kernels.rope import rope_kernel
    from repro_torch.launch import train
    real = train.make_train_step

    def make(loss_fn, tcfg):
        step = real(loss_fn, tcfg)

        def recorded(*args):
            torch.cuda.synchronize()
            before = (flash_attention_kernel.launches,
                      flash_attention_backward_kernel.launches,
                      rope_kernel.launches, rope_kernel.backward_launches)
            t0 = time.perf_counter()
            if len(rec) == profile_at:
                box = []
                prof = _profile_step(lambda: box.append(step(*args)),
                                     label, "flash_bwd")
                out = box[0]
            else:
                out, prof = step(*args), None
            torch.cuda.synchronize()
            rec.append({
                "wall": time.perf_counter() - t0, "profiled": prof,
                "loss": float(out[2]["loss"]), "ce": float(out[2]["ce"]),
                "mtp": float(out[2]["mtp"]),
                "fwd": flash_attention_kernel.launches - before[0],
                "bwd": flash_attention_backward_kernel.launches - before[1],
                "rope": (rope_kernel.launches - before[2],
                         rope_kernel.backward_launches - before[3])})
            return out
        return recorded

    train.make_train_step = make
    try:
        yield rec
    finally:
        train.make_train_step = real


@contextlib.contextmanager
def _launcher_config(cfg):
    """Within the scope, ``launch.train.main`` runs ``cfg`` for its
    ``--arch`` (a depth cut of a published config; the launcher has no
    depth option, as the reference's has none)."""
    from repro_torch.launch import train
    real = train.get_config
    train.get_config = lambda arch: cfg
    try:
        yield
    finally:
        train.get_config = real


def _flash_calls_a_step(cfg) -> tuple:
    """Flash forward launches and backward calls of one training step of
    ``cfg`` (rows of equal source and target lengths for the enc-dec
    family, as the launcher makes them): every attention once forward and
    once backward, the forward again where ``remat="full"`` recomputes
    it; DeepSeek's MTP layer once each (outside remat)."""
    from repro_torch.models.encdec import EncDecConfig
    if isinstance(cfg, EncDecConfig):
        # encoder, decoder self- and cross-attention (S_dec == S_enc)
        n, extra = cfg.n_enc_layers + 2 * cfg.n_dec_layers, 0
    else:
        n, extra = _attention_layers(cfg), int(cfg.mtp)
    return (2 if cfg.remat == "full" else 1) * n + extra, n + extra


def _rope_calls_a_step(cfg) -> tuple:
    """RoPE kernel launches of one training step of ``cfg``, forward and
    inverse: q and k of every rotary attention (the enc-dec family's
    encoder and decoder self-attention; its cross-attention has none), in
    the pattern of :func:`_flash_calls_a_step`: once forward (again where
    ``remat="full"`` recomputes it) and once inverse; DeepSeek's MTP layer
    once each."""
    from repro_torch.models.encdec import EncDecConfig
    if isinstance(cfg, EncDecConfig):
        n, extra = cfg.n_enc_layers + cfg.n_dec_layers, 0
    else:
        n, extra = _attention_layers(cfg), int(cfg.mtp)
    return (2 * ((2 if cfg.remat == "full" else 1) * n + extra),
            2 * (n + extra))


def _train_lm_path(dev, kernels, run=TRAIN, label="train-lm", profile=True,
                   int8_ef=True, cfg=None):
    """Phases 12b, 14 and 15: ``python -m repro_torch.launch.train`` at
    ``run``'s arch (full width and depth, or ``cfg``, a depth cut of it),
    ``run["steps"]`` steps of ``run["batch"]`` x ``run["seq"]`` tokens (the
    last profiled where ``profile``; each flash backward call of the first
    held against its plain version on its own inputs, ``_held_backward``),
    then, where ``int8_ef``, 2 steps with int8 error-feedback gradient
    compression. Every step launches the RoPE kernel as
    :func:`_rope_calls_a_step` says. Returns the main run's launches
    (``_counts(kernels)``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import encdec, lm
    from repro_torch.models.specs import n_params
    cfg = cfg or get_config(run["arch"])
    is_ed = isinstance(cfg, encdec.EncDecConfig)
    specs = encdec.encdec_specs(cfg) if is_ed else lm.lm_specs(cfg)
    tokens = run["batch"] * run["seq"]
    argv = ["--arch", run["arch"], "--steps", str(run["steps"]),
            "--batch", str(run["batch"]), "--seq", str(run["seq"])]
    shape = ("(a row: seq // 2 source frames, seq // 2 target tokens)"
             if is_ed else f"{[(g.kind, g.mlp, g.count) for g in cfg.segments]}"
             f", mtp {cfg.mtp}")
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers {shape}, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_head "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, remat "
          f"{cfg.remat}, logit_chunk {cfg.logit_chunk}; n_params "
          f"{n_params(specs)}; main({argv})")
    want_fwd, want_bwd = _flash_calls_a_step(cfg)
    want_rope = _rope_calls_a_step(cfg)
    rec, held = [], []
    _reset_counts(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _recorded_train_steps(
            rec, run["steps"] - 1 if profile else None, label), \
            _launcher_config(cfg), _held_backward(held, want_bwd):
        params = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = _counts(kernels)
    del params
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in rec]
    steady = [r["wall"] for r in rec[1:-1]]
    for i, r in enumerate(rec):
        print(f"[{label}] step {i}: loss {r['loss']!r}, ce {r['ce']!r}, "
              f"mtp {r['mtp']!r}, wall {r['wall']!r} s (synchronised"
              f"{', under the profiler' if r['profiled'] else ''}), "
              f"{tokens / r['wall']!r} tokens/s; flash forward launches "
              f"{r['fwd']}, backward {r['bwd']}; RoPE forward and inverse "
              f"{r['rope']}")
    mean = statistics.fmean(steady)
    print(f"[{label}] main() wall {wall!r} s (weights drawn, first step's "
          f"warm-up included); steps 1-{len(rec) - 2}: mean step wall "
          f"{mean!r} s, {tokens / mean!r} tokens/s, median "
          f"{statistics.median(steady)!r} s; peak device memory {peak} "
          f"bytes; launches {launches}")
    _below_card(label, peak)
    shapes = {}
    for shape, causal, errs in held:
        shapes.setdefault((shape, causal), []).append(max(errs))
    worst = max((e for *_, errs in held for e in errs), default=0.0)
    print(f"[{label}] step 0's {len(held)} flash backward calls, kernel vs "
          f"plain on each call's own q, k, v, out, dO and lse: relative L2 "
          f"max {worst!r} (tolerance {ATTN_REL_TOL}); by (B, H, S, D, Hkv), "
          f"causal: " + "; ".join(
              f"{shape} {causal}: {len(e)} calls, max {max(e)!r}"
              for (shape, causal), e in shapes.items()))
    if len(held) != want_bwd or not worst <= ATTN_REL_TOL:
        raise AssertionError(f"{label}: the flash backward disagrees with "
                             f"its plain version on the training step's "
                             f"inputs ({len(held)} calls held of "
                             f"{want_bwd})")
    # the backward calls up to D 128 (D a multiple of 8) run the wgmma
    # kernels, the calls past it the wide ones
    want_wgmma = sum(shape[3] <= 128 and shape[3] % 8 == 0
                     for shape, _, _ in held)
    if (len(rec) != run["steps"]
            or any(r["fwd"] != want_fwd or r["bwd"] != want_bwd for r in rec)
            or launches["flash_attention_kernel.tensor_core"]
            != want_fwd * run["steps"]
            or launches["flash_attention_backward_kernel.tensor_core"]
            != want_bwd * run["steps"]
            or launches["flash_attention_backward_kernel.wgmma"]
            != want_wgmma * run["steps"]):
        raise AssertionError(f"{label}: flash launches a step "
                             f"{[(r['fwd'], r['bwd']) for r in rec]}, not "
                             f"{want_fwd} forward and {want_bwd} backward, "
                             f"all on the tensor cores, {want_wgmma} of the "
                             f"backward on wgmma ({launches})")
    if any(r["rope"] != want_rope for r in rec):
        raise AssertionError(f"{label}: RoPE kernel launches a step (forward"
                             f", inverse) {[r['rope'] for r in rec]}, not "
                             f"{want_rope}")
    # with DeepSeek's MTP head the CE is held to fall and the MTP term to
    # stay finite: its layer's output meets the head without a norm, and
    # at full width that term starts near 60 and grows under AdamW, as the
    # reference's does at 128 heads (tests/test_torch_train.py,
    # test_launcher_mtp_term_at_128_heads_matches_reference)
    mtp = getattr(cfg, "mtp", False)
    held = [r["ce"] for r in rec] if mtp else losses
    if (not all(math.isfinite(r[k]) for r in rec for k in ("loss", "mtp"))
            or not held[-1] < held[0]):
        raise AssertionError(f"{label}: losses {losses} (ce "
                             f"{[r['ce'] for r in rec]}, mtp "
                             f"{[r['mtp'] for r in rec]}) not finite or not "
                             "falling")
    print(f"[{label}] losses finite, step {len(losses) - 1}'s "
          f"{'ce' if mtp else 'loss'} below step 0's; "
          f"{want_fwd} forward and {want_bwd} backward flash launches a "
          f"step, all on the tensor cores, {want_wgmma} backward a step on "
          f"the wgmma kernels "
          f"({launches['flash_attention_backward_kernel.wgmma']} in "
          f"{run['steps']} steps); {want_rope[0]} forward and "
          f"{want_rope[1]} inverse RoPE launches a step ok")
    prof = rec[-1]["profiled"]
    print(f"[{label}] " + json.dumps({
        "model": cfg.name, "layers": cfg.n_layers,
        "parameters": n_params(specs), "batch": run["batch"],
        "seq": run["seq"], "losses": losses,
        "mtp": [r["mtp"] for r in rec], "step_wall_s": [r["wall"] for r in rec],
        "steady_step_s": mean, "tokens_per_s": tokens / mean,
        "busy": None if prof is None else prof["busy"],
        "kernels": None if prof is None else prof["kernels"],
        "peak_bytes": peak, "flash_forward": want_fwd,
        "flash_backward": want_bwd, "rope_forward": want_rope[0],
        "rope_inverse": want_rope[1]}))

    if not int8_ef:
        return launches
    rec_ef = []
    torch.cuda.reset_peak_memory_stats()
    with _recorded_train_steps(rec_ef):
        params = train.main(argv[:2] + ["--steps", "2"] + argv[4:]
                            + ["--grad-compression", "int8_ef"])
    peak_ef = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    ef = [r["loss"] for r in rec_ef]
    print(f"[{label}] --grad-compression int8_ef, 2 steps: losses {ef}, "
          f"walls {[r['wall'] for r in rec_ef]} s; peak device memory "
          f"{peak_ef} bytes")
    if len(ef) != 2 or not all(math.isfinite(v) for v in ef):
        raise AssertionError(f"{label} int8_ef: losses {ef}")
    return launches


def _float32(cfg):
    """``cfg`` with float32 weights and activations (the enc-dec config's
    dtypes are class attributes: a subclass carries them)."""
    import torch
    from repro_torch.models.encdec import EncDecConfig
    f32 = torch.float32
    if not isinstance(cfg, EncDecConfig):
        return dataclasses.replace(cfg, param_dtype=f32, dtype=f32)

    class Float32(type(cfg)):
        param_dtype = dtype = f32
    return Float32(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


def _train_loss(cfg, run, dev):
    """The launcher's loss at step 0 of ``run``'s batch x seq: the function
    of the parameters ``launch.train.main`` differentiates (the enc-dec
    family's rows of ``seq // 2`` seeded source frames and ``seq // 2``
    target tokens)."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models import encdec, lm
    toks, labels = batch_for_step(DataConfig(vocab=cfg.vocab,
                                             batch=run["batch"],
                                             seq_len=run["seq"]), 0)
    toks = torch.as_tensor(toks, device=dev).long()
    labels = torch.as_tensor(labels, device=dev).long()
    if not isinstance(cfg, encdec.EncDecConfig):
        return lambda params: lm.lm_loss(params, cfg, toks, labels)[0]
    half = run["seq"] // 2
    frames = torch.as_tensor(np.random.default_rng(1000).normal(
        size=(run["batch"], half, cfg.d_model)).astype(np.float32),
        device=dev)
    return lambda params: encdec.encdec_loss(
        params, cfg, frames, toks[:, :half], labels[:, :half])[0]


def _train_kernel_vs_plain(dev, cfg=None, run=TRAIN, label="train-lm-route",
                           backward=None, held=True):
    """Phases 12c, 14 and 15: one step's loss and gradients of ``cfg``
    (default internlm2-1.8b at full width, depth cut 24 -> 2, bf16),
    ``run``'s batch x seq tokens: the kernel route (its backward
    ``backward`` where given) against the plain route (the plain flash
    forward and backward and the plain RoPE swapped in; it launches no
    RoPE kernel, the kernel route :func:`_rope_calls_a_step`'s). Every
    gradient leaf within relative L2 ``LOGITS_REL_TOL`` and the loss within
    that share, where ``held``; else only printed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain, flash_attention_kernel,
        flash_attention_plain)
    from repro_torch.kernels.rope import rope_kernel
    from repro_torch.models import encdec, lm
    from repro_torch.models.lm import Segment
    from repro_torch.models.specs import materialize, tree_leaves
    cfg = cfg or dataclasses.replace(get_config(TRAIN["arch"]),
                                     segments=(Segment("attn", "dense", 2),))
    specs = (encdec.encdec_specs(cfg)
             if isinstance(cfg, encdec.EncDecConfig) else lm.lm_specs(cfg))
    params = materialize(specs, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
    loss_of = _train_loss(cfg, run, dev)

    rope = []

    def grads():
        before = (rope_kernel.launches, rope_kernel.backward_launches)
        loss = loss_of(params)
        out = loss.detach(), torch.autograd.grad(loss, leaves)
        rope.append((rope_kernel.launches - before[0],
                     rope_kernel.backward_launches - before[1]))
        return out

    with (_attention_route(flash_attention_kernel, backward) if backward
          else contextlib.nullcontext()):
        kernel = grads()
    with _attention_route(flash_attention_plain,
                          flash_attention_backward_plain), _plain_rope():
        plain = grads()
    torch.cuda.synchronize()
    if rope != [_rope_calls_a_step(cfg), (0, 0)]:
        raise AssertionError(f"{label}: RoPE kernel launches (forward, "
                             f"inverse) on the kernel and plain routes "
                             f"{rope}, not {[_rope_calls_a_step(cfg)]} and "
                             "none")
    names = ["/".join(p) for p, _ in tree_leaves(params)]
    errs = {n: _rel_err(a, b) for n, a, b in zip(names, kernel[1], plain[1])}
    worst = max(errs, key=errs.get)
    print(f"[{label}] {cfg.name} depth {cfg.n_layers}, "
          f"{str(cfg.param_dtype).split('.')[1]} weights, one step at "
          f"{run['batch']} x {run['seq']}: loss kernel route "
          f"{kernel[0].item()!r}, plain route {plain[0].item()!r}; gradient "
          f"relative L2 error (RoPE launches on the two routes {rope}): "
          f"worst {worst} {errs[worst]!r} "
          f"({f'tolerance {LOGITS_REL_TOL}' if held else 'not held'}), "
          f"all {errs}")
    if held and not (errs[worst] <= LOGITS_REL_TOL
                     and abs(kernel[0].item() - plain[0].item())
                     <= LOGITS_REL_TOL * abs(plain[0].item())):
        raise AssertionError(f"{label}: the kernel route's gradients "
                             "disagree with the plain route's")
    del params, leaves, kernel, plain
    torch.cuda.empty_cache()


def _train_restart(dev):
    """Phase 12d (``--train-restart``, in a child process): the launcher at
    internlm2's smoke config on the card, 6 steps straight against 3 steps,
    a checkpoint and a relaunch to 6, under
    ``torch.use_deterministic_algorithms(True)``: the step-6 checkpoints'
    parameters and moments bit-identical."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import train
    argv = ["--arch", TRAIN["arch"], "--smoke", "--batch", "2", "--seq",
            "128", "--ckpt-every", "3"]
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as straight, \
                tempfile.TemporaryDirectory() as split:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                train.main(argv + ["--steps", "6", "--ckpt-dir", straight])
                train.main(argv + ["--steps", "3", "--ckpt-dir", split])
                train.main(argv + ["--steps", "6", "--ckpt-dir", split])
            log = out.getvalue()
            with np.load(f"{straight}/step_6/arrays.npz") as a, \
                    np.load(f"{split}/step_6/arrays.npz") as b:
                keys = sorted(a.files)
                differ = [k for k in keys if k not in b.files
                          or a[k].tobytes() != b[k].tobytes()]
    finally:
        torch.use_deterministic_algorithms(was)
    restored = "restored checkpoint at step 3" in log
    print(f"[train-restart] {TRAIN['arch']} smoke on the card: 6 steps "
          f"straight vs 3 + relaunch to 6 (deterministic algorithms): "
          f"relaunch restored at step 3: {restored}; {len(keys)} leaves of "
          f"the step-6 checkpoint (params and opt), differing: {differ}")
    if not restored or differ or not keys:
        raise AssertionError("train-restart: the relaunched run is not "
                             "bit-identical to the straight one")


def _child(flag: str, label: str):
    """Phases 12d and 15: ``chip_smoke.py flag`` in a child process, run
    under deterministic algorithms: cuBLAS reads its workspace setting
    once, at its first call, and deterministic algorithms need
    ``:4096:8``; the child gets it, so the earlier phases run under the
    default setting."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(root / "chip_smoke.py"), flag],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=600)
    print(out.stdout, end="")
    if out.returncode != 0:
        raise AssertionError(f"{label}: the child exited "
                             f"{out.returncode}:\n{out.stderr[-3000:]}")
    print(f"[{label}] child process: exit 0 in "
          f"{time.perf_counter() - t0!r} s")
    return out.stdout


# ---- training on a device mesh: DeviceMesh/DTensor, EP, elastic restore ------

MESH_RUN = dict(arch="internlm2-1.8b", steps=4, batch=2, seq=4096)
# qwen3-moe-30b-a3b's depth cut for the expert-parallel check (phase 15's)
MESH_MOE = ("qwen3-moe-30b-a3b", ("attn", "moe", 6))
MESH_REL_TOL = 1e-6
# phase 16e: phi3-medium-14b's attention (40 / 10 heads of 128), 1 x 4096,
# the sequence in 4 shards as a model axis of 4 splits it
MESH_SEQ = dict(arch="phi3-medium-14b", batch=1, seq=4096, shards=4)


def _rel_gap(a, b) -> float:
    """Relative L2 gap of two tensors (0 where both are 0)."""
    a, b = a.float(), b.float()
    den = b.norm().item()
    return (a - b).norm().item() / den if den else (a - b).norm().item()


@contextlib.contextmanager
def _host_rows():
    """Within the scope, ``launch.train``'s unsharded batches are the rows a
    sharded batch holds (row ``r`` from shard ``r``), drawn on the host."""
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    real = train.batch_for_step

    def rows(cfg, step, mesh=None):
        buf = pipeline.rows_for_step(cfg, step, range(cfg.batch))
        return buf[:, :-1], buf[:, 1:]
    train.batch_for_step = rows
    try:
        yield
    finally:
        train.batch_for_step = real


@contextlib.contextmanager
def _counting_moe(drops, ep_calls):
    """Within the scope, every MoE dispatch appends its dropped assignments
    to ``drops`` and every expert-parallel application one to
    ``ep_calls``."""
    from repro_torch.models import moe
    real_dispatch, real_ep = moe._dispatch, moe._moe_ep

    def dispatch(*a):
        buf, meta = real_dispatch(*a)
        drops.append(int((~meta[2]).sum()))
        return buf, meta

    def ep(*a):
        ep_calls.append(1)
        return real_ep(*a)
    moe._dispatch, moe._moe_ep = dispatch, ep
    try:
        yield
    finally:
        moe._dispatch, moe._moe_ep = real_dispatch, real_ep


def _mesh_launcher(card, kernels, mesh):
    """Phase 16a: ``launch.train --mesh 1x1`` at internlm2-1.8b's full width
    against the unsharded launcher at the same seed on the same rows."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.specs import tree_leaves
    run = MESH_RUN
    cfg = get_config(run["arch"])
    want_fwd, want_bwd = _flash_calls_a_step(cfg)
    want_rope = _rope_calls_a_step(cfg)
    tokens = run["batch"] * run["seq"]
    argv = ["--arch", run["arch"], "--steps", str(run["steps"]), "--batch",
            str(run["batch"]), "--seq", str(run["seq"])]
    runs, held = {}, 0
    for name, extra in (("mesh 1x1", ["--mesh", "1x1"]), ("unsharded", [])):
        rec = []
        _reset_counts(kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _recorded_train_steps(rec, run["steps"] - 1, "mesh"), \
                (_host_rows() if not extra else contextlib.nullcontext()):
            params = train.main(argv + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        leaves = [t.to_local() if hasattr(t, "to_local") else t
                  for _, t in tree_leaves(params)]
        steady = statistics.fmean(r["wall"] for r in rec[1:-1])
        # the peak less the first run's final parameters, still held
        runs[name] = dict(rec=rec, leaves=leaves, launches=_counts(kernels),
                          peak=torch.cuda.max_memory_allocated() - held,
                          wall=wall, steady=steady)
        held = sum(t.numel() * t.element_size() for t in leaves)
        prof = rec[-1]["profiled"]
        print(f"[mesh] {name}: {cfg.name} full width, {run['steps']} steps "
              f"of {run['batch']} x {run['seq']}: losses "
              f"{[r['loss'] for r in rec]}; step walls "
              f"{[r['wall'] for r in rec]} s; steps 1-{len(rec) - 2} mean "
              f"{steady!r} s, {tokens / steady!r} tokens/s; peak "
              f"{runs[name]['peak']} bytes; busy share "
              f"{None if prof is None else prof['busy']!r}; flash launches "
              f"a step {[(r['fwd'], r['bwd']) for r in rec]}; RoPE "
              f"launches a step {[r['rope'] for r in rec]}; main() wall "
              f"{wall!r} s; card {card}")
        if any(r["fwd"] != want_fwd or r["bwd"] != want_bwd for r in rec):
            raise AssertionError(f"mesh: {name} made flash launches "
                                 f"{[(r['fwd'], r['bwd']) for r in rec]} a "
                                 f"step, not {want_fwd} and {want_bwd}")
        # the mesh's DTensors rotate on their local shards, on the kernel
        if any(r["rope"] != want_rope for r in rec):
            raise AssertionError(f"mesh: {name} made RoPE launches "
                                 f"{[r['rope'] for r in rec]} a step, not "
                                 f"{want_rope}")
        del params
    m, u = runs["mesh 1x1"], runs["unsharded"]
    loss_gap = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(m["rec"], u["rec"]))
    param_gap = max(_rel_gap(a, b) for a, b in zip(m["leaves"], u["leaves"]))
    same = (all(a["loss"] == b["loss"] for a, b in zip(m["rec"], u["rec"]))
            and all(torch.equal(a, b)
                    for a, b in zip(m["leaves"], u["leaves"])))
    print(f"[mesh] 1x1 mesh vs unsharded launcher: losses and final "
          f"parameters bit-identical: {same}; largest relative gap: loss "
          f"{loss_gap!r}, parameters (relative L2, worst leaf) "
          f"{param_gap!r} (tolerance {MESH_REL_TOL}); step wall "
          f"{m['steady']!r} vs {u['steady']!r} s "
          f"({m['steady'] / u['steady']!r}x: DTensor's host overhead); "
          f"peak {m['peak']} vs {u['peak']} bytes; card {card}")
    print("[mesh] " + json.dumps({
        "model": cfg.name, "mesh": "1x1", "batch": run["batch"],
        "seq": run["seq"], "losses": [r["loss"] for r in m["rec"]],
        "unsharded_losses": [r["loss"] for r in u["rec"]],
        "bit_identical": same, "loss_rel_gap": loss_gap,
        "param_rel_gap": param_gap, "steady_step_s": m["steady"],
        "unsharded_steady_step_s": u["steady"],
        "tokens_per_s": tokens / m["steady"],
        "unsharded_tokens_per_s": tokens / u["steady"],
        "busy": (m["rec"][-1]["profiled"] or {}).get("busy"),
        "unsharded_busy": (u["rec"][-1]["profiled"] or {}).get("busy"),
        "peak_bytes": m["peak"], "unsharded_peak_bytes": u["peak"],
        "flash_forward": want_fwd, "flash_backward": want_bwd,
        "rope_forward": want_rope[0], "rope_inverse": want_rope[1],
        "launches": m["launches"]}))
    if not (loss_gap <= MESH_REL_TOL and param_gap <= MESH_REL_TOL):
        raise AssertionError("mesh: the 1x1 mesh launcher departs from the "
                             "unsharded one")
    del runs
    torch.cuda.empty_cache()


def _mesh_moe(card, mesh, dev):
    """Phase 16b: qwen3-moe-30b-a3b at 6 of 48 layers, one forward and
    backward of a 2 x 4096 batch with every ``moe_apply`` on the
    expert-parallel path (DTensor parameters and batch in a mesh context)
    against the single-device path, routes pinned to the latter's."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, rows_for_step
    from repro_torch.models import lm
    from repro_torch.models.lm import Segment
    from repro_torch.models.specs import materialize, tree_leaves, tree_map
    from repro_torch.sharding import rules as R
    arch, depth = MESH_MOE
    cfg = dataclasses.replace(get_config(arch), segments=(Segment(*depth),))
    b, s = MESH_RUN["batch"], MESH_RUN["seq"]
    buf = torch.as_tensor(rows_for_step(
        DataConfig(vocab=cfg.vocab, batch=b, seq_len=s), 0, range(b)),
        device=dev).long()
    toks, labels = buf[:, :-1], buf[:, 1:]
    params = materialize(lm.lm_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
    routes, drops, ep = [], [], []
    t0 = time.perf_counter()
    with _recording_routes(routes), _counting_moe(drops, ep):
        loss = lm.lm_loss(params, cfg, toks, labels)[0]
        grads = torch.autograd.grad(loss, leaves)
    single = (loss.detach(), grads, list(drops))
    del loss, grads
    rep = R.NamedSharding(mesh, ())
    dparams = tree_map(lambda t: R.distribute(t.detach(), rep), params)
    dleaves = [t.requires_grad_() for _, t in tree_leaves(dparams)]
    bsh = R.NamedSharding(mesh, R.batch_partition(mesh, 2))
    drops.clear()
    with _pinned_routes(lambda i: routes[i]), _counting_moe(drops, ep), \
            R.set_context(mesh):
        loss = lm.lm_loss(dparams, cfg, R.distribute(toks, bsh),
                          R.distribute(labels, bsh))[0]
        n_ep = len(ep)
        grads = torch.autograd.grad(loss, dleaves)
    torch.cuda.synchronize()
    loss = loss.full_tensor()
    gaps = {"/".join(p): _rel_gap(g.to_local(), h) for (p, _), g, h in
            zip(tree_leaves(params), grads, single[1])}
    worst = max(gaps, key=gaps.get)
    loss_gap = abs(loss.item() - single[0].item()) / abs(single[0].item())
    same = (loss.item() == single[0].item()
            and all(torch.equal(g.to_local(), h)
                    for g, h in zip(grads, single[1])))
    print(f"[mesh-moe] {cfg.name} depth {cfg.n_layers} (6 attention + MoE "
          f"layers of 48), {b} x {s}, {cfg.param_dtype}, capacity factor "
          f"{cfg.moe.capacity_factor}: expert-parallel applications in the "
          f"forward {n_ep} (of {cfg.n_layers} layers; {len(ep)} with the "
          f"recomputation); loss EP {loss.item()!r}, single "
          f"{single[0].item()!r} (relative gap {loss_gap!r}); gradients "
          f"relative L2, worst {worst} {gaps[worst]!r} (tolerance "
          f"{MESH_REL_TOL}); bit-identical: {same}; dropped assignments a "
          f"dispatch (the forward's, then the recomputation's) EP {drops}, "
          f"single {single[2]}; "
          f"{time.perf_counter() - t0!r} s; card {card}")
    if (n_ep != cfg.n_layers or drops != single[2]
            or not loss_gap <= MESH_REL_TOL
            or not gaps[worst] <= MESH_REL_TOL):
        raise AssertionError("mesh-moe: the expert-parallel path departs "
                             "from the single-device path")
    del params, dparams, leaves, dleaves, grads, single
    torch.cuda.empty_cache()


def _mesh_seq_attention(card, dev):
    """Phase 16e: sequence-parallel attention (``seq_shard_attn``) at
    phi3-medium-14b's attention shape in bf16. The card is one, so this
    process plays each rank of the model axis in turn: shard ``r`` of q
    against the whole K/V through ``layers._SeqShardAttention`` (``r + 1``
    flash calls forward and backward), against one ``_FlashAttention``
    over the whole sequence: outputs, dq by rows, and dk/dv summed over the
    shards, within ``ATTN_REL_TOL`` relative L2."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    cfg = get_config(MESH_SEQ["arch"])
    b, s, n = MESH_SEQ["batch"], MESH_SEQ["seq"], MESH_SEQ["shards"]
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    g = torch.Generator(device=dev).manual_seed(16)
    q, k, v, do = (torch.randn(b, s, m, d, generator=g, device=dev)
                   .to(torch.bfloat16) for m in (h, hkv, hkv, h))
    whole = [t.clone().requires_grad_() for t in (q, k, v)]
    want = L._FlashAttention.apply(*whole, None, True)
    want.backward(do)
    kv = [t.clone().requires_grad_() for t in (k, v)]
    c = s // n
    outs, dqs, ms = [], [], []
    launches = (fa.flash_attention_kernel.launches,
                fa.flash_attention_backward_kernel.launches)
    for r in range(n):
        qr = q[:, r * c:(r + 1) * c].clone().requires_grad_()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = L._SeqShardAttention.apply(qr, *kv, r, True)
        out.backward(do[:, r * c:(r + 1) * c])
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        outs.append(out.detach())
        dqs.append(qr.grad)
    fwd = fa.flash_attention_kernel.launches - launches[0]
    bwd = fa.flash_attention_backward_kernel.launches - launches[1]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    again = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    ev[0].record()
    L._FlashAttention.apply(*again, None, True).backward(do)
    ev[1].record()
    torch.cuda.synchronize()
    errs = {"out": _rel_gap(torch.cat(outs, 1), want),
            "dq": _rel_gap(torch.cat(dqs, 1), whole[0].grad),
            "dk": _rel_gap(kv[0].grad, whole[1].grad),
            "dv": _rel_gap(kv[1].grad, whole[2].grad)}
    print(f"[mesh-seq] {cfg.name} attention ({h} / {hkv} heads of {d}), "
          f"{b} x {s} bf16 in {n} sequence shards: flash launches forward "
          f"{fwd}, backward {bwd} (expected {n * (n + 1) // 2} each); "
          f"relative L2 against the whole sequence's kernel call {errs} "
          f"(tolerance {ATTN_REL_TOL}); forward + backward ms a shard "
          f"{ms!r}, the whole sequence on one card "
          f"{ev[0].elapsed_time(ev[1])!r}; card {card}")
    if (fwd != bwd or fwd != n * (n + 1) // 2
            or not max(errs.values()) <= ATTN_REL_TOL):
        raise AssertionError("mesh-seq: sequence-parallel attention departs "
                             "from the whole sequence's")


def _mesh_checkpoint_and_batches(card, mesh, dev):
    """Phases 16c and 16d: internlm2-1.8b at full width, depth cut 24 -> 2,
    laid out by ``BASE_RULES`` on the mesh, saved and restored through
    ``shardings=`` bit for bit; ``batch_for_step`` on the mesh against the
    rows drawn on the host."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, batch_for_step,
                                           rows_for_step)
    from repro_torch.models import lm
    from repro_torch.models.lm import Segment
    from repro_torch.models.specs import materialize, tree_leaves
    from repro_torch.sharding import rules as R
    cfg = dataclasses.replace(get_config(MESH_RUN["arch"]),
                              segments=(Segment("attn", "dense", 2),))
    specs = lm.lm_specs(cfg)
    params = materialize(specs, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    sh = R.tree_shardings(mesh, specs, R.BASE_RULES)

    def place(t, h):
        return (R.distribute(t, h) if isinstance(h, R.NamedSharding)
                else {k: place(t[k], h[k]) for k in t})
    tree = place(params, sh)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        store.save(d, 7, tree)
        restored, step, _ = store.restore(d, params, shardings=sh)
    pairs = list(zip(tree_leaves(tree), tree_leaves(restored)))
    differ = ["/".join(p) for (p, a), (_, b) in pairs
              if a.placements != b.placements
              or not torch.equal(a.to_local(), b.to_local())]
    placements = sorted({str(a.placements) for (_, a), _ in pairs})
    n_bytes = sum(a.to_local().numel() * a.element_size()
                  for (_, a), _ in pairs)
    print(f"[mesh-ckpt] {cfg.name} depth 2, {len(pairs)} leaves ({n_bytes} "
          f"bytes) laid out by BASE_RULES ({placements}), saved and "
          f"restored through shardings= in {time.perf_counter() - t0!r} s: "
          f"step {step}, leaves differing (values or placements): {differ}; "
          f"card {card}")
    if differ or step != 7:
        raise AssertionError("mesh-ckpt: the restored checkpoint is not "
                             "bit-identical")
    del params, tree, restored, pairs
    dcfg = DataConfig(vocab=cfg.vocab, batch=MESH_RUN["batch"],
                      seq_len=MESH_RUN["seq"])
    bad = []
    for i in range(MESH_RUN["steps"]):
        tokens, labels = batch_for_step(dcfg, i, mesh)
        host = rows_for_step(dcfg, i, range(dcfg.batch))
        if not (np.array_equal(tokens.to_local().cpu().numpy(), host[:, :-1])
                and np.array_equal(labels.to_local().cpu().numpy(),
                                   host[:, 1:])
                and tokens.to_local().device == dev):
            bad.append(i)
    print(f"[mesh-batch] batch_for_step on the mesh, steps 0-"
          f"{MESH_RUN['steps'] - 1} of {dcfg.batch} x {dcfg.seq_len}: "
          f"{tokens.placements} int32 DTensors on {dev}, against the rows "
          f"drawn on the host: steps differing {bad}")
    if bad:
        raise AssertionError("mesh-batch: sharded batches differ from the "
                             "host's rows")


def _mesh_phase():
    """Phase 16 (``--mesh``, in a child process): training on a device
    mesh. One process joins a one-rank NCCL group (torchrun's variables,
    set here where no launcher set them) and builds the 1 x 1 mesh over
    ``("data", "model")``; 16a-16d run on it, then 16e."""
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    if "RANK" not in os.environ:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
    t0 = time.perf_counter()
    card = _card_line()
    dev = init_distributed()
    mesh = make_test_mesh((1, 1), ("data", "model"))
    print(f"[mesh] {dist.get_backend()} group of {dist.get_world_size()} on "
          f"{dev}; mesh {mesh}")
    try:
        _mesh_launcher(card, (fa.flash_attention_kernel,
                              fa.flash_attention_backward_kernel), mesh)
        _mesh_moe(card, mesh, dev)
        _mesh_checkpoint_and_batches(card, mesh, dev)
        _mesh_seq_attention(card, dev)
    finally:
        dist.destroy_process_group()
    print(f"[mesh] phase 16 in {time.perf_counter() - t0!r} s (this "
          f"process); card {card}")


# ---- the mesh analysed without running it: cells, dry run, device order -------

DRYRUN_TRAIN = dict(arch="internlm2-1.8b", batch=2, seq=4096)
DRYRUN_FLOP_TOL = 1e-6
# the folded trace's peak against the real step's
DRYRUN_PEAK_TOL = 0.2
# the dry run's cells at full width on the (16, 16) production mesh
DRYRUN_CELLS = ("internlm2-1.8b", "qwen3-moe-30b-a3b", "zamba2-2.7b",
                "xlstm-125m")
# (query heads, kv heads) a rank of every flash op there, where the kv heads
# do not divide the model axis of 16: each rank's own query heads and the
# kv head they read
DRYRUN_FLASH_HEADS = {"internlm2-1.8b": (1, 1), "qwen3-moe-30b-a3b": (2, 1)}
# xlstm's train_4k on the (2, 16, 16) world: half the pod's rows a data
# shard, its scans split over (row, head) pairs; FLOPs a device at most
# this share of the pod record's
DRYRUN_XLSTM_MULTIPOD = 0.6


def _fake_world(n: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _dryrun_trace_vs_real(card):
    """Phase 17a: the traced 2 x 4096 step of internlm2-1.8b against the
    same step run on the card, both on a 1 x 1 mesh laid out by the cell's
    shardings."""
    import torch
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core.trace_analysis import (analyze_trace, dot_flops,
                                                 flash_flops)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.rope import rope_kernel
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import init_distributed, make_test_mesh
    from repro_torch.models.specs import materialize, tree_map
    from repro_torch.sharding import rules as R
    from repro_torch.train.optim import AdamWConfig, adamw_init
    run = DRYRUN_TRAIN
    shape = ShapeSpec("train_2x4096", run["seq"], run["batch"], "train")

    _fake_world(1)
    try:
        traced = {}
        for fold in (False, True):      # unrolled, then its layers folded
            cell = build_cell(run["arch"], shape, make_test_mesh((1, 1)))
            t0 = time.perf_counter()
            traced[fold] = cell.trace(fold=fold) + (time.perf_counter()
                                                    - t0,)
    finally:
        dist.destroy_process_group()
    trace, memory, trace_s = traced[True]
    st = analyze_trace(trace)
    unrolled = analyze_trace(traced[False][0])
    n_fwd = sum(op.count for op in trace.ops
                if op.base == "flash_attention" and flash_flops(op) > 0)
    n_bwd = sum(op.count for op in trace.ops
                if op.base == "flash_attention_backward"
                and flash_flops(op) > 0)
    n_rope = sum(op.count for op in trace.ops if op.base == "rope")
    dots = sum(dot_flops(op) * op.count for op in trace.ops)
    coll = dict(st["collectives"], by_link=D.collective_links(trace))
    roof = D.roofline_terms(st["flops"], st["bytes"], coll,
                            cell.model_flops, 1)
    print(f"[dryrun] (a) traced {run['arch']} {run['batch']} x {run['seq']} "
          f"train step on a fake 1 x 1 mesh, layers folded, in {trace_s!r} "
          f"s: {len(trace.ops)} ops recorded for {trace.n_unrolled}, flash "
          f"{n_fwd} forward / {n_bwd} backward, matrix-product FLOPs "
          f"{dots!r}, all FLOPs {st['flops']!r}, bytes {st['bytes']!r}, "
          f"predicted peak {memory['peak_bytes_per_device']} bytes, roofline "
          f"{roof}; unrolled in {traced[False][2]!r} s: "
          f"{len(traced[False][0].ops)} ops, FLOPs {unrolled['flops']!r}, "
          f"bytes {unrolled['bytes']!r}, predicted peak "
          f"{traced[False][1]['peak_bytes_per_device']} bytes")

    if "RANK" not in os.environ:
        import socket
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dev = init_distributed()
    kernels = (fa.flash_attention_kernel, fa.flash_attention_backward_kernel,
               rope_kernel)
    try:
        mesh = make_test_mesh((1, 1))
        real = build_cell(run["arch"], shape, mesh)
        gen = torch.Generator(device=dev).manual_seed(0)
        p_specs, o_specs, b_specs = real.arg_specs
        p_sh, _, b_sh = real.in_shardings
        params = materialize(p_specs, gen, device=dev)
        params = {k: v for k, v in params.items()}

        def placed(tree, sh):
            if isinstance(tree, dict):
                return {k: placed(v, sh[k]) for k, v in tree.items()}
            return R.distribute(tree, sh)
        params = placed(params, p_sh)
        opt = adamw_init(params, AdamWConfig(state_dtype="fp32"))
        vocab = real.arg_specs[0]["embed"]["table"].shape[0]
        batch = {k: R.distribute(torch.randint(0, vocab, s.shape,
                                               generator=gen, device=dev),
                                 b_sh[k]) for k, s in b_specs.items()}
        real.step_fn(params, opt, batch)              # warm-up
        torch.cuda.synchronize()
        _reset_counts(kernels)
        counter = FlopCounterMode(display=False)
        with counter:
            real.step_fn(params, opt, batch)
        torch.cuda.synchronize()
        launches = _counts(kernels)
        flops = counter.get_total_flops()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        real.step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    del params, opt, batch
    torch.cuda.empty_cache()
    got = (launches["flash_attention_kernel"],
           launches["flash_attention_backward_kernel"])
    # the RoPE kernel both ways: one repro_torch.rope op a launch
    rope = launches["rope_kernel"] + launches["rope_kernel.backward"]
    gap = abs(dots - flops) / flops
    pred = memory["peak_bytes_per_device"]
    print(f"[dryrun] (a) the real step on a one-rank NCCL 1 x 1 mesh: flash "
          f"launches {got[0]} forward / {got[1]} backward (trace {n_fwd} / "
          f"{n_bwd}), RoPE {rope} both ways (trace {n_rope}); "
          f"FlopCounterMode {flops} FLOPs vs the trace's matrix "
          f"products {dots!r} (relative gap {gap!r}, tolerance "
          f"{DRYRUN_FLOP_TOL}); peak {peak} bytes vs predicted {pred} "
          f"({(pred - peak) / peak!r} relative); step wall {wall!r} s, "
          f"ideal {roof['ideal_compute_s']!r} s: measured fraction "
          f"{roof['ideal_compute_s'] / wall!r} vs roofline fraction "
          f"{roof['roofline_fraction']!r} (dominant {roof['dominant']}); "
          f"card {card}")
    print("[dryrun] " + json.dumps({
        "phase": "17a", "model": run["arch"], "batch": run["batch"],
        "seq": run["seq"], "trace_s": trace_s, "trace_ops": len(trace.ops),
        "unrolled_ops": trace.n_unrolled,
        "unrolled_trace_s": traced[False][2],
        "unrolled_trace_ops": len(traced[False][0].ops),
        "unrolled_flops": unrolled["flops"],
        "unrolled_bytes": unrolled["bytes"],
        "unrolled_peak_bytes":
            traced[False][1]["peak_bytes_per_device"],
        "flash_traced": [n_fwd, n_bwd], "flash_launched": list(got),
        "rope_traced": n_rope, "rope_launched": rope,
        "trace_matmul_flops": dots, "flop_counter_flops": flops,
        "flop_rel_gap": gap, "trace_flops": st["flops"],
        "trace_bytes": st["bytes"], "predicted_peak_bytes": pred,
        "measured_peak_bytes": peak, "memory": memory,
        "model_flops": cell.model_flops, "step_wall_s": wall,
        "measured_fraction": roof["ideal_compute_s"] / wall,
        "roofline": roof}))
    if got != (n_fwd, n_bwd):
        raise AssertionError(f"dryrun: the trace's flash ops {n_fwd} / "
                             f"{n_bwd} are not the real step's launches "
                             f"{got}")
    if rope != n_rope or not rope:
        raise AssertionError(f"dryrun: the trace's {n_rope} RoPE ops are not "
                             f"the real step's {rope} launches")
    if gap > DRYRUN_FLOP_TOL:
        raise AssertionError(f"dryrun: the trace's matrix-product FLOPs "
                             f"depart from FlopCounterMode's by {gap!r}")
    if st["flops"] != unrolled["flops"]:
        raise AssertionError(f"dryrun: the folded trace counts "
                             f"{st['flops']!r} FLOPs, the unrolled "
                             f"{unrolled['flops']!r}")
    if abs(pred - peak) > DRYRUN_PEAK_TOL * peak:
        raise AssertionError(f"dryrun: the folded trace's peak {pred} is "
                             f"not within {DRYRUN_PEAK_TOL} of the real "
                             f"step's {peak}")
    return {"flash_attention": got[0], "flash_attention_backward": got[1],
            "rope": rope}


def _dryrun_production(card):
    """Phase 17b: ``run_cell`` at full width on the (16, 16) fake world,
    the flash ops' heads a rank where the kv heads do not divide the model
    axis, and xlstm's cell on the (2, 16, 16) world against its pod
    record; returns qwen3's traffic graph on the mesh (for 17c)."""
    import tempfile
    from repro_torch.core.gpu_adapter import traffic_from_trace
    from repro_torch.core.trace_analysis import flash_flops
    from repro_torch.launch import dryrun as D
    graphs, heads, flops = {}, {}, {}

    def seen(tr, mesh, arch):
        graphs[arch] = traffic_from_trace(tr, mesh)
        heads[arch] = sorted({(op.inputs[0][0][1], op.inputs[1][0][1])
                              for op in tr.ops if flash_flops(op)})
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    for arch in DRYRUN_CELLS:
        rec = D.run_cell(arch, "train_4k", False, out_dir,
                         on_trace=lambda tr, mesh, a=arch: seen(tr, mesh, a))
        if not rec["ok"]:
            raise AssertionError(f"dryrun: {arch} x train_4k failed: "
                                 f"{rec['error']}\n{rec['traceback']}")
        r = rec["roofline"]
        print(f"[dryrun] (b) {arch} x train_4k x pod (256 ranks, fsdp "
              f"{rec['fsdp']}): trace {rec['trace_s']} s (host CPU), "
              f"{rec['n_trace_ops']} ops recorded for "
              f"{rec['n_unrolled_ops']}, total {rec['total_s']} s; dominant "
              f"{r['dominant']}, roofline fraction "
              f"{r['roofline_fraction']!r}, useful FLOPs ratio "
              f"{r['useful_flops_ratio']!r}; card {card}")
        print(D.compiled_summary(rec))
        print("[dryrun] " + json.dumps({
            "phase": "17b", "arch": arch, "shape": "train_4k",
            "fsdp": rec["fsdp"], "trace_s": rec["trace_s"],
            "n_trace_ops": rec["n_trace_ops"],
            "n_unrolled_ops": rec["n_unrolled_ops"],
            "total_s": rec["total_s"], "memory": rec["memory"],
            "cost": rec["cost"], "roofline": r,
            "collectives": {k: rec["collectives"][k] for k in
                            ("operand_bytes", "wire_bytes", "n_ops",
                             "by_link", "by_axis")}}))
        flops[arch] = rec["cost"]["flops_per_device"]
    for arch, want in DRYRUN_FLASH_HEADS.items():
        print(f"[dryrun] (b) {arch} x train_4k x pod: (query heads, kv "
              f"heads) a rank of its flash ops {heads[arch]}, want "
              f"[{want}]; card {card}")
        if heads[arch] != [want]:
            raise AssertionError(f"dryrun: {arch}'s flash ops take "
                                 f"{heads[arch]} heads a rank, not {want}")
    rec = D.run_cell("xlstm-125m", "train_4k", True, out_dir)
    if not rec["ok"]:
        raise AssertionError(f"dryrun: xlstm-125m x train_4k x multipod "
                             f"failed: {rec['error']}\n{rec['traceback']}")
    share = rec["cost"]["flops_per_device"] / flops["xlstm-125m"]
    print(f"[dryrun] (b) xlstm-125m x train_4k x multipod (512 ranks): "
          f"trace {rec['trace_s']} s (host CPU), FLOPs a device "
          f"{rec['cost']['flops_per_device']!r}, {share!r} of the pod "
          f"record's (at most {DRYRUN_XLSTM_MULTIPOD}), useful FLOPs ratio "
          f"{rec['roofline']['useful_flops_ratio']!r}; card {card}")
    print("[dryrun] " + json.dumps({
        "phase": "17b", "arch": "xlstm-125m", "shape": "train_4k",
        "mesh": "multipod", "trace_s": rec["trace_s"],
        "cost": rec["cost"], "share_of_pod": share,
        "flash_heads": {a: heads[a] for a in DRYRUN_FLASH_HEADS}}))
    if share > DRYRUN_XLSTM_MULTIPOD:
        raise AssertionError(f"dryrun: xlstm's multi-pod FLOPs a device "
                             f"are {share!r} of the pod's")
    return graphs["qwen3-moe-30b-a3b"]


def _dryrun_device_order(card, graph):
    """Phase 17c: qwen3's traffic on 256 GPUs of ``nvlink_cluster((4,
    8))``: the rank order against the paper's SA, and the repair of a
    scrambled order; the kernels' launches counted."""
    import numpy as np
    from repro_torch.core import gpu_adapter as G
    from repro_torch.core.placement.population import (
        simulated_annealing_population)
    from repro_torch.kernels import delta_cost as delta_mod
    from repro_torch.kernels import noc_segsum
    kernels = (noc_segsum.link_traffic, noc_segsum.link_traffic_routes,
               delta_mod.delta_cost, delta_mod.sa_chains)
    noc = G.nvlink_cluster((4, 8))
    ranks = G.gpu_cores(noc)
    base = G.ici_cost(graph, noc, ranks)
    _reset_counts(kernels)
    t0 = time.perf_counter()
    order, res = G.optimize_device_order(graph, noc,
                                         method="simulated_annealing",
                                         budget=4000, seed=0, init=ranks)
    sa_s = time.perf_counter() - t0
    sa_launches = _counts(kernels)
    # the device-resident SA: 64 chains, chain 0 from the rank order, in
    # one sa_chains launch
    _reset_counts(kernels)
    t0 = time.perf_counter()
    _, dres = G.optimize_device_order(graph, noc,
                                      method="simulated_annealing",
                                      budget=4000, seed=0, backend="device",
                                      restarts=64, init=ranks)
    dev_s = time.perf_counter() - t0
    dev_launches = _counts(kernels)
    scrambled = np.random.default_rng(0).permutation(graph.n)
    bad = float(G.ici_cost_batch(graph, noc, scrambled[None, :])[
        "comm_cost"][0])
    _reset_counts(kernels)
    t0 = time.perf_counter()
    repaired = simulated_annealing_population(graph, noc, iters=1500,
                                              pop_size=8, init=scrambled,
                                              seed=1)
    rep_s = time.perf_counter() - t0
    rep_launches = _counts(kernels)
    rep = noc.evaluate(graph, repaired).comm_cost
    print(f"[dryrun] (c) qwen3-moe-30b-a3b train_4k traffic on "
          f"nvlink_cluster((4, 8)), {noc.n_cores} GPUs: rank order "
          f"comm_cost {base['comm_cost']!r}, SA from it (4000 steps, the "
          f"card's scorer) {res.comm_cost!r} in {sa_s!r} s, launches "
          f"{sa_launches}; the device SA (64 chains x 4000 steps) "
          f"{dres.comm_cost!r} in {dev_s!r} s, launches {dev_launches}; "
          f"scrambled {bad!r} -> repaired {rep!r} (pop SA 8 x 1500) in "
          f"{rep_s!r} s, launches {rep_launches}; card {card}")
    launches = {k: sa_launches[k] + dev_launches[k] + rep_launches[k]
                for k in sa_launches}
    print("[dryrun] " + json.dumps({
        "phase": "17c", "rank_order_cost": float(base["comm_cost"]),
        "sa_cost": float(res.comm_cost), "sa_s": sa_s,
        "device_sa_cost": float(dres.comm_cost), "device_sa_s": dev_s,
        "scrambled_cost": bad, "repaired_cost": float(rep),
        "repair_s": rep_s, "sa_launches": sa_launches,
        "device_sa_launches": dev_launches,
        "repair_launches": rep_launches}))
    if dev_launches["sa_chains"] != 1:
        raise AssertionError(f"dryrun: the device SA made "
                             f"{dev_launches['sa_chains']} sa_chains "
                             f"launches, not 1")
    if not (res.comm_cost <= base["comm_cost"]
            and dres.comm_cost <= base["comm_cost"] and rep < bad):
        raise AssertionError("dryrun: the device-order search made the "
                             "order worse")
    return launches


def _dryrun_phase():
    """Phase 17 (``--dryrun``, in a child process)."""
    t0 = time.perf_counter()
    card = _card_line()
    # each kernel's launches in the runs phase 17 counts, by the kernels
    # line's names: 17a's counted step and 17c's searches
    launches = _dryrun_trace_vs_real(card)
    graph = _dryrun_production(card)
    launches.update(_dryrun_device_order(card, graph))
    print("[dryrun-launches] " + json.dumps(launches))
    print(f"[dryrun] phase 17 in {time.perf_counter() - t0!r} s (this "
          f"process); card {card}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs one CUDA card", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--wrapper-times"]:
        card = _card_line()
        print(card)
        _wrapper_host_times(torch.device("cuda"), card)
        return 0
    if sys.argv[1:] == ["--train-restart"]:
        _train_restart(torch.device("cuda"))
        return 0
    if sys.argv[1:] == ["--moe-repeat"]:
        _moe_repeat(torch.device("cuda"))
        return 0
    if sys.argv[1:] == ["--mesh"]:
        _mesh_phase()
        return 0
    if sys.argv[1:] == ["--dryrun"]:
        _dryrun_phase()
        return 0
    if sys.argv[1:] == ["--flash-backward"]:
        _flash_backward_phase()
        return 0
    if sys.argv[1:] == ["--flash-backward-split"]:
        _flash_backward_split()
        return 0
    if sys.argv[1:] == ["--flash-backward-times"]:
        _flash_backward_times()
        return 0
    if sys.argv[1:] == ["--rope"]:
        _rope_phase()
        return 0
    if sys.argv[1:] == ["--flash-backward-digests"]:
        print(_card_line())
        _backward_digests(torch.device("cuda"))
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import (NoC, HierarchicalMesh, evaluate_batch,
                                  random_dag)
    from repro_torch.core.noc_batch import (build_incident_tables,
                                            validate_placements)
    from repro_torch.core.partition import partition_model
    from repro_torch.deploy import as_objective, deploy_model
    from repro_torch.kernels import _build
    from repro_torch.kernels import delta_cost as delta_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels.delta_cost import delta_cost, delta_cost_plain
    from repro_torch.kernels import lif as lif_mod
    from repro_torch.kernels import rope as rope_mod
    from repro_torch.kernels import spike_matmul as mm_mod
    from repro_torch.kernels.noc_segsum import (KERNEL, link_traffic,
                                                link_traffic_plain,
                                                link_traffic_routes)
    from repro_torch.obs import Recorder
    from repro_torch.snn import profile_model, spike_resnet18, spike_vgg16

    dev = torch.device("cuda")
    # float32 matmuls stay float32 (PyTorch's default, stated); cuDNN keeps
    # its default TF32 setting, so that the training path's own scoped
    # float32 convolutions (snn.layers.fp32_convs) are what is exercised
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    kernels = (link_traffic, link_traffic_routes, delta_cost,
               delta_mod.sa_chains, lif_mod.lif_step_kernel,
               lif_mod.lif_backward_kernel, mm_mod.spike_matmul_kernel,
               fa_mod.flash_attention_kernel,
               fa_mod.flash_attention_backward_kernel, rope_mod.rope_kernel)

    # ---- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    names = [KERNEL, delta_mod.KERNEL, lif_mod.KERNEL, mm_mod.KERNEL,
             fa_mod.KERNEL, rope_mod.KERNEL]
    _build.build(names)
    print(f"[build] {', '.join(names)} (in parallel): "
          f"{time.perf_counter() - t0:.2f} s")
    ptxas = {name: _ptxas_report(name, _build.build_log(name))
             for name in names}
    spills = [f"{e['kernel']} ({e['spill_stores']}/{e['spill_loads']} bytes)"
              for report in ptxas.values() for e in report
              if e["spill_stores"] or e["spill_loads"]]
    print(f"[build] kernels that spill: {spills if spills else 'none'}")

    # ---- phase 2: kernel vs plain version -------------------------------------
    rng = np.random.default_rng(0)
    vgg = spike_vgg16()
    noc = NoC(8, 8, **FULL_NOC)
    graph = partition_model(profile_model(vgg, batch=8, training=True),
                            noc.n_cores, "balanced").to_graph()
    cases = []
    for B, K, n_links in [(3, 500, 256), (1, 7, 16), (2, 130, 20),
                          (4, 1024, 100)]:
        ids = torch.as_tensor(rng.integers(0, n_links + 1, (B, K)),
                              dtype=torch.int32)
        cases.append((f"kernel-test {B}x{K}->{n_links}", ids, n_links))
    cases.append(("all-padding 2x64->16",
                  torch.full((2, 64), 16, dtype=torch.int32), 16))
    main_ids, main_w, main_links = _route_ids(
        noc, graph, _random_placements(rng, graph.n, noc.n_cores, 256))
    cases.append((f"main path {tuple(main_ids.shape)}->{main_links}",
                  main_ids, main_links))
    torus = NoC(16, 16, torus=True)
    g_torus = random_dag(200, p=0.05, seed=1)
    t_ids, _, t_links = _route_ids(
        torus, g_torus, _random_placements(rng, 200, torus.n_cores, 16))
    cases.append((f"torus 16x16 {tuple(t_ids.shape)}->{t_links}", t_ids,
                  t_links))
    hier = HierarchicalMesh(2, 2, 4, 4)
    g_hier = random_dag(60, p=0.2, seed=2)
    h_ids, _, h_links = _route_ids(
        hier, g_hier, _random_placements(rng, 60, hier.n_cores, 64))
    cases.append((f"hier 2x2:4x4 {tuple(h_ids.shape)}->{h_links}", h_ids,
                  h_links))
    for name, ids, n_links in cases:
        for kind in ("int", "float"):
            w = (torch.as_tensor(rng.integers(0, 16, ids.shape),
                                 dtype=torch.float32) if kind == "int" else
                 torch.as_tensor(rng.random(ids.shape), dtype=torch.float32))
            ids_d, w_d = ids.to(dev), w.to(dev)
            got = link_traffic(ids_d, w_d, n_links)
            torch.cuda.synchronize()
            want = link_traffic_plain(ids_d, w_d, n_links)
            if kind == "int":
                ok = torch.equal(got, want)
            else:
                ok = torch.allclose(got, want, rtol=1e-5, atol=1e-3)
            err = (got - want).abs().max().item() if got.numel() else 0.0
            print(f"[kernel] {KERNEL} {name} {kind} weights: "
                  f"max_abs_err={err!r} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"{KERNEL} disagrees with its plain "
                                     f"version on {name} ({kind} weights)")
    # the main path's own weights: edge volumes (sums above 2^24, float32)
    got = link_traffic(main_ids.to(dev), main_w.to(dev), main_links)
    torch.cuda.synchronize()
    want = link_traffic_plain(main_ids.to(dev), main_w.to(dev), main_links)
    main_err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-3):
        raise AssertionError(f"{KERNEL} disagrees on the main path's volumes")
    print(f"[kernel] {KERNEL} main path volumes: max_abs_err={main_err!r} "
          f"(max {want.abs().max().item()!r}, rtol=1e-5) ok")
    routes_err, routes_main = _check_link_traffic_routes(dev, rng, noc,
                                                         graph)
    delta_err = _check_delta_cost(dev, graph, noc, rng)
    _check_sa_chains(dev)
    resnet = spike_resnet18()
    _check_lif(dev, rng, vgg, resnet)
    bwd_err = _check_lif_backward(dev, rng, vgg, resnet)
    _check_spike_matmul(dev, rng, vgg)
    flash_err = _check_flash(dev)

    # ---- phase 3: cuda backend vs numpy backend --------------------------------
    P = _random_placements(rng, graph.n, noc.n_cores, 256)
    m_np = evaluate_batch(noc, graph, P, backend="numpy")
    m_cu = evaluate_batch(noc, graph, P, backend="cuda")
    for field in ("comm_cost", "max_link", "latency", "link_traffic",
                  "core_traffic"):
        a, b = getattr(m_cu, field), getattr(m_np, field)
        if not np.allclose(a, b, rtol=1e-5, atol=1e-3):
            raise AssertionError(f"evaluate_batch(cuda).{field} != numpy")
    if not np.array_equal(m_cu.max_hops, m_np.max_hops):
        raise AssertionError("evaluate_batch(cuda).max_hops != numpy")
    rel = np.abs(m_cu.latency - m_np.latency).max() / m_np.latency.max()
    print(f"[evaluate] cuda vs numpy on {graph.n} nodes, "
          f"{graph.edge_arrays()[0].size} edges, 256 placements: "
          f"latency max rel err {rel!r} ok")
    _check_delta_stream(dev, graph, noc, rng)

    # ---- phase 4: the PPO path ---------------------------------------------------
    rec = Recorder()
    _reset_counts(kernels)
    t0 = time.perf_counter()
    plan = deploy_model(vgg, noc, method="ppo", objective="latency",
                        recorder=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(kernels)
    report = plan.report()
    print("[deploy] report " + json.dumps(report))
    print(f"[deploy] wall {wall!r} s; stage times "
          f"{json.dumps(plan.stage_times_s)}; launches {launches}")
    phases: dict = {}
    for ev in rec.events:
        if ev["kind"] == "span" and ev["name"].startswith("ppo."):
            phases[ev["name"]] = phases.get(ev["name"], 0.0) + ev["dur"]
    print(f"[deploy] PPO phase totals over {len(plan.placement.history)} "
          f"iterations (host clock, each phase ends in a sync): "
          f"{json.dumps(phases)}")
    res = plan.placement
    validate_placements(noc, res.placement, plan.graph.n)
    if not math.isfinite(res.objective_cost):
        raise AssertionError("objective_cost is not finite")
    host = as_objective("latency").from_metrics(
        noc.evaluate(plan.graph, res.placement), noc)
    best = res.history[-1]["best_cost"]
    if not math.isclose(best, host, rel_tol=1e-5):
        raise AssertionError(f"best rollout latency {best!r} (cuda scorer) "
                             f"!= host evaluate {host!r}")
    if (len(res.history) != 40 or launches["link_traffic_routes"] != 40
            or launches["link_traffic"] != 0):
        raise AssertionError(f"main path ran {len(res.history)} iterations "
                             f"and {launches} kernel launches, not 40 "
                             "link_traffic_routes launches and no "
                             "link_traffic launch")
    print(f"[deploy] best latency {best!r} s (cuda) vs host evaluate "
          f"{host!r} s ok; link_traffic_routes launches per deploy_model "
          f"{launches['link_traffic_routes']} (one per PPO iteration), "
          f"link_traffic {launches['link_traffic']} ok")

    ppo_launches = launches["link_traffic_routes"], launches["link_traffic"]

    # ---- phase 5: the device SA path ---------------------------------------------
    sa_launches, sa_plan, sa_check = _sa_path(vgg, noc, kernels)

    # ---- phase 6: device GA, multilevel, host searches ----------------------------
    _other_paths(vgg, noc, graph, kernels)

    # ---- phase 7: BPTT training at full width ----------------------------------
    print(f"[train] cudnn.allow_tf32 outside the training path: "
          f"{torch.backends.cudnn.allow_tf32} (the path scopes it off)")
    lif_launches = _train_path(vgg, "vgg16", 5, dev, kernels, 13)
    differ, _ = _kernel_vs_plain_step(vgg, "vgg16", dev)
    if differ:
        raise AssertionError(f"vgg16: gradients differ between the kernel "
                             f"and the plain path: {differ}")
    print("[vgg16] every gradient bit-identical ok")
    _train_path(resnet, "resnet18", 3, dev, kernels, 17)
    differ, grads = _kernel_vs_plain_step(resnet, "resnet18", dev)
    ops = _nondeterministic_ops(resnet, dev)
    print(f"[resnet18] ops of the step that PyTorch reports as "
          f"nondeterministic on the card: {ops}")
    if differ:
        print(f"[resnet18] gradients that differ: {differ}")
        if not ops:
            raise AssertionError("resnet18: gradients differ with no "
                                 "nondeterministic op on the path")
        for name in differ:
            a, b = grads[name]
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-6):
                raise AssertionError(f"resnet18: gradient {name} differs "
                                     f"beyond rtol 1e-4, atol 1e-6")
        print("[resnet18] the differing gradients agree within rtol 1e-4, "
              "atol 1e-6 ok")
    else:
        print("[resnet18] every gradient bit-identical ok")

    # ---- phase 8: the event-driven conv path ------------------------------------
    mm_launches, mm_err, first_convs = _spike_conv_path(vgg, dev, kernels)

    # ---- phase 9: timing ---------------------------------------------------------
    # "ms"/"plain_ms"/"library_ms" are per-call times of back-to-back eager
    # calls under CUDA events, host overhead included (one definition across
    # slices); the "*device_ms" keys are device time from CUDA-graph replay
    ids_d, w_d = main_ids.to(dev), main_w.to(dev)
    ids64 = ids_d.long()
    base = torch.zeros(ids_d.shape[0], main_links + 1, device=dev)
    B, K = ids_d.shape
    lt_fns = (lambda: link_traffic(ids_d, w_d, main_links),
              lambda: link_traffic_plain(ids_d, w_d, main_links),
              lambda: torch.scatter_add(base, 1, ids64, w_d))
    dev_ms = [_graph_ms(f) for f in lt_fns]
    ms, plain_ms, library_ms = (_time_ms(f) for f in lt_fns)
    n_bytes = B * K * (4 + 4) + B * main_links * 4
    n_ops = int((ids_d < main_links).sum().item())       # adds this data needs
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"[time] {KERNEL} [{B}, {K}] -> {main_links}: kernel {ms!r} ms, "
          f"plain {plain_ms!r} ms, scatter_add {library_ms!r} ms (per call); "
          f"device {dev_ms[0]!r}, {dev_ms[1]!r}, {dev_ms[2]!r} ms; bound "
          f"{bound_ms!r} ms ({n_bytes} bytes, {n_ops} adds); card {card}")

    rows = [{
        "name": "link_traffic", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/noc_segsum.cu",
        "replaces": "src/repro/kernels/noc_segsum.py:54",
        "launches": ppo_launches[1], "max_abs_err": main_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "device_ms": dev_ms[0],
        "plain_device_ms": dev_ms[1], "library_device_ms": dev_ms[2],
        "path": "none: the PPO scorer runs link_traffic_routes; held against "
                "its plain version in phase 2",
    }]
    rows.append(_time_link_traffic_routes(routes_main, ppo_launches[0],
                                          routes_err, ptxas[KERNEL], card))
    inc = build_incident_tables(sa_plan.graph)
    delta_times = {}
    for label, R, K, hops in [
            ("SA path", 64, 2 * inc.max_degree, noc.hops_matrix()),
            ("R=K=C=1024", 1024, 1024, NoC(32, 32).hops_matrix())]:
        C = hops.shape[0]
        args = [torch.as_tensor(rng.integers(0, C, (R, K)),
                                dtype=torch.int32, device=dev)
                for _ in range(4)]
        # the graph's own incident volumes, one node's row after another
        nodes = rng.integers(0, sa_plan.graph.n, (R, -(-K // inc.max_degree)))
        vol = inc.vol[nodes].reshape(R, -1)[:, :K]
        args += [torch.as_tensor(vol, dtype=torch.float32, device=dev),
                 torch.as_tensor(hops, dtype=torch.float32, device=dev)]
        d_fns = (lambda: delta_cost(*args), lambda: delta_cost_plain(*args))
        d_dev = [_graph_ms(f) for f in d_fns]
        d_ms, d_plain = (_time_ms(f) for f in d_fns)
        d_bytes = 5 * R * K * 4 + C * C * 4 + R * 4
        d_ops = 3 * R * K          # subtract, multiply, add per entry
        tb, to = d_bytes / HBM_BYTES_PER_S, d_ops / FP32_OPS_PER_S
        delta_times[label] = (d_ms, d_plain, max(tb, to) * 1e3,
                              "bytes" if tb >= to else "operations", d_dev)
        print(f"[time] delta_cost {label} ({R}, {K}, {C}): kernel {d_ms!r} "
              f"ms, plain {d_plain!r} ms (per call); device {d_dev[0]!r}, "
              f"{d_dev[1]!r} ms; bound "
              f"{delta_times[label][2]!r} ms ({d_bytes} bytes, {d_ops} "
              f"flops); no single PyTorch call computes this function "
              f"(library_ms null); card {card}")
    d_ms, d_plain, d_bound, d_by, d_dev = delta_times["SA path"]
    rows.append({
        "name": "delta_cost", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_cost.cu",
        "replaces": "src/repro/kernels/delta_cost.py:67",
        "launches": sa_launches["delta_cost"], "max_abs_err": delta_err,
        "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
        "bound_by": d_by, "library_ms": None, "device_ms": d_dev[0],
        "plain_device_ms": d_dev[1], "library_device_ms": None,
        "path": "none: the device SA runs sa_chains; held against its plain "
                "version in phase 2 and launched once a step by the loop "
                "sa_chains is checked against in phase 5",
    })
    rows.append(_time_sa_chains(sa_check, sa_launches["sa_chains"],
                                ptxas[delta_mod.KERNEL], card))
    rows += _time_snn_kernels(dev, rng, vgg, first_convs, card, lif_launches,
                              mm_launches, mm_err, bwd_err)

    # ---- phase 10: the LM token server at full width ---------------------------
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Segment
    flash_launches = _serve_path(get_config("internlm2-1.8b"), "serve",
                                 SERVED["batch"], SERVED["prompt_len"],
                                 SERVED["gen_len"], dev, kernels)["flash"]
    danube = get_config("h2o-danube-1.8b")
    danube = dataclasses.replace(danube, segments=(
        Segment("attn", "dense", DANUBE["layers"]),))
    _serve_path(danube, "serve-danube", DANUBE["batch"],
                DANUBE["prompt_len"], DANUBE["gen_len"], dev, kernels)
    flash_row = _time_flash(dev, card, flash_launches, flash_err)
    rows.append(flash_row)

    # ---- phase 11: the placement front end on the card --------------------------
    _placement_front_end(vgg, noc, kernels, plan, phases)

    # ---- phase 12: LM training at full width ------------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    bwd_errs = _check_flash_backward(dev)
    bwd_splits = _backward_splits()
    train_launches = _train_lm_path(dev, kernels)
    bwd_row = _time_flash_backward(
        dev, card, train_launches["flash_attention_backward_kernel"],
        bwd_errs["trained internlm2 layer"],
        split=bwd_splits[_split_key("internlm2-1.8b", True)])
    rows.append(bwd_row)
    rows.append(_time_rope(dev, card, train_launches))
    torch.cuda.reset_peak_memory_stats()
    _train_kernel_vs_plain(dev)
    _child("--train-restart", "train-restart")
    print(f"[train-lm] phase 12 in {time.perf_counter() - t0!r} s")

    # ---- phase 13: the MLA and MoE families served at full width ---------------
    t0 = time.perf_counter()
    _serve_families(dev, card, kernels, flash_row)
    print(f"[families] phase 13 in {time.perf_counter() - t0!r} s")

    # ---- phase 14: the recurrent families served and trained -----------------
    t0 = time.perf_counter()
    _recurrent_families(dev, card, kernels, flash_row, bwd_row,
                        bwd_errs["trained zamba2 shared block"], bwd_splits)
    print(f"[recurrent] phase 14 in {time.perf_counter() - t0!r} s")

    # ---- phase 15: the enc-dec family, and MLA/MoE training -------------------
    t0 = time.perf_counter()
    _encdec_and_families(dev, card, kernels, flash_row, bwd_row, bwd_errs,
                         bwd_splits)
    print(f"[encdec] phase 15 in {time.perf_counter() - t0!r} s")

    # ---- phase 16: training on a device mesh ----------------------------------
    t0 = time.perf_counter()
    _child("--mesh", "mesh")
    print(f"[mesh] phase 16 in {time.perf_counter() - t0!r} s")

    # ---- phase 17: the mesh analysed without running it -----------------------
    t0 = time.perf_counter()
    out = _child("--dryrun", "dryrun")
    dry = json.loads(next(line for line in out.splitlines()
                          if line.startswith("[dryrun-launches] "))
                     .split(" ", 1)[1])
    for row in rows:              # null: a kernel phase 17 did not count
        row["dryrun_launches"] = dry.get(row["name"])
    print(f"[dryrun] phase 17 in {time.perf_counter() - t0!r} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
