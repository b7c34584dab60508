#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --wrapper-times   # only the LIF wrappers' host cost
    python3 chip_smoke.py --train-restart   # only phase 12d

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
    evaluate); ``run_scenario`` at ``benchmarks/fault_replace.py``'s full
    configuration (S-VGG16 on hier 2x2:4x4, budget 4096, deploy budget
    65536, threshold 0.02, migration weight 0.12, warm t0 0.005, the busiest
    inter-chip link dropped, ``compare_cold=True``), identical with the
    recorder on and off, its objectives the host evaluate's, with
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
    dtypes and D=256 (float32 within 1e-4 of each gradient's largest
    magnitude, bf16 within relative L2 2e-2), each run twice bit-identical;
    the forward's lse against the plain version's (float32 1e-5, bf16
    1e-4, of 1 + max |lse|) and its output bit-identical with and without
    lse; the backward's times (eager and CUDA-graph device time) against
    its bound, its plain version and the backward of
    ``F.scaled_dot_product_attention`` (its device time from a graph of the
    backward alone); (b) ``launch.train.main`` at
    internlm2-1.8b's full width and depth, 6 steps of 2 x 4096 tokens:
    each step's synchronised wall, tokens/s, loss and flash launches (48
    forward, all on the tensor cores, and 24 backward calls a step under
    ``remat="full"``), losses finite and falling, peak device memory, the
    last step under torch.profiler (busy share, top kernels, the flash
    backward's share); then 2 steps with ``--grad-compression int8_ef``;
    (c) one step's loss and gradients at full width, depth cut to 2,
    through the kernels and through their plain versions (every gradient
    leaf within relative L2 5e-2); (d) the launcher at the smoke config,
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
    memory below the card's; one ``[families]`` JSON line a model.

Every path starts with all launch counts set to 0 (the flash kernel's
tensor-core count too) and reads them just after. The ``kernels`` line
lists ``flash_attention_backward`` (phase 12b's launches, phase 12a's
times) beside the eight kernels of the earlier phases.

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


def _reset_counts(kernels) -> None:
    for fn in kernels:
        fn.launches = 0
        if hasattr(fn, "tensor_core_launches"):
            fn.tensor_core_launches = 0


def _counts(kernels) -> dict:
    out = {fn.__name__: fn.launches for fn in kernels}
    out.update({f"{fn.__name__}.tensor_core": fn.tensor_core_launches
                for fn in kernels if hasattr(fn, "tensor_core_launches")})
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


def _layerwise_attention(params, cfg, prompts):
    """One prefill of ``prompts`` through the flash kernel; at every layer
    the plain version also runs on the same q, k, v. Returns each layer's
    relative L2 error of the kernel's output against the plain one's."""
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    errs = []

    def both(q, k, v, *, causal, window, out, lse):
        flash_attention_kernel(q, k, v, causal=causal, window=window,
                               out=out, lse=lse)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        errs.append(_rel_err(out, want))
        return out
    _prefill_last(params, cfg, prompts, both)
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


def _serve_path(cfg, label, batch, prompt_len, gen_len, dev, kernels,
                check_cfg=None, check_batch=None, strict=False):
    """Phases 10 and 13: serve ``cfg`` at full width through
    ``launch.serve.generate`` (seeded bf16 weights, greedy), with the flash
    kernel's launches; time to first token and decode per token from the
    pieces ``generate`` runs; one profiled prefill and decode step; prefill
    through the plain version of the attention against the kernel's (a MoE
    model's routes pinned to the kernel prefill's, its free-running
    difference printed); prefill + decode against ``forward`` on the first
    ``check_batch`` rows of the generated tokens, under ``check_cfg``
    (default: ``cfg`` and the whole batch; a MoE model's routes pinned to
    ``forward``'s). With ``strict``, two ``generate`` calls must give equal
    tokens. A MoE model's share of dropped assignments is read from the
    second call. Returns a dict of the results (``flash`` is the main
    run's flash launches, ``rel`` the kernel-vs-plain error)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize, n_params, param_bytes
    specs = lm.lm_specs(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = materialize(specs, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    out = {"model": cfg.name, "layers": cfg.n_layers, "batch": batch,
           "prompt_len": prompt_len, "gen_len": gen_len,
           "parameters": n_params(specs), "param_bytes": param_bytes(specs),
           "materialize_s": time.perf_counter() - t0,
           "materialize_peak_bytes": torch.cuda.max_memory_allocated()}
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
    n_new = batch * gen_len

    # the main path: one generate call, as a user makes it
    _reset_counts(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toks = generate(params, cfg, prompts, gen_len, device=dev)
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    launches = _counts(kernels)
    flash = launches["flash_attention_kernel"]
    tensor_core = launches["flash_attention_kernel.tensor_core"]
    out["generate_peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[{label}] generate batch {batch}, prompt {prompt_len}, {gen_len} "
          f"greedy tokens: wall {wall_first!r} s (first call); peak device "
          f"memory {out['generate_peak_bytes']} bytes; launches {launches}")
    if flash != cfg.n_layers or tensor_core != cfg.n_layers:
        raise AssertionError(f"{label}: {flash} flash launches, "
                             f"{tensor_core} on the tensor cores, not one "
                             f"per layer of the prefill ({cfg.n_layers})")
    if (tuple(toks.shape) != (batch, prompt_len + gen_len)
            or not torch.equal(toks[:, :prompt_len].cpu(),
                               torch.as_tensor(prompts))
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab):
        raise AssertionError(f"{label}: generate returned bad tokens")
    routes = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _recording_routes(routes):
        toks2 = generate(params, cfg, prompts, gen_len, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["repeat_equal"] = torch.equal(toks, toks2)
    print(f"[{label}] generate again: wall {wall!r} s, {n_new / wall!r} "
          f"new tokens/s end to end (prefill included); tokens equal to the "
          f"first call's: {out['repeat_equal']}")
    if strict and not out["repeat_equal"]:
        raise AssertionError(f"{label}: two generate calls gave different "
                             f"tokens")
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

        for part, step in (
                ("prefill", lambda: lm.prefill(params, cfg, pt, cache)),
                ("decode", lambda: lm.decode_step(
                    params, cfg, cache, gen_toks[:, -1:],
                    prompt_len + gen_len - 1))):
            prof = _profile_step(step, f"{label}-{part}",
                                 "flash_fwd_mma_kernel")
            out[f"{part}_busy"] = None if prof is None else prof["busy"]
            out[f"{part}_kernels"] = None if prof is None else prof["kernels"]
        del cache

        # the kernel against its plain version on the model's own q, k, v
        # at every layer of the prefill (each layer's input from the kernel
        # route)
        layer_errs = _layerwise_attention(params, cfg, pt)
        out["attention_rel_max"] = max(layer_errs)
        print(f"[{label}] each prefill layer's attention, kernel vs plain "
              f"on the same q, k, v: relative L2 max "
              f"{max(layer_errs)!r}, mean "
              f"{sum(layer_errs) / len(layer_errs)!r} over "
              f"{len(layer_errs)} layers (tolerance {ATTN_REL_TOL})")
        if not max(layer_errs) <= ATTN_REL_TOL:
            raise AssertionError(f"{label}: the flash kernel disagrees with "
                                 f"its plain version on the model's q, k, v")

        # the whole prefill through the plain attention; a MoE model's
        # routes pinned to the kernel prefill's
        kernel_ids, plain_ids = [], []
        with _recording_routes(kernel_ids):
            kernel_logits = _prefill_last(params, cfg, pt)

        def pinned():
            return (_pinned_routes(lambda i: kernel_ids[i]) if kernel_ids
                    else contextlib.nullcontext())
        if cfg.moe is not None:
            with _recording_routes(plain_ids):
                free = _prefill_last(params, cfg, pt, flash_attention_plain)
            out["routes_differ"] = _routes_differ(kernel_ids, plain_ids)
            out["kernel_vs_plain_rel_unpinned"] = _rel_err(kernel_logits,
                                                           free)
            print(f"[{label}] prefill through the plain attention with its "
                  f"own routing: {out['routes_differ']!r} of the (layer, "
                  f"token) top-{cfg.moe.top_k} sets differ from the kernel "
                  f"prefill's; last-position logits relative L2 "
                  f"{out['kernel_vs_plain_rel_unpinned']!r} (not gated: "
                  f"top-k routing is discontinuous)")
            del free
        with pinned():
            plain_logits = _prefill_last(params, cfg, pt,
                                         flash_attention_plain)
        # the model's own response to one bf16 rounding of its input: the
        # plain prefill again with the embedding table perturbed by 2^-8
        # relative noise, rounded to bf16
        with pinned():
            noisy_logits = _prefill_last(_noisy_embedding(params), cfg, pt,
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
              f"attention{'' if cfg.moe is None else ' (routes pinned)'}: "
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
            plain_toks = generate(params, cfg, prompts, gen_len, device=dev)
        agree = (plain_toks[:, prompt_len:] == gen_toks).float().mean()
        print(f"[{label}] greedy tokens through the plain attention equal to "
              f"the kernel path's: {agree.item()!r} of {n_new} (not gated: "
              f"random-weight bf16 logits tie)")

        # prefill + decode against forward on the same tokens
        ccfg = check_cfg or cfg
        cb = check_batch or batch
        errs = _decode_vs_forward(params, ccfg, toks[:cb], prompt_len)
        out["decode_vs_forward_rel"] = max(errs)
        how = ("" if ccfg is cfg else
               f" under a dropless copy of the config (capacity factor "
               f"{ccfg.moe.capacity_factor}), batch {cb}, routed by "
               f"forward's ids (the main run's capacity drops assignments "
               f"in prefill and forward but none in decode)")
        print(f"[{label}] prefill + decode logits vs forward over the "
              f"{prompt_len + gen_len} tokens{how}: relative L2 error max "
              f"{max(errs)!r}, mean {sum(errs) / len(errs)!r} over "
              f"{len(errs)} positions (tolerance {tol!r})")
        if not max(errs) <= tol:
            raise AssertionError(f"{label}: decode disagrees with forward")
    out["phase_peak_bytes"] = max(torch.cuda.max_memory_allocated(),
                                  out["materialize_peak_bytes"])
    out.update(flash=flash, rel=rel)
    del params
    torch.cuda.empty_cache()
    return out


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


def _flash_at(dev, card, model, b, h, hkv, s, d):
    """The bf16 flash kernel at one served prefill shape (causal): held
    against its plain version (1e-2), one tensor-core launch; then timed
    beside its bound, the plain version and
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
    got = flash_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    tc = flash_attention_kernel.tensor_core_launches - tc
    want = flash_attention_plain(q, k, v)
    err = (got.float() - want.float()).abs().max().item()
    tol = FLASH_TOL["bfloat16"]
    shape = f"B{b} H{h} Hkv{hkv} S{s} D{d} bf16 causal"
    ok = (tc == 1 and bool(torch.isfinite(got.float()).all())
          and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    print(f"[kernel] flash_attention {model} prefill {shape}: max_abs_err="
          f"{err!r} (rtol=atol={tol}); tensor-core launches {tc} "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at {model}'s prefill shape")
    del got, want
    fns = (lambda: flash_attention_kernel(q, k, v),
           lambda: flash_attention_plain(q, k, v),
           lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True))
    dev_ms = [_graph_ms(f, reps=3, replays=3) for f in fns]
    ms = [_time_ms(f, reps=5, warmup=2) for f in fns]
    pairs = visible_pairs(s) * b * h
    n_ops = 4 * d * pairs
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    t_ops, t_bytes = n_ops / BF16_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    entry = {"model": model, "shape": shape, "max_abs_err": err,
             "ms": ms[0], "plain_ms": ms[1], "library_ms": ms[2],
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
        if res["phase_peak_bytes"] >= total:
            raise AssertionError(f"{label}: peak {res['phase_peak_bytes']} "
                                 f"bytes, not below the card's {total}")
        res["card"] = card
        print(f"[families] {json.dumps(res)}")
        results.append(res)
    return results


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
    """Phase 11d: ``run_scenario`` at benchmarks/fault_replace.py's full
    configuration: S-VGG16 on hier 2x2:4x4, the busiest inter-chip link of
    the seeded deployment dropped at step 2, ``compare_cold=True``; once
    with the recorder (deploying itself) and once without (on the first
    deployment's plan). Both results must be identical, and every objective
    they record is the host evaluate's."""
    import numpy as np
    import torch
    from repro_torch.core import HierarchicalMesh
    from repro_torch.core.topology import degrade
    from repro_torch.deploy import as_objective, deploy_model, run_scenario
    from repro_torch.obs import Recorder
    from repro_torch.snn import spike_vgg16
    fr = FAULT_REPLACE
    hm = HierarchicalMesh(2, 2, 4, 4, **FULL_NOC)
    cfg = spike_vgg16(n_classes=10, in_res=32, T=4)
    t0 = time.perf_counter()
    plan = deploy_model(cfg, hm, method="simulated_annealing", seed=0,
                        budget=fr["deploy_budget"], schedule="none")
    deploy_s = time.perf_counter() - t0
    m = hm.evaluate(plan.graph, plan.placement.placement)
    loads = np.zeros(hm.n_links)
    for label, vol in m.link_traffic.items():
        loads[hm.link_id_of(label)] = vol
    lid = int(np.argmax(np.where(hm.interchip_mask(), loads, -1.0)))
    kw = dict(method="simulated_annealing", objective="comm_cost",
              budget=fr["budget"], deploy_budget=fr["deploy_budget"],
              migration_weight=fr["migration_weight"],
              warm_kw={"t0": fr["warm_t0"]}, seed=0,
              threshold=fr["threshold"], compare_cold=True,
              cold_budget=fr["deploy_budget"])
    scenario = f"steps=6;fault=link:{lid}@2"
    rec = Recorder()
    _reset_counts(kernels)
    t0 = time.perf_counter()
    on = run_scenario(cfg, hm, scenario, recorder=rec, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(kernels)
    off = run_scenario(cfg, hm, scenario, plan=plan, **kw)
    identical = on.to_dict() == off.to_dict()
    calls = rec.counters.get("noc_batch.dispatches", 0)
    print(f"[runtime] hier 2x2:4x4 S-VGG16, link {lid} dropped at step 2: "
          f"replacements {on.n_replacements}, cold fallbacks "
          f"{on.n_cold_fallbacks}, moved {on.moved_state_bytes / 1e6!r} MB, "
          f"max degradation {on.max_degradation!r}, final objective "
          f"{on.final_objective!r}; wall {wall!r} s (first deployment "
          f"{deploy_s!r} s); {calls} scorer calls = {calls / wall!r} a "
          f"second; launches {launches}")
    print("[runtime] recoveries " + json.dumps(on.recoveries))
    print(f"[runtime] result identical with the recorder on and off: "
          f"{identical}")
    if not identical:
        raise AssertionError("run_scenario differs with the recorder on and "
                             "off on the card")
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


def _bwd_case(dev, b, h, hkv, s, d, window, dtype, seed=0):
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=gen, device=dev) * 0.5
    k = torch.randn(b, hkv, s, d, generator=gen, device=dev) * 0.5
    v = torch.randn(b, hkv, s, d, generator=gen, device=dev)
    dout = torch.randn(b, h, s, d, generator=gen, device=dev)
    q, k, v, dout = (t.to(dtype) for t in (q, k, v, dout))
    lse = torch.empty(b, h, s, device=dev)
    out = flash_attention_kernel(q, k, v, window=window, lse=lse)
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


def _check_flash_backward(dev):
    """Phase 12a: the flash backward kernel against its plain version over
    the sweep, deterministic; the forward's lse against the plain
    version's; the forward's output bit-identical with and without lse.
    Returns the max error at the trained shape."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_backward_plain,
        flash_attention_kernel, flash_attention_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    sweep = [("trained internlm2 layer",) + TRAINED + (None, bf16),
             ("h2o-danube", 1, 32, 8, 4608, 80, 4096, bf16),
             ("smoke configs", 2, 4, 2, 128, 16, None, f32),
             ("smoke configs window 24", 2, 4, 2, 128, 16, 24, f32),
             ("odd S and D", 1, 4, 2, 77, 20, 5, f32),
             ("odd S and D", 1, 4, 2, 77, 20, 5, bf16),
             ("D=256", 1, 4, 2, 100, 256, 37, f32)]
    trained_err = None
    for name, b, h, hkv, s, d, window, dtype in sweep:
        args = _bwd_case(dev, b, h, hkv, s, d, window, dtype)
        got = flash_attention_backward_kernel(*args, window=window)
        again = flash_attention_backward_kernel(*args, window=window)
        torch.cuda.synchronize()
        want = flash_attention_backward_plain(*args, window=window)
        key = str(dtype).split(".")[1]
        err = _bwd_err(got, want, key)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
        ok = err <= BWD_TOL[key] and same and finite
        print(f"[kernel] flash_attention_backward {name} B{b} H{h} Hkv{hkv} "
              f"S{s} D{d} window {window} {dtype}: error {err!r} "
              f"({'relative L2' if key == 'bfloat16' else 'max abs over max'}"
              f", tolerance {BWD_TOL[key]}); a second run bit-identical: "
              f"{same} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"flash_attention_backward disagrees with "
                                 f"its plain version on {name}")
        if trained_err is None:
            trained_err = max((g.float() - w.float()).abs().max().item()
                              for g, w in zip(got, want))
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
    return trained_err


def _sdpa_backward_graph_ms(q, k, v, dout, reps: int, replays: int) -> float:
    """Device time of the backward of ``F.scaled_dot_product_attention(
    is_causal=True, enable_gqa=True)`` alone: its forward runs once on a side
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
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
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


def _time_flash_backward(dev, card, launches, err):
    """Phase 12a, ``flash_attention_backward`` row: one layer's attention
    backward at the trained shape (B2, H16, Hkv 8, S4096, D128, bf16,
    causal) through the kernel, its plain version and the backward of
    ``F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on
    the same tensors, timed alone."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_backward_plain,
        visible_pairs)
    b, h, hkv, s, d = TRAINED
    q, k, v, out, dout, lse = _bwd_case(dev, b, h, hkv, s, d, None,
                                        torch.bfloat16, seed=1)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
    fns = (lambda: flash_attention_backward_kernel(q, k, v, out, dout, lse),
           lambda: flash_attention_backward_plain(q, k, v, out, dout, lse),
           lambda: torch.autograd.grad(lib_out, leaves, dout,
                                       retain_graph=True))
    lib_err = max(_rel_err(a, b_) for a, b_ in zip(fns[2](), fns[1]()))
    ms = [_time_ms(fns[0], reps=10, warmup=2),
          _time_ms(fns[1], reps=3, warmup=1),
          _time_ms(fns[2], reps=10, warmup=2)]
    # device time from graph replay; the library's backward is captured
    # alone, on the stream its forward ran on (see _sdpa_backward_graph_ms)
    dev_ms = [_graph_ms(fns[0], reps=5, replays=3),
              _graph_ms(fns[1], reps=1, replays=2),
              _sdpa_backward_graph_ms(q, k, v, dout, reps=5, replays=3)]
    pairs = visible_pairs(s) * b * h
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
        "calls": "one layer's attention backward of internlm2-1.8b training "
                 "(B2, H16, Hkv8, S4096, D128, bf16, causal): the delta "
                 "pre-pass, dQ and dK/dV kernels",
    }
    row["achieved_tflops"] = n_ops / dev_ms[0] / 1e9
    row["vs_library"] = dev_ms[0] / dev_ms[2]
    print(f"[time] flash_attention_backward B{b} H{h} Hkv{hkv} S{s} D{d} bf16 "
          f"causal: kernel {ms[0]!r} ms, plain {ms[1]!r} ms, SDPA backward "
          f"{ms[2]!r} ms (per call); device (graph) kernel {dev_ms[0]!r}, "
          f"plain {dev_ms[1]!r}, SDPA backward {dev_ms[2]!r} ms; kernel "
          f"device time {row['vs_library']!r}x SDPA backward's; bound "
          f"{row['bound_ms']!r} ms ({n_ops} flops over {pairs} visible pairs "
          f"at {BF16_OPS_PER_S:.3g} flop/s; {n_bytes} bytes); kernel "
          f"{row['achieved_tflops']!r} TFLOP/s; SDPA vs plain relative L2 "
          f"{lib_err!r}; card {card}")
    return row


@contextlib.contextmanager
def _recorded_train_steps(rec, profile_at=None):
    """Within the scope, every step ``launch.train.main`` takes is
    synchronised and recorded in ``rec``: wall, loss, ce, and the flash
    forward / backward launches it made; step ``profile_at`` runs under
    torch.profiler (its wall is recorded apart)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_kernel, flash_attention_kernel)
    from repro_torch.launch import train
    real = train.make_train_step

    def make(loss_fn, tcfg):
        step = real(loss_fn, tcfg)

        def recorded(*args):
            torch.cuda.synchronize()
            before = (flash_attention_kernel.launches,
                      flash_attention_backward_kernel.launches)
            t0 = time.perf_counter()
            if len(rec) == profile_at:
                box = []
                prof = _profile_step(lambda: box.append(step(*args)),
                                     "train-lm", "flash_bwd")
                out = box[0]
            else:
                out, prof = step(*args), None
            torch.cuda.synchronize()
            rec.append({
                "wall": time.perf_counter() - t0, "profiled": prof,
                "loss": float(out[2]["loss"]), "ce": float(out[2]["ce"]),
                "fwd": flash_attention_kernel.launches - before[0],
                "bwd": flash_attention_backward_kernel.launches - before[1]})
            return out
        return recorded

    train.make_train_step = make
    try:
        yield rec
    finally:
        train.make_train_step = real


def _train_lm_path(dev, kernels):
    """Phase 12b: ``python -m repro_torch.launch.train`` at internlm2-1.8b's
    full width and depth, 6 steps of 2 x 4096 tokens (the last profiled),
    then 2 steps with int8 error-feedback gradient compression. Returns the
    flash backward launches of the main run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.models.specs import n_params
    cfg = get_config(TRAIN["arch"])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    argv = ["--arch", TRAIN["arch"], "--steps", str(TRAIN["steps"]),
            "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"])]
    print(f"[train-lm] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_head "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, remat "
          f"{cfg.remat}, logit_chunk {cfg.logit_chunk}; "
          f"{n_params(lm.lm_specs(cfg))} parameters; main({argv})")
    rec = []
    _reset_counts(kernels)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _recorded_train_steps(rec, profile_at=TRAIN["steps"] - 1):
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
        print(f"[train-lm] step {i}: loss {r['loss']!r}, ce {r['ce']!r}, "
              f"wall {r['wall']!r} s (synchronised"
              f"{', under the profiler' if r['profiled'] else ''}), "
              f"{tokens / r['wall']!r} tokens/s; flash forward launches "
              f"{r['fwd']}, backward {r['bwd']}")
    mean = statistics.fmean(steady)
    print(f"[train-lm] main() wall {wall!r} s (weights drawn, first step's "
          f"warm-up included); steps 1-{len(rec) - 2}: mean step wall "
          f"{mean!r} s, {tokens / mean!r} tokens/s, median "
          f"{statistics.median(steady)!r} s; peak device memory {peak} "
          f"bytes; launches {launches}")
    want_fwd, want_bwd = 2 * cfg.n_layers, cfg.n_layers   # remat="full"
    if (len(rec) != TRAIN["steps"]
            or any(r["fwd"] != want_fwd or r["bwd"] != want_bwd for r in rec)
            or launches["flash_attention_kernel.tensor_core"]
            != want_fwd * TRAIN["steps"]):
        raise AssertionError(f"train-lm: flash launches a step "
                             f"{[(r['fwd'], r['bwd']) for r in rec]}, not "
                             f"{want_fwd} forward (all on the tensor cores) "
                             f"and {want_bwd} backward")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train-lm: losses {losses} not finite or not "
                             "falling")
    print(f"[train-lm] losses finite, step {len(losses) - 1} below step 0; "
          f"{want_fwd} forward flash launches (all on the tensor cores) and "
          f"{want_bwd} backward calls a step ok")

    rec_ef = []
    torch.cuda.reset_peak_memory_stats()
    with _recorded_train_steps(rec_ef):
        params = train.main(argv[:2] + ["--steps", "2"] + argv[4:]
                            + ["--grad-compression", "int8_ef"])
    peak_ef = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    ef = [r["loss"] for r in rec_ef]
    print(f"[train-lm] --grad-compression int8_ef, 2 steps: losses {ef}, "
          f"walls {[r['wall'] for r in rec_ef]} s; peak device memory "
          f"{peak_ef} bytes")
    if len(ef) != 2 or not all(math.isfinite(v) for v in ef):
        raise AssertionError(f"train-lm int8_ef: losses {ef}")
    return launches["flash_attention_backward_kernel"]


def _train_kernel_vs_plain(dev):
    """Phase 12c: one step's loss and gradients of internlm2-1.8b at full
    width, depth cut 24 -> 2, bf16, 2 x 4096 tokens: the kernel route
    against the plain Function (the plain forward and backward swapped in).
    Every gradient leaf within relative L2 ``LOGITS_REL_TOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_plain, flash_attention_plain)
    from repro_torch.models import lm
    from repro_torch.models.lm import Segment
    from repro_torch.models.specs import materialize, tree_leaves
    cfg = dataclasses.replace(get_config(TRAIN["arch"]),
                              segments=(Segment("attn", "dense", 2),))
    params = materialize(lm.lm_specs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    leaves = [t.requires_grad_() for _, t in tree_leaves(params)]
    toks, labels = batch_for_step(DataConfig(vocab=cfg.vocab,
                                             batch=TRAIN["batch"],
                                             seq_len=TRAIN["seq"]), 0)
    toks = torch.as_tensor(toks, device=dev).long()
    labels = torch.as_tensor(labels, device=dev).long()

    def grads():
        loss, _ = lm.lm_loss(params, cfg, toks, labels)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    kernel = grads()
    with _attention_route(flash_attention_plain,
                          flash_attention_backward_plain):
        plain = grads()
    torch.cuda.synchronize()
    errs = {"/".join(p): _rel_err(a, b)
            for (p, _), a, b in zip(tree_leaves(params), kernel[1], plain[1])}
    worst = max(errs, key=errs.get)
    print(f"[train-lm-route] {cfg.name} depth 2, one step at "
          f"{TRAIN['batch']} x {TRAIN['seq']}: loss kernel route "
          f"{kernel[0].item()!r}, plain route {plain[0].item()!r}; gradient "
          f"relative L2 error: worst {worst} {errs[worst]!r}, all {errs} "
          f"(tolerance {LOGITS_REL_TOL})")
    if not (errs[worst] <= LOGITS_REL_TOL
            and abs(kernel[0].item() - plain[0].item())
            <= LOGITS_REL_TOL * abs(plain[0].item())):
        raise AssertionError("train-lm-route: the kernel route's gradients "
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


def _train_restart_in_child():
    """Phase 12d in a child process: cuBLAS reads its workspace setting once,
    at its first call, and deterministic algorithms need ``:4096:8``; the
    child gets it, so the earlier phases run under the default setting."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(root / "chip_smoke.py"),
                          "--train-restart"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    print(out.stdout, end="")
    if out.returncode != 0:
        raise AssertionError(f"train-restart: the child exited "
                             f"{out.returncode}:\n{out.stderr[-3000:]}")
    print(f"[train-restart] child process: exit 0 in "
          f"{time.perf_counter() - t0!r} s")


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
               fa_mod.flash_attention_backward_kernel)

    # ---- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    names = [KERNEL, delta_mod.KERNEL, lif_mod.KERNEL, mm_mod.KERNEL,
             fa_mod.KERNEL]
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
    flash_bwd_err = _check_flash_backward(dev)
    bwd_launches = _train_lm_path(dev, kernels)
    rows.append(_time_flash_backward(dev, card, bwd_launches, flash_bwd_err))
    torch.cuda.reset_peak_memory_stats()
    _train_kernel_vs_plain(dev)
    _train_restart_in_child()
    print(f"[train-lm] phase 12 in {time.perf_counter() - t0!r} s")

    # ---- phase 13: the MLA and MoE families served at full width ---------------
    t0 = time.perf_counter()
    _serve_families(dev, card, kernels, flash_row)
    print(f"[families] phase 13 in {time.perf_counter() - t0!r} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
