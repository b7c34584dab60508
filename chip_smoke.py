#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

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
   of each chain's sum of absolute terms; ``lif`` bit for bit at every LIF
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
3. hold ``evaluate_batch(backend="cuda")`` against the numpy float64 backend
   on the main path's graph for 256 random placements, and the device SA's
   ``_swap_delta`` (through ``delta_cost``) against the numpy
   ``delta_comm_cost`` along a 200-swap stream on the same graph;
4. drive the PPO path: ``deploy_model(spike_vgg16(), NoC(8, 8, ...),
   method="ppo", objective="latency")`` with its defaults (``device="cuda"``,
   ``backend="cuda"``, 40 PPO iterations at batch 256); check the plan;
5. drive the device SA path: the same ``deploy_model`` with ``method="sa",
   backend="device", restarts=64`` (5000 steps); check the plan against the
   host evaluate and against ``restarts=1``; profile 500 steps of the loop;
6. drive the device GA (``method="ga", backend="device"``, pop 64, 99
   generations), the multilevel V-cycle on a 1024-node layered DAG over a
   32x32 mesh with a device SA coarse level, and one short run of each host
   search on the card;
7. drive BPTT training at full width: ``snn.bptt.train_step`` of
   ``spike_vgg16()`` (T=4) at batch 8, 5 steps from one set of seeded
   weights (52 LIF launches a step), and of ``spike_resnet18()`` (68 a step),
   3 steps; loss, wall and launches per step and one profiled step each;
   then each first step again through the LIF kernel and through its plain
   version with deterministic cuDNN: loss, logits, spikes and gradients
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
   ``lif`` and ``spike_matmul`` rows sum one Spike-VGG16 timestep's calls
   (13 LIF states; 12 spiking-conv products with the path's own spikes).
   The ``flash_attention`` row is one layer's attention of the served
   prefill, against ``F.scaled_dot_product_attention``, measured after
   phase 10 (10 calls to a graph). Both rows add the achieved rate
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
    against ``forward`` on the same tokens (the same tolerance).

Every path starts with all launch counts set to 0 (the flash kernel's
tensor-core count too) and reads them just after.
Prints a ``{"kernels": [...]}`` JSON line and, last, ``{"ok": true,
"device": {...}}``. Exits non-zero without a result when CUDA is absent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
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


def _check_delta_stream(dev, graph, noc, rng, n_swaps: int = 200):
    """Phase 3, second half: the device SA's ``_swap_delta`` through the
    kernel along a swap stream, against the numpy ``delta_comm_cost``."""
    import torch
    from repro_torch.core.noc_batch import (batched_noc,
                                            build_incident_tables,
                                            delta_comm_cost)
    from repro_torch.core.placement.device_search import _swap_delta
    from repro_torch.kernels.delta_cost import delta_cost

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
        got = _swap_delta(
            torch.as_tensor(slots[None], dtype=torch.int32, device=dev),
            torch.tensor([i], device=dev), torch.tensor([j], device=dev),
            hops_d, *tabs, graph.n, use_pallas=True).item()
        want = delta_comm_cost(noc, graph, slots, i, j, inc)
        a, b = min(i, graph.n), min(j, graph.n)
        scale = float((inc.vol[a].sum() + inc.vol[b].sum()) * hops.max())
        worst = max(worst, abs(got - want) / max(scale, 1.0))
        if abs(got - want) > 1e-5 * scale + 1e-6:
            raise AssertionError(f"_swap_delta {got!r} != delta_comm_cost "
                                 f"{want!r} on swap ({i}, {j})")
        slots[i], slots[j] = slots[j], slots[i]
    if delta_cost.launches - before != n_swaps:
        raise AssertionError("the swap stream did not launch delta_cost "
                             "once per swap")
    print(f"[delta] _swap_delta (cuda, delta_cost) vs delta_comm_cost "
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
    launch). Returns the kernels that spill."""
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
    spills = []
    for e, fn in zip(entries, names):
        st, ld = e.get("spill", (0, 0))
        short = re.sub(r"\(.*\)$", "", fn.replace("(anonymous namespace)::",
                                                  ""))
        print(f"[build] {name}: {short}: {e.get('regs')} registers, "
              f"{e.get('smem', 0)} bytes static smem, spill stores {st} "
              f"bytes, spill loads {ld} bytes")
        if st or ld:
            spills.append(f"{short} ({st}/{ld} bytes)")
    return spills


def _sa_path(vgg, noc, kernels):
    """Phase 5: ``deploy_model`` through the device SA at restarts=64 and 1,
    and a profile of the SA loop. Returns (launches, wall, plan)."""
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
    if launches["delta_cost"] != iters:
        raise AssertionError(f"SA path launched delta_cost "
                             f"{launches['delta_cost']} times, not {iters}")
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
    _profile_sa_loop(plan.graph, noc, steps=500)
    return launches["delta_cost"], wall, plan


def _profile_sa_loop(graph, noc, steps: int):
    """torch.profiler over ``steps`` SA steps at restarts=64: device kernel
    time against the host-clock wall, kernel launches per step, and the
    kernels and host operators that dominate."""
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
        device_search.simulated_annealing_device(graph, noc, iters=steps,
                                                 restarts=64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us == 0.0:
        print(f"[sa-profile] {steps} steps: wall {wall!r} s; device time "
              "not measured (the profiler recorded no device events)")
        return
    n_kernels = sum(e.count for e in kernels)
    delta_us = sum(e.self_device_time_total for e in kernels
                   if "delta_cost" in e.key)
    print(f"[sa-profile] {steps} steps at restarts=64 (whole call, set-up "
          f"included): wall {wall!r} s = {wall / steps * 1e6!r} us per "
          f"step; device kernel time {dev_us / 1e6!r} s (busy share "
          f"{dev_us / 1e6 / wall!r}); {n_kernels} kernels = "
          f"{n_kernels / steps!r} per step; delta_cost "
          f"{delta_us / steps!r} us per step")
    for e in sorted(kernels, key=lambda e: -e.count)[:10]:
        print(f"[sa-profile] kernel {e.count / steps:.2f}/step "
              f"{e.self_device_time_total / steps:.3f} us/step "
              f"{e.key[:90]}")
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"[sa-profile] host op {e.count / steps:.2f}/step "
              f"{e.self_cpu_time_total / steps:.2f} us/step self CPU "
              f"{e.key}")


def _other_paths(vgg, noc, graph, kernels):
    """Phase 6: device GA, multilevel on a 1024-node DAG, host searches."""
    import numpy as np
    import torch
    from repro_torch.core import LogicalGraph, NoC
    from repro_torch.core.graph import layered_dag
    from repro_torch.core.noc_batch import validate_placements
    from repro_torch.core.placement import optimize_placement, zigzag
    from repro_torch.deploy import deploy_model

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
    _reset_counts(kernels)
    t0 = time.perf_counter()
    ml = optimize_placement(big, mesh, method="multilevel", backend="device",
                            coarsen_to=64, refine_iters=3, iters=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(kernels)
    validate_placements(mesh, ml.placement, big.n)
    if launches["delta_cost"] != 2000:
        raise AssertionError(f"multilevel launched delta_cost "
                             f"{launches['delta_cost']} times, not 2000")
    print(f"[ml] multilevel (device SA coarse level) on {big.n} nodes over "
          f"32x32: comm cost {float(ml.comm_cost)!r}; wall {wall!r} s; launches "
          f"{launches} ok")

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
def _recording(forward):
    """Within the scope, ``snn.neurons.lif_step`` runs ``forward`` (the
    kernel or its plain version) and every spike tensor it returns is
    recorded, as are the logits of ``snn.bptt.loss_fn``'s rollout."""
    from repro_torch.snn import bptt, neurons
    rec = {"spikes": [], "logits": []}
    real_forward, real_rollout = neurons._lif_forward, bptt.model_rollout

    def lif(*args, **kw):
        u, s = forward(*args, **kw)
        rec["spikes"].append(s)
        return u, s

    def rollout(*args, **kw):
        logits, rate = real_rollout(*args, **kw)
        rec["logits"].append(logits.detach())
        return logits, rate

    neurons._lif_forward, bptt.model_rollout = lif, rollout
    try:
        yield rec
    finally:
        neurons._lif_forward, bptt.model_rollout = real_forward, real_rollout


def _profile_step(step, label: str, kernel: str = "lif_kernel"):
    """torch.profiler over one call of ``step``: wall, device kernel time,
    busy share, kernel count and the share of the kernels whose name holds
    ``kernel``."""
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
    return dev_us / 1e6 / wall


def _train_path(cfg, label, steps, dev, kernels, lifs_per_step):
    """Phase 8: ``train_step`` at full width, batch 8, ``steps`` times from
    one set of weights; loss, wall and LIF launches per step; one profiled
    step. Returns the LIF launches of the run."""
    import torch
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
    if launches["lif_step_kernel"] != want:
        raise AssertionError(f"{label}: {launches['lif_step_kernel']} LIF "
                             f"launches, not {want}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{label}: loss is not finite: {losses}")
    print(f"[{label}] lif launches per step "
          f"{launches['lif_step_kernel'] // steps} = {lifs_per_step} LIFs x "
          f"T={cfg.T} ok")
    _profile_step(lambda: train_step(net, opt, x, y, cfg), label)
    return launches["lif_step_kernel"]


def _kernel_vs_plain_step(cfg, label, dev):
    """The first training step through the LIF kernel and through its plain
    version on the card, same weights and batch, deterministic cuDNN: loss,
    logits, every spike tensor and every gradient. Returns the names of the
    gradients that differ."""
    import torch
    from repro_torch.kernels.lif import lif_step_kernel, lif_step_plain
    from repro_torch.snn.bptt import loss_and_grads
    from repro_torch.snn.models import init_model
    net = init_model(cfg, torch.Generator().manual_seed(0), device=dev)
    x, y = _batch(cfg, 0, dev)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        runs = []
        for forward in (lif_step_kernel, lif_step_plain):
            with _recording(forward) as rec:
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
    print(f"[{label}] kernel path vs plain path, first step, deterministic "
          f"cuDNN: loss {l_k.item()!r} and logits bit-identical, "
          f"{len(sp_k)} spike tensors bit-identical; gradients "
          f"bit-identical for {len(names) - len(differ)} of {len(names)} "
          f"parameters")
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
                      mm_launches, mm_err):
    """Phase 7, SNN rows: one timestep's worth of each kernel on the
    Spike-VGG16 path, summed over its calls (13 LIF states; 12 spiking-conv
    im2col products with the path's own spikes and weights)."""
    import numpy as np
    import torch
    from repro_torch.kernels.lif import lif_step_kernel, lif_step_plain
    from repro_torch.kernels.ops import im2col
    from repro_torch.kernels.spike_matmul import (spike_matmul_kernel,
                                                  spike_matmul_plain)
    tot = dict(ms=0.0, plain=0.0, dev=0.0, plain_dev=0.0, bytes=0, ops=0)
    for shape in _lif_state_shapes(vgg):
        n = math.prod(shape)
        # enough input sets to exceed the 50 MB L2 cache, used in turn, so
        # every call reads its inputs from device memory, as the training
        # step's u and s (written a timestep earlier) are
        sets = [[torch.as_tensor(a.astype(np.float32), device=dev)
                 .reshape(shape)
                 for a in (rng.standard_normal(n), rng.random(n) < 0.2,
                           rng.standard_normal(n))]
                for _ in range(max(2, -(-64_000_000 // (12 * n))))]
        turn = itertools.cycle(sets)
        fns = (lambda: lif_step_kernel(*next(turn)),
               lambda: lif_step_plain(*next(turn)))
        d_k, d_p = (_graph_ms(f) for f in fns)
        m_k, m_p = (_time_ms(f) for f in fns)
        tot["ms"] += m_k
        tot["plain"] += m_p
        tot["dev"] += d_k
        tot["plain_dev"] += d_p
        tot["bytes"] += 5 * 4 * n          # read u, s, I; write u', s'
        tot["ops"] += 5 * n                # 2 mul, 1 sub, 1 add, 1 compare
        print(f"[time] lif {shape}: kernel {m_k!r} ms, plain {m_p!r} ms (per "
              f"call); device {d_k!r}, {d_p!r} ms; bytes bound "
              f"{20 * n / HBM_BYTES_PER_S * 1e3!r} ms")
    tb, to = tot["bytes"] / HBM_BYTES_PER_S, tot["ops"] / FP32_OPS_PER_S
    lif_row = {
        "name": "lif", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lif.cu",
        "replaces": "src/repro/kernels/lif.py:38",
        "launches": lif_launches, "max_abs_err": 0.0,
        "ms": tot["ms"], "plain_ms": tot["plain"],
        "bound_ms": max(tb, to) * 1e3,
        "bound_by": "bytes" if tb >= to else "operations",
        "library_ms": None, "device_ms": tot["dev"],
        "plain_device_ms": tot["plain_dev"], "library_device_ms": None,
        "calls": "sum over the 13 LIF states of one Spike-VGG16 timestep",
    }
    print(f"[time] lif, one VGG16 timestep (13 calls): kernel {tot['ms']!r} "
          f"ms, plain {tot['plain']!r} ms; device {tot['dev']!r}, "
          f"{tot['plain_dev']!r} ms; bound {lif_row['bound_ms']!r} ms "
          f"({tot['bytes']} bytes, {tot['ops']} flops); no single PyTorch "
          f"call computes this function (library_ms null); card {card}")

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
    return [lif_row, mm_row]


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
def _attention_route(fn):
    """Within the scope, the model's causal self-attention on the card runs
    ``fn`` (the kernel or its plain version)."""
    from repro_torch.models import layers
    real = layers._flash_forward
    layers._flash_forward = fn
    try:
        yield
    finally:
        layers._flash_forward = real


def _rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


def _serve_path(cfg, label, batch, prompt_len, gen_len, dev, kernels):
    """Phase 10: serve ``cfg`` at full width through ``launch.serve.generate``
    (seeded bf16 weights, greedy), with the flash kernel's launches; time to
    first token and decode per token from the pieces ``generate`` runs;
    one profiled prefill and decode step; prefill through the plain version
    of the attention against the kernel's; decode against ``forward``.
    Returns (flash launches of the main run, kernel-vs-plain rel. error)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.models.specs import materialize, n_params, param_bytes
    specs = lm.lm_specs(cfg)
    t0 = time.perf_counter()
    params = materialize(specs, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    torch.cuda.synchronize()
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}, kv heads {cfg.n_kv_heads}, "
          f"d_head {cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
          f"{cfg.window}; {n_params(specs)} parameters, {param_bytes(specs)} "
          f"bytes ({cfg.param_dtype}), drawn on the card in "
          f"{time.perf_counter() - t0!r} s")
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
    print(f"[{label}] generate batch {batch}, prompt {prompt_len}, {gen_len} "
          f"greedy tokens: wall {wall_first!r} s (first call); peak device "
          f"memory {torch.cuda.max_memory_allocated()} bytes; launches "
          f"{launches}")
    if flash != cfg.n_layers or tensor_core != cfg.n_layers:
        raise AssertionError(f"{label}: {flash} flash launches, "
                             f"{tensor_core} on the tensor cores, not one "
                             f"per layer of the prefill ({cfg.n_layers})")
    if (tuple(toks.shape) != (batch, prompt_len + gen_len)
            or not torch.equal(toks[:, :prompt_len].cpu(),
                               torch.as_tensor(prompts))
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab):
        raise AssertionError(f"{label}: generate returned bad tokens")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks2 = generate(params, cfg, prompts, gen_len, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[{label}] generate again: wall {wall!r} s, {n_new / wall!r} "
          f"new tokens/s end to end (prefill included); tokens equal to the "
          f"first call's: {torch.equal(toks, toks2)}")

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
        seen = [logits[:, -1].clone()]
        steps = []
        for i in range(gen_len):
            t0 = time.perf_counter()
            logits, cache = lm.decode_step(params, cfg, cache,
                                           gen_toks[:, i:i + 1],
                                           prompt_len + i)
            torch.argmax(logits[:, -1], dim=-1)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            seen.append(logits[:, -1].clone())
        step_s = sum(steps[1:]) / max(len(steps) - 1, 1)
        print(f"[{label}] time to first token (prefill of {batch} x "
              f"{prompt_len} and the argmax) {ttft!r} s; decode "
              f"{step_s * 1e3!r} ms per token step (mean after the first; "
              f"first {steps[0] * 1e3!r} ms), {batch / step_s!r} tokens/s "
              f"at batch {batch}; first token equal to generate's: "
              f"{torch.equal(first, gen_toks[:, 0])}")

        _profile_step(lambda: lm.prefill(params, cfg, pt, cache),
                      f"{label}-prefill", "flash_fwd_mma_kernel")
        _profile_step(lambda: lm.decode_step(params, cfg, cache,
                                             gen_toks[:, -1:],
                                             prompt_len + gen_len - 1),
                      f"{label}-decode", "flash_fwd_mma_kernel")

        # the same prefill with the attention's plain version
        with _attention_route(flash_attention_plain):
            plain_cache = materialize(
                lm.cache_specs(cfg, batch, prompt_len + gen_len), device=dev)
            plain_logits, _ = lm.prefill(params, cfg, pt, plain_cache)
            torch.cuda.synchronize()
        kernel_logits = seen[0]
        rel = _rel_err(kernel_logits, plain_logits[:, -1])
        mx = (kernel_logits.float() - plain_logits[:, -1].float()).abs().max()
        same_tok = torch.equal(kernel_logits.argmax(-1),
                               plain_logits[:, -1].argmax(-1))
        print(f"[{label}] prefill last-position logits, kernel vs plain "
              f"attention: relative L2 error {rel!r} (tolerance "
              f"{LOGITS_REL_TOL}), max abs {mx.item()!r} (logits up to "
              f"{plain_logits.float().abs().max().item()!r}); greedy first "
              f"token equal: {same_tok}")
        if not rel <= LOGITS_REL_TOL:
            raise AssertionError(f"{label}: kernel and plain prefill logits "
                                 f"differ by {rel!r}")
        with _attention_route(flash_attention_plain):
            plain_toks = generate(params, cfg, prompts, gen_len, device=dev)
        agree = (plain_toks[:, prompt_len:] == gen_toks).float().mean()
        print(f"[{label}] greedy tokens through the plain attention equal to "
              f"the kernel path's: {agree.item()!r} of {n_new} (not gated: "
              f"random-weight bf16 logits tie)")

        # decode against forward on the same tokens
        full, _ = lm.forward(params, cfg, toks)
        torch.cuda.synchronize()
        errs = [_rel_err(got, full[:, prompt_len - 1 + i])
                for i, got in enumerate(seen)]
        print(f"[{label}] prefill + decode logits vs forward over the "
              f"{prompt_len + gen_len} tokens: relative L2 error max "
              f"{max(errs)!r}, mean {sum(errs) / len(errs)!r} over "
              f"{len(errs)} positions (tolerance {LOGITS_REL_TOL})")
        if not max(errs) <= LOGITS_REL_TOL:
            raise AssertionError(f"{label}: decode disagrees with forward")
        if not all(bool(torch.isfinite(t.float()).all()) for t in seen):
            raise AssertionError(f"{label}: logits are not finite")
    del params, cache, plain_cache, full
    torch.cuda.empty_cache()
    return flash, rel


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
        "plain_device_ms": dev_ms[1], "library_device_ms": dev_ms[2],
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
    return row


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs one CUDA card", file=sys.stderr)
        return 1
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
                                                link_traffic_plain)
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
    kernels = (link_traffic, delta_cost, lif_mod.lif_step_kernel,
               mm_mod.spike_matmul_kernel, fa_mod.flash_attention_kernel)

    # ---- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    names = [KERNEL, delta_mod.KERNEL, lif_mod.KERNEL, mm_mod.KERNEL,
             fa_mod.KERNEL]
    _build.build(names)
    print(f"[build] {', '.join(names)} (in parallel): "
          f"{time.perf_counter() - t0:.2f} s")
    spills = []
    for name in names:
        spills += _ptxas_report(name, _build.build_log(name))
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
    delta_err = _check_delta_cost(dev, graph, noc, rng)
    resnet = spike_resnet18()
    _check_lif(dev, rng, vgg, resnet)
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
    if len(res.history) != 40 or launches["link_traffic"] <= 0:
        raise AssertionError(f"main path ran {len(res.history)} iterations "
                             f"and {launches} kernel launches")
    print(f"[deploy] best latency {best!r} s (cuda) vs host evaluate "
          f"{host!r} s ok")

    ppo_launches = launches["link_traffic"]

    # ---- phase 5: the device SA path ---------------------------------------------
    sa_launches, _, sa_plan = _sa_path(vgg, noc, kernels)

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
        "launches": ppo_launches, "max_abs_err": main_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "device_ms": dev_ms[0],
        "plain_device_ms": dev_ms[1], "library_device_ms": dev_ms[2],
    }]
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
        # the device SA's own call: the same launch without the checks
        d_unchecked = _time_ms(lambda: delta_mod._delta_cost_unchecked(*args))
        d_bytes = 5 * R * K * 4 + C * C * 4 + R * 4
        d_ops = 3 * R * K          # subtract, multiply, add per entry
        tb, to = d_bytes / HBM_BYTES_PER_S, d_ops / FP32_OPS_PER_S
        delta_times[label] = (d_ms, d_plain, max(tb, to) * 1e3,
                              "bytes" if tb >= to else "operations", d_dev)
        print(f"[time] delta_cost {label} ({R}, {K}, {C}): kernel {d_ms!r} "
              f"ms, plain {d_plain!r} ms, unchecked launcher "
              f"{d_unchecked!r} ms (per call); device {d_dev[0]!r}, "
              f"{d_dev[1]!r} ms; bound "
              f"{delta_times[label][2]!r} ms ({d_bytes} bytes, {d_ops} "
              f"flops); no single PyTorch call computes this function "
              f"(library_ms null); card {card}")
    d_ms, d_plain, d_bound, d_by, d_dev = delta_times["SA path"]
    rows.append({
        "name": "delta_cost", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/delta_cost.cu",
        "replaces": "src/repro/kernels/delta_cost.py:67",
        "launches": sa_launches, "max_abs_err": delta_err,
        "ms": d_ms, "plain_ms": d_plain, "bound_ms": d_bound,
        "bound_by": d_by, "library_ms": None, "device_ms": d_dev[0],
        "plain_device_ms": d_dev[1], "library_device_ms": None,
    })
    rows += _time_snn_kernels(dev, rng, vgg, first_convs, card, lif_launches,
                              mm_launches, mm_err)

    # ---- phase 10: the LM token server at full width ---------------------------
    from repro_torch.configs import get_config
    from repro_torch.models.lm import Segment
    flash_launches, _ = _serve_path(get_config("internlm2-1.8b"), "serve",
                                    SERVED["batch"], SERVED["prompt_len"],
                                    SERVED["gen_len"], dev, kernels)
    danube = get_config("h2o-danube-1.8b")
    danube = dataclasses.replace(danube, segments=(
        Segment("attn", "dense", DANUBE["layers"]),))
    _serve_path(danube, "serve-danube", DANUBE["batch"],
                DANUBE["prompt_len"], DANUBE["gen_len"], dev, kernels)
    rows.append(_time_flash(dev, card, flash_launches, flash_err))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
