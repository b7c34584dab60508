#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each of which fails the run loudly:

1. print the card's name and power limit and the torch/CUDA versions; build
   every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, started together) and print ptxas' register/shared-memory report;
2. hold each kernel against its plain PyTorch version on the card:
   ``link_traffic`` at the reference kernel-test shapes, the PPO rollout
   shape of the main path, a 16x16 torus and a hierarchical mesh — exactly
   on integer weights (partial sums below 2^24), within rtol=1e-5, atol=1e-3
   on float weights; ``delta_cost`` at the reference kernel-test shape, the
   SA path's shape, all-padding rows, R=K=1, a 16x16 torus and a 32x32 mesh
   — exactly on integer volumes, and on the graph's own volumes within 1e-5
   of each chain's sum of absolute terms;
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
7. time each kernel at its path's shapes beside its bound, its plain version
   and one PyTorch library call where one exists: ``ms``, ``plain_ms`` and
   ``library_ms`` are the per-call time of back-to-back eager calls under
   CUDA events, host overhead included (the definition of every slice);
   ``device_ms``, ``plain_device_ms`` and ``library_device_ms`` are device
   time from CUDA events around replays of a CUDA graph of 100 calls.

Every path starts with all launch counts set to 0 and reads them just after.
Prints a ``{"kernels": [...]}`` JSON line and, last, ``{"ok": true,
"device": {...}}``. Exits non-zero without a result when CUDA is absent.
"""
from __future__ import annotations

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


def _counts(kernels) -> dict:
    return {fn.__name__: fn.launches for fn in kernels}


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
    from repro_torch.kernels.delta_cost import delta_cost, delta_cost_plain
    from repro_torch.kernels.noc_segsum import (KERNEL, link_traffic,
                                                link_traffic_plain)
    from repro_torch.obs import Recorder
    from repro_torch.snn import profile_model, spike_vgg16

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)}")
    kernels = (link_traffic, delta_cost)

    # ---- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    names = [KERNEL, delta_mod.KERNEL]
    _build.build(names)
    print(f"[build] {', '.join(names)} (in parallel): "
          f"{time.perf_counter() - t0:.2f} s")
    for name in names:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "bytes stack" in line:
                print(f"[build] {name}: {line.strip()}")

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

    # ---- phase 7: timing ---------------------------------------------------------
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
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
