#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each of which fails the run loudly:

1. print the card's name and power limit and the torch/CUDA versions; build
   every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, started together) and print ptxas' register/shared-memory report;
2. hold each kernel against its plain PyTorch version on the card: the
   reference kernel-test shapes, the PPO rollout shape of the main path, a
   16x16 torus and a hierarchical mesh — exactly on integer weights (partial
   sums below 2^24), within rtol=1e-5, atol=1e-3 on float weights;
3. hold ``evaluate_batch(backend="cuda")`` against the numpy float64 backend
   on the main path's graph for 256 random placements;
4. drive the main path: ``deploy_model(spike_vgg16(), NoC(8, 8, ...),
   method="ppo", objective="latency")`` with its defaults (``device="cuda"``,
   ``backend="cuda"``, 40 PPO iterations at batch 256), with every launch
   count set to 0 just before and read just after; check the plan;
5. time each kernel with CUDA events at the main path's shape beside its
   bound, its plain version and one PyTorch library call.

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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs one CUDA card", file=sys.stderr)
        return 1
    import numpy as np
    from repro_torch.core import (NoC, HierarchicalMesh, evaluate_batch,
                                  random_dag)
    from repro_torch.core.noc_batch import validate_placements
    from repro_torch.core.partition import partition_model
    from repro_torch.deploy import as_objective, deploy_model
    from repro_torch.kernels import _build
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

    # ---- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.build([KERNEL])
    print(f"[build] {KERNEL}: {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log(KERNEL).splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "bytes stack" in line:
            print(f"[build] {line.strip()}")

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

    # ---- phase 4: the main path ------------------------------------------------
    rec = Recorder()
    link_traffic.launches = 0
    t0 = time.perf_counter()
    plan = deploy_model(vgg, noc, method="ppo", objective="latency",
                        recorder=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {KERNEL: link_traffic.launches}
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
    if len(res.history) != 40 or launches[KERNEL] <= 0:
        raise AssertionError(f"main path ran {len(res.history)} iterations "
                             f"and {launches} kernel launches")
    print(f"[deploy] best latency {best!r} s (cuda) vs host evaluate "
          f"{host!r} s ok")

    # ---- phase 5: timing ---------------------------------------------------------
    ids_d, w_d = main_ids.to(dev), main_w.to(dev)
    ids64 = ids_d.long()
    base = torch.zeros(ids_d.shape[0], main_links + 1, device=dev)
    B, K = ids_d.shape
    ms = _time_ms(lambda: link_traffic(ids_d, w_d, main_links))
    plain_ms = _time_ms(lambda: link_traffic_plain(ids_d, w_d, main_links))
    library_ms = _time_ms(lambda: torch.scatter_add(base, 1, ids64, w_d))
    n_bytes = B * K * (4 + 4) + B * main_links * 4
    n_ops = int((ids_d < main_links).sum().item())       # adds this data needs
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"[time] {KERNEL} [{B}, {K}] -> {main_links}: kernel {ms!r} ms, "
          f"plain {plain_ms!r} ms, scatter_add {library_ms!r} ms, bound "
          f"{bound_ms!r} ms ({n_bytes} bytes, {n_ops} adds); card {card}")

    kernels = [{
        "name": "link_traffic", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/noc_segsum.cu",
        "replaces": "src/repro/kernels/noc_segsum.py:54",
        "launches": launches[KERNEL], "max_abs_err": main_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
