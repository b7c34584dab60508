"""``python -m repro_torch.deploy``: end-to-end deployment sweeps.

Every subcommand that computes runs on the card unless ``--device cpu`` asks
for the host (``--device`` takes any torch device string; without a CUDA
device and without ``--device cpu`` the command fails).

Sweeps models × methods × objectives through
:func:`repro_torch.deploy.deploy_model`
on one topology (``--cores/--torus`` flat grids, or any ``--topology`` spec —
multi-chip ``hier:...`` meshes included) and prints a CSV-ish table (one row
per deployment) with the paper's metrics plus per-stage wall times. ``--json``
stores the full :meth:`DeploymentPlan.report` dicts; ``--smoke`` runs a
seconds-scale sweep so CI keeps the whole flow from bitrotting.

Examples::

    PYTHONPATH=src python -m repro_torch.deploy                 # default sweep
    PYTHONPATH=src python -m repro_torch.deploy --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.deploy --models spike_vgg16 \\
        --methods zigzag,simulated_annealing --objectives comm_cost,max_link \\
        --cores 32 --budget 2000 --json results/deploy_sweep.json
    PYTHONPATH=src python -m repro_torch.deploy \\
        --topology hier:2x2:4x4,ibw=5e8 --partition chip \\
        --copartition-iters 2 --methods genetic

``--trace out.jsonl`` / ``--chrome-trace out.json`` attach a
:class:`repro_torch.obs.Recorder` to the whole sweep: per-stage spans, search
trajectory events, and scoring counters land in a JSONL event log and/or a
``chrome://tracing`` / Perfetto-loadable trace file.

``report`` deploys one model and prints the NoC flow report (per-link load
summary, hotspot top-k, per-chip / inter-chip byte breakdown, ASCII heatmap —
see :func:`repro_torch.obs.flow_report`)::

    PYTHONPATH=src python -m repro_torch.deploy report \\
        --topology hier:2x2:4x4 --method genetic --budget 2000 \\
        --trace deploy_trace.jsonl

``--faults "link:3,node:7"`` runs any of the commands on a degraded fabric
(dropped links/cores with detour re-routing — see
:class:`repro_torch.core.topology.DegradedTopology`). ``replay`` feeds a
fault/traffic-drift scenario through the online re-placement control loop
(:mod:`repro_torch.deploy.runtime`) and prints the per-step monitor table, the
per-event recovery table, and before/after hotspot reports::

    PYTHONPATH=src python -m repro_torch.deploy replay \\
        --topology hier:2x2:4x4 \\
        --scenario "steps=8;drift=diurnal:0.3:8;fault=link:8@2" \\
        --compare-cold --json results/replay.json

``serve`` runs the persistent placement service
(:mod:`repro_torch.deploy.service`): plan caching keyed by canonical
:class:`repro_torch.deploy.request.DeployRequest` identity, near-miss warm
starts, fused batched scoring for concurrent same-graph requests.
``request`` is the client (it computes nothing, so it has no ``--device``).
``report``/``replay`` accept ``--plan PATH|URL`` to reuse a served/cached
plan instead of re-deploying::

    PYTHONPATH=src python -m repro_torch.deploy serve --port 8642 \\
        --cache results/plan_cache.json
    PYTHONPATH=src python -m repro_torch.deploy request \\
        --url http://127.0.0.1:8642 --method sa --budget 2000 --save plan.json
    PYTHONPATH=src python -m repro_torch.deploy report --plan plan.json
"""
from __future__ import annotations

import argparse
import json
import os

from ..core.noc import NoC
from ..core.topology import degrade, parse_topology
from ..device import resolve_device
from ..obs import Recorder, flow_report
from ..snn import spike_resnet18, spike_resnet50, spike_vgg16
from .engine import SCHEDULES, deploy_model
from .objective import OBJECTIVES

MODELS = {
    "spike_resnet18": spike_resnet18,
    "spike_resnet50": spike_resnet50,
    "spike_vgg16": spike_vgg16,
}

# paper §5.1 grids: 32 cores as 4x8, 64 as 8x8 (benchmarks/common.make_noc)
GRIDS = {16: (4, 4), 32: (4, 8), 64: (8, 8), 256: (16, 16)}

COLUMNS = ("model", "method", "objective", "objective_cost", "comm_cost",
           "max_link", "latency_ms", "makespan_ms", "util", "place_s")


def _row(plan) -> tuple:
    r = plan.report()
    p, s = r["placement"], r["schedule"]
    return (r["model"], p["method"], p["objective"],
            f"{p['objective_cost']:.4e}", f"{p['comm_cost']:.4e}",
            f"{p['max_link']:.4e}", f"{p['latency_s'] * 1e3:.3f}",
            f"{s['makespan_s'] * 1e3:.3f}" if s else "-",
            f"{s['mean_utilization']:.3f}" if s else "-",
            f"{r['stage_times_s']['place']:.2f}")


def _csv(values) -> str:
    return ",".join(str(v) for v in values)


def _add_topology_args(ap):
    ap.add_argument("--cores", type=int, default=32,
                    help=f"NoC size; known grids: {sorted(GRIDS)}")
    ap.add_argument("--torus", action="store_true")
    ap.add_argument("--topology", default=None, metavar="SPEC",
                    help="explicit topology spec overriding --cores/--torus: "
                         "mesh:RxC | torus:RxC | hier:CRxCC:KRxKC"
                         "[,ibw=...,ien=...,ilat=...] "
                         "(see repro_torch.core.topology.parse_topology)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="deploy on a degraded fabric: comma list of "
                         "link:<id> / node:<core> faults present from the "
                         "start, e.g. \"link:3,node:7\" (note ppo/policy "
                         "refuse degraded fabrics)")


def _add_device_arg(ap):
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card; "
                         "'cpu' runs on the host)")


def _resolve_device(ap, args):
    """``--device`` as a torch device; a missing card is a usage error."""
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))


def _resolve_topology(ap, args, cores):
    if args.topology is not None:
        try:
            topo = parse_topology(args.topology, link_bw=8e9,
                                  core_flops=25.6e9, hop_latency=2e-8)
        except ValueError as e:
            ap.error(str(e))
    else:
        if cores not in GRIDS:
            ap.error(f"--cores must be one of {sorted(GRIDS)}")
        rows, cols = GRIDS[cores]
        topo = NoC(rows, cols, torus=args.torus, link_bw=8e9,
                   core_flops=25.6e9, hop_latency=2e-8)
    if getattr(args, "faults", None):
        from .runtime import parse_faults
        try:
            f = parse_faults(args.faults)
            topo = degrade(topo, links=f["links"], nodes=f["nodes"])
        except ValueError as e:           # InfeasibleTopologyError included
            ap.error(str(e))
    return topo


def _restarts_kw(ap, args) -> dict:
    """``--restarts N`` as an optimize_placement kwarg (device backend only —
    the host SA has no parallel-chain notion, so reject the combination)."""
    if args.restarts is None:
        return {}
    if args.backend != "device":
        ap.error("--restarts requires --backend device")
    if args.restarts < 1:
        ap.error("--restarts must be >= 1")
    return {"restarts": args.restarts}


def _multilevel_args(ap):
    ap.add_argument("--coarsen-to", type=int, default=None, metavar="N",
                    help="multilevel only: coarsen the logical graph to <= N "
                         "nodes before the flat search (default 64)")
    ap.add_argument("--refine-iters", type=int, default=None, metavar="K",
                    help="multilevel only: K * n_level greedy swap proposals "
                         "per uncoarsened level (default 3)")
    ap.add_argument("--coarse-method", default=None, metavar="M",
                    help="multilevel only: flat method for the coarsest "
                         "level (default simulated_annealing)")


def _multilevel_kw(ap, args, methods) -> dict:
    """``--coarsen-to/--refine-iters/--coarse-method`` as optimize_placement
    kwargs (method multilevel/ml only — flat searches have no V-cycle)."""
    kw = {}
    if args.coarsen_to is not None:
        kw["coarsen_to"] = args.coarsen_to
    if args.refine_iters is not None:
        kw["refine_iters"] = args.refine_iters
    if args.coarse_method is not None:
        kw["coarse_method"] = args.coarse_method
    if kw and not any(m in ("multilevel", "ml") for m in methods):
        ap.error("--coarsen-to/--refine-iters/--coarse-method require "
                 "--method multilevel")
    return kw


def _load_plan(ap, src, device):
    """``--plan PATH|URL`` -> (DeployRequest, live DeploymentPlan on
    ``device``).

    Accepts a saved DeployResponse / cache-entry JSON (anything carrying
    ``request`` + ``placement``) or a server URL returning one
    (``http://host:port/plan/<cache_key>``). The plan is re-materialized
    without searching (:func:`repro_torch.deploy.engine.instantiate_plan`),
    so flow reports on served plans are free."""
    from .engine import instantiate_plan
    from .request import DeployRequest
    from .service import fetch_plan

    try:
        d = fetch_plan(src)
    except OSError as e:
        ap.error(f"cannot load plan from {src!r}: {e}")
    if not isinstance(d, dict) or "request" not in d or "placement" not in d:
        ap.error(f"{src!r} is not a cached plan (need a JSON object with "
                 "'request' and 'placement' — a saved DeployResponse or a "
                 "/plan/<cache_key> payload)")
    try:
        req = DeployRequest.from_json(d["request"])
        return req, instantiate_plan(req, d["placement"], device=device)
    except (TypeError, ValueError) as e:
        ap.error(f"cannot re-materialize plan from {src!r}: {e}")


def _write_traces(recorder, trace, chrome_trace):
    for path, writer in ((trace, recorder.write_jsonl),
                         (chrome_trace, recorder.write_chrome_trace)):
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            writer(path)
            print(f"# wrote {path}")


def report_main(argv=None) -> int:
    """``report``: deploy one model, print the NoC flow report."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.deploy report",
        description="Deploy one model and print the NoC flow report: "
                    "link-load summary, hotspot top-k, per-chip/inter-chip "
                    "byte breakdown, per-core ASCII heatmap.")
    ap.add_argument("--model", default="spike_resnet18",
                    choices=tuple(MODELS))
    ap.add_argument("--method", default="sigmate",
                    help="optimize_placement method")
    ap.add_argument("--objective", default="comm_cost",
                    help=f"objective spec; names: {tuple(OBJECTIVES)}")
    _add_topology_args(ap)
    ap.add_argument("--partition", "--strategy", dest="strategy",
                    default="auto",
                    choices=("auto", "compute", "storage", "balanced",
                             "chip", "chip_balanced"))
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default=None,
                    help="scoring backend override (batch|torch|cuda|"
                         "reference, or device for the one-launch SA/GA)")
    ap.add_argument("--restarts", type=int, default=None, metavar="N",
                    help="parallel SA restart chains (backend=device only)")
    _multilevel_args(ap)
    _add_device_arg(ap)
    ap.add_argument("--top-k", type=int, default=10,
                    help="hotspot links to list")
    ap.add_argument("--plan", default=None, metavar="PATH|URL",
                    help="flow-report a cached plan (saved DeployResponse / "
                         "cache-entry JSON, or a server /plan/<cache_key> "
                         "URL) instead of deploying; model/topology/search "
                         "options are taken from the plan's own request")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the flow report dict (plus the plan report) "
                         "to PATH")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the deployment's Recorder event log (JSONL)")
    ap.add_argument("--chrome-trace", default=None, metavar="PATH",
                    help="write a chrome://tracing / Perfetto trace JSON")
    args = ap.parse_args(argv)

    device = _resolve_device(ap, args)
    recorder = Recorder() if (args.trace or args.chrome_trace) else None
    if args.plan:
        req, plan = _load_plan(ap, args.plan, device)
        noc = plan.noc
        model_name, method, objective = plan.model, req.method, \
            req.objective[0]
    else:
        noc = _resolve_topology(ap, args, args.cores)
        cfg = MODELS[args.model](n_classes=10, in_res=32, T=4)
        plan = deploy_model(cfg, noc, partition_strategy=args.strategy,
                            method=args.method, objective=args.objective,
                            schedule="none", seed=args.seed,
                            budget=args.budget, backend=args.backend,
                            recorder=recorder, device=device,
                            **_restarts_kw(ap, args),
                            **_multilevel_kw(ap, args, [args.method]))
        model_name, method, objective = args.model, args.method, \
            args.objective
    rep = flow_report(noc, plan.graph, plan.placement, top_k=args.top_k)
    d = noc.describe()
    topo = f"{d.get('kind', 'grid')} {d.get('rows')}x{d.get('cols')}" \
           f" ({d.get('n_cores')} cores)"
    print(f"deployment: {model_name} via {method} "
          f"(objective={objective}) on {topo}")
    print(rep.render(top_k=args.top_k))

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"flow": rep.to_dict(), "plan": plan.report()}, f,
                      indent=2)
        print(f"# wrote {args.json}")
    if recorder is not None:
        _write_traces(recorder, args.trace, args.chrome_trace)
    return 0


def replay_main(argv=None) -> int:
    """``replay``: replay a fault/drift scenario through the online
    re-placement loop and print the per-event recovery table."""
    from .runtime import run_scenario

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.deploy replay",
        description="Replay a fault/drift scenario through the online "
                    "re-placement control loop (repro_torch.deploy.runtime): "
                    "per-step monitor table, per-event recovery table, and "
                    "before/after NoC hotspot reports.")
    ap.add_argument("--scenario", required=True, metavar="SPEC",
                    help="scenario: compact grammar "
                         "(steps=12;drift=diurnal:0.4:8;fault=link:21@3;"
                         "repair=link:21@9;seed=7), a JSON object string, or "
                         "a JSON file path")
    ap.add_argument("--model", default="spike_resnet18",
                    choices=tuple(MODELS))
    ap.add_argument("--method", default="simulated_annealing",
                    help="warm-startable optimize_placement method "
                         "(simulated_annealing / genetic / random_search)")
    ap.add_argument("--objective", default="comm_cost",
                    help=f"base objective; names: {tuple(OBJECTIVES)}")
    _add_topology_args(ap)
    ap.add_argument("--threshold", type=float, default=0.15,
                    help="tolerated objective degradation before re-placing")
    ap.add_argument("--migration-weight", type=float, default=0.05,
                    help="state-movement penalty weight of warm re-placement "
                         "(0 disables the migration term)")
    ap.add_argument("--budget", type=int, default=512)
    ap.add_argument("--escalation", type=float, default=4.0)
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-cold", action="store_true",
                    help="also run a from-scratch re-optimization at every "
                         "recovery and record it next to the warm result")
    ap.add_argument("--plan", default=None, metavar="PATH|URL",
                    help="start from a cached plan (saved DeployResponse / "
                         "cache-entry JSON, or a server /plan/<cache_key> "
                         "URL) instead of deploying first; the plan's own "
                         "model and topology are used")
    _add_device_arg(ap)
    ap.add_argument("--top-k", type=int, default=5,
                    help="hotspot links in the before/after flow reports")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the ScenarioResult dict to PATH")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the run's Recorder event log (JSONL)")
    ap.add_argument("--chrome-trace", default=None, metavar="PATH",
                    help="write a chrome://tracing / Perfetto trace JSON")
    args = ap.parse_args(argv)

    device = _resolve_device(ap, args)
    recorder = Recorder() if (args.trace or args.chrome_trace) else None
    if args.plan:
        _, plan = _load_plan(ap, args.plan, device)
        noc, cfg = plan.noc, None          # re-partitions reuse plan.profiles
    else:
        noc = _resolve_topology(ap, args, args.cores)
        cfg, plan = MODELS[args.model](n_classes=10, in_res=32, T=4), None
    try:
        res = run_scenario(cfg, noc, args.scenario, method=args.method,
                           objective=args.objective,
                           threshold=args.threshold,
                           migration_weight=args.migration_weight,
                           budget=args.budget, escalation=args.escalation,
                           max_retries=args.max_retries, seed=args.seed,
                           compare_cold=args.compare_cold, recorder=recorder,
                           plan=plan, device=device)
    except ValueError as e:
        ap.error(str(e))

    print(f"scenario: {json.dumps(res.scenario)}")
    print(f"\nmonitor ({len(res.samples)} steps):")
    print(_csv(("t", "objective", "degradation_pct", "links_down",
                "nodes_down", "action")))
    for s in res.samples:
        obj = "-" if s["objective"] is None else f"{s['objective']:.4e}"
        deg = "-" if s["degradation"] is None \
            else f"{100 * s['degradation']:+.1f}"
        print(_csv((s["t"], obj, deg,
                    ";".join(map(str, s["faults"]["links"])) or "-",
                    ";".join(map(str, s["faults"]["nodes"])) or "-",
                    s["action"])))

    print(f"\nrecoveries ({len(res.recoveries)}):")
    print(_csv(("t", "reason", "mode", "objective_before", "objective_after",
                "moved_MB", "attempts")))
    for r in res.recoveries:
        mode = "repartition" if r["repartitioned"] else \
            r["attempts"][-1]["mode"] if r["attempts"] else "-"
        before = "-" if r["objective_before"] is None \
            else f"{r['objective_before']:.4e}"
        attempts = ";".join(f"{a['mode']}@{a['budget']}"
                            for a in r["attempts"])
        print(_csv((r["t"], r["reason"], mode, before,
                    f"{r['objective_after']:.4e}",
                    f"{r['moved_state_bytes'] / 1e6:.2f}", attempts)))
        cold = r.get("cold_reference")
        if cold:
            print(f"#   cold reference @{cold['budget']}: "
                  f"objective={cold['objective']:.4e} "
                  f"moved_MB={cold['moved_state_bytes'] / 1e6:.2f}")
    print(f"\ntotals: replacements={res.n_replacements} "
          f"cold_fallbacks={res.n_cold_fallbacks} "
          f"moved_MB={res.moved_state_bytes / 1e6:.2f} "
          f"max_degradation={100 * res.max_degradation:+.1f}%")

    final_faults = res.samples[-1]["faults"] if res.samples \
        else {"links": [], "nodes": []}
    final_topo = degrade(noc, links=final_faults["links"],
                         nodes=final_faults["nodes"])
    before = flow_report(noc, res.initial_graph, res.initial_placement,
                         top_k=args.top_k)
    after = flow_report(final_topo, res.final_graph, res.final_placement,
                        top_k=args.top_k)
    print("\ninitial placement on the starting fabric:")
    print(before.render(top_k=args.top_k))
    print("\nfinal placement on the surviving fabric:")
    print(after.render(top_k=args.top_k))

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(res.to_dict(), f, indent=2)
        print(f"# wrote {args.json}")
    if recorder is not None:
        _write_traces(recorder, args.trace, args.chrome_trace)
    return 0


def serve_main(argv=None) -> int:
    """``serve``: run the persistent placement service."""
    from .plancache import PlanCache
    from .service import PlacementService, make_server

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.deploy serve",
        description="Persistent placement service: POST /deploy answers "
                    "DeployRequest JSON from the plan cache (exact hits), "
                    "warm-starts near misses from cached placements, and "
                    "fuses concurrent same-graph cold requests into one "
                    "batched search dispatch. GET /stats for p50/p99 request "
                    "latencies and hit/miss/warm counters.")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help="JSON plan-cache file: loaded at startup when it "
                         "exists, saved on shutdown — cache hits survive "
                         "server restarts")
    ap.add_argument("--max-entries", type=int, default=1024,
                    help="plan-cache capacity (LRU eviction beyond it)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="micro-batch size cap for concurrent requests")
    ap.add_argument("--window-ms", type=float, default=10.0,
                    help="micro-batching window: requests arriving within "
                         "it share one dispatch")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable fused batched search (serial per-request "
                         "searches; answers are identical by construction)")
    ap.add_argument("--warm-budget-frac", type=float, default=0.4,
                    help="first warm-start attempt budget as a fraction of "
                         "the request's full budget")
    ap.add_argument("--warm-threshold", type=float, default=0.05,
                    help="accepted warm cost overshoot vs the donor plan "
                         "before the budget escalates")
    _add_device_arg(ap)
    args = ap.parse_args(argv)
    device = _resolve_device(ap, args)

    if args.cache and os.path.exists(args.cache):
        cache = PlanCache.load(args.cache, max_entries=args.max_entries)
        print(f"# loaded {len(cache)} cached plans from {args.cache}")
    else:
        cache = PlanCache(max_entries=args.max_entries)
    service = PlacementService(cache=cache, fuse=not args.no_fuse,
                               warm_budget_frac=args.warm_budget_frac,
                               warm_threshold=args.warm_threshold,
                               device=device)
    server, queue = make_server(service, host=args.host, port=args.port,
                                max_batch=args.max_batch,
                                window_s=args.window_ms / 1e3)
    host, port = server.server_address[:2]
    print(f"# placement service on http://{host}:{port} "
          "(POST /deploy, /deploy_batch; GET /stats, /healthz, /plan/<key>)")

    def _terminate(signum, frame):       # SIGTERM saves the cache too
        raise KeyboardInterrupt

    import signal
    signal.signal(signal.SIGTERM, _terminate)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\n# shutting down")
    finally:
        server.server_close()
        queue.close()
        if args.cache:
            service.cache.save(args.cache)
            print(f"# saved {len(service.cache)} plans to {args.cache}")
    return 0


def request_main(argv=None) -> int:
    """``request``: client — POST one deployment request."""
    from .request import DeployRequest
    from .service import request_over_http

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.deploy request",
        description="Build one canonical DeployRequest and POST it to a "
                    "running placement service; prints where the plan came "
                    "from (hit / warm / miss) and its costs.")
    ap.add_argument("--url", default="http://127.0.0.1:8642")
    ap.add_argument("--model", default="spike_resnet18",
                    choices=tuple(MODELS))
    ap.add_argument("--method", default="simulated_annealing",
                    help="optimize_placement method")
    ap.add_argument("--objective", default="comm_cost",
                    help=f"objective spec; names: {tuple(OBJECTIVES)}")
    _add_topology_args(ap)
    ap.add_argument("--partition", "--strategy", dest="strategy",
                    default="auto",
                    choices=("auto", "compute", "storage", "balanced",
                             "chip", "chip_balanced"))
    ap.add_argument("--schedule", default="none", choices=SCHEDULES,
                    help="schedule stage of the returned plan (default "
                         "none: placement-only requests cache best)")
    ap.add_argument("--budget", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds to wait for the response")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="write the DeployResponse JSON (reusable as "
                         "--plan for report/replay)")
    args = ap.parse_args(argv)

    noc = _resolve_topology(ap, args, args.cores)
    cfg = MODELS[args.model](n_classes=10, in_res=32, T=4)
    try:
        req = DeployRequest.from_call(
            cfg, noc, partition_strategy=args.strategy, method=args.method,
            objective=args.objective, schedule=args.schedule,
            budget=args.budget, seed=args.seed, backend=args.backend)
    except (TypeError, ValueError) as e:
        ap.error(str(e))
    try:
        resp = request_over_http(args.url, req, timeout=args.timeout)
    except OSError as e:
        ap.error(f"cannot reach placement service at {args.url}: {e}")
    warm = f" warm_from={resp.warm_from[:12]}" if resp.warm_from else ""
    fused = " (fused batch row)" if resp.fused else ""
    print(f"{resp.status}{fused}{warm}: {req.describe()}")
    print(f"cache_key={resp.cache_key}")
    print(f"objective_cost={resp.objective_cost:.6e} "
          f"comm_cost={resp.comm_cost:.6e} "
          f"latency_s={resp.latency_s:.4f} attempts={resp.attempts}")
    if args.save:
        os.makedirs(os.path.dirname(args.save) or ".", exist_ok=True)
        with open(args.save, "w") as f:
            json.dump(resp.to_dict(), f, indent=2)
        print(f"# wrote {args.save}")
    return 0


def main(argv=None) -> int:
    import sys
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "report":
        return report_main(argv[1:])
    if argv and argv[0] == "replay":
        return replay_main(argv[1:])
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and argv[0] == "request":
        return request_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.deploy",
        description="End-to-end SNN deployment sweep: "
                    "profile -> partition -> place -> schedule.")
    ap.add_argument("--models", default="spike_vgg16",
                    help=f"comma list from {tuple(MODELS)}")
    ap.add_argument("--methods", default="zigzag,sigmate,random_search,ppo",
                    help="comma list of optimize_placement methods")
    ap.add_argument("--objectives", default="comm_cost",
                    help=f"comma list from {tuple(OBJECTIVES)}")
    _add_topology_args(ap)
    ap.add_argument("--contention-feedback", action="store_true",
                    help="inflate per-stage schedule times with the placed "
                         "NoC contention (closes the placement->schedule "
                         "loop)")
    ap.add_argument("--partition", "--strategy", dest="strategy",
                    default="auto",
                    choices=("auto", "compute", "storage", "balanced",
                             "chip", "chip_balanced"),
                    help="partition strategy; 'auto' picks the chip-aware "
                         "'chip' strategy on hier topologies and 'balanced' "
                         "on flat grids")
    ap.add_argument("--copartition-iters", type=int, default=0,
                    metavar="N",
                    help="partition->place co-design rounds: feed placed "
                         "interchip traffic back into the chip allocation "
                         "(chip-aware strategies on hier topologies only)")
    ap.add_argument("--schedule", default="fpdeep", choices=SCHEDULES)
    ap.add_argument("--units", type=int, default=8,
                    help="pipelined work units (feature-map rows / micro-batches)")
    ap.add_argument("--budget", type=int, default=None,
                    help="search budget (evaluations / iterations)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default=None,
                    help="scoring backend override (batch|torch|cuda|"
                         "reference, or device for the one-launch SA/GA "
                         "of simulated_annealing/genetic)")
    ap.add_argument("--restarts", type=int, default=None, metavar="N",
                    help="parallel SA restart chains (backend=device only)")
    _multilevel_args(ap)
    _add_device_arg(ap)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write full DeploymentPlan reports to PATH")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write the sweep's Recorder event log (JSONL): "
                         "stage spans, search trajectories, scoring counters")
    ap.add_argument("--chrome-trace", default=None, metavar="PATH",
                    help="write a chrome://tracing / Perfetto trace JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale CI sweep (tiny model/budgets)")
    args = ap.parse_args(argv)

    if args.smoke:
        models = ["spike_resnet18"]
        methods = ["zigzag", "sigmate", "random_search"]
        objectives = ["comm_cost", "max_link"]
        cores, budget, units = 16, 64, 4
    else:
        models = args.models.split(",")
        methods = args.methods.split(",")
        objectives = args.objectives.split(",")
        cores, budget, units = args.cores, args.budget, args.units

    noc = _resolve_topology(ap, args, cores)
    device = _resolve_device(ap, args)

    for model_name in models:            # fail on typos before any sweep runs
        if model_name not in MODELS:
            ap.error(f"unknown model {model_name!r}; choose from {tuple(MODELS)}")
    if args.backend == "device":         # device runs sa/ga only — fail early
        bad = [m for m in methods
               if m not in ("sa", "ga", "simulated_annealing", "genetic",
                            "ml", "multilevel")]
        if bad:
            ap.error(f"--backend device implements sa/ga only; drop {bad} "
                     "from --methods (default smoke/sweep lists include "
                     "constructors)")
    ml_kw = _multilevel_kw(ap, args, methods)

    # one recorder across the whole sweep: deployments show up as consecutive
    # span groups, counters accumulate sweep-wide
    recorder = Recorder() if (args.trace or args.chrome_trace) else None
    reports = []
    print(_csv(COLUMNS))
    for model_name in models:
        cfg = MODELS[model_name](n_classes=10, in_res=32, T=4)
        for method in methods:
            for objective in objectives:
                plan = deploy_model(
                    cfg, noc, partition_strategy=args.strategy, method=method,
                    objective=objective, schedule=args.schedule, n_units=units,
                    seed=args.seed, budget=budget, backend=args.backend,
                    contention_feedback=args.contention_feedback,
                    copartition_iters=args.copartition_iters,
                    recorder=recorder, device=device,
                    **_restarts_kw(ap, args),
                    **(ml_kw if method in ("ml", "multilevel") else {}))
                reports.append(plan.report())
                print(_csv(_row(plan)))

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(reports, f, indent=2)
        print(f"# wrote {args.json}")
    if recorder is not None:
        _write_traces(recorder, args.trace, args.chrome_trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
