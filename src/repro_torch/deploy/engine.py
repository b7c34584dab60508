"""The paper's end-to-end deployment flow as one engine (paper §4, Fig 3).

``deploy_model`` chains four stages:

1. **profile**  — per-layer compute/storage/traffic costs
   (:func:`repro_torch.snn.profile_model`, spike-aware);
2. **partition** — balanced compute+storage slicing onto logical cores
   (paper §4.2, :func:`repro_torch.core.partition.partition_model`);
3. **place**    — logical→physical core placement under a pluggable
   :mod:`repro_torch.deploy.objective` (paper §4.3 RL placement and the
   constructors, :func:`repro_torch.core.placement.optimize_placement`), on
   ``device``;
4. **schedule** — fine-grained pipelined training schedule
   (paper §4.3 / Fig 9, :mod:`repro_torch.core.pipeline`).

The result is a :class:`DeploymentPlan` carrying every stage's artifact,
per-stage wall times, and a JSON-able :meth:`DeploymentPlan.report`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import pipeline
from ..core.partition import (CoreSpec, LayerProfile, Partition,
                              partition_model)
from ..obs import NULL_RECORDER
from ..snn.models import SNNConfig
from ..snn.profile import profile_model
from .objective import as_objective, partition_interchip_bytes

SCHEDULES = ("layerwise", "fpdeep", "one_f_one_b", "none")


@dataclasses.dataclass
class DeploymentPlan:
    """Everything the deployment flow produced, stage by stage."""
    model: str
    noc: object                      # repro.core.topology.Topology
    profiles: list                   # [LayerProfile]
    partition: Partition
    graph: object                    # LogicalGraph the placer consumed
    placement: object                # PlacementResult
    schedule_name: str
    schedule: object                 # pipeline.Schedule | None
    n_units: int
    stage_times_s: dict              # {"profile"|"partition"|"place"|"schedule": s}
    contention_feedback: bool = False
    copartition_iters: int = 0       # co-design outer-loop rounds actually run

    def report(self) -> dict:
        """JSON-able summary (what the CLI/benchmark sweeps emit)."""
        r = self.placement
        sched = None
        if self.schedule is not None:
            sched = {
                "name": self.schedule_name,
                "n_units": self.n_units,
                "makespan_s": float(self.schedule.makespan),
                "mean_utilization": float(self.schedule.mean_utilization()),
                "contention_feedback": self.contention_feedback,
            }
        part_rep = {"strategy": self.partition.strategy,
                    "n_slices": self.partition.n,
                    "imbalance": float(self.partition.imbalance())}
        if self.partition.chip_of is not None:
            part_rep.update({
                "n_chips": int(self.partition.n_chips),
                "interchip_cut_bytes":
                    float(partition_interchip_bytes(self.graph)),
                "copartition_iters": int(self.copartition_iters),
            })
        return {
            "model": self.model,
            "noc": self.noc.describe(),
            "partition": part_rep,
            "placement": {"method": r.method, "objective": r.objective,
                          "objective_cost": float(r.objective_cost),
                          "comm_cost": float(r.comm_cost),
                          "mean_hops": float(r.mean_hops),
                          "max_link": float(r.max_link),
                          "latency_s": float(r.latency),
                          "throughput": float(r.throughput),
                          "wall_time_s": float(r.wall_time_s)},
            "schedule": sched,
            "stage_times_s": dict(self.stage_times_s),
        }


def _profiles(model, batch: int, training: bool, spike_density: float):
    """model spec -> (name, [LayerProfile]); accepts an SNNConfig or an
    already-profiled layer list (then the profile stage is a no-op)."""
    if isinstance(model, SNNConfig):
        return model.name, profile_model(model, batch=batch,
                                         spike_density=spike_density,
                                         training=training)
    layers = list(model)
    if not all(isinstance(l, LayerProfile) for l in layers):
        raise TypeError("model must be an SNNConfig or a list of LayerProfile")
    return f"profiled[{len(layers)}]", layers


def _schedule(times, schedule: str, n_units: int,
              bwd_ratio: float, training: bool):
    if schedule == "none":
        return None
    if schedule == "layerwise":
        return pipeline.layerwise(times, n_units, bwd_ratio, training)
    if schedule == "fpdeep":
        return pipeline.fpdeep(times, n_units, bwd_ratio, training)
    # "one_f_one_b": 1F1B is defined on uniform per-stage times; model the
    # chain with the mean slice latency and the configured bwd/fwd ratio
    t_f = float(np.mean(times)) if times else 0.0
    return pipeline.one_f_one_b(len(times), n_units,
                                fwd_time=t_f, bwd_time=bwd_ratio * t_f)


def resolve_partition_strategy(strategy: str, noc) -> str:
    """``"auto"`` → chip-aware on hierarchical (multi-chip) topologies,
    the historical ``"balanced"`` everywhere else; explicit strategies pass
    through untouched."""
    if strategy == "auto":
        return "chip" if getattr(noc, "n_chips", 1) > 1 else "balanced"
    return strategy


def _measured_cut_weights(part, graph, placement, noc) -> np.ndarray:
    """Per-layer-unit cut-cost multipliers from *placed* interchip traffic.

    For every logical edge, count the inter-chip links its placed route
    actually crosses (XY routes between diagonal chips cross two boundaries;
    multicast fan-out multiplies the producer's shard) and attribute the
    bytes to the producer's layer unit. The ratio measured/predicted per unit
    re-weights the chip DP's cut costs on the next co-partition round, so
    boundaries that turned out expensive in silicon get moved to cheaper
    layers."""
    mask = noc.interchip_mask()
    n_units = max(s.layer for s in part.slices) + 1
    measured = np.zeros(n_units)
    predicted = np.zeros(n_units)
    unit = np.array([s.layer for s in part.slices])
    cut = graph.chip_cut_mask()
    for i, j, vol in zip(*graph.edge_arrays()):
        ids = np.asarray(noc.route_ids(int(placement[i]), int(placement[j])),
                         dtype=np.int64)
        measured[unit[i]] += vol * float(mask[ids].sum()) if ids.size else 0.0
        if cut[i, j]:
            predicted[unit[i]] += vol
    w = np.ones(n_units)
    nz = predicted > 0
    w[nz] = np.maximum(measured[nz] / predicted[nz], 1e-3)
    return w


def deploy_model(model, noc, partition_strategy: str = "auto",
                 method: str = "ppo", objective="comm_cost",
                 schedule: str = "fpdeep", n_units: int = 8,
                 batch: int = 8, training: bool = True,
                 spike_density: float = 0.15, core: CoreSpec = CoreSpec(),
                 seed: int = 0, budget: int | None = None,
                 backend: str | None = None, bwd_ratio: float = 2.0,
                 contention_feedback: bool = False,
                 copartition_iters: int = 0,
                 recorder=None, device=None,
                 **method_kw) -> DeploymentPlan:
    """Run the full deployment flow of ``model`` onto ``noc``.

    This is the reference engine's body (``repro.deploy.engine._deploy``)
    called directly: the reference's ``deploy_model`` first canonicalizes the
    call into a ``DeployRequest``, and that request layer is not ported yet
    (ROADMAP queue 1, item 5). Results are the same either way.

    ``model`` is an :class:`repro_torch.snn.SNNConfig` (profiled here) or a
    pre-built ``list[LayerProfile]``. ``noc`` is any topology (flat ``NoC``
    or a multi-chip ``HierarchicalMesh``).
    ``method``/``objective``/``backend``/``budget``/``method_kw`` go to
    :func:`optimize_placement`; ``schedule`` is one of :data:`SCHEDULES`
    ("none" skips the scheduling stage).

    ``device`` (``None``: the card) is where placement runs; on a CUDA
    device ``backend=None`` resolves to ``"cuda"``, so link-level objectives
    (``latency``, ``max_link``, ``energy``, ``interchip``) score every PPO
    rollout batch through the link-traffic kernel. ``device="cpu"`` resolves
    it to ``"batch"`` (numpy float64), the reference's default.

    ``partition_strategy="auto"`` (the default) selects the chip-aware
    ``"chip"`` strategy on multi-chip topologies and ``"balanced"`` on flat
    chips. ``copartition_iters > 0`` closes the partition→place co-design
    loop on chip-aware strategies: placed interchip traffic per layer-unit
    boundary is fed back as cut-cost multipliers, the model is re-partitioned
    and re-placed, and the best plan under ``objective`` (ties broken on
    fewer placed interchip bytes) wins. ``contention_feedback=True`` inflates
    each slice's latency by the time its placed core spends serializing NoC
    traffic before the pipeline schedule is built.

    ``recorder`` is an optional :class:`repro_torch.obs.Recorder`: every
    stage runs inside a span (the ``stage_times_s`` durations are the span
    durations), the placement search emits per-iteration events, and scoring
    dispatch counts accumulate as counters.
    """
    # placement sits beside deploy in the layering (core.placement imports
    # deploy.objective at module scope) — resolve it at call time
    from ..core.placement import optimize_placement

    # validate the cheap-to-check specs before any search work is spent
    as_objective(objective)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; "
                         f"choose from {SCHEDULES}")
    strategy = resolve_partition_strategy(partition_strategy, noc)
    # a detached run still measures stage times through (unrecorded) spans
    rec = recorder if recorder is not None else NULL_RECORDER
    with rec.span("deploy.profile") as sp_profile:
        name, profiles = _profiles(model, batch, training, spike_density)
    # degraded topologies partition onto the surviving cores only
    n_usable = getattr(noc, "n_alive_cores", noc.n_cores)
    with rec.span("deploy.partition", strategy=strategy) as sp_partition:
        part = partition_model(profiles, n_usable, strategy, core,
                               topology=noc)
        graph = part.to_graph()
    if schedule == "one_f_one_b":
        # 1F1B needs n_micro >= n_stages for a full pipe; report the count
        # actually scheduled, not the request
        n_units = max(n_units, part.n)
    with rec.span("deploy.place", method=method) as sp_place:
        result = optimize_placement(graph, noc, method=method, seed=seed,
                                    budget=budget, backend=backend,
                                    objective=objective, recorder=recorder,
                                    device=device, **method_kw)

    rounds_run = 0
    with rec.span("deploy.copartition", iters=copartition_iters) as sp_copart:
        if copartition_iters > 0 and part.chip_of is not None \
                and getattr(noc, "n_chips", 1) > 1:

            def _placed_interchip(g, placement):
                return noc.interchip_bytes(
                    noc.evaluate(g, placement).link_traffic)

            best = (part, graph, result)
            best_key = (result.objective_cost,
                        _placed_interchip(graph, result.placement))
            cur_part, cur_graph, cur_result = part, graph, result
            for _ in range(copartition_iters):
                cut_w = _measured_cut_weights(cur_part, cur_graph,
                                              cur_result.placement, noc)
                cand = partition_model(profiles, n_usable, strategy, core,
                                       topology=noc, cut_weights=cut_w)
                if cand.n == cur_part.n and \
                        np.array_equal(cand.chip_of, cur_part.chip_of):
                    break                     # allocation fixed point
                cand_graph = cand.to_graph()
                cand_result = optimize_placement(
                    cand_graph, noc, method=method, seed=seed, budget=budget,
                    backend=backend, objective=objective, recorder=recorder,
                    device=device, **method_kw)
                rounds_run += 1
                cand_key = (cand_result.objective_cost,
                            _placed_interchip(cand_graph,
                                              cand_result.placement))
                cur_part, cur_graph, cur_result = \
                    cand, cand_graph, cand_result
                if cand_key < best_key:
                    best_key, best = cand_key, (cand, cand_graph, cand_result)
            part, graph, result = best

    with rec.span("deploy.schedule", schedule=schedule) as sp_schedule:
        times = [s.latency(part.core) for s in part.slices]
        if contention_feedback and schedule != "none":
            # placed NoC contention: seconds each core spends serializing the
            # traffic routed through it, added to the slice it hosts
            # (contention is nonnegative, so makespan can only grow vs the
            # analytic path)
            comm_t = noc.core_comm_time(noc.evaluate(graph, result.placement))
            flat = np.asarray(comm_t, dtype=float).reshape(-1)
            times = [t + float(flat[int(p)])
                     for t, p in zip(times, result.placement)]
        sched = _schedule(times, schedule, n_units, bwd_ratio, training)
    stage_times = {"profile": sp_profile.duration_s,
                   "partition": sp_partition.duration_s,
                   "place": sp_place.duration_s,
                   "schedule": sp_schedule.duration_s}
    if rounds_run:
        stage_times["copartition"] = sp_copart.duration_s
    if recorder is not None:
        recorder.count("deploy.deployments")
    return DeploymentPlan(
        model=name, noc=noc, profiles=profiles, partition=part, graph=graph,
        placement=result, schedule_name=schedule, schedule=sched,
        n_units=n_units,
        stage_times_s=stage_times,
        contention_feedback=contention_feedback and schedule != "none",
        copartition_iters=rounds_run)
