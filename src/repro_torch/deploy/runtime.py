"""Online re-placement under faults and traffic drift (the robustness loop).

Every other flow in the repo is a one-shot offline optimization over a static
traffic matrix. This module treats the deployed placement as a *live*
artifact: a scenario feeds the controller synthetic traffic drift
(diurnal/bursty modulation of the logical graph's edge volumes, or a
pluggable trace), link/core fault events and repairs; the controller monitors
the placement's objective against the healthy baseline and, when degradation
crosses a threshold (or a fault makes the placement outright infeasible),
recovers it:

1. **Warm re-place** — re-run the search warm-started from the live placement
   (``init=``) under the base objective extended with a ``migration`` term
   (:func:`repro_torch.deploy.objective.with_migration`) charging byte-hops to move
   each unit's resident state — so recovery trades quality against the cost
   of actually moving neuron/weight state between near-storage cores.
2. **Escalate** — if the recovered objective is still above the degradation
   band, retry with the budget multiplied by ``escalation`` (up to
   ``max_retries`` times).
3. **Re-partition** — when a *core* drops (or is repaired), chip capacities
   changed, so the whole ``deploy_model`` flow re-runs on the degraded fabric
   (the ``copartition_iters`` machinery included) instead of patching the
   placement.
4. **Cold fallback** — a fresh cold search (no warm start, no migration
   penalty) runs last; the controller keeps whichever of warm/cold scores
   better, counting the cold option's full state movement against it.

Every event, decision and recovery is emitted through :mod:`repro_torch.obs`
(``runtime.*`` spans/events/counters); with the recorder detached the loop is
bit-identical — all control decisions read deterministic objective values and
seeded RNG streams only. Scenarios come from :func:`parse_scenario` (compact
spec grammar or JSON, see the README "Robustness" section) or are built
programmatically from :class:`ScenarioEvent`.

The searches run on ``device`` (``None``: the card), where ``backend=None``
scores through the port's default there (``"cuda"``: float32 on the card;
``"batch"``: numpy float64 on the CPU, where every decision matches the JAX
package's step for step). The monitor and every recorded objective are the
host float64 ``Topology.evaluate``.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from ..core.graph import LogicalGraph
from ..core.topology import InfeasibleTopologyError, degrade
from ..obs import NULL_RECORDER
from .engine import deploy_model
from .objective import MigrationSpec, as_objective, with_migration

#: Event kinds a scenario may contain (besides per-step drift).
EVENT_KINDS = ("drop_link", "drop_node", "repair_link", "repair_node")

#: Built-in drift generators (first element of a drift spec tuple).
DRIFT_KINDS = ("diurnal", "bursty")


@dataclasses.dataclass(frozen=True)
class ScenarioEvent:
    """One discrete scenario event: at step ``t``, fail or repair ``target``
    (a directed link id for ``*_link`` kinds, a core id for ``*_node``)."""
    t: int
    kind: str
    target: int

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {self.kind!r}; "
                             f"choose from {EVENT_KINDS}")
        if self.t < 0:
            raise ValueError(f"event step must be >= 0, got {self.t}")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A deterministic timeline the runtime loop replays.

    ``drift`` is ``None`` (static traffic), a tuple
    ``("diurnal", amplitude, period)`` / ``("bursty", amplitude, prob)``
    driven by ``drift_seed``, or any callable ``(graph, t) -> LogicalGraph``
    (the pluggable-trace hook; callables are not JSON-serializable).
    """
    steps: int
    events: tuple = ()
    drift: object = None
    drift_seed: int = 0

    def __post_init__(self):
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0, got {self.steps}")
        object.__setattr__(self, "events", tuple(self.events))
        for ev in self.events:
            if not isinstance(ev, ScenarioEvent):
                raise TypeError(f"events must be ScenarioEvent, got {ev!r}")
            if ev.t >= self.steps:
                raise ValueError(f"event at step {ev.t} beyond steps="
                                 f"{self.steps}")
        d = self.drift
        if d is not None and not callable(d):
            d = tuple(d)
            if len(d) != 3 or d[0] not in DRIFT_KINDS:
                raise ValueError(
                    f"drift spec must be ({'|'.join(DRIFT_KINDS)}, "
                    f"amplitude, period|prob), got {self.drift!r}")
            object.__setattr__(self, "drift",
                               (d[0], float(d[1]), float(d[2])))

    def events_at(self, t: int) -> tuple:
        return tuple(ev for ev in self.events if ev.t == t)

    def to_dict(self) -> dict:
        drift = self.drift
        if callable(drift):
            drift = f"<callable {getattr(drift, '__name__', 'drift')}>"
        return {"steps": self.steps, "drift": drift,
                "drift_seed": self.drift_seed,
                "events": [dataclasses.asdict(ev) for ev in self.events]}


_FAULT_KIND = {"link": ("drop_link", "repair_link"),
               "node": ("drop_node", "repair_node")}


def parse_faults(spec: str) -> dict:
    """``--faults`` grammar: ``"link:3,node:7"`` -> ``{"links": [3],
    "nodes": [7]}`` — faults present from step zero."""
    out = {"links": [], "nodes": []}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"bad fault {part!r} (want link:<id> or "
                             "node:<id>)")
        kind, _, ident = part.partition(":")
        kind = kind.strip().lower()
        if kind not in _FAULT_KIND:
            raise ValueError(f"bad fault kind {kind!r} in {spec!r} "
                             "(want link|node)")
        out["links" if kind == "link" else "nodes"].append(int(ident))
    return out


def parse_scenario(spec) -> Scenario:
    """Normalize a scenario spec into a :class:`Scenario`.

    Accepts a :class:`Scenario`, a JSON file path, a JSON object string, or
    the compact grammar (semicolon-separated clauses)::

        steps=12;drift=diurnal:0.4:8;fault=link:21@3;repair=link:21@9
        steps=8;drift=bursty:2.0:0.25;seed=7;fault=node:5@2

    JSON form mirrors :meth:`Scenario.to_dict`::

        {"steps": 12, "drift": ["diurnal", 0.4, 8], "drift_seed": 0,
         "events": [{"t": 3, "kind": "drop_link", "target": 21}]}
    """
    if isinstance(spec, Scenario):
        return spec
    if isinstance(spec, dict):
        return _scenario_from_dict(spec)
    text = str(spec).strip()
    if os.path.exists(text) or text.endswith(".json"):
        with open(text) as f:
            return _scenario_from_dict(json.load(f))
    if text.startswith("{"):
        return _scenario_from_dict(json.loads(text))
    steps, drift, drift_seed, events = 0, None, 0, []
    for clause in text.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if "=" not in clause:
            raise ValueError(f"bad scenario clause {clause!r} in {spec!r} "
                             "(want key=value)")
        key, _, val = clause.partition("=")
        key = key.strip().lower()
        if key == "steps":
            steps = int(val)
        elif key == "seed":
            drift_seed = int(val)
        elif key == "drift":
            parts = val.split(":")
            if len(parts) != 3:
                raise ValueError(f"bad drift {val!r} (want kind:amp:period)")
            drift = (parts[0].strip().lower(), float(parts[1]),
                     float(parts[2]))
        elif key in ("fault", "repair"):
            body, _, t = val.partition("@")
            if not t:
                raise ValueError(f"bad event {clause!r} (want "
                                 f"{key}=link:<id>@<step>)")
            kind, _, ident = body.partition(":")
            kind = kind.strip().lower()
            if kind not in _FAULT_KIND:
                raise ValueError(f"bad event target kind {kind!r} in "
                                 f"{clause!r} (want link|node)")
            ev_kind = _FAULT_KIND[kind][0 if key == "fault" else 1]
            events.append(ScenarioEvent(int(t), ev_kind, int(ident)))
        else:
            raise ValueError(f"unknown scenario clause key {key!r} in "
                             f"{spec!r}")
    return Scenario(steps=steps, events=tuple(events), drift=drift,
                    drift_seed=drift_seed)


def _scenario_from_dict(d: dict) -> Scenario:
    drift = d.get("drift")
    if isinstance(drift, list):
        drift = tuple(drift)
    events = tuple(ScenarioEvent(int(e["t"]), str(e["kind"]),
                                 int(e["target"]))
                   for e in d.get("events", ()))
    return Scenario(steps=int(d.get("steps", 0)), events=events, drift=drift,
                    drift_seed=int(d.get("drift_seed", 0)))


# ---------------------------------------------------------------------------
# traffic drift
# ---------------------------------------------------------------------------

def drift_graph(graph: LogicalGraph, drift, t: int,
                seed: int = 0) -> LogicalGraph:
    """``graph`` with edge volumes modulated for step ``t``.

    * ``("diurnal", amp, period)`` — each edge follows its own phase of a
      ``1 + amp·sin(2π(t/period + φ_e))`` day curve (φ_e seeded per edge), so
      the *relative* traffic pattern shifts over the day instead of scaling
      uniformly.
    * ``("bursty", amp, prob)`` — per step, each edge independently bursts to
      ``1 + amp``× volume with probability ``prob`` (seeded per step).
    * callable — ``drift(graph, t) -> LogicalGraph`` (pluggable trace).

    Deterministic in ``(drift, t, seed, graph shape)``; volumes are floored
    at 5% of baseline so the graph never degenerates.
    """
    if drift is None or t < 0:
        return graph
    if callable(drift):
        return drift(graph, t)
    kind, amp, param = drift
    src, dst, _ = graph.edge_arrays()       # row-major, same order as .edges
    if not src.size:
        return graph
    if kind == "diurnal":
        phase = np.random.default_rng(seed).random(src.size)
        factors = 1.0 + amp * np.sin(
            2.0 * np.pi * (t / max(param, 1e-9) + phase))
    elif kind == "bursty":
        rng = np.random.default_rng((seed + 1) * 1_000_003 + t)
        factors = np.where(rng.random(src.size) < param, 1.0 + amp, 1.0)
    else:
        raise ValueError(f"unknown drift kind {kind!r}; "
                         f"choose from {DRIFT_KINDS}")
    factors = np.maximum(factors, 0.05)
    adj = np.array(graph.adj, dtype=np.float64)
    adj[src, dst] *= factors
    return LogicalGraph(adj, graph.compute, graph.memory,
                        names=graph.names, chip_of=graph.chip_of)


# ---------------------------------------------------------------------------
# the control loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScenarioResult:
    """What a scenario run produced: one sample per step, one record per
    recovery, and the final live deployment state."""
    scenario: dict                  # Scenario.to_dict()
    samples: list                   # per-step monitor samples
    recoveries: list                # one dict per re-placement decision
    final_placement: np.ndarray
    final_objective: float
    baseline_objective: float       # healthy reference at scenario end
    max_degradation: float          # worst monitored obj/baseline - 1
    n_replacements: int
    n_cold_fallbacks: int
    moved_state_bytes: float        # total bytes migrated over the scenario
    initial_placement: np.ndarray = None
    initial_graph: object = None    # unperturbed LogicalGraph at deploy time
    final_graph: object = None      # unperturbed LogicalGraph at scenario end

    def to_dict(self) -> dict:
        return {
            "scenario": self.scenario,
            "samples": list(self.samples),
            "recoveries": list(self.recoveries),
            "initial_placement": [int(c) for c in self.initial_placement],
            "final_placement": [int(c) for c in self.final_placement],
            "final_objective": float(self.final_objective),
            "baseline_objective": float(self.baseline_objective),
            "max_degradation": float(self.max_degradation),
            "n_replacements": int(self.n_replacements),
            "n_cold_fallbacks": int(self.n_cold_fallbacks),
            "moved_state_bytes": float(self.moved_state_bytes),
        }


def _objective_of(obj, topo, graph, placement) -> float:
    return obj.from_metrics(topo.evaluate(graph, placement), topo, placement)


def run_scenario(model, noc, scenario, *,
                 method: str = "simulated_annealing",
                 objective="comm_cost",
                 threshold: float = 0.15,
                 migration_weight: float = 1.0,
                 budget: int = 256,
                 deploy_budget: int | None = None,
                 escalation: float = 4.0,
                 max_retries: int = 2,
                 seed: int = 0,
                 compare_cold: bool = False,
                 cold_budget: int | None = None,
                 warm_kw: dict | None = None,
                 recorder=None,
                 plan=None,
                 device=None,
                 **deploy_kw) -> ScenarioResult:
    """Deploy ``model`` on ``noc`` and replay ``scenario`` through the
    online re-placement control loop; returns a :class:`ScenarioResult`.

    ``threshold`` is the tolerated objective degradation (ratio over the
    healthy baseline) before a re-place triggers; ``migration_weight`` scales
    the state-movement penalty of warm re-placement (0 disables it —
    bit-identical to migration-free scoring); ``budget`` is the warm search's
    evaluation budget (``deploy_budget`` overrides it for the initial
    deployment and any re-partition — spend more there so the live placement
    starts converged and recoveries respond to the fault, not to leftover
    optimization slack), multiplied by ``escalation`` on each retry (at most
    ``max_retries``), after which a cold search (fresh start, no migration
    penalty, same escalated budget) is tried; warm and cold compete under
    the migration-aware selection key (base objective plus the weighted
    byte-hop cost of moving there), so the cold option's near-total state
    movement counts against it. ``method`` must be a warm-startable search
    (SA / genetic / RS). ``warm_kw`` passes method-specific kwargs to the
    warm re-placement searches only (e.g. ``{"t0": 0.005}`` anneals repair
    runs much cooler than a from-scratch SA, so they perturb the live
    placement locally instead of scrambling it).

    ``compare_cold=True`` additionally runs a from-scratch re-optimization at
    every recovery and records its objective and moved-state bytes next to
    the warm result — the data behind the bounded-degradation acceptance
    claim in ``benchmarks/fault_replace.py``.

    Control decisions read deterministic objective values and seeded RNG
    streams only, so results are bit-identical with the recorder attached or
    detached (``tests/test_runtime.py`` pins this).

    ``plan`` (a :class:`repro_torch.deploy.DeploymentPlan`) skips the initial
    deployment and replays the scenario on an existing live plan — e.g. one
    re-materialized from the placement service's cache
    (:func:`repro_torch.deploy.engine.instantiate_plan`); ``model`` may then
    be ``None`` (re-partitions reuse the plan's profiles).

    ``device`` (``None``: the card) is where every search of the scenario
    runs.
    """
    scenario = parse_scenario(scenario)
    rec = recorder if recorder is not None else NULL_RECORDER
    base_obj = as_objective(objective)
    if base_obj.has_migration:
        raise ValueError("pass the base objective; the runtime adds the "
                         "migration term itself (migration_weight=)")
    deploy_kw.setdefault("schedule", "none")

    d_budget = deploy_budget if deploy_budget is not None else budget
    if plan is None:
        with rec.span("runtime.deploy",
                      model=getattr(model, "name", "profiled")):
            plan = deploy_model(model, noc, method=method,
                                objective=objective, seed=seed,
                                budget=d_budget, recorder=recorder,
                                device=device, **deploy_kw)
    profiles = plan.profiles
    base_graph = plan.graph                 # unperturbed logical units
    initial_graph = base_graph
    placement = np.asarray(plan.placement.placement, dtype=int)
    initial_placement = placement
    topo = noc                              # live (possibly degraded) fabric
    # a pre-degraded noc (e.g. CLI --faults) seeds the live fault sets, so
    # later events stack on top of it instead of silently repairing it
    dropped_links: set = {int(l) for l in noc.dropped_links()}
    dropped_nodes: set = {int(c) for c in noc.dropped_nodes()}

    graph = drift_graph(base_graph, scenario.drift, 0, scenario.drift_seed) \
        if scenario.steps else base_graph
    baseline = _objective_of(base_obj, topo, graph, placement)
    samples, recoveries = [], []
    n_replace = n_cold = 0
    moved_total = 0.0
    max_deg = 0.0

    def _recover(t: int, reason: str, forced_repartition: bool,
                 before: float):
        """One recovery episode; returns the new placement (and may rebuild
        the partition — then ``base_graph``/``graph`` are refreshed too)."""
        nonlocal base_graph, graph, placement, baseline
        nonlocal n_replace, n_cold, moved_total
        from ..core.placement import optimize_placement

        old_placement = placement
        spec = MigrationSpec.from_graph(base_graph, old_placement)
        record = {"t": t, "reason": reason, "attempts": [],
                  "repartitioned": bool(forced_repartition)}

        if forced_repartition:
            # chip capacities changed: re-run the whole engine flow (the
            # copartition machinery included) on the degraded fabric
            rp_budget = d_budget if deploy_budget is not None \
                else int(budget * escalation)
            with rec.span("runtime.repartition", t=t):
                plan2 = deploy_model(profiles, topo, method=method,
                                     objective=objective, seed=seed,
                                     budget=rp_budget, recorder=recorder,
                                     device=device, **deploy_kw)
            base_graph = plan2.graph
            graph = drift_graph(base_graph, scenario.drift, t,
                                scenario.drift_seed)
            new_placement = np.asarray(plan2.placement.placement, dtype=int)
            # units changed shape: count the whole resident state as moved
            # unless the unit count (and therefore the state map) survived
            if len(spec.state_bytes) == base_graph.n:
                moved = spec.moved_bytes(new_placement)
            else:
                moved = float(np.asarray(base_graph.memory,
                                         dtype=np.float64).sum())
            cost = _objective_of(base_obj, topo, graph, new_placement)
            record["attempts"].append(
                {"mode": "repartition", "budget": int(rp_budget),
                 "objective": cost, "moved_state_bytes": moved})
        else:
            warm_obj = with_migration(base_obj, spec, migration_weight)

            def _total(base_cost: float, moved_cand) -> float:
                """The controller's selection key: service quality plus the
                migration-weighted byte-hop cost of actually moving there.
                (``moved_cand`` is a placement; with weight 0 this collapses
                to the base objective.)"""
                if migration_weight == 0.0:
                    return base_cost
                return base_cost + migration_weight * float(
                    spec.cost(topo.hops_matrix(), moved_cand))

            attempt_budget = budget
            new_placement, cost, moved = None, np.inf, 0.0
            best_total = np.inf
            for attempt in range(max_retries + 1):
                with rec.span("runtime.replace", t=t, attempt=attempt,
                              budget=attempt_budget):
                    res = optimize_placement(
                        graph, topo, method=method, seed=seed + attempt,
                        budget=attempt_budget, objective=warm_obj,
                        init=old_placement, recorder=recorder,
                        device=device, **(warm_kw or {}))
                cand = np.asarray(res.placement, dtype=int)
                cand_cost = _objective_of(base_obj, topo, graph, cand)
                cand_total = _total(cand_cost, cand)
                if cand_total < best_total:
                    new_placement, cost = cand, cand_cost
                    best_total = cand_total
                    moved = spec.moved_bytes(cand)
                record["attempts"].append(
                    {"mode": "warm", "budget": int(attempt_budget),
                     "objective": cand_cost,
                     "moved_state_bytes": spec.moved_bytes(cand)})
                if cost <= (1.0 + threshold) * baseline:
                    break
                attempt_budget = int(attempt_budget * escalation)
            if cost > (1.0 + threshold) * baseline:
                # escalation exhausted: try a fresh cold search; it is
                # adopted only if its quality gain pays for the state it
                # moves (same migration-aware selection key as the warm
                # attempts — the cold option moves nearly everything)
                with rec.span("runtime.cold_fallback", t=t,
                              budget=attempt_budget):
                    res = optimize_placement(
                        graph, topo, method=method, seed=seed,
                        budget=attempt_budget, objective=objective,
                        recorder=recorder, device=device)
                cand = np.asarray(res.placement, dtype=int)
                cand_cost = _objective_of(base_obj, topo, graph, cand)
                record["attempts"].append(
                    {"mode": "cold", "budget": int(attempt_budget),
                     "objective": cand_cost,
                     "moved_state_bytes": spec.moved_bytes(cand)})
                if _total(cand_cost, cand) < best_total:
                    new_placement, cost = cand, cand_cost
                    moved = spec.moved_bytes(cand)
                    n_cold += 1
                    rec.count("runtime.cold_fallbacks")

        if compare_cold:
            cb = cold_budget if cold_budget is not None \
                else int(budget * escalation ** max_retries)
            with rec.span("runtime.cold_reference", t=t, budget=cb):
                ref = optimize_placement(graph, topo, method=method,
                                         seed=seed + 10_000, budget=cb,
                                         objective=objective,
                                         recorder=recorder, device=device)
            ref_p = np.asarray(ref.placement, dtype=int)
            record["cold_reference"] = {
                "objective": _objective_of(base_obj, topo, graph, ref_p),
                "moved_state_bytes": spec.moved_bytes(ref_p)
                if len(spec.state_bytes) == base_graph.n
                else float(np.asarray(base_graph.memory,
                                      dtype=np.float64).sum()),
                "budget": int(cb),
            }

        n_replace += 1
        moved_total += moved
        placement = new_placement
        record.update(
            objective_before=None if not np.isfinite(before) else before,
            objective_after=cost, moved_state_bytes=moved)
        recoveries.append(record)
        rec.count("runtime.replacements")
        rec.event("runtime.recovered", t=t, reason=reason,
                  objective=cost, moved_state_bytes=moved)
        baseline = cost
        return record

    for t in range(scenario.steps):
        with rec.span("runtime.step", t=t):
            graph = drift_graph(base_graph, scenario.drift, t,
                                scenario.drift_seed)
            forced, repartition = False, False
            for ev in scenario.events_at(t):
                rec.event("runtime.fault" if ev.kind.startswith("drop")
                          else "runtime.repair", t=t, kind=ev.kind,
                          target=ev.target)
                rec.count(f"runtime.{ev.kind}")
                if ev.kind == "drop_link":
                    dropped_links.add(int(ev.target))
                elif ev.kind == "repair_link":
                    dropped_links.discard(int(ev.target))
                elif ev.kind == "drop_node":
                    dropped_nodes.add(int(ev.target))
                    repartition = True
                elif ev.kind == "repair_node":
                    dropped_nodes.discard(int(ev.target))
                    repartition = True
                topo = degrade(noc, links=sorted(dropped_links),
                               nodes=sorted(dropped_nodes))
                forced = True

            try:
                cur = _objective_of(base_obj, topo, graph, placement)
                infeasible = False
            except InfeasibleTopologyError:
                cur, infeasible = float("inf"), True
            ratio = (cur / baseline - 1.0) if baseline > 0 else 0.0
            if np.isfinite(ratio):
                max_deg = max(max_deg, ratio)
            action = "none"
            if infeasible or repartition:
                rec.event("runtime.monitor", t=t, objective=None,
                          degradation=None, infeasible=True)
                _recover(t, "infeasible_placement" if infeasible
                         else "chip_capacity_change", True, cur)
                action = "repartition"
            else:
                rec.event("runtime.monitor", t=t, objective=cur,
                          degradation=ratio, infeasible=False)
                if ratio > threshold:
                    _recover(t, "degradation", False, cur)
                    action = "replace"
                else:
                    # repairs/drift can leave the live placement better than
                    # the remembered baseline; track the best healthy level
                    # so later faults are judged against it
                    baseline = min(baseline, cur)
            samples.append({"t": t, "objective": None if infeasible else cur,
                            "degradation": None if infeasible else ratio,
                            "faults": {"links": sorted(dropped_links),
                                       "nodes": sorted(dropped_nodes)},
                            "action": action})

    final = _objective_of(base_obj, topo, graph, placement) \
        if scenario.steps else baseline
    return ScenarioResult(
        scenario=scenario.to_dict(), samples=samples, recoveries=recoveries,
        final_placement=placement, final_objective=float(final),
        baseline_objective=float(baseline), max_degradation=float(max_deg),
        n_replacements=n_replace, n_cold_fallbacks=n_cold,
        moved_state_bytes=float(moved_total),
        initial_placement=initial_placement, initial_graph=initial_graph,
        final_graph=base_graph)
