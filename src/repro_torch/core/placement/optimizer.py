"""End-to-end placement optimization entry point.

``optimize_placement(graph, noc, method=...)`` returns a uniform
:class:`PlacementResult`. ``noc`` is any :class:`..topology.Topology`.
This slice of the port implements ``ppo`` (the paper's RL placer) and the
``zigzag``/``sigmate`` constructors; every other method of the reference
raises ``NotImplementedError`` naming the ROADMAP item that ports it.

``device`` (``None``: the card) is where PPO trains and where the torch/cuda
scorers run. ``backend=None`` resolves to ``"cuda"`` on a CUDA device (the
link-traffic kernel for link-level objectives) and to ``"batch"`` (numpy
float64, as in the reference) on the CPU. ``objective`` selects what the
searches minimize (see :mod:`repro_torch.deploy.objective`); the constructors
build the same placement whatever the objective, only their reported
``objective_cost`` changes. The final metrics come from the topology's own
``evaluate``, the host reference loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ...deploy.objective import as_objective
from ...device import resolve_device
from ...obs import maybe_span
from . import baselines
from .ppo import PPOConfig, run_ppo


@dataclasses.dataclass
class PlacementResult:
    method: str
    placement: np.ndarray
    comm_cost: float
    mean_hops: float
    latency: float
    throughput: float
    max_link: float
    wall_time_s: float
    history: list | None = None
    objective: str = "comm_cost"
    objective_cost: float = float("nan")

    def summary(self) -> dict:
        return {
            "method": self.method,
            "comm_cost": self.comm_cost,
            "mean_hops": self.mean_hops,
            "latency": self.latency,
            "throughput": self.throughput,
            "max_link": self.max_link,
            "wall_time_s": self.wall_time_s,
            "objective": self.objective,
            "objective_cost": self.objective_cost,
        }


METHODS = ("zigzag", "sigmate", "random_search", "simulated_annealing",
           "greedy", "policy", "ppo", "genetic",
           "population_random_search", "population_simulated_annealing",
           "multilevel")

# short spellings accepted by optimize_placement (paper/CLI shorthand)
METHOD_ALIASES = {"sa": "simulated_annealing", "ga": "genetic",
                  "rs": "random_search", "ml": "multilevel"}

#: methods of the reference not ported yet -> the ROADMAP item that ports them
NOT_PORTED = {
    "random_search": "queue 1, item 3 (host searches)",
    "simulated_annealing": "queue 1, item 3 (host searches)",
    "greedy": "queue 1, item 3 (host searches)",
    "genetic": "queue 1, item 3 (host searches)",
    "population_random_search": "queue 1, item 3 (host searches)",
    "population_simulated_annealing": "queue 1, item 3 (host searches)",
    "policy": "queue 1, item 4 (policy_baseline)",
    "multilevel": "queue 1, item 7 (multilevel placement)",
}


def _check_method(method: str) -> str:
    method = METHOD_ALIASES.get(method, method)
    if method in NOT_PORTED:
        raise NotImplementedError(
            f"placement method {method!r} is not ported yet (ROADMAP "
            f"{NOT_PORTED[method]})")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    return method


def method_kwargs(method: str) -> frozenset:
    """The ``**method_kw`` names :func:`optimize_placement` accepts for
    ``method`` (alias-resolved). Constructors take none; ``ppo`` takes the
    :class:`PPOConfig` fields :func:`optimize_placement` does not set
    itself, plus ``cfg`` and ``init``."""
    method = _check_method(method)
    if method in ("zigzag", "sigmate"):
        return frozenset()
    fields = frozenset(f.name for f in dataclasses.fields(PPOConfig))
    return (fields - frozenset({"iterations", "seed", "backend",
                                "objective"})) | frozenset({"cfg", "init"})


def validate_method_kw(method: str, kw: dict,
                       backend: str | None = None) -> None:
    """Raise ``TypeError`` listing the accepted kwargs when ``kw`` contains
    names ``method`` does not take."""
    allowed = method_kwargs(method)
    unknown = sorted(set(kw) - allowed)
    if unknown:
        method = METHOD_ALIASES.get(method, method)
        accepted = ", ".join(sorted(allowed)) or "none"
        raise TypeError(
            f"unknown method kwarg(s) {unknown} for placement method "
            f"{method!r} (backend={backend!r}); accepted: {accepted}")


def _chip_seed(graph, noc):
    """Chip-respecting initialization when the partition was chip-aware and
    the topology actually has chips; ``None`` otherwise."""
    if getattr(graph, "chip_of", None) is None or \
            getattr(noc, "n_chips", 1) <= 1:
        return None
    return baselines.chip_init(graph, noc)


def optimize_placement(graph, noc, method: str = "ppo", seed: int = 0,
                       budget: int | None = None, backend: str | None = None,
                       objective=None, recorder=None, device=None,
                       **kw) -> PlacementResult:
    """``backend=None`` / ``objective=None`` mean the defaults (``"cuda"`` on
    a CUDA device, ``"batch"`` on the CPU / ``"comm_cost"`` — and for ppo a
    caller-supplied ``cfg`` keeps its own values); an explicit value
    overrides everywhere, including a passed ``cfg``.

    ``recorder`` runs the dispatch inside a ``place.<method>`` span and
    collects PPO's per-iteration events and the scorer's counters.

    On a multi-chip topology with a chip-aware partition (``graph.chip_of``),
    the chip-respecting constructor :func:`baselines.chip_init` joins the
    candidate set PPO's returned placement is drawn from, as does a
    user-supplied ``init`` placement.
    """
    history = None
    method = _check_method(method)
    validate_method_kw(method, kw, backend=backend)
    dev = resolve_device(device)
    if backend == "device":
        raise NotImplementedError(
            "backend='device' (the one-dispatch device searches) is not "
            "ported yet (ROADMAP queue 1, item 6)")
    bk = backend or ("cuda" if dev.type == "cuda" else "batch")
    ob = objective if objective is not None else "comm_cost"
    if method == "ppo" and \
            getattr(noc, "n_alive_cores", noc.n_cores) != noc.n_cores:
        raise ValueError(
            f"method {method!r} does not support degraded topologies — its "
            "discretizer can land on dropped cores")
    chip_seed = _chip_seed(graph, noc) if method == "ppo" else None
    # a user-supplied ``init`` joins the best-of candidate set like the
    # chip seed
    rl_init = kw.pop("init", None) if method == "ppo" else None
    with maybe_span(recorder, f"place.{method}", seed=seed,
                    backend=bk) as sp:
        if method == "zigzag":
            placement = baselines.zigzag(graph.n, noc)
        elif method == "sigmate":
            placement = baselines.sigmate(graph.n, noc)
        else:
            cfg = kw.pop("cfg", None)
            if cfg is None:
                cfg = PPOConfig(iterations=budget or 40, seed=seed,
                                backend=bk, objective=ob, **kw)
            else:
                _reject_cfg_extras("ppo", cfg, kw)
                cfg = _override_cfg(cfg, backend, objective)
            st = run_ppo(graph, noc, cfg, recorder=recorder, device=dev)
            placement, history = st.best_placement, st.history
            ob = cfg.objective

        obj = as_objective(ob)
        m = noc.evaluate(graph, placement)
        if method == "ppo":
            # best-of candidate set: the chip-respecting constructor and any
            # user-supplied seed placement compete with the RL result
            for cand in (chip_seed, rl_init):
                if cand is None:
                    continue
                cand = np.asarray(cand, dtype=int)
                m_seed = noc.evaluate(graph, cand)
                if obj.from_metrics(m_seed, noc, cand) < \
                        obj.from_metrics(m, noc, placement):
                    placement, m = cand, m_seed
    return PlacementResult(
        method=method, placement=np.asarray(placement),
        comm_cost=m.comm_cost, mean_hops=m.mean_hops, latency=m.latency,
        throughput=m.throughput, max_link=m.max_link,
        wall_time_s=sp.duration_s, history=history,
        objective=obj.name, objective_cost=obj.from_metrics(m, noc, placement))


def _reject_cfg_extras(method, cfg, kw):
    """A passed ``cfg`` carries the full search config — loose field kwargs
    beside it are a TypeError."""
    if kw:
        raise TypeError(
            f"method {method!r}: got both cfg={type(cfg).__name__} and loose "
            f"config kwarg(s) {sorted(kw)}; fold them into the cfg "
            "(dataclasses.replace) or drop the cfg")


def _override_cfg(cfg, backend, objective):
    """Explicit optimize_placement backend/objective beat a passed cfg's."""
    repl = {}
    if backend is not None:
        repl["backend"] = backend
    if objective is not None:
        repl["objective"] = objective
    return dataclasses.replace(cfg, **repl) if repl else cfg
