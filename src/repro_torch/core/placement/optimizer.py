"""End-to-end placement optimization entry point.

``optimize_placement(graph, noc, method=...)`` returns a uniform
:class:`PlacementResult`. ``noc`` is any :class:`..topology.Topology`.
Every method of the reference is ported.

``device`` (``None``: the card) is where PPO and the policy baseline
train, where the torch/cuda scorers run and where the device searches run.
``backend=None`` resolves to ``"cuda"`` on a CUDA device (float32 scoring
on the card; the link-traffic kernel for link-level objectives) and to
``"batch"`` (numpy float64, as in the reference) on the CPU. ``backend="device"`` (``simulated_annealing``/
``sa``, ``genetic``/``ga`` and ``multilevel``'s coarse level) switches to the
device-resident searches of :mod:`.device_search` — O(degree) delta costs
through the ``delta_cost`` kernel, plus ``restarts=N`` parallel SA chains —
a float32 method variant, not a replay of the host backends. The host
searches draw from numpy RNG, so on ``backend="batch"`` they match the
reference seed for seed.

``objective`` selects what the searches minimize (see
:mod:`repro_torch.deploy.objective`); the deterministic constructors
(``zigzag``, ``sigmate``, ``greedy``) build the same placement whatever the
objective, only their reported ``objective_cost`` changes. The final metrics
come from the topology's own ``evaluate``, the host reference loop.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np

from ...deploy.objective import as_objective
from ...device import resolve_backend, resolve_device
from ...obs import maybe_span
from . import baselines, device_search, multilevel, population
from .policy_baseline import PolicyConfig, run_policy_baseline
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

# arguments optimize_placement supplies itself — never forwardable via **kw
_OWN_PARAMS = frozenset({"graph", "noc", "seed", "backend", "objective",
                            "recorder", "budget", "generations", "iters",
                            "device"})


def _check_method(method: str) -> str:
    method = METHOD_ALIASES.get(method, method)
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    return method


def _fn_kwargs(fn) -> frozenset:
    """Tunable kwargs a search function accepts, minus the ones
    :func:`optimize_placement` sets itself."""
    return frozenset(inspect.signature(fn).parameters) - _OWN_PARAMS


def method_kwargs(method: str, backend: str | None = None,
                  coarse_method: str | None = None) -> frozenset:
    """The ``**method_kw`` names :func:`optimize_placement` accepts for
    ``method`` (alias-resolved) under ``backend``.

    ``iters``/``generations`` are always accepted (they alias ``budget``);
    deterministic constructors take none; ``multilevel`` additionally accepts
    everything its ``coarse_method`` does (pass the requested coarse method,
    default ``simulated_annealing``); ``ppo`` and ``policy`` take the
    :class:`PPOConfig` / :class:`PolicyConfig` fields
    :func:`optimize_placement` does not set itself, plus ``cfg`` and
    ``init``.
    """
    method = _check_method(method)
    budgets = frozenset({"iters", "generations"})
    if method in ("zigzag", "sigmate", "greedy"):
        return frozenset()
    if method == "random_search":
        return _fn_kwargs(baselines.random_search) | budgets
    if method == "simulated_annealing":
        fn = (device_search.simulated_annealing_device
              if backend == "device" else baselines.simulated_annealing)
        return _fn_kwargs(fn) | budgets
    if method == "population_random_search":
        return _fn_kwargs(population.random_search_population) | budgets
    if method == "population_simulated_annealing":
        return _fn_kwargs(population.simulated_annealing_population) | budgets
    if method == "genetic":
        fn = (device_search.genetic_device if backend == "device"
              else population.genetic_population)
        return _fn_kwargs(fn) | budgets
    if method == "multilevel":
        own = frozenset({"coarsen_to", "refine_iters", "coarse_method"})
        coarse = METHOD_ALIASES.get(coarse_method or "simulated_annealing",
                                    coarse_method or "simulated_annealing")
        if coarse == "multilevel":        # no recursive coarsening
            return own | budgets
        return own | method_kwargs(coarse, backend=backend) | budgets
    cfg_cls = PPOConfig if method == "ppo" else PolicyConfig
    fields = frozenset(f.name for f in dataclasses.fields(cfg_cls))
    return (fields - frozenset({"iterations", "seed", "backend",
                                "objective"})) | frozenset({"cfg", "init"})


def validate_method_kw(method: str, kw: dict,
                       backend: str | None = None) -> None:
    """Raise ``TypeError`` listing the accepted kwargs when ``kw`` contains
    names ``method`` does not take."""
    allowed = method_kwargs(method, backend=backend,
                            coarse_method=kw.get("coarse_method"))
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

    ``recorder`` (a :class:`repro_torch.obs.Recorder`) turns on
    search-trajectory telemetry: the whole dispatch runs inside a
    ``place.<method>`` span, every search method emits per-iteration events
    (cost, best-so-far, acceptance/temperature/diversity where meaningful),
    and the scorer counts evaluations and dispatches. Detached (``None``, the
    default) results are identical.

    On a multi-chip topology with a chip-aware partition (``graph.chip_of``),
    the searches are seeded with :func:`baselines.chip_init` — slices
    pre-binned to their assigned chip's cores: SA/genetic/RS get it as their
    ``init``; for ppo the seed joins the candidate set the returned best
    placement is drawn from, as does a user-supplied ``init``. An explicit
    ``init=`` kwarg always wins. The deterministic flat constructors
    (``zigzag``/``sigmate``/``greedy``) stay chip-oblivious baselines.
    """
    history = None
    method = _check_method(method)
    validate_method_kw(method, kw, backend=backend)
    dev = resolve_device(device)
    bk = resolve_backend(backend, dev)
    ob = objective if objective is not None else "comm_cost"
    if bk == "device" and method not in ("simulated_annealing", "genetic",
                                         "multilevel"):
        raise ValueError(
            f"backend='device' implements simulated_annealing (sa) and "
            f"genetic (ga) only, not {method!r}")
    if method in ("ppo", "policy") and \
            getattr(noc, "n_alive_cores", noc.n_cores) != noc.n_cores:
        raise ValueError(
            f"method {method!r} does not support degraded topologies — its "
            "discretizer can land on dropped cores; use "
            "simulated_annealing / genetic / random_search (the methods the "
            "online re-placement loop warm-starts) on faulty fabrics")
    init_methods = ("random_search", "simulated_annealing", "genetic",
                    "population_random_search",
                    "population_simulated_annealing")
    chip_seed = (_chip_seed(graph, noc)
                 if method in init_methods + ("ppo", "policy") else None)
    if chip_seed is not None and method in init_methods:
        kw.setdefault("init", chip_seed)
    # RL methods have no init hook; a user-supplied ``init`` (e.g. a fast
    # device-SA placement) joins the best-of candidate set like the chip seed
    rl_init = (kw.pop("init", None) if method in ("ppo", "policy") else None)
    with maybe_span(recorder, f"place.{method}", seed=seed,
                    backend=bk) as sp:
        if method == "zigzag":
            placement = baselines.zigzag(graph.n, noc)
        elif method == "sigmate":
            placement = baselines.sigmate(graph.n, noc)
        elif method == "random_search":
            placement = baselines.random_search(
                graph, noc, iters=kw.pop("iters", None) or budget or 2000,
                seed=seed, backend=bk, objective=ob, recorder=recorder,
                device=dev, **kw)
        elif method == "simulated_annealing":
            iters = kw.pop("iters", None) or budget or 5000
            if bk == "device":
                placement = device_search.simulated_annealing_device(
                    graph, noc, iters=iters, seed=seed, objective=ob,
                    recorder=recorder, device=dev, **kw)
            else:
                placement = baselines.simulated_annealing(
                    graph, noc, iters=iters, seed=seed, backend=bk,
                    objective=ob, recorder=recorder, device=dev, **kw)
        elif method == "population_random_search":
            placement = population.random_search_population(
                graph, noc, iters=kw.pop("iters", None) or budget or 2000,
                seed=seed, backend=bk, objective=ob, recorder=recorder,
                device=dev, **kw)
        elif method == "population_simulated_annealing":
            # budget counts total evaluations for every method; population SA
            # performs pop_size evaluations per lock-step iteration
            pop = max(1, kw.get("pop_size", 16))
            iters = kw.pop("iters", None) or max(1, (budget or 16000) // pop)
            placement = population.simulated_annealing_population(
                graph, noc, iters=iters, seed=seed, backend=bk, objective=ob,
                recorder=recorder, device=dev, **kw)
        elif method == "genetic":
            # one whole-population scoring call per generation (+ the initial
            # one), so budgets below 2*pop_size still spend up to 2*pop_size
            # evaluations; genetic_population validates pop_size itself
            pop = kw.setdefault("pop_size", 64)
            gens = kw.pop("generations", None)
            if gens is None:
                gens = max(1, (budget or 6400) // max(pop, 1) - 1)
            if bk == "device":
                placement = device_search.genetic_device(
                    graph, noc, generations=gens, seed=seed,
                    objective=ob, recorder=recorder, device=dev, **kw)
            else:
                placement = population.genetic_population(
                    graph, noc, generations=gens, seed=seed, backend=bk,
                    objective=ob, recorder=recorder, device=dev, **kw)
        elif method == "multilevel":
            # coarsen -> coarse search -> refine; passes the *original*
            # backend/objective (possibly None) through so its
            # coarsen_to >= n delegation replays the flat call bit-for-bit
            placement = multilevel.multilevel_placement(
                graph, noc, seed=seed, budget=budget, backend=backend,
                objective=objective, recorder=recorder, device=dev, **kw)
        elif method == "greedy":
            placement = baselines.greedy(graph, noc)
        elif method == "policy":
            cfg = kw.pop("cfg", None)
            if cfg is None:
                cfg = PolicyConfig(iterations=budget or 40, seed=seed,
                                   backend=bk, objective=ob, **kw)
            else:
                _reject_cfg_extras("policy", cfg, kw)
                cfg = _override_cfg(cfg, backend, objective)
            out = run_policy_baseline(graph, noc, cfg, recorder=recorder,
                                      device=dev)
            placement, history = out["best_placement"], out["history"]
            ob = cfg.objective
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
        if method in ("ppo", "policy"):
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
