"""Population-batched placement search built on :mod:`repro_torch.core.noc_batch`.

Three families:

* :func:`random_search_population` — draws the *same* permutation stream as the
  sequential ``baselines.random_search`` (same ``seed`` => same best placement)
  but scores ``pop_size`` candidates per vectorized call.
* :func:`simulated_annealing_population` — ``pop_size`` independent annealing
  chains advanced in lock-step; every step proposes one pairwise swap per chain
  and scores the whole population in one batched call. Chain 0 starts from the
  deterministic ``init`` (zigzag by default, matching the sequential SA); the
  other chains start from random injective placements, so the population also
  acts as a multi-start restart strategy.
* :func:`genetic_population` — evolutionary search: order-preserving
  permutation recombination (OX1 crossover) + pairwise-swap mutation +
  elitism, the whole population scored per generation through
  :func:`repro_torch.core.noc_batch.make_scorer` — so it works with every objective
  spec and scoring backend (numpy, torch, cuda) and on any topology
  (:class:`repro_torch.core.topology.HierarchicalMesh` multi-chip systems included).

All return the best placement found, like their sequential counterparts.
``backend=None``, the default, scores with ``"cuda"`` on a CUDA ``device``
(``None``: the card) and with ``"batch"`` on the CPU, as in
:mod:`.baselines`.
"""
from __future__ import annotations

import numpy as np

from ...device import resolve_backend
from ..noc_batch import make_scorer, validate_placements
from .baselines import core_pool, sigmate, zigzag


def random_search_population(graph, noc, iters: int = 2000,
                             pop_size: int = 256, seed: int = 0,
                             backend: str | None = None,
                             objective="comm_cost", init=None,
                             recorder=None, device=None) -> np.ndarray:
    """Paper's RS baseline, scored ``pop_size`` placements at a time.

    Consumes the RNG stream exactly like the sequential version (one
    ``rng.permutation`` per candidate, first-minimum wins), so for a given
    ``seed`` and ``objective`` it returns the same placement — only faster.
    ``init`` is scored as candidate zero before any RNG draw (the
    chip-respecting seeding hook), leaving the sampling stream unchanged.
    """
    if pop_size < 1:
        raise ValueError(f"pop_size must be >= 1, got {pop_size}")
    rng = np.random.default_rng(seed)
    score = make_scorer(noc, graph, resolve_backend(backend, device),
                        objective, recorder=recorder, device=device)
    best, best_cost = None, np.inf
    if init is not None:
        init = np.asarray(init, dtype=int)
        validate_placements(noc, init, graph.n)
        best, best_cost = init, float(score(init[None, :])[0])
    done = 0
    batch_idx = 0
    pool = core_pool(noc)
    while done < iters:
        k = min(pop_size, iters - done)
        perms = np.stack([rng.permutation(pool)[:graph.n]
                          for _ in range(k)])
        costs = score(perms)
        i = int(np.argmin(costs))
        if costs[i] < best_cost:
            best, best_cost = perms[i].copy(), float(costs[i])
        done += k
        if recorder is not None:
            recorder.event("population_rs.batch", batch=batch_idx,
                           evaluated=done, batch_min=float(costs[i]),
                           batch_mean=float(costs.mean()),
                           best_cost=best_cost)
        batch_idx += 1
    return best


def simulated_annealing_population(graph, noc, iters: int = 1000,
                                   pop_size: int = 16, t0: float = 0.05,
                                   t_end_frac: float = 1e-3, seed: int = 0,
                                   init=None, backend: str | None = None,
                                   objective="comm_cost",
                                   recorder=None, device=None) -> np.ndarray:
    """``pop_size`` independent pairwise-swap SA chains, batch-scored per step.

    Each step performs one proposed swap per chain (``pop_size`` evaluations
    per step, so ``iters × pop_size`` total — compare budgets accordingly).
    ``objective`` selects the annealed score (repro_torch.deploy.objective
    spec).
    ``recorder`` emits one ``population_sa.iter`` event per lock-step
    iteration (best/mean cost, per-step acceptance fraction, mean
    temperature); detached the loop is untouched.
    """
    if pop_size < 1:
        raise ValueError(f"pop_size must be >= 1, got {pop_size}")
    rng = np.random.default_rng(seed)
    pool = core_pool(noc)       # int when intact; alive-core array otherwise
    pool_arr = (np.arange(pool) if isinstance(pool, int)
                else np.asarray(pool))
    n, n_slots = graph.n, pool_arr.size
    score = make_scorer(noc, graph, resolve_backend(backend, device),
                        objective, recorder=recorder, device=device)

    base = np.asarray(init if init is not None else zigzag(n, noc), dtype=int)
    validate_placements(noc, base, n)        # reject bad user-supplied init
    free = np.setdiff1d(pool_arr, base)
    slots = np.empty((pop_size, n_slots), dtype=int)
    slots[0] = np.concatenate([base, free])
    for p in range(1, pop_size):
        slots[p] = rng.permutation(pool)

    cost = score(slots[:, :n])
    i0 = int(np.argmin(cost))
    best, best_cost = slots[i0, :n].copy(), float(cost[i0])
    t = np.maximum(t0 * np.maximum(cost, 1.0), 1e-9)
    cooling = t_end_frac ** (1.0 / max(iters, 1))
    rows = np.arange(pop_size)
    for it in range(iters):
        i = rng.integers(0, n_slots, pop_size)
        j = rng.integers(0, n_slots, pop_size)
        valid = ~((i == j) | ((i >= n) & (j >= n)))
        swapped = slots.copy()
        swapped[rows, i], swapped[rows, j] = slots[rows, j], slots[rows, i]
        new_cost = score(swapped[:, :n])
        delta = np.clip((cost - new_cost) / np.maximum(t, 1e-9), None, 0.0)
        accept = valid & ((new_cost <= cost) |
                          (rng.random(pop_size) < np.exp(delta)))
        slots = np.where(accept[:, None], swapped, slots)
        cost = np.where(accept, new_cost, cost)
        i1 = int(np.argmin(cost))
        if cost[i1] < best_cost:
            best, best_cost = slots[i1, :n].copy(), float(cost[i1])
        t *= cooling
        if recorder is not None:
            recorder.event("population_sa.iter", iter=it,
                           best_cost=best_cost, cur_min=float(cost[i1]),
                           cur_mean=float(cost.mean()),
                           accept_frac=float(accept.mean()),
                           temperature=float(t.mean()))
    return best


# ---------------------------------------------------------------------------
# Genetic (evolutionary) search
# ---------------------------------------------------------------------------

def _ox_crossover(rng, p1: np.ndarray, p2: np.ndarray) -> np.ndarray:
    """Order crossover (OX1) on two core permutations.

    The child copies the ``[i, j)`` segment from ``p1`` and fills the
    remaining slots with ``p2``'s cores in ``p2``'s order, starting after the
    segment and wrapping — the classic order-preserving permutation
    recombination, always yielding a valid (injective) permutation.
    """
    size = p1.size
    i, j = np.sort(rng.integers(0, size + 1, 2))
    if i == j:
        return p1.copy()
    child = np.empty(size, dtype=p1.dtype)
    child[i:j] = p1[i:j]
    fill = p2[~np.isin(p2, p1[i:j], assume_unique=True)]
    tail = size - j                       # slots after the segment, pre-wrap
    child[j:] = fill[:tail]
    child[:i] = fill[tail:]
    return child


def genetic_population(graph, noc, generations: int = 80, pop_size: int = 64,
                       elite_frac: float = 0.125, tournament: int = 3,
                       crossover_rate: float = 0.9, mutation_rate: float = 0.6,
                       seed: int = 0, init=None, backend: str | None = None,
                       objective="comm_cost", recorder=None,
                       device=None) -> np.ndarray:
    """Evolutionary placement search, whole population scored per generation.

    Chromosomes are full core permutations (length ``noc.n_cores``; the first
    ``graph.n`` entries are the placement), so crossover can also move nodes
    through free cores. Individuals 0/1 seed the population with the
    deterministic zigzag/sigmate constructors (or the validated user ``init``),
    the rest start random; each generation keeps the ``elite_frac`` best
    unchanged and refills by tournament selection + OX1 crossover
    (:func:`_ox_crossover`) + pairwise-swap mutation (each child takes another
    swap with probability ``mutation_rate`` — a geometric number of swaps,
    ~1.5 expected at the 0.6 default). The total evaluation budget is
    ``(generations + 1) × pop_size``. ``recorder`` emits one ``ga.gen`` event
    per generation (best/mean cost plus a population-diversity index: the
    mean fraction of placement slots differing from the generation's best
    individual); detached the search is untouched.
    """
    if pop_size < 2:
        raise ValueError(f"pop_size must be >= 2, got {pop_size}")
    if tournament < 1:
        raise ValueError(f"tournament must be >= 1, got {tournament}")
    rng = np.random.default_rng(seed)
    pool = core_pool(noc)       # int when intact; alive-core array otherwise
    pool_arr = (np.arange(pool) if isinstance(pool, int)
                else np.asarray(pool))
    n, n_slots = graph.n, pool_arr.size
    score = make_scorer(noc, graph, resolve_backend(backend, device),
                        objective, recorder=recorder, device=device)

    def full_perm(placement) -> np.ndarray:
        placement = np.asarray(placement, dtype=int)
        free = np.setdiff1d(pool_arr, placement)
        return np.concatenate([placement, free])

    slots = np.empty((pop_size, n_slots), dtype=int)
    if init is not None:
        validate_placements(noc, np.asarray(init, dtype=int), n)
        slots[0] = full_perm(init)
    else:
        slots[0] = full_perm(zigzag(n, noc))
    slots[1] = full_perm(sigmate(n, noc))
    for p in range(2, pop_size):
        slots[p] = rng.permutation(pool)

    n_elite = max(1, int(round(elite_frac * pop_size)))
    cost = score(slots[:, :n])
    i0 = int(np.argmin(cost))
    best, best_cost = slots[i0, :n].copy(), float(cost[i0])
    if recorder is not None:
        recorder.event("ga.gen", gen=-1, best_cost=best_cost,
                       cur_min=float(cost[i0]), cur_mean=float(cost.mean()),
                       diversity=float(
                           (slots[:, :n] != slots[i0, :n]).mean()))

    for gen in range(generations):
        order = np.argsort(cost, kind="stable")
        nxt = np.empty_like(slots)
        nxt[:n_elite] = slots[order[:n_elite]]
        # tournament selection: draw all parent candidates for the generation
        # in one call so the RNG stream is a simple function of (seed, sizes)
        cand = rng.integers(0, pop_size, (pop_size - n_elite, 2, tournament))
        winners = cand[np.arange(pop_size - n_elite)[:, None, None],
                       np.arange(2)[None, :, None],
                       np.argmin(cost[cand], axis=2)[..., None]][..., 0]
        for k in range(pop_size - n_elite):
            a, b = winners[k]
            if rng.random() < crossover_rate:
                child = _ox_crossover(rng, slots[a], slots[b])
            else:
                child = slots[a].copy()
            while rng.random() < mutation_rate:
                i, j = rng.integers(0, n_slots, 2)
                child[i], child[j] = child[j], child[i]
            nxt[n_elite + k] = child
        slots = nxt
        cost = score(slots[:, :n])
        i1 = int(np.argmin(cost))
        if cost[i1] < best_cost:
            best, best_cost = slots[i1, :n].copy(), float(cost[i1])
        if recorder is not None:
            recorder.event("ga.gen", gen=gen, best_cost=best_cost,
                           cur_min=float(cost[i1]),
                           cur_mean=float(cost.mean()),
                           diversity=float(
                               (slots[:, :n] != slots[i1, :n]).mean()))
    return best
