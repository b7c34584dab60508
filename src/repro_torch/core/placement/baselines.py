"""Baseline placement methods (paper §5.1): Zigzag, Sigmate, Random Search — plus
simulated annealing and a communication-greedy constructor (beyond-paper references).

The search baselines score candidates through
:func:`repro_torch.core.noc_batch.make_scorer` (``backend="batch"`` —
vectorized float64, bit-identical to the per-edge reference loop on
integer-volume graphs, within a last-ulp summation difference on continuous
volumes; ``backend="cuda"``/``"torch"`` score in float32 on ``device``,
``None`` meaning the card; ``backend="reference"`` is the exact original
path; ``backend=None``, the default, is ``"cuda"`` on a CUDA ``device`` and
``"batch"`` on the CPU, see :func:`repro_torch.device.resolve_backend`), so
they run on any :class:`repro_torch.core.topology.Topology`. Their
random draws are numpy's, so on ``backend="batch"`` they match the JAX
package seed for seed. Note the constructors (zigzag/sigmate) and the plain
searches are *flat-aware* only: on a multi-chip ``HierarchicalMesh`` they see
the global core grid but not the chip boundaries. Population-batched variants
(and the genetic evolutionary search) live in :mod:`.population`.
"""
from __future__ import annotations

import numpy as np

from ...device import resolve_backend
from ..noc_batch import make_scorer, validate_placements


def core_pool(noc):
    """The pool random placements draw from: the plain core *count* on intact
    topologies — so ``rng.permutation(int)`` keeps the historical sampling
    stream bit-for-bit — or the surviving-core array on degraded ones
    (:class:`repro.core.topology.DegradedTopology`)."""
    n_alive = getattr(noc, "n_alive_cores", noc.n_cores)
    if n_alive == noc.n_cores:
        return noc.n_cores
    return np.asarray(noc.alive_cores(), dtype=np.int64)


def _n_alive(noc) -> int:
    return getattr(noc, "n_alive_cores", noc.n_cores)


def zigzag(n_nodes: int, noc) -> np.ndarray:
    """Row-major sequential deployment from the top-left corner (skipping
    dropped cores on degraded fabrics)."""
    if n_nodes > _n_alive(noc):
        raise ValueError("graph larger than NoC")
    if _n_alive(noc) != noc.n_cores:
        return np.asarray(noc.alive_cores()[:n_nodes], dtype=int)
    return np.arange(n_nodes)


def sigmate(n_nodes: int, noc) -> np.ndarray:
    """Serpentine deployment: each row filled in alternating direction, so
    consecutive logical nodes stay physically adjacent across row boundaries
    (dropped cores are skipped on degraded fabrics)."""
    if n_nodes > _n_alive(noc):
        raise ValueError("graph larger than NoC")
    order = []
    for r in range(noc.rows):
        cols = range(noc.cols) if r % 2 == 0 else range(noc.cols - 1, -1, -1)
        order.extend(noc.index(r, c) for c in cols)
    if _n_alive(noc) != noc.n_cores:
        dropped = noc.dropped_nodes()
        order = [c for c in order if c not in dropped]
    return np.asarray(order[:n_nodes])


def chip_init(graph, noc) -> np.ndarray:
    """Chip-respecting constructor: slices pre-binned to their assigned chip.

    Requires a chip-aware partition (``graph.chip_of``, see
    ``repro.core.partition`` ``strategy="chip"``): each chip's slices fill
    that chip's cores in serpentine (within-chip sigmate) order, so the only
    inter-chip traffic left is the partition's own chip-cut edges. This is
    the initialization the searches (SA/genetic/RS) and the RL methods are
    seeded with on hierarchical topologies — the partition→place half of the
    co-design loop.
    """
    if graph.chip_of is None:
        raise ValueError("graph has no chip assignment; partition with a "
                         "chip-aware strategy first (strategy='chip')")
    placement = np.full(graph.n, -1, dtype=int)
    for chip in np.unique(graph.chip_of):
        nodes = np.nonzero(graph.chip_of == chip)[0]
        cores = np.asarray(noc.cores_of_chip(int(chip)), dtype=int)
        if nodes.size > cores.size:
            raise ValueError(f"chip {int(chip)} assigned {nodes.size} slices "
                             f"but has only {cores.size} cores")
        order = _serpentine(cores, noc)
        placement[nodes] = order[:nodes.size]
    return placement


def _serpentine(cores: np.ndarray, noc) -> np.ndarray:
    """Order ``cores`` serpentine-wise (row-major, alternating direction per
    row) so consecutive slices stay physically adjacent inside their chip."""
    if not hasattr(noc, "coord"):       # non-grid topologies: index order
        return np.asarray(cores, dtype=int)
    coords = np.array([noc.coord(c) for c in cores])
    order = []
    for k, r in enumerate(np.unique(coords[:, 0])):
        row = cores[coords[:, 0] == r]
        row = row[np.argsort(coords[coords[:, 0] == r, 1])]
        order.extend(row[::-1] if k % 2 else row)
    return np.asarray(order, dtype=int)


def random_search(graph, noc, iters: int = 2000, seed: int = 0,
                  backend: str | None = None,
                  objective="comm_cost", init=None,
                  recorder=None, device=None) -> np.ndarray:
    """Paper's RS baseline: sample random injective placements, keep the best
    (under ``objective`` — comm cost by default, see
    repro_torch.deploy.objective).
    ``init``, when given, is scored as candidate zero (before any RNG draw,
    so the sampling stream is unchanged) — the chip-respecting seeding hook.
    ``recorder`` emits one ``rs.iter`` event per candidate (cost, best) —
    detached it costs one None-check per iteration and the RNG stream (and
    so the result) is untouched.
    """
    rng = np.random.default_rng(seed)
    score = make_scorer(noc, graph, resolve_backend(backend, device),
                        objective, recorder=recorder, device=device)
    best, best_cost = None, np.inf
    if init is not None:
        init = np.asarray(init, dtype=int)
        validate_placements(noc, init, graph.n)
        best, best_cost = init, float(score(init[None, :])[0])
    pool = core_pool(noc)
    for it in range(iters):
        p = rng.permutation(pool)[:graph.n]
        c = float(score(p[None, :])[0])
        if c < best_cost:
            best, best_cost = p, c
        if recorder is not None:
            recorder.event("rs.iter", iter=it, cost=c, best_cost=best_cost)
    return best


def simulated_annealing(graph, noc, iters: int = 5000, t0: float = 0.05,
                        t_end_frac: float = 1e-3, seed: int = 0,
                        init=None, backend: str | None = None,
                        objective="comm_cost", recorder=None,
                        decay_on_degenerate: bool = False,
                        device=None) -> np.ndarray:
    """Pairwise-swap SA over placements (beyond-paper local-search reference,
    cf. cyclic RL+SA placement [Vashisht et al. 2020]).

    Temperature starts at ``t0 × initial_cost`` and decays geometrically to
    ``t_end_frac`` of that over ``iters`` steps. ``objective`` selects the
    annealed score (comm cost by default; any repro_torch.deploy.objective
    spec).
    ``recorder`` emits exactly one ``sa.iter`` event per step (current/best
    cost, temperature, accepted flag) and counts accepted moves; detached it
    costs one None-check per step and the trajectory is bit-identical.

    Degenerate proposals (``i == j``, or both indices in the free-core tail)
    historically skipped the ``t *= cooling`` decay, so the realized schedule
    stretches with the collision count instead of ending at
    ``t0 × t_end_frac`` after ``iters`` steps. ``decay_on_degenerate=True``
    decays unconditionally (the intended geometric schedule — and what the
    device backend implements); the default ``False`` keeps the historical
    trajectory bit-for-bit.
    """
    rng = np.random.default_rng(seed)
    score = make_scorer(noc, graph, resolve_backend(backend, device),
                        objective, recorder=recorder, device=device)
    cur = np.array(init if init is not None else zigzag(graph.n, noc))
    validate_placements(noc, cur, graph.n)   # reject bad user-supplied init
    # extend with free (surviving) cores so swaps can move nodes to empty cells
    pool = core_pool(noc)
    cands = range(pool) if isinstance(pool, int) else pool.tolist()
    free = [i for i in cands if i not in set(cur.tolist())]
    slots = np.concatenate([cur, np.asarray(free, dtype=int)])
    n = graph.n
    cost = float(score(slots[None, :n])[0])
    best, best_cost = slots[:n].copy(), cost
    t = max(t0 * max(cost, 1.0), 1e-9)
    cooling = t_end_frac ** (1.0 / max(iters, 1))
    for it in range(iters):
        accepted = False
        i, j = rng.integers(0, len(slots), 2)
        if i == j or (i >= n and j >= n):
            if decay_on_degenerate:
                t *= cooling
            if recorder is not None:
                recorder.event("sa.iter", iter=it, cost=cost,
                               best_cost=best_cost, temperature=t,
                               accepted=False, proposed=False)
            continue
        slots[i], slots[j] = slots[j], slots[i]
        new_cost = float(score(slots[None, :n])[0])
        if new_cost <= cost or rng.random() < np.exp((cost - new_cost) / max(t, 1e-9)):
            cost = new_cost
            accepted = True
            if cost < best_cost:
                best, best_cost = slots[:n].copy(), cost
        else:
            slots[i], slots[j] = slots[j], slots[i]
        t *= cooling
        if recorder is not None:
            recorder.event("sa.iter", iter=it, cost=cost,
                           best_cost=best_cost, temperature=t,
                           accepted=accepted, proposed=True)
            if accepted:
                recorder.count("sa.accepted")
    return best


def greedy(graph, noc) -> np.ndarray:
    """Constructive greedy: place nodes in topological-ish (index) order, each at
    the free core minimizing the incremental hop-weighted cost to already-placed
    neighbours.

    Vectorized over the core axis with the precomputed hop matrix
    (:func:`repro_torch.core.noc_batch.build_tables`): each node costs two
    hop-matrix products instead of an O(n_cores × n) Python loop of
    ``noc.hops`` calls. Identical placements to the per-pair reference
    (:func:`_greedy_reference`) — ``np.argmin`` keeps the same
    first-strict-minimum tie-break, and on integer-volume graphs every
    incremental cost is an exactly-representable float64 sum.
    """
    from ..noc_batch import batched_noc
    hops = batched_noc(noc).tables.hops.astype(np.float64)
    placement = np.full(graph.n, -1, dtype=int)
    taken = np.zeros(noc.n_cores, dtype=bool)
    dropped = np.asarray(sorted(noc.dropped_nodes()), dtype=int)
    taken[dropped] = True                 # never place on dead cores
    adj = graph.adj
    for node in range(graph.n):
        placed = np.nonzero(placement >= 0)[0]
        pcores = placement[placed]
        inc = hops[:, pcores] @ adj[node, placed] \
            + adj[placed, node] @ hops[pcores, :]
        inc[taken] = np.inf
        core = int(np.argmin(inc))        # first minimum, like the reference
        placement[node] = core
        taken[core] = True
    return placement


def _greedy_reference(graph, noc) -> np.ndarray:
    """Original per-pair greedy loop (O(n² · n_cores) ``noc.hops`` calls) —
    kept as the parity oracle :func:`greedy` is tested against."""
    placement = np.full(graph.n, -1, dtype=int)
    taken = {int(c) for c in noc.dropped_nodes()}
    adj = graph.adj
    for node in range(graph.n):
        best_core, best_inc = None, np.inf
        for core in range(noc.n_cores):
            if core in taken:
                continue
            inc = 0.0
            for other in range(graph.n):
                if placement[other] < 0:
                    continue
                if adj[node, other] > 0:
                    inc += adj[node, other] * noc.hops(core, placement[other])
                if adj[other, node] > 0:
                    inc += adj[other, node] * noc.hops(placement[other], core)
            if inc < best_inc:
                best_inc, best_core = inc, core
        placement[node] = best_core
        taken.add(best_core)
    return placement
