"""Multilevel placement: coarsen -> place -> refine (METIS-style V-cycle).

Every flat search in the repo (SA/GA/RS/PPO, the device backend included)
permutes the full node set and stops scaling past a few hundred logical
cores. This module turns one large placement problem into a hierarchy of
small ones, the way cluster-based SNN mapping flows do (cf. arxiv
2108.12444; arxiv 2503.02033 documents where flat ILP/search dies):

1. **Coarsening** — repeated heavy-edge matching over the
   :class:`~repro_torch.core.graph.LogicalGraph`: each round pairs nodes with
   their mutually-heaviest neighbour (vectorized, no per-edge Python loop)
   and merges matched pairs, summing ``compute``/``memory`` and accumulating
   ``adj``; edges internalized by a merge disappear. Invariant: the coarse
   graph's total off-diagonal traffic equals the fine graph's minus the
   internalized volume (tested in ``tests/test_multilevel.py``). Each round
   is recorded as a :class:`CoarseningLevel` carrying the fine->coarse
   ``node_map``.

2. **Region mapping** — each level is placed on a *region grid*: the fine
   core grid repeatedly halved along its larger dimension until it just
   covers the level's node count. A level placement (injective nodes ->
   regions) projects to the next finer level by sending every child node to
   the region containing its parent's region center, resolving collisions
   with a serpentine-scan spill (two vectorized prefix passes), so every
   level's placement projects to a *valid* (injective, in-range) fine
   placement; the finest level's region grid is the core grid itself.

3. **V-cycle** — :func:`multilevel_placement` places the coarsest
   graph with any existing flat method through
   :func:`~repro_torch.core.placement.optimizer.optimize_placement`
   (``backend="batch"`` or ``"device"``; chip_init-seeded when the topology
   is multi-chip and the partition was chip-aware), then walks back up,
   projecting and refining each level with bounded greedy swap search whose
   move evaluation is the O(degree) incident-edge delta of
   :func:`repro_torch.core.noc_batch.build_incident_tables` — with hop distances
   computed from grid coordinates instead of the all-pairs route tables, so
   refinement never materializes an O(n_cores^2) table even at 10^4+ cores.

``coarsen_to >= graph.n`` coarsens nothing and delegates to the flat method
unchanged — bit-identical placements, the identity contract the property
tests pin. Degraded (faulty) topologies are rejected: detour routing breaks
the coordinate hop formula; use the flat searches (the online re-placement
path) there.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..graph import LogicalGraph
from ..noc_batch import build_incident_tables
from ..topology import GridTopology


# ---------------------------------------------------------------------------
# Coarsening (heavy-edge matching)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CoarseningLevel:
    """One coarsening round: the coarse graph plus the fine->coarse map."""
    graph: LogicalGraph        # the coarse graph (n_coarse nodes)
    node_map: np.ndarray       # [fine_n] int64: fine node -> coarse node
    fine_n: int                # node count of the graph that was coarsened

    @property
    def ratio(self) -> float:
        """Coarse/fine node ratio (~0.5 when matching is dense)."""
        return self.graph.n / max(self.fine_n, 1)


def _undirected_edges(graph: LogicalGraph):
    """(a, b, w) with a < b: directed volumes summed per unordered pair."""
    src, dst, vol = graph.edge_arrays()
    keep = src != dst
    src, dst, vol = src[keep], dst[keep], vol[keep]
    key = np.minimum(src, dst) * graph.n + np.maximum(src, dst)
    uniq, inv = np.unique(key, return_inverse=True)
    w = np.bincount(inv, weights=vol)
    return uniq // graph.n, uniq % graph.n, w


def _heaviest_neighbor(nodes, nbrs, ws, n: int) -> np.ndarray:
    """[n] heaviest neighbour per node over the given (node, nbr, w) edge
    list (ties toward the lower neighbour id), -1 for isolated nodes."""
    order = np.lexsort((-nbrs, ws, nodes))
    snd = nodes[order]
    left = np.searchsorted(snd, np.arange(n), side="left")
    right = np.searchsorted(snd, np.arange(n), side="right")
    hn = np.full(n, -1, dtype=np.int64)
    has = right > left
    hn[has] = nbrs[order][right[has] - 1]
    return hn


def heavy_edge_matching(graph: LogicalGraph, rounds: int = 4) -> np.ndarray:
    """[n] partner index per node, -1 for unmatched — each node matched at
    most once (the matching invariant).

    Three vectorized passes:

    1. *Mutual-heaviest-neighbour rounds* — every still-free node finds its
       heaviest free neighbour (ties toward the lower node id); mutual pairs
       match. A few rounds reach near-maximal matchings on mesh-like graphs
       without the per-edge Python loop of classic greedy HEM.
    2. *Greedy leftover edges* — remaining free-free edges scanned once in
       descending-weight order (the textbook greedy HEM, bounded by the edge
       count).
    3. *Two-hop twin matching* — still-free nodes grouped by their heaviest
       neighbour and paired within groups. Star subgraphs (a MoE block: one
       router feeding hundreds of experts) defeat edge matching — at most
       two leaves per hub can ever match — but the leaves are *twins*
       (identical neighbourhoods), so merging them loses no structure; this
       is what keeps coarsening moving on 10^4-node MoE graphs.
    """
    n = graph.n
    match = np.full(n, -1, dtype=np.int64)
    ua, ub, w = _undirected_edges(graph)
    if ua.size == 0:
        return match
    nodes = np.concatenate([ua, ub])
    nbrs = np.concatenate([ub, ua])
    ws = np.concatenate([w, w])
    for _ in range(max(rounds, 1)):
        free = match < 0
        ok = free[nodes] & free[nbrs]
        if not ok.any():
            break
        hn = _heaviest_neighbor(nodes[ok], nbrs[ok], ws[ok], n)
        cand = np.nonzero(hn >= 0)[0]
        mutual = cand[hn[hn[cand]] == cand]
        pick = mutual[mutual < hn[mutual]]
        if pick.size == 0:
            break
        match[pick] = hn[pick]
        match[hn[pick]] = pick

    # greedy pass over the leftover free-free edges, heaviest first
    free = match < 0
    ok = free[ua] & free[ub]
    if ok.any():
        ea, eb, ew = ua[ok], ub[ok], w[ok]
        for k in np.lexsort((ea, eb, -ew)):
            a, b = int(ea[k]), int(eb[k])
            if match[a] < 0 and match[b] < 0:
                match[a], match[b] = b, a

    # two-hop pass: pair free nodes that share a heaviest neighbour
    free_nodes = np.nonzero(match < 0)[0]
    if free_nodes.size >= 2:
        hn0 = _heaviest_neighbor(nodes, nbrs, ws, n)   # over ALL edges
        key = hn0[free_nodes]
        keep = key >= 0
        free_nodes, key = free_nodes[keep], key[keep]
        order = np.lexsort((free_nodes, key))
        sf, sk = free_nodes[order], key[order]
        if sf.size >= 2:
            starts = np.r_[True, sk[1:] != sk[:-1]]
            idx = np.arange(sf.size)
            pos = idx - np.maximum.accumulate(np.where(starts, idx, 0))
            has_next = np.r_[~starts[1:], False]       # next is same group
            first = (pos % 2 == 0) & has_next
            a = sf[first]
            b = sf[np.nonzero(first)[0] + 1]
            match[a] = b
            match[b] = a
    return match


def coarsen_once(graph: LogicalGraph) -> CoarseningLevel | None:
    """One heavy-edge-matching round; ``None`` when nothing matched.

    Merged nodes sum ``compute``/``memory``; the coarse ``adj`` accumulates
    every fine edge whose endpoints land in different coarse nodes (edges
    internalized by a merge vanish — traffic conservation minus
    internalized volume). ``chip_of``, when present, propagates as the chip
    of the merged pair's heavier-memory member (ties: lower node id), so
    chip_init seeding survives to the coarsest level.
    """
    match = heavy_edge_matching(graph)
    n = graph.n
    partner = np.where(match >= 0, match, np.arange(n))
    rep = np.minimum(np.arange(n), partner)
    reps = np.unique(rep)
    n_c = reps.size
    if n_c == n:
        return None
    node_map = np.searchsorted(reps, rep).astype(np.int64)
    compute = np.bincount(node_map, weights=graph.compute, minlength=n_c)
    memory = np.bincount(node_map, weights=graph.memory, minlength=n_c)
    src, dst, vol = graph.edge_arrays()
    cs, cd = node_map[src], node_map[dst]
    keep = cs != cd
    adj = np.bincount(cs[keep] * n_c + cd[keep], weights=vol[keep],
                      minlength=n_c * n_c).reshape(n_c, n_c)
    chip_of = None
    if graph.chip_of is not None:
        order = np.lexsort((np.arange(n), -graph.memory, node_map))
        cm = node_map[order]
        first = np.searchsorted(cm, np.arange(n_c), side="left")
        chip_of = graph.chip_of[order][first]
    coarse = LogicalGraph(adj, compute, memory, chip_of=chip_of)
    return CoarseningLevel(graph=coarse, node_map=node_map, fine_n=n)


def coarsen(graph: LogicalGraph, coarsen_to: int,
            min_shrink: float = 0.95, max_levels: int = 64) -> list:
    """Coarsening levels until the graph has <= ``coarsen_to`` nodes (or
    matching stalls — a round shrinking less than ``1 - min_shrink`` stops
    the hierarchy). Empty list when ``coarsen_to >= graph.n``."""
    levels: list = []
    g = graph
    while g.n > coarsen_to and len(levels) < max_levels:
        lvl = coarsen_once(g)
        if lvl is None or lvl.graph.n > min_shrink * g.n:
            break
        levels.append(lvl)
        g = lvl.graph
    return levels


# ---------------------------------------------------------------------------
# Region mapping
# ---------------------------------------------------------------------------

def _grid_sequence(rows: int, cols: int) -> list:
    """Region-grid hierarchy: the fine grid repeatedly halved (ceil) along
    its larger dimension, down to 1x1. Strictly decreasing areas."""
    grids = [(rows, cols)]
    r, c = rows, cols
    while r * c > 1:
        if r >= c:
            r = (r + 1) // 2
        else:
            c = (c + 1) // 2
        grids.append((r, c))
    return grids


def _pick_grid(grids: list, n_nodes: int) -> tuple:
    """Smallest grid in the hierarchy that still fits ``n_nodes`` regions."""
    best = grids[0]
    for g in grids:
        if g[0] * g[1] >= n_nodes:
            best = g
        else:
            break
    return best


def _serp_order(rows: int, cols: int) -> np.ndarray:
    """Region ids in serpentine scan order (row-major, alternating)."""
    ids = np.arange(rows * cols).reshape(rows, cols)
    ids[1::2] = ids[1::2, ::-1]
    return ids.ravel()


def _hops_fn(rows: int, cols: int, torus: bool):
    """Vectorized XY hop distance on a (rows, cols) grid — equals
    ``GridTopology.hops`` (shorter wrap on tori) without any table."""
    def hops(a, b):
        ra, ca = a // cols, a % cols
        rb, cb = b // cols, b % cols
        if torus:
            dr = np.minimum((ra - rb) % rows, (rb - ra) % rows)
            dc = np.minimum((ca - cb) % cols, (cb - ca) % cols)
        else:
            dr = np.abs(ra - rb)
            dc = np.abs(ca - cb)
        return dr + dc
    return hops


def project_placement(parent_placement: np.ndarray, node_map: np.ndarray,
                      parent_grid: tuple, child_grid: tuple,
                      fine_shape: tuple) -> np.ndarray:
    """Project a level placement one level down — always valid.

    Each child node desires the ``child_grid`` region containing its
    parent's ``parent_grid`` region center (both expressed in fine-grid
    coordinates). Collisions are resolved by a serpentine-scan spill: nodes
    sorted by desired serpentine rank take the first free region at or after
    their desired rank (one forward running-max pass, one clamp), which is
    injective whenever ``n_nodes <= n_regions``.
    """
    R, C = fine_shape
    pgr, pgc = parent_grid
    cgr, cgc = child_grid
    pid = np.asarray(parent_placement, dtype=np.int64)[node_map]
    center_r = (pid // pgc + 0.5) * R / pgr
    center_c = (pid % pgc + 0.5) * C / pgc
    desired = ((center_r * cgr / R).astype(np.int64) * cgc
               + (center_c * cgc / C).astype(np.int64))
    serp = _serp_order(cgr, cgc)
    rank_of = np.empty_like(serp)
    rank_of[serp] = np.arange(serp.size)
    dr = rank_of[desired]
    n, m = dr.size, serp.size
    if n > m:
        raise ValueError(f"{n} nodes do not fit {m} regions")
    order = np.lexsort((np.arange(n), dr))
    b = np.minimum(np.maximum.accumulate(dr[order] - np.arange(n)), m - n)
    out = np.empty(n, dtype=np.int64)
    out[order] = serp[b + np.arange(n)]
    return out


# ---------------------------------------------------------------------------
# O(degree) refinement
# ---------------------------------------------------------------------------

def _candidate_deltas(hops, tables, p_pad, i: int, ri: int,
                      cand_regions, cand_nodes, n: int) -> np.ndarray:
    """[C] comm-cost deltas of swapping node ``i`` (at region ``ri``) with
    each candidate region's occupant — the coordinate-hops counterpart of
    :func:`repro_torch.core.noc_batch.delta_comm_cost` (same padded-placement and
    sentinel-row conventions, exact on integer volumes), all ``C``
    candidates scored in one O(C x degree) vectorized evaluation.

    ``cand_nodes[c]`` is the node occupying ``cand_regions[c]`` or the
    sentinel ``n`` for a free region (the sentinel's incident row is
    all-zero, so free-region moves fall out of the same arithmetic).
    """
    rc = np.asarray(cand_regions, dtype=np.int64)
    bs = np.asarray(cand_nodes, dtype=np.int64)
    # node i's incident edges: neighbour b moves to ri, the rest stay
    others = tables.other[i].astype(np.int64)
    vols = tables.vol[i]
    oc = p_pad[others]
    oc_after = np.where(others[None, :] == bs[:, None], ri, oc[None, :])
    delta = (vols[None, :] * (hops(rc[:, None], oc_after)
                              - hops(ri, oc)[None, :])).sum(axis=1)
    # occupant edges: i<->b edges zeroed (already counted above), so i's own
    # move never matters here and "after" only moves b from rc to ri
    others_b = tables.other[bs].astype(np.int64)
    vols_b = np.where(others_b == i, 0.0, tables.vol[bs])
    oc_b = p_pad[others_b]
    delta += (vols_b * (hops(ri, oc_b)
                        - hops(rc[:, None], oc_b))).sum(axis=1)
    return delta


_NBR_OFFSETS = ((-1, 0), (1, 0), (0, -1), (0, 1),
                (-1, -1), (-1, 1), (1, -1), (1, 1))


def refine_placement(graph: LogicalGraph, grid: tuple, torus: bool,
                     placement: np.ndarray, sweeps: int, rng) -> tuple:
    """Bounded local refinement of one level: ``sweeps`` node sweeps, each
    node greedily trying to swap into its 8-neighbour regions.

    Uncoarsening preserves the coarse solution's *global* structure, so the
    residual error is local — a node one region off from where its
    neighbourhood wants it. Classic multilevel refinement therefore only
    needs distance-1 moves (which become coarse-distance moves at coarser
    levels). Every candidate is scored in O(degree) through the
    incident-edge tables, so one sweep costs O(8 * edges), independent of
    the region count. Returns ``(placement, cost_before, cost_after)``.
    """
    gr, gc = grid
    hops = _hops_fn(gr, gc, torus)
    tables = build_incident_tables(graph)
    n = graph.n
    m = gr * gc
    # node -> region, padded with a 0 at index n (the sentinel slot of the
    # incident tables; its volumes are zero so the value never contributes)
    p_pad = np.append(np.asarray(placement, dtype=np.int64), 0)
    node_of = np.full(m, n, dtype=np.int64)      # region -> node (n = free)
    node_of[placement] = np.arange(n)
    src, dst, vol = graph.edge_arrays()
    cost0 = float((vol * hops(p_pad[src], p_pad[dst])).sum())
    cost = cost0
    for _ in range(max(sweeps, 0)):
        improved = False
        for i in rng.permutation(n):
            i = int(i)
            ri = int(p_pad[i])
            r, c = divmod(ri, gc)
            cand = []
            for dr, dc in _NBR_OFFSETS:
                rr, cc = r + dr, c + dc
                if torus:
                    rr, cc = rr % gr, cc % gc
                elif not (0 <= rr < gr and 0 <= cc < gc):
                    continue
                cand.append(rr * gc + cc)
            cand = np.asarray(cand, dtype=np.int64)
            deltas = _candidate_deltas(hops, tables, p_pad, i, ri, cand,
                                       node_of[cand], n)
            best = int(np.argmin(deltas))
            if deltas[best] < 0:
                rj = int(cand[best])
                b = int(node_of[rj])
                p_pad[i] = rj
                node_of[rj] = i
                node_of[ri] = b
                if b < n:
                    p_pad[b] = ri
                cost += float(deltas[best])
                improved = True
        if not improved:
            break
    return p_pad[:n].copy(), cost0, cost


# ---------------------------------------------------------------------------
# Region-grid surrogate topology (coarsest-level search)
# ---------------------------------------------------------------------------

class _RegionTopology(GridTopology):
    """Mesh/torus of core regions the coarsest graph is searched on.

    Hop distances between regions stand in for fine-grid distances (uniform
    block size up to ceil rounding). ``chip_map`` (majority chip of each
    region's fine cores) exposes the fine topology's chip structure so
    ``chip_init`` seeding works on the surrogate."""

    def __init__(self, rows: int, cols: int, torus: bool = False,
                 chip_map: np.ndarray | None = None):
        super().__init__(rows, cols, torus=torus)
        self._chip_map = (None if chip_map is None
                          else np.asarray(chip_map, dtype=np.int64))

    @property
    def n_chips(self) -> int:
        return (1 if self._chip_map is None
                else int(self._chip_map.max()) + 1)

    def chip_of_array(self) -> np.ndarray:
        if self._chip_map is None:
            return super().chip_of_array()
        return self._chip_map

    def cache_key(self) -> tuple:
        chips = (None if self._chip_map is None
                 else tuple(int(c) for c in self._chip_map))
        return super().cache_key() + ("mlregion", chips)


def _region_chip_map(noc, gr: int, gc: int) -> np.ndarray:
    """Majority chip of each region's fine cores (ties: lower chip id)."""
    R, C = noc.grid_shape
    chips = np.asarray(noc.chip_of_array(), dtype=np.int64)
    core = np.arange(noc.n_cores)
    region = ((core // C) * gr // R) * gc + (core % C) * gc // C
    counts = np.zeros((gr * gc, int(chips.max()) + 1), dtype=np.int64)
    np.add.at(counts, (region, chips), 1)
    return counts.argmax(axis=1).astype(np.int64)


# ---------------------------------------------------------------------------
# The V-cycle
# ---------------------------------------------------------------------------

def _check_noc(noc):
    if getattr(noc, "n_alive_cores", noc.n_cores) != noc.n_cores \
            or noc.dropped_links():
        raise ValueError(
            "multilevel placement supports intact topologies only (detour "
            "routes break the coordinate hop metric); use the flat searches "
            "(the online re-placement path) on degraded fabrics")
    if not hasattr(noc, "rows") or not hasattr(noc, "cols"):
        raise ValueError("multilevel placement needs a grid topology "
                         f"(mesh/torus/hier); got {type(noc).__name__}")


def grid_comm_cost(graph: LogicalGraph, noc, placement) -> float:
    """Vectorized Σ bytes x hops of ``placement`` on an intact grid topology
    — equal to ``noc.evaluate(graph, placement).comm_cost`` (XY routes are
    shortest paths) without the per-edge route replay or the O(n_cores^2)
    tables, so it stays usable at 10^4+ cores."""
    _check_noc(noc)
    hops = _hops_fn(noc.rows, noc.cols, bool(getattr(noc, "torus", False)))
    src, dst, vol = graph.edge_arrays()
    P = np.asarray(placement, dtype=np.int64)
    return float((vol * hops(P[src], P[dst])).sum())


def multilevel_placement(graph: LogicalGraph, noc, coarsen_to: int = 64,
                         refine_iters: int = 3,
                         coarse_method: str = "simulated_annealing",
                         seed: int = 0, budget: int | None = None,
                         backend: str | None = None, objective=None,
                         recorder=None, device=None,
                         **method_kw) -> np.ndarray:
    """The V-cycle: coarsen to <= ``coarsen_to`` nodes, place the
    coarsest graph with ``coarse_method`` (any flat
    ``optimize_placement`` method; ``backend``/``budget``/``seed`` and extra
    kwargs pass straight through), then uncoarsen level by level with
    ``refine_iters`` greedy neighbourhood sweeps per level.

    ``coarsen_to >= graph.n`` delegates to the flat method untouched —
    bit-identical placements (the identity contract). The refinement
    objective is comm cost; other objectives raise (anneal them on the flat
    searches instead). ``recorder`` emits one ``ml.level`` event per level
    (size, coarsening ratio, refine gain, wall seconds) following the
    ``sa.iter``/``ga.gen`` trajectory-event pattern; results are
    bit-identical with or without it. ``device`` (``None``: the card) is
    where the coarse search runs; coarsening and refinement are numpy.
    """
    from .optimizer import METHOD_ALIASES, optimize_placement
    method = METHOD_ALIASES.get(coarse_method, coarse_method)
    if method == "multilevel":
        raise ValueError("coarse_method must be a flat method, not "
                         "'multilevel'")
    if objective not in (None, "comm_cost"):
        from ...deploy.objective import as_objective
        if not as_objective(objective).is_comm_cost:
            raise ValueError(
                "multilevel refinement minimizes comm_cost only; got "
                f"objective={objective!r} — use the flat searches for "
                "weighted objectives")

    levels = coarsen(graph, coarsen_to) if coarsen_to < graph.n else []
    if not levels:
        # identity path: the flat method, bit-for-bit
        return np.asarray(optimize_placement(
            graph, noc, method=method, seed=seed, budget=budget,
            backend=backend, objective=objective, recorder=recorder,
            device=device, **method_kw).placement)

    _check_noc(noc)
    rows, cols = noc.grid_shape
    if graph.n > noc.n_cores:
        raise ValueError("graph larger than NoC")
    torus = bool(getattr(noc, "torus", False))
    grids = _grid_sequence(rows, cols)
    graphs = [graph] + [lv.graph for lv in levels]
    lvl_grid = [(rows, cols)] + [_pick_grid(grids, g.n) for g in graphs[1:]]

    # ---- coarsest level: flat search on the region surrogate -------------
    t0 = time.perf_counter()
    coarsest = graphs[-1]
    gr, gc = lvl_grid[-1]
    chip_map = None
    search_graph = coarsest
    if getattr(noc, "n_chips", 1) > 1 and coarsest.chip_of is not None:
        chip_map = _region_chip_map(noc, gr, gc)
        need = np.bincount(coarsest.chip_of, minlength=chip_map.max() + 1)
        have = np.bincount(chip_map, minlength=need.size)
        if np.any(need > have[:need.size]):
            # merged chip demands exceed the region grid's chip capacities:
            # fall back to a chip-oblivious coarse search
            chip_map = None
    if chip_map is None and coarsest.chip_of is not None:
        search_graph = LogicalGraph(coarsest.adj, coarsest.compute,
                                    coarsest.memory, names=coarsest.names,
                                    chip_of=None)
    topo_c = _RegionTopology(gr, gc, torus=torus, chip_map=chip_map)
    res = optimize_placement(search_graph, topo_c, method=method, seed=seed,
                             budget=budget, backend=backend,
                             objective=objective, recorder=recorder,
                             device=device, **method_kw)
    placement = np.asarray(res.placement, dtype=np.int64)
    if recorder is not None:
        recorder.event("ml.level", level=len(levels), n_nodes=coarsest.n,
                       n_regions=gr * gc,
                       coarsen_ratio=levels[-1].ratio,
                       refine_gain=0.0, cost=res.comm_cost,
                       wall_s=time.perf_counter() - t0)

    # ---- uncoarsen + refine ---------------------------------------------
    for k in range(len(levels) - 1, -1, -1):
        t0 = time.perf_counter()
        child = graphs[k]
        placement = project_placement(placement, levels[k].node_map,
                                      lvl_grid[k + 1], lvl_grid[k],
                                      (rows, cols))
        placement, before, after = refine_placement(
            child, lvl_grid[k], torus, placement, sweeps=refine_iters,
            rng=np.random.default_rng([seed, k]))
        if recorder is not None:
            cgr, cgc = lvl_grid[k]
            recorder.event("ml.level", level=k, n_nodes=child.n,
                           n_regions=cgr * cgc,
                           coarsen_ratio=levels[k].ratio,
                           refine_gain=before - after, cost=after,
                           wall_s=time.perf_counter() - t0)
            recorder.count("ml.levels")
    return placement
