"""Baseline placement constructors (paper §5.1): Zigzag and Sigmate, plus the
chip-respecting constructor that seeds searches on multi-chip topologies.

The searches of the reference module (random search, simulated annealing,
greedy) are not ported yet (ROADMAP queue 1, item 3: host searches).
"""
from __future__ import annotations

import numpy as np


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
