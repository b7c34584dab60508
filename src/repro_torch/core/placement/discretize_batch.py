"""Batched continuous action -> placement discretization (paper §4.3 "Action").

The sequential reference (`discretize.actions_to_placement`) runs a pure-Python
clockwise spiral search per node per sample — the dominant cost of every
`run_ppo` rollout once scoring is batched. This module vectorizes the
whole pipeline over a ``[B, n, 2]`` action batch while staying **bit-exact**
against the reference: identical placements for identical actions and priority
order, so PPO trajectories are seed-for-seed unchanged.

The key precomputation is a per-topology *scan table*: for every start cell,
the full search order the spiral visits — the cell itself, then every ring of
increasing Manhattan distance walked clockwise from north, filtered to
in-bounds cells. Rings partition the grid, so each row of the table is a
permutation of all ``rows*cols`` cells and "first free cell in the reference
spiral" becomes "first free entry of ``scan_table[start]``". Collision
resolution then runs one short loop over *nodes* (priority order — the
sequential data dependence the reference semantics require) with all batch
samples resolved per step by pure numpy gather/argmax, instead of ``B × n``
Python spiral searches.

The device resolver (:func:`make_torch_resolver`, also bound to the
reference's name ``make_jax_resolver``) runs the same loop over nodes on a
torch device, each step one gather from the scan table for the whole batch;
it consumes integer grid cells (bin actions with `continuous_to_grid_batch`,
which is float64 and matches the reference binning exactly).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ...device import resolve_device
from .discretize import _clockwise_ring, continuous_to_grid


def continuous_to_grid_batch(cont: np.ndarray, rows: int, cols: int,
                             clip: float = 1.0) -> np.ndarray:
    """[..., n, 2] continuous -> [..., n] flat grid cells (no collision
    handling). The binning itself is :func:`discretize.continuous_to_grid`
    (one shared formula); this just flattens to ``r * cols + c`` cell ids,
    what the resolver consumes."""
    g = continuous_to_grid(cont, rows, cols, clip).astype(np.int64)
    return g[..., 0] * cols + g[..., 1]


@functools.lru_cache(maxsize=None)
def scan_table(rows: int, cols: int) -> np.ndarray:
    """[rows*cols, rows*cols] int32: row ``s`` is the reference spiral's full
    visit order from start cell ``s`` (each row a permutation of all cells)."""
    n = rows * cols
    table = np.empty((n, n), dtype=np.int32)
    for s in range(n):
        r0, c0 = divmod(s, cols)
        order = [s]
        for dist in range(1, rows + cols):
            for (r, c) in _clockwise_ring(r0, c0, dist):
                if 0 <= r < rows and 0 <= c < cols:
                    order.append(r * cols + c)
        table[s] = order
    return table


def resolve_collisions_batch(cells: np.ndarray, rows: int, cols: int,
                             priority=None) -> np.ndarray:
    """[B, n] flat grid cells (possibly colliding) -> injective cores [B, n].

    Nodes are resolved in priority order (the sequential dependence of the
    reference); each step handles the whole batch with vectorized numpy.
    """
    cells = np.asarray(cells, dtype=np.int64)
    B, n = cells.shape
    n_cores = rows * cols
    if n > n_cores:
        raise ValueError(f"{n} nodes do not fit on {rows}x{cols} grid")
    order = np.arange(n) if priority is None else np.asarray(priority)
    table = scan_table(rows, cols)
    taken = np.zeros((B, n_cores), dtype=bool)
    # -1 fill matches the sequential reference for nodes a partial priority
    # order never visits
    out = np.full((B, n), -1, dtype=np.int64)
    bidx = np.arange(B)
    for i, node in enumerate(order):
        start = cells[:, node]
        chosen = start.copy()
        coll = np.nonzero(taken[bidx, start])[0]        # samples that collide
        if coll.size:
            # at step i at most i cells are taken, so the first free cell sits
            # within the first i+1 entries of the spiral scan order
            scan = table[start[coll], :i + 1]           # [m, i+1]
            free = ~taken[coll[:, None], scan]
            chosen[coll] = scan[np.arange(coll.size), free.argmax(axis=1)]
        out[:, node] = chosen
        taken[bidx, chosen] = True
    return out


def actions_to_placement_batch(cont: np.ndarray, rows: int, cols: int,
                               clip: float = 1.0, priority=None) -> np.ndarray:
    """[B, n, 2] continuous actions -> [B, n] placements, bit-exact vs the
    sequential :func:`discretize.actions_to_placement` per sample."""
    cont = np.asarray(cont)
    if cont.ndim == 2:                                  # single sample
        return actions_to_placement_batch(cont[None], rows, cols, clip,
                                          priority)[0]
    return resolve_collisions_batch(
        continuous_to_grid_batch(cont, rows, cols, clip), rows, cols, priority)


def make_torch_resolver(rows: int, cols: int, priority=None, device=None):
    """``cells [B, n] -> placements [B, n]`` (int64 tensor on ``device``,
    ``None``: the card): the collision resolver as a loop over nodes in
    priority order, each step vectorised over the batch. Integer table
    lookups only, so it matches the numpy resolver exactly, the ``-1`` fill
    of nodes a partial priority order never visits included.

    The first free core of each row is ``argmax`` over an int32 free mask
    gathered along the row's scan order (``torch.argmax`` returns the first
    of tied maxima)."""
    dev = resolve_device(device)
    table = torch.as_tensor(scan_table(rows, cols), dtype=torch.long,
                            device=dev)
    n_cores = rows * cols
    if priority is not None and np.unique(priority).size != len(priority):
        # a duplicate would resolve one node twice and take two cores
        raise ValueError("priority must not contain duplicate node ids")
    prio = None if priority is None else [int(p) for p in priority]

    def resolve(cells):
        cells = torch.as_tensor(np.asarray(cells), dtype=torch.long,
                                device=dev)
        B, n = cells.shape
        if n > n_cores:                     # same loud failure as numpy path
            raise ValueError(f"{n} nodes do not fit on {rows}x{cols} grid")
        bidx = torch.arange(B, device=dev)
        free = torch.ones(B, n_cores, dtype=torch.int32, device=dev)
        out = torch.full((B, n), -1, dtype=torch.long, device=dev)
        for node in (range(n) if prio is None else prio):
            scan = table[cells[:, node]]                    # [B, n_cores]
            first = torch.argmax(free.gather(1, scan), dim=1)
            chosen = scan[bidx, first]
            out[:, node] = chosen
            free[bidx, chosen] = 0
        return out

    return resolve


#: the reference's name for the device resolver
make_jax_resolver = make_torch_resolver
