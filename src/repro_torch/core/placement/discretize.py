"""Continuous action -> discrete placement (paper §4.3 "Action").

The actor emits, per logical node, a continuous coordinate in each grid dimension.
Coordinates are clipped to [-clip, clip], equidistantly discretized onto the
rows × cols grid, and collisions are resolved by a clockwise spiral search: nodes are
assigned in priority order (graph order — producers first), and a node whose cell is
taken moves to the free cell with minimal Manhattan distance, scanning clockwise from
the contested cell (the paper's "rotating on the axis with the minimum step distance in
a clockwise direction").
"""
from __future__ import annotations

import numpy as np


def continuous_to_grid(cont: np.ndarray, rows: int, cols: int,
                       clip: float = 1.0) -> np.ndarray:
    """[..., 2] continuous -> [..., 2] int grid coords (no collision handling).

    Leading axes pass through, so this is also the batched binning used by
    ``discretize_batch`` (one formula — the bit-exactness contract between the
    sequential and batched paths hangs on it).
    """
    cont = np.clip(np.asarray(cont, dtype=np.float64), -clip, clip)
    # equidistant bins over [-clip, clip]
    r = np.floor((cont[..., 0] + clip) / (2 * clip) * rows).astype(int)
    c = np.floor((cont[..., 1] + clip) / (2 * clip) * cols).astype(int)
    return np.stack([np.clip(r, 0, rows - 1), np.clip(c, 0, cols - 1)],
                    axis=-1)


def _clockwise_ring(r0: int, c0: int, dist: int):
    """Cells at Manhattan distance ``dist`` from (r0, c0), clockwise from north."""
    cells = []
    # walk the diamond: N -> E -> S -> W
    r, c = r0 - dist, c0
    for dr, dc in ((1, 1), (1, -1), (-1, -1), (-1, 1)):
        for _ in range(dist):
            cells.append((r, c))
            r += dr
            c += dc
    return cells


def resolve_collisions(coords: np.ndarray, rows: int, cols: int,
                       priority=None) -> np.ndarray:
    """[n, 2] grid coords (possibly colliding) -> injective core indices [n]."""
    n = coords.shape[0]
    if n > rows * cols:
        raise ValueError(f"{n} nodes do not fit on {rows}x{cols} grid")
    order = np.arange(n) if priority is None else np.asarray(priority)
    taken = np.zeros((rows, cols), dtype=bool)
    out = np.full(n, -1, dtype=int)
    for node in order:
        r0, c0 = int(coords[node, 0]), int(coords[node, 1])
        if not taken[r0, c0]:
            taken[r0, c0] = True
            out[node] = r0 * cols + c0
            continue
        placed = False
        for dist in range(1, rows + cols):
            for (r, c) in _clockwise_ring(r0, c0, dist):
                if 0 <= r < rows and 0 <= c < cols and not taken[r, c]:
                    taken[r, c] = True
                    out[node] = r * cols + c
                    placed = True
                    break
            if placed:
                break
        if not placed:  # pragma: no cover - guarded by n <= rows*cols
            raise RuntimeError("no free cell found")
    return out


def actions_to_placement(cont: np.ndarray, rows: int, cols: int,
                         clip: float = 1.0, priority=None) -> np.ndarray:
    return resolve_collisions(continuous_to_grid(cont, rows, cols, clip),
                              rows, cols, priority)
