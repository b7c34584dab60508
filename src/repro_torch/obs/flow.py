"""NoC flow introspection: where the bytes actually go.

The paper's headline claims (lower communication cost, no local hotspots,
balanced inter-core load) are *distributional* properties of the NoC flow
matrix, but the stack only surfaces final scalar costs. :func:`flow_report`
materializes the per-link load vector of one placement from the existing
batched route tables (:mod:`repro_torch.core.noc_batch`) and summarizes it:

* hotspots — top-k loaded links with their physical labels;
* imbalance — Gini coefficient and coefficient of variation over the loads of
  the *active* links (links that carry any traffic; mesh border slots that can
  never carry traffic would otherwise bias the indices);
* locality — per-chip intra-chip byte totals and the inter-chip byte total on
  multi-chip topologies;
* an ASCII heatmap of per-core routed traffic for terminal-side debugging.

Invariant (tested): ``link_loads.sum() == comm_cost`` — every byte×hop lands
on exactly one directed link.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def gini(values) -> float:
    """Gini coefficient of a nonnegative sample (0 = perfectly even,
    → 1 = one value carries everything)."""
    x = np.sort(np.asarray(values, dtype=np.float64))
    n = x.size
    total = x.sum()
    if n == 0 or total <= 0:
        return 0.0
    # mean absolute difference form via the sorted-rank identity
    ranks = np.arange(1, n + 1)
    return float((2.0 * (ranks * x).sum() / (n * total)) - (n + 1) / n)


def cov(values) -> float:
    """Coefficient of variation (std / mean; 0 for an empty or zero sample)."""
    x = np.asarray(values, dtype=np.float64)
    if x.size == 0 or x.mean() == 0:
        return 0.0
    return float(x.std() / x.mean())


_RAMP = " .:-=+*#%@"


def ascii_heatmap(grid, width: int = 2) -> str:
    """Render a 2-D nonnegative array as an ASCII intensity map (one glyph
    per cell, ``width`` chars wide), normalized to the array max."""
    g = np.asarray(grid, dtype=np.float64)
    if g.ndim != 2:
        raise ValueError(f"heatmap needs a 2-D array, got shape {g.shape}")
    peak = g.max()
    lines = []
    for row in g:
        cells = []
        for v in row:
            lvl = 0 if peak <= 0 else int(round((len(_RAMP) - 1) * v / peak))
            cells.append(_RAMP[lvl] * width)
        lines.append("".join(cells))
    return "\n".join(lines)


@dataclasses.dataclass
class FlowReport:
    """Per-link flow matrix of one placement, with hotspot / imbalance /
    locality summaries. Build with :func:`flow_report`."""
    topology: dict               # Topology.describe()
    n_links: int
    n_active_links: int
    total_bytes: float           # Σ edge volumes
    byte_hops: float             # Σ bytes × hops == link_loads.sum()
    max_link: float
    mean_active_link: float
    gini: float                  # over active-link loads
    cov: float                   # over active-link loads
    top_links: list              # [{link, src, dst, bytes, interchip}] desc
    per_chip_bytes: dict         # chip -> intra-chip bytes
    interchip_bytes: float
    link_loads: np.ndarray       # [n_links]
    core_traffic: np.ndarray     # [rows, cols]

    def to_dict(self) -> dict:
        """JSON-able summary (link_loads/core_traffic arrays elided)."""
        return {
            "topology": self.topology,
            "n_links": self.n_links,
            "n_active_links": self.n_active_links,
            "total_bytes": self.total_bytes,
            "byte_hops": self.byte_hops,
            "max_link": self.max_link,
            "mean_active_link": self.mean_active_link,
            "gini": self.gini,
            "cov": self.cov,
            "top_links": self.top_links,
            "per_chip_bytes": {str(k): v
                               for k, v in self.per_chip_bytes.items()},
            "interchip_bytes": self.interchip_bytes,
        }

    def heatmap(self, width: int = 2) -> str:
        """ASCII per-core routed-traffic map (rows × cols grid)."""
        return ascii_heatmap(self.core_traffic, width=width)

    # Heatmap ceiling for render(): above this many cores the per-core glyph
    # map (O(cells) string) is unreadable and slow to build, so render()
    # switches to a top-k hottest-core summary. 4096 = a 64x64 chip; every
    # historical (<= pod-scale) topology renders identically.
    MAX_HEATMAP_CELLS = 4096

    def render(self, top_k: int = 10,
               max_heatmap_cells: int | None = None) -> str:
        """Human-readable report (what ``python -m repro_torch.deploy
        report`` prints).

        On topologies above ``max_heatmap_cells`` cores (default
        :data:`MAX_HEATMAP_CELLS`) the ASCII heatmap is replaced by the
        ``top_k`` hottest cores plus distribution stats, so the report stays
        terminal-sized on pod-scale meshes."""
        t = self.topology
        lines = [
            f"flow report: {t.get('kind', '?')} "
            f"{t.get('rows', '?')}x{t.get('cols', '?')} "
            f"({self.n_links} links, {self.n_active_links} active)",
            f"  total bytes     {self.total_bytes:.4e}",
            f"  byte-hops       {self.byte_hops:.4e}",
            f"  max link        {self.max_link:.4e}",
            f"  mean activelink {self.mean_active_link:.4e}",
            f"  gini / cov      {self.gini:.4f} / {self.cov:.4f}",
        ]
        if self.per_chip_bytes and len(self.per_chip_bytes) > 1:
            chip_str = "  ".join(f"chip{c}={b:.3e}"
                                 for c, b in sorted(self.per_chip_bytes.items()))
            lines.append(f"  per-chip bytes  {chip_str}")
            lines.append(f"  interchip bytes {self.interchip_bytes:.4e}")
        lines.append(f"  top {min(top_k, len(self.top_links))} links:")
        for entry in self.top_links[:top_k]:
            ic = "  [interchip]" if entry["interchip"] else ""
            lines.append(f"    {entry['link']}: {entry['bytes']:.4e}{ic}")
        cap = (self.MAX_HEATMAP_CELLS if max_heatmap_cells is None
               else max_heatmap_cells)
        ct = np.asarray(self.core_traffic, dtype=np.float64)
        if ct.size <= cap:
            lines.append("  per-core traffic heatmap "
                         f"(max={float(ct.max()):.3e}):")
            for row in self.heatmap().splitlines():
                lines.append("    " + row)
        else:
            flat = ct.ravel()
            order = np.argsort(flat, kind="stable")[::-1]
            k = min(top_k, int((flat > 0).sum()))
            lines.append(f"  per-core traffic: {ct.size} cores (heatmap "
                         f"suppressed above {cap}); top {k} cores:")
            cols = ct.shape[1]
            for core in order[:k]:
                r, c = divmod(int(core), cols)
                lines.append(f"    core ({r},{c}): {flat[core]:.4e}")
            active = flat[flat > 0]
            mean = float(active.mean()) if active.size else 0.0
            lines.append(f"    active cores {active.size}, "
                         f"mean {mean:.4e}, max {float(ct.max()):.4e}")
        return "\n".join(lines)


def flow_report(noc, graph, placement, top_k: int = 10) -> FlowReport:
    """Materialize the per-link load vector of ``placement`` and summarize.

    Uses the cached batched route tables (one ``noc_batch`` evaluation,
    float64), so the loads match the reference evaluator exactly on
    integer-volume graphs. ``noc`` is any Topology, ``graph`` a LogicalGraph,
    ``placement`` an [n] core-index array (or anything carrying one in a
    ``.placement`` attribute — a ``PlacementResult``, a ``DeploymentPlan``'s
    placement entry).
    """
    from ..core.noc_batch import batched_noc

    while hasattr(placement, "placement"):     # PlacementResult etc.
        placement = placement.placement
    bn = batched_noc(noc)
    m = bn.evaluate(graph, np.asarray(placement, dtype=int)[None, :],
                    backend="numpy")
    loads = np.asarray(m.link_traffic[0], dtype=np.float64)
    active = loads[loads > 0]

    ic_mask = noc.interchip_mask()
    src = np.asarray(noc.link_src_array(), dtype=np.int64)
    chip_of = noc.chip_of_array()

    order = np.argsort(loads, kind="stable")[::-1]
    top = []
    for lid in order[:top_k]:
        if loads[lid] <= 0:
            break
        top.append({
            "link": repr(noc.link_label(int(lid))),
            "src": int(src[lid]),
            "dst": int(np.asarray(noc.link_dst_array())[lid]),
            "bytes": float(loads[lid]),
            "interchip": bool(ic_mask is not None and ic_mask[lid]),
        })

    # vectorized per-chip / inter-chip totals: np.bincount accumulates in
    # ascending link-id order, the same addition sequence as the historical
    # per-link Python loop, so the floats are bit-identical
    active_ids = np.nonzero(loads)[0]
    ic = (ic_mask[active_ids] if ic_mask is not None
          else np.zeros(active_ids.size, dtype=bool))
    interchip_total = float(loads[active_ids[ic]].sum())
    intra = active_ids[~ic]
    per_chip: dict = {}
    if intra.size:
        sums = np.bincount(chip_of[src[intra]], weights=loads[intra])
        per_chip = {int(c): float(sums[c]) for c in np.nonzero(sums)[0]}

    edges_total = float(graph.edge_arrays()[2].sum())
    return FlowReport(
        topology=noc.describe(),
        n_links=int(loads.size),
        n_active_links=int(active.size),
        total_bytes=edges_total,
        byte_hops=float(loads.sum()),
        max_link=float(m.max_link[0]),
        mean_active_link=float(active.mean()) if active.size else 0.0,
        gini=gini(active),
        cov=cov(active),
        top_links=top,
        per_chip_bytes=per_chip,
        interchip_bytes=interchip_total,
        link_loads=loads,
        core_traffic=np.asarray(m.core_traffic[0], dtype=np.float64),
    )
