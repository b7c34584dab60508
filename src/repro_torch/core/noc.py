"""2D mesh/torus NoC model (paper §3.2, §5 evaluation platform).

The paper evaluates placements on a simulator of its many-core near-memory
chip: a 2D mesh NoC with deterministic shortest-path ("clockwise search")
routing, one router per core, 4 neighbour links. Since the topology refactor
the machinery lives in :class:`repro.core.topology.GridTopology` (of which
:class:`NoC` is the flat single-chip case — bit-identical routes, metrics and
optimizer trajectories, snapshot-pinned in ``tests/test_topology.py``):

* ``route(src, dst)``    — deterministic dimension-ordered (XY) shortest path; on a
  torus each dimension independently picks the shorter wrap direction (clockwise
  tie-break, matching the paper's clockwise search).
* ``evaluate(graph, placement)`` — accumulates per-link traffic for every logical edge
  and derives the paper's metrics: total communication cost (Σ bytes×hops, which equals
  total link traffic, the CDV objective of Eq. 4), hop histogram, per-core hotspot map,
  and an analytic latency/throughput estimate.

The same evaluator doubles as the ICI traffic model for TPU pods (``tpu_adapter``):
a v5e pod is a 16×16 torus of chips, so ``NoC(16, 16, torus=True)`` with
link bandwidth = ICI bandwidth scores TPU device orderings. Multi-chip systems
with asymmetric inter-chip links are :class:`repro.core.topology.
HierarchicalMesh`; every optimizer and batched scoring backend accepts any
:class:`repro.core.topology.Topology`.
"""
from __future__ import annotations

from .topology import GridTopology, NoCMetrics  # noqa: F401  (re-export)


class NoC(GridTopology):
    """Single-chip 2D mesh/torus — the flat special case of
    :class:`repro.core.topology.GridTopology` (all behaviour lives there)."""
