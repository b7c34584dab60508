"""The paper's placement problem on a GPU cluster: the port's
``repro.core.tpu_adapter``.

A cluster of H100 nodes is structurally the paper's hierarchical NoC: eight
GPUs of a node share NVLink (450 GB/s each way a GPU), and nodes are joined
by InfiniBand (one 400 Gb/s NIC a GPU, 50 GB/s). NCCL owns the routing of
each collective, so placement acts one level up: the permutation from
*logical mesh positions* (what a DeviceMesh's dims index) to *physical
GPUs* decides which collectives stay inside a node. As the reference does,
we

1. take the collectives of a step, here from its op trace
   (``core/trace_analysis.py``: :func:`trace_collectives`), with per-device
   operand bytes and their process groups;
2. build a device-level :class:`LogicalGraph` whose edges are per-step bytes
   between logical devices (:func:`collective_traffic_graph`): ring
   neighbours for all-reduce/all-gather/reduce-scatter, all pairs within a
   group for all-to-all;
3. score and optimize the logical→physical assignment with the paper's
   machinery (:func:`optimize_device_order`) and reorder the ranks for
   ``launch.mesh.make_production_mesh(placement=...)``.

The trace names each collective's process group, so
:func:`traffic_from_trace` attributes it to the mesh dim whose group it ran
on; the reference guesses the axis from the group's size
(``traffic_from_hlo``). The TPU models (:func:`pod_noc`,
:func:`multislice_pod`) are kept with the reference's numbers;
:func:`nvlink_cluster` is the GPU system's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..device import resolve_backend
from .graph import LogicalGraph
from .noc import NoC
from .topology import HierarchicalMesh

@dataclasses.dataclass
class CollectiveOp:
    kind: str                 # the reference's name: all-reduce, ...
    out_bytes: float          # per-device output bytes
    group_size: int           # devices participating per group
    source_target_pairs: list | None = None
    group_ranks: tuple = ()   # the ranks of this device's group
    count: int = 1            # runs of it in the step (a folded loop's)

    @property
    def operand_bytes(self) -> float:
        """Per-device operand ("input shard") bytes — roofline's
        collective_bytes."""
        if self.kind == "all-gather":
            return self.out_bytes / max(self.group_size, 1)
        if self.kind == "reduce-scatter":
            return self.out_bytes * max(self.group_size, 1)
        return self.out_bytes

    @property
    def wire_bytes(self) -> float:
        """Bytes each device actually moves over links (ring algorithms)."""
        s = max(self.group_size, 1)
        if self.kind == "all-reduce":
            return 2.0 * (s - 1) / s * self.out_bytes
        if self.kind == "all-gather":
            return (s - 1) / s * self.out_bytes
        if self.kind == "reduce-scatter":
            return (s - 1) / s * self.operand_bytes
        if self.kind == "all-to-all":
            return (s - 1) / s * self.out_bytes
        return self.out_bytes   # collective-permute


def trace_collectives(trace) -> list:
    """The collectives of an op trace (a ``Trace`` or a list of its ops) as
    :class:`CollectiveOp`s, with the output bytes the reference's parser
    reads off an HLO instruction."""
    ops = trace.ops if hasattr(trace, "ops") else trace
    out = []
    for op in ops:
        if "kind" not in op.attrs:
            continue
        a = op.attrs
        # a permute receives what it sends (see trace_analysis)
        descs = op.inputs if a["kind"] == "collective-permute" else \
            op.outputs
        out_b = sum(float(np.prod(d[0])) * d[2] for d in descs)
        out.append(CollectiveOp(a["kind"], out_b, a["group_size"], None,
                                tuple(a["group_ranks"]), op.count))
    return out


def collective_bytes(trace) -> dict:
    """Aggregate per-device collective bytes by kind + totals."""
    ops = trace_collectives(trace)
    by_kind: dict = {}
    for op in ops:
        d = by_kind.setdefault(op.kind, {"count": 0, "operand_bytes": 0.0,
                                         "wire_bytes": 0.0})
        d["count"] += op.count
        d["operand_bytes"] += op.operand_bytes * op.count
        d["wire_bytes"] += op.wire_bytes * op.count
    total_operand = sum(d["operand_bytes"] for d in by_kind.values())
    total_wire = sum(d["wire_bytes"] for d in by_kind.values())
    return {"by_kind": by_kind, "operand_bytes": total_operand,
            "wire_bytes": total_wire, "n_ops": sum(op.count for op in ops)}


# ---------------------------------------------------------------------------
# Device-level traffic graph
# ---------------------------------------------------------------------------

def _axis_groups(mesh_shape, axis: int):
    """Groups of flat logical device ids that share all coords except
    ``axis``."""
    n = int(np.prod(mesh_shape))
    ids = np.arange(n).reshape(mesh_shape)
    moved = np.moveaxis(ids, axis, -1)
    return moved.reshape(-1, mesh_shape[axis])


def collective_traffic_graph(mesh_shape, axis_traffic: dict,
                             a2a_traffic: dict | None = None,
                             compute=None) -> LogicalGraph:
    """Build the device-level logical graph from per-axis collective traffic.

    axis_traffic: {axis_index: per-device ring bytes} — ring collectives
      (all-reduce / all-gather / reduce-scatter) put their wire bytes on the
      two ring-neighbour edges of each group member.
    a2a_traffic:  {axis_index: per-device a2a bytes} — all-to-all spreads
      bytes/(S-1) onto every pair in the group (MoE dispatch).
    """
    n = int(np.prod(mesh_shape))
    adj = np.zeros((n, n))
    for axis, bytes_per_dev in (axis_traffic or {}).items():
        for group in _axis_groups(mesh_shape, axis):
            s = len(group)
            if s < 2:
                continue
            per_edge = bytes_per_dev / 2.0     # ring splits onto 2 directions
            for i in range(s):
                a, b = group[i], group[(i + 1) % s]
                adj[a, b] += per_edge
                adj[b, a] += per_edge
    for axis, bytes_per_dev in (a2a_traffic or {}).items():
        for group in _axis_groups(mesh_shape, axis):
            s = len(group)
            if s < 2:
                continue
            per_pair = bytes_per_dev / (s - 1)
            for i in range(s):
                for j in range(s):
                    if i != j:
                        adj[group[i], group[j]] += per_pair
    if compute is None:
        compute = np.ones(n)
    return LogicalGraph(adj, compute, np.zeros(n))


def mesh_axis_of(group_ranks, mesh) -> int | None:
    """The dim of ``mesh`` (a DeviceMesh) whose process group holds exactly
    ``group_ranks`` (this rank's group along that dim), else None."""
    import torch.distributed as dist
    ranks = sorted(group_ranks)
    for d in range(mesh.ndim):
        if sorted(dist.get_process_group_ranks(mesh.get_group(d))) == ranks:
            return d
    return None


def traffic_from_trace(trace, mesh) -> LogicalGraph:
    """Attribute each traced collective to the mesh dim whose process group
    it ran on (exact: the trace keeps the group's ranks); a collective over
    a group that is no single dim's (a flattened pair of dims) is skipped,
    as the reference skips a group size no axis has."""
    axis_traffic: dict = {}
    a2a_traffic: dict = {}
    for op in trace_collectives(trace):
        axis = mesh_axis_of(op.group_ranks, mesh)
        if axis is None:
            continue
        target = a2a_traffic if op.kind == "all-to-all" else axis_traffic
        target[axis] = target.get(axis, 0.0) + op.wire_bytes * op.count
    return collective_traffic_graph(tuple(mesh.shape), axis_traffic,
                                    a2a_traffic)


# ---------------------------------------------------------------------------
# Placement of logical devices on the physical system
# ---------------------------------------------------------------------------

def pod_noc(rows: int = 16, cols: int = 16, link_bw: float = 50e9) -> NoC:
    """v5e pod: 2D torus, ~50 GB/s per ICI link (the reference's model)."""
    return NoC(rows, cols, torus=True, link_bw=link_bw, core_flops=197e12)


def multislice_pod(slice_grid=(2, 2), slice_shape=(8, 8),
                   ici_bw: float = 50e9, dcn_bw: float = 6.25e9,
                   dcn_latency: float = 1e-5,
                   core_flops: float = 197e12) -> HierarchicalMesh:
    """Multi-slice deployment: a grid of ICI-mesh slices joined by DCN (the
    reference's model); :func:`optimize_device_order` runs on it
    unchanged."""
    return HierarchicalMesh(slice_grid[0], slice_grid[1],
                            slice_shape[0], slice_shape[1],
                            interchip_bw=dcn_bw, link_bw=ici_bw,
                            core_flops=core_flops, hop_latency=1e-6,
                            interchip_latency=dcn_latency)


def nvlink_cluster(node_grid, node_shape=(2, 4), nvlink_bw: float = 450e9,
                   ib_bw: float = 50e9, ib_latency: float = 5e-6,
                   core_flops: float = 989e12) -> HierarchicalMesh:
    """H100 nodes of ``node_shape`` GPUs (8) on a ``node_grid`` joined by
    InfiniBand: :func:`multislice_pod` with the GPU system's rates (NVLink
    450 GB/s each way a GPU, one 400 Gb/s NIC a GPU, dense bf16 989
    TFLOP/s). An approximation: NVSwitch makes any two GPUs of a node one
    hop apart, where the grid model counts up to four (``2 x 4``) hops;
    what it keeps is the two link classes, NVLink inside a node and
    InfiniBand between nodes."""
    return multislice_pod(node_grid, node_shape, ici_bw=nvlink_bw,
                          dcn_bw=ib_bw, dcn_latency=ib_latency,
                          core_flops=core_flops)


def gpu_cores(noc: HierarchicalMesh) -> np.ndarray:
    """The core of each GPU rank on a cluster model: node-major (rank ``r``
    in node ``r // (GPUs a node)``, nodes in row-major order), row-major
    within a node. The order in which ranks are numbered, as the default
    device order of the cluster."""
    nodes = noc.chip_of_array()
    order = np.lexsort((np.arange(noc.n_cores), nodes))
    return order


def default_assignment(n_devices: int) -> np.ndarray:
    return np.arange(n_devices)


def ici_cost(graph: LogicalGraph, noc: NoC, assignment=None) -> dict:
    assignment = (default_assignment(graph.n) if assignment is None
                  else assignment)
    m = noc.evaluate(graph, assignment)
    return {"comm_cost": m.comm_cost, "mean_hops": m.mean_hops,
            "max_link": m.max_link, "latency": m.latency}


def ici_cost_batch(graph: LogicalGraph, noc: NoC, assignments,
                   backend: str | None = None, device=None) -> dict:
    """Batched :func:`ici_cost`: score a [B, n] population of device
    orderings in one vectorized :mod:`..core.noc_batch` call. ``backend``
    None: the port's resolver (``"cuda"`` for the card, ``device=None``;
    numpy float64 for ``device="cpu"``)."""
    from .noc_batch import evaluate_batch
    m = evaluate_batch(noc, graph, assignments,
                       backend=resolve_backend(backend, device),
                       device=device)
    return {"comm_cost": m.comm_cost, "mean_hops": m.mean_hops,
            "max_link": m.max_link, "latency": m.latency}


def optimize_device_order(graph: LogicalGraph, noc: NoC, method: str = "ppo",
                          budget: int | None = None, seed: int = 0,
                          backend: str | None = None, device=None, **kw):
    """Paper's optimizer applied to the device graph. Returns (assignment,
    PlacementResult); ``assignment[logical] = physical core index``.
    ``backend`` and ``device`` as ``core.placement.optimize_placement``
    takes them (None, None: the card's scorer)."""
    from .placement import optimize_placement
    res = optimize_placement(graph, noc, method=method, budget=budget,
                             seed=seed, backend=backend, device=device, **kw)
    return res.placement, res


def apply_assignment(ranks, assignment, mesh_shape):
    """Reorder ``ranks`` so logical mesh position i is served by physical
    rank ``ranks[assignment[i]]``, shaped ``mesh_shape``: the rank array
    ``launch.mesh.make_production_mesh(placement=assignment)`` builds its
    mesh over."""
    ranks = list(ranks)
    n = int(np.prod(mesh_shape))
    if len(ranks) != n:
        raise ValueError(f"need {n} devices, got {len(ranks)}")
    ordered = [ranks[int(p)] for p in np.asarray(assignment)]
    return np.asarray(ordered, dtype=object).reshape(mesh_shape)
