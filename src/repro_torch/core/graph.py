"""Logical task graphs (paper §3.1, Definition A).

A :class:`LogicalGraph` is the weighted DAG ``M(A, E)`` produced by partitioning a
model: nodes are model slices ("logical cores"), edge weights are communication data
volumes in bytes. Node attributes carry the compute/storage costs used by the
partitioner and the five node features of the paper's RL state (§4.3):
``[multicast, in_degree, out_degree, in_volume, out_volume]``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

N_NODE_FEATURES = 5


@dataclasses.dataclass
class LogicalGraph:
    """Weighted DAG of logical cores.

    adj[i, j] = bytes sent from node i to node j per step (0 if no edge).
    compute[i] = per-step compute cost of node i (seconds, or normalized units).
    memory[i]  = bytes of state (weights + activations) resident on node i.
    chip_of[i] = chip the partitioner assigned node i to (chip-aware
                 partitioning only; ``None`` means chip-oblivious — every
                 historical path).
    """

    adj: np.ndarray
    compute: np.ndarray
    memory: np.ndarray
    names: list | None = None
    chip_of: np.ndarray | None = None

    def __post_init__(self):
        self.adj = np.asarray(self.adj, dtype=np.float64)
        n = self.adj.shape[0]
        if self.adj.shape != (n, n):
            raise ValueError("adj must be square")
        self.compute = np.asarray(self.compute, dtype=np.float64).reshape(n)
        self.memory = np.asarray(self.memory, dtype=np.float64).reshape(n)
        if self.names is None:
            self.names = [f"n{i}" for i in range(n)]
        if self.chip_of is not None:
            self.chip_of = np.asarray(self.chip_of, dtype=np.int64).reshape(n)

    @property
    def n(self) -> int:
        return self.adj.shape[0]

    @property
    def edges(self):
        """List of (src, dst, bytes) for nonzero edges."""
        src, dst = np.nonzero(self.adj)
        return [(int(i), int(j), float(self.adj[i, j])) for i, j in zip(src, dst)]

    def edge_arrays(self):
        """``(src, dst, vol)`` ndarrays of the nonzero edges, in the same
        row-major order as :attr:`edges`.

        The vectorized form of the edge list: one ``np.nonzero`` scan and one
        fancy-gather instead of a Python list of per-edge tuples — the setup
        path every hot consumer (`noc_batch` table building, the reference
        evaluators, flow reports) reads at 10⁴+ edges.
        """
        src, dst = np.nonzero(self.adj)
        return (src.astype(np.int64), dst.astype(np.int64),
                self.adj[src, dst].astype(np.float64))

    # ---- chip-cut tagging (chip-aware partitioning, paper §4.2 co-design) ----
    def chip_cut_mask(self) -> np.ndarray:
        """[n, n] bool — True where an edge's endpoints live on different
        chips under the partitioner's ``chip_of`` assignment. All-False when
        the partition was chip-oblivious (``chip_of is None``)."""
        if self.chip_of is None:
            return np.zeros_like(self.adj, dtype=bool)
        return (self.chip_of[:, None] != self.chip_of[None, :]) & (self.adj > 0)

    def chip_cut_bytes(self) -> float:
        """Partition-induced inter-chip traffic (bytes/step) *before* any
        placement: Σ volumes of edges crossing a chip cut. The quantity
        chip-aware partitioning minimizes, and a lower bound on the placed
        interchip bytes of any chip-respecting placement."""
        return float(self.adj[self.chip_cut_mask()].sum())

    # ---- RL state encoding (paper Fig 5) -------------------------------------
    def node_features(self) -> np.ndarray:
        """[n, 5]: multicast flag, in/out degree, in/out data volume (normalized)."""
        a = self.adj
        out_deg = (a > 0).sum(axis=1).astype(np.float64)
        in_deg = (a > 0).sum(axis=0).astype(np.float64)
        out_vol = a.sum(axis=1)
        in_vol = a.sum(axis=0)
        multicast = (out_deg > 1).astype(np.float64)
        feats = np.stack([multicast, in_deg, out_deg, in_vol, out_vol], axis=1)
        # scale-free normalization so PPO is invariant to units
        denom = feats.max(axis=0, keepdims=True)
        denom[denom == 0] = 1.0
        return feats / denom

    def laplacian(self) -> np.ndarray:
        """Symmetric-normalized Laplacian L̂ = D^-1/2 (A_sym + I) D^-1/2 (GCN form)."""
        a = self.adj + self.adj.T
        a = (a > 0).astype(np.float64) + np.eye(self.n)
        d = a.sum(axis=1)
        dinv = 1.0 / np.sqrt(np.maximum(d, 1e-12))
        return (a * dinv[:, None]) * dinv[None, :]

    def total_traffic(self) -> float:
        return float(self.adj.sum())

    def validate_dag(self) -> bool:
        """True iff the graph is acyclic (Kahn)."""
        indeg = (self.adj > 0).sum(axis=0).astype(int)
        stack = [i for i in range(self.n) if indeg[i] == 0]
        seen = 0
        adj_list = [np.nonzero(self.adj[i])[0] for i in range(self.n)]
        while stack:
            u = stack.pop()
            seen += 1
            for v in adj_list[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(int(v))
        return seen == self.n


def chain_graph(volumes, compute=None, memory=None) -> LogicalGraph:
    """Simple chain DAG: node i -> i+1 with volumes[i] bytes."""
    n = len(volumes) + 1
    adj = np.zeros((n, n))
    for i, v in enumerate(volumes):
        adj[i, i + 1] = v
    compute = np.ones(n) if compute is None else compute
    memory = np.ones(n) if memory is None else memory
    return LogicalGraph(adj, compute, memory)


def random_dag(n: int, p: float = 0.3, seed: int = 0,
               vol_scale: float = 1024.0) -> LogicalGraph:
    """Random DAG for property tests: edges only i->j with i<j."""
    rng = np.random.default_rng(seed)
    adj = np.triu(rng.random((n, n)) < p, k=1).astype(np.float64)
    adj *= rng.uniform(0.1, 1.0, (n, n)) * vol_scale
    # keep the chain so the graph is connected
    for i in range(n - 1):
        if adj[i, i + 1] == 0:
            adj[i, i + 1] = vol_scale * rng.uniform(0.1, 1.0)
    compute = rng.uniform(0.5, 2.0, n)
    memory = rng.uniform(0.5, 2.0, n) * 1e6
    return LogicalGraph(adj, compute, memory)


# ---------------------------------------------------------------------------
# Large-graph workload generators (multilevel placement, 10^3 - 10^5 nodes)
# ---------------------------------------------------------------------------
# All three build the dense ``adj`` through vectorized index assignment (no
# per-edge Python loop), so generation stays seconds-scale at 10^4+ nodes.
# The dense [n, n] float64 adjacency is the practical memory ceiling: ~2 GB
# at n=16384, ~80 GB at n=10^5 — size to the host.


def layered_dag(n_layers: int, width: int, fanout: int = 3,
                skip_p: float = 0.02, seed: int = 0,
                vol_scale: float = 1024.0) -> LogicalGraph:
    """Layered feedforward DAG with ``n_layers * width`` nodes.

    Each node feeds ``fanout`` consecutive (wrapping) positions of the next
    layer — the sliced-CNN/SNN traffic shape of the paper's partitioned
    models — plus a sparse set of longer skip edges (``skip_p`` per node,
    always >= 2 layers forward, so the graph stays acyclic). The workhorse
    synthetic instance for scaling placement search to 10^3-10^5 logical
    cores.
    """
    if n_layers < 2 or width < 1 or fanout < 1:
        raise ValueError("need n_layers >= 2, width >= 1, fanout >= 1")
    n = n_layers * width
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n))
    pos = np.arange(width)
    for layer in range(n_layers - 1):
        base, nxt = layer * width, (layer + 1) * width
        for k in range(min(fanout, width)):
            adj[base + pos, nxt + (pos + k) % width] = \
                vol_scale * rng.uniform(0.1, 1.0, width)
    n_skips = int(skip_p * n)
    if n_layers > 2 and n_skips:
        sl = rng.integers(0, n_layers - 2, n_skips)
        dl = sl + 2 + (rng.random(n_skips) * (n_layers - 2 - sl)).astype(int)
        si = sl * width + rng.integers(0, width, n_skips)
        di = dl * width + rng.integers(0, width, n_skips)
        adj[si, di] = vol_scale * rng.uniform(0.1, 1.0, n_skips)
    compute = rng.uniform(0.5, 2.0, n)
    memory = rng.uniform(0.5, 2.0, n) * 1e6
    return LogicalGraph(adj, compute, memory)


def moe_dag(n_blocks: int, n_experts: int, top_k: int = 8, seed: int = 0,
            vol_scale: float = 4096.0) -> LogicalGraph:
    """MoE-style DAG: per block a router fans out to ``n_experts`` expert
    nodes and a combine node gathers them; blocks are chained.

    ``n = n_blocks * (n_experts + 2)`` nodes. Router->expert volumes follow a
    sparse Dirichlet gate: the block's ``top_k`` experts carry the bulk of
    the bytes, the rest a small residual — the high-fan-out, weight-skewed
    traffic that defeats flat swap search (``moe_dag(64, 254)`` is the
    16384-node headline instance of ``benchmarks/multilevel.py``).
    """
    if n_blocks < 1 or n_experts < 1 or not (1 <= top_k <= n_experts):
        raise ValueError("need n_blocks >= 1, 1 <= top_k <= n_experts")
    stride = n_experts + 2
    n = n_blocks * stride
    adj = np.zeros((n, n))
    rng = np.random.default_rng(seed)
    e = np.arange(n_experts)
    for b in range(n_blocks):
        router = b * stride
        experts = router + 1 + e
        combine = router + 1 + n_experts
        gates = rng.dirichlet(np.full(n_experts, 0.3))
        top = np.argsort(gates, kind="stable")[::-1][:top_k]
        w = np.full(n_experts, 0.05 / n_experts)
        w[top] += 0.95 * gates[top] / gates[top].sum()
        adj[router, experts] = vol_scale * w
        adj[experts, combine] = vol_scale * w
        if b + 1 < n_blocks:
            adj[combine, (b + 1) * stride] = vol_scale
    compute = np.full(n, 0.1)
    # experts work in proportion to their routed bytes; routers/combines light
    for b in range(n_blocks):
        router = b * stride
        compute[router + 1 + e] = 0.1 + adj[router, router + 1 + e] / vol_scale
    memory = np.full(n, 1e5)
    memory[np.add.outer(np.arange(0, n, stride), 1 + e).ravel()] = 4e6
    return LogicalGraph(adj, compute, memory)
