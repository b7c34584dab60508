"""Balanced compute+storage model partitioning (paper §4.2, Fig 4).

The paper partitions each layer along input channels C / output channels K, *unevenly
across layers*, so that every logical core's per-step latency — compute time **plus**
weight-streaming time for slices whose weights spill out of on-chip SRAM — is balanced.
This avoids the "bucket effect" of compute-only balancing (late layers stall streaming
weights) and of storage-only balancing (early layers stall on compute).

Three strategies are implemented for the Fig 4 comparison:

* ``compute``  — allocate cores ∝ FLOPs (Core-Placement-style uniform compute split),
* ``storage``  — allocate cores ∝ weight bytes,
* ``balanced`` — allocate cores ∝ modeled slice latency (compute + spill streaming),
  then refine allocation greedily to minimize the maximum per-core latency.

Two *chip-aware* strategies close the partition→topology co-design loop on
multi-chip systems (:class:`repro.core.topology.HierarchicalMesh`), where the
flat strategies routinely slice a layer across a chip boundary and force the
placement optimizer to burn inter-chip bandwidth fixing a partition-time
mistake (cf. Song et al.'s SNN design flow and ILP crossbar mapping, which
treat partition and mapping as one problem):

* ``chip``          — first allocate whole layers / contiguous layer groups to
  chips by DP, minimizing the activation bytes that must cross chip cuts
  subject to every chip's latency staying within a slack band of the best
  achievable balance (each chip's aggregate SRAM/FLOPs budget is what the
  latency model reads); then run the existing ``balanced`` compute+storage
  refinement *within* each chip.
* ``chip_balanced`` — same two-level flow, but the chip allocation strictly
  minimizes the per-chip latency bucket first and only tie-breaks on cut
  bytes (balance-first; ``chip`` is cut-first).

Both require ``topology=``; on a single-chip topology they degenerate to
``balanced`` (with an all-zero chip assignment). The resulting
:class:`Partition` carries ``chip_of`` (slice → chip) and
:meth:`Partition.to_graph` tags the logical graph with it, so objectives can
score partition-induced interchip traffic *before* any placement and
optimizers can seed searches with chip-respecting initializations.

``Partition.to_graph()`` lowers a partition to the weighted logical DAG consumed by the
placement optimizer: slice s of layer l multicasts its activation shard to every slice
of layer l+1 (K-split consumers need the full input), which is exactly the multicast
node feature the RL state encodes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import LogicalGraph


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Per-layer cost profile (built by snn.profile / models cost model)."""
    name: str
    flops: float              # per-sample forward FLOPs
    weight_bytes: float
    out_bytes: float          # activation bytes produced per sample
    c_in: int = 1
    c_out: int = 1


@dataclasses.dataclass(frozen=True)
class CoreSpec:
    """Hardware model of one near-memory core (or one TPU chip for the adapter)."""
    sram_bytes: float = 2 * 2 ** 20       # on-core SRAM for weights
    flops_per_s: float = 25.6e9           # 16x16 MAC @ 100MHz, FP16
    stream_bw: float = 8e9                # off-chip weight streaming bandwidth
    def __post_init__(self):
        assert self.sram_bytes > 0 and self.flops_per_s > 0 and self.stream_bw > 0


@dataclasses.dataclass(frozen=True)
class Slice:
    layer: int
    name: str
    frac: float               # fraction of the layer's K channels
    flops: float
    weight_bytes: float
    out_bytes: float

    def latency(self, core: CoreSpec) -> float:
        compute = self.flops / core.flops_per_s
        spill = max(self.weight_bytes - core.sram_bytes, 0.0)
        return compute + spill / core.stream_bw


@dataclasses.dataclass
class Partition:
    slices: list
    core: CoreSpec
    strategy: str
    chip_of: np.ndarray | None = None   # [n] slice -> chip (chip-aware only)

    @property
    def n(self) -> int:
        return len(self.slices)

    def latencies(self) -> np.ndarray:
        return np.array([s.latency(self.core) for s in self.slices])

    def imbalance(self) -> float:
        """Bucket-effect metric: max/mean per-core latency (1.0 = perfect)."""
        lat = self.latencies()
        return float(lat.max() / lat.mean()) if lat.size else 1.0

    @property
    def n_chips(self) -> int:
        """Chips the slices are assigned over (1 when chip-oblivious)."""
        if self.chip_of is None:
            return 1
        return int(self.chip_of.max()) + 1 if self.chip_of.size else 1

    def chip_loads(self) -> np.ndarray:
        """[n_chips] max per-slice latency on each chip (the per-chip bucket
        the chip-aware DP balances)."""
        lat = self.latencies()
        chips = self.chip_of if self.chip_of is not None \
            else np.zeros(self.n, dtype=np.int64)
        out = np.zeros(self.n_chips)
        np.maximum.at(out, chips, lat)
        return out

    def interchip_bytes(self) -> float:
        """Partition-induced inter-chip traffic (bytes/step), before any
        placement — Σ volumes of logical edges whose endpoints the partitioner
        assigned to different chips. 0.0 when chip-oblivious."""
        return self.to_graph().chip_cut_bytes()

    def to_graph(self) -> LogicalGraph:
        n = len(self.slices)
        adj = np.zeros((n, n))
        by_layer: dict = {}
        for idx, s in enumerate(self.slices):
            by_layer.setdefault(s.layer, []).append(idx)
        layers = sorted(by_layer)
        for a, b in zip(layers[:-1], layers[1:]):
            for i in by_layer[a]:
                for j in by_layer[b]:
                    # K-split consumer needs the producer's full activation shard
                    adj[i, j] = self.slices[i].out_bytes
        compute = np.array([s.flops for s in self.slices])
        memory = np.array([s.weight_bytes for s in self.slices])
        return LogicalGraph(adj, compute, memory,
                            names=[s.name for s in self.slices],
                            chip_of=self.chip_of)


#: Chip-aware strategies (two-level: layers -> chips, then balanced within).
CHIP_STRATEGIES = ("chip", "chip_balanced")

#: All partition_model strategies.
STRATEGIES = ("compute", "storage", "balanced") + CHIP_STRATEGIES

#: Latency slack band of the cut-minimizing ``chip`` DP: a chip may run up to
#: this fraction above the best achievable per-chip balance if that lets the
#: cut land at a cheaper layer boundary.
CHIP_LATENCY_SLACK = 0.25


def _layer_weight(layer: LayerProfile, strategy: str, core: CoreSpec) -> float:
    if strategy == "compute":
        return layer.flops
    if strategy == "storage":
        return layer.weight_bytes
    if strategy in ("balanced",) + CHIP_STRATEGIES:
        # chip-aware strategies balance the same modeled slice latency
        return Slice(0, layer.name, 1.0, layer.flops, layer.weight_bytes,
                     layer.out_bytes).latency(core)
    raise ValueError(f"unknown strategy {strategy!r}; "
                     f"choose from {STRATEGIES}")


def _alloc_largest_remainder(weights: np.ndarray, n_cores: int) -> np.ndarray:
    """Integer core counts per layer, >=1 each, summing to n_cores."""
    n_layers = len(weights)
    if n_cores < n_layers:
        raise ValueError(f"need >= {n_layers} cores, got {n_cores}")
    w = np.maximum(np.asarray(weights, dtype=np.float64), 1e-30)
    ideal = w / w.sum() * n_cores
    alloc = np.maximum(np.floor(ideal).astype(int), 1)
    while alloc.sum() > n_cores:                       # floored over budget (rare)
        over = alloc - ideal
        over[alloc <= 1] = -np.inf
        i = int(np.argmax(over))
        if alloc[i] <= 1:  # nothing left to take
            break
        alloc[i] -= 1
    rem = ideal - alloc
    order = np.argsort(-rem)
    k = 0
    while alloc.sum() < n_cores:
        alloc[order[k % n_layers]] += 1
        k += 1
    return alloc


def _slice_layer(li: int, layer: LayerProfile, n_slices: int) -> list:
    """Even K-split within a layer (within one layer the cost is symmetric in
    channel fraction, so equal fractions minimize the within-layer maximum;
    the *cross-layer* allocation carries the unevenness)."""
    out: list = []
    base = layer.c_out // n_slices
    extra = layer.c_out % n_slices
    for s in range(n_slices):
        k = base + (1 if s < extra else 0)
        frac = k / max(layer.c_out, 1)
        out.append(Slice(
            layer=li, name=f"{layer.name}.s{s}", frac=frac,
            flops=layer.flops * frac,
            weight_bytes=layer.weight_bytes * frac,
            out_bytes=layer.out_bytes * frac,
        ))
    return out


def _group_contiguous(weights: np.ndarray, k: int) -> list:
    """Optimal contiguous k-way partition minimizing max group weight
    (binary search on capacity + greedy feasibility)."""
    w = np.asarray(weights, dtype=np.float64)
    lo, hi = w.max(), w.sum()

    def fits(cap):
        groups, cur, cnt = [], 0.0, 1
        bounds = []
        for i, x in enumerate(w):
            if cur + x > cap and cur > 0:
                bounds.append(i)
                cnt += 1
                cur = x
            else:
                cur += x
        return cnt <= k, bounds

    for _ in range(60):
        mid = 0.5 * (lo + hi)
        ok, _ = fits(mid)
        if ok:
            hi = mid
        else:
            lo = mid
    _, bounds = fits(hi)
    starts = [0] + bounds + [len(w)]
    groups = [(starts[i], starts[i + 1]) for i in range(len(starts) - 1)]
    while len(groups) < k:                      # split the heaviest splittable group
        sizes = [w[a:b].sum() if b - a > 1 else -1 for a, b in groups]
        gi = int(np.argmax(sizes))
        a, b = groups[gi]
        cum = np.cumsum(w[a:b])
        cut = a + 1 + int(np.argmin(np.abs(cum[:-1] - cum[-1] / 2)))
        groups[gi:gi + 1] = [(a, cut), (cut, b)]
    return groups


def _merge_group(layers, a: int, b: int) -> LayerProfile:
    sub = layers[a:b]
    return LayerProfile(
        name="+".join(l.name for l in sub),
        flops=sum(l.flops for l in sub),
        weight_bytes=sum(l.weight_bytes for l in sub),
        out_bytes=sub[-1].out_bytes,
        c_in=sub[0].c_in, c_out=sub[-1].c_out)


def _unit_latency(layer: LayerProfile, k: int, core: CoreSpec) -> float:
    """Max slice latency of ``layer`` split K-wise over ``k`` cores (O(1):
    the worst slice carries the ceil share of the channels)."""
    if k <= 0:
        return float("inf")
    c_out = max(layer.c_out, 1)
    kk = min(k, c_out)
    share = -(-c_out // kk) / c_out           # ceil(c_out/k)/c_out
    return Slice(0, layer.name, share, layer.flops * share,
                 layer.weight_bytes * share,
                 layer.out_bytes * share).latency(core)


def _chip_latency(units, weights, a: int, b: int, cap: int,
                  core: CoreSpec) -> float:
    """Modeled latency of one chip hosting ``units[a:b]`` on ``cap`` cores:
    the chip's aggregate SRAM/FLOPs budget enters through the per-slice spill
    model after a proportional core allocation (no greedy refinement here —
    the DP calls this O(U²·chips) times; the winner is refined afterwards)."""
    if b - a > cap:                           # each unit needs >= 1 core
        return float("inf")
    if b <= a:
        return 0.0
    alloc = _alloc_largest_remainder(weights[a:b], cap)
    return max(_unit_latency(units[a + i], int(k), core)
               for i, k in enumerate(alloc))


def _chips_dp(units, weights, capacities, core: CoreSpec,
              cut_weights=None, slack: float = 0.0):
    """Contiguous allocation of layer-units to chips (the chip-aware DP).

    Two passes over ``f[c][i]`` = best value assigning the first ``i`` units
    to the first ``c`` chips:

    1. *balance*: minimize the max per-chip latency -> ``B*``;
    2. *cut*: minimize Σ weighted cut bytes (the activation bytes the last
       unit before each chip boundary must ship across it, scaled by
       ``cut_weights`` — the co-partition feedback hook) subject to every
       chip's latency staying within ``B* × (1 + slack)``.

    Returns (list of (a, b) unit ranges per used chip, B*).
    """
    n_units = len(units)
    n_chips = min(len(capacities), n_units)
    caps = [int(c) for c in capacities[:n_chips]]
    cw = np.ones(n_units) if cut_weights is None \
        else np.asarray(cut_weights, dtype=np.float64)
    cut_cost = np.array([u.out_bytes for u in units]) * cw[:n_units]

    lat_cache: dict = {}

    def lat(a, b, c):
        key = (a, b, caps[c])
        if key not in lat_cache:
            lat_cache[key] = _chip_latency(units, weights, a, b, caps[c], core)
        return lat_cache[key]

    INF = float("inf")
    # pass 1: minimize the latency bucket
    f = np.full((n_chips + 1, n_units + 1), INF)
    f[0, 0] = 0.0
    for c in range(1, n_chips + 1):
        for i in range(c, n_units + 1):
            lo = max(c - 1, i - caps[c - 1])
            for j in range(lo, i):
                v = max(f[c - 1, j], lat(j, i, c - 1))
                if v < f[c, i]:
                    f[c, i] = v
    b_star = float(f[n_chips, n_units])
    if not np.isfinite(b_star):
        raise ValueError(
            f"cannot fit {n_units} layer units onto {n_chips} chips with "
            f"capacities {caps} (a contiguous chip group would overflow)")

    # pass 2: minimize weighted cut bytes within the latency band
    cap_lat = b_star * (1.0 + max(slack, 0.0)) + 1e-12 * max(b_star, 1.0)
    g = np.full((n_chips + 1, n_units + 1), INF)
    back = np.zeros((n_chips + 1, n_units + 1), dtype=int)
    g[0, 0] = 0.0
    for c in range(1, n_chips + 1):
        for i in range(c, n_units + 1):
            lo = max(c - 1, i - caps[c - 1])
            for j in range(lo, i):
                if g[c - 1, j] == INF or lat(j, i, c - 1) > cap_lat:
                    continue
                v = g[c - 1, j] + (cut_cost[j - 1] if 0 < j else 0.0)
                if v < g[c, i]:
                    g[c, i] = v
                    back[c, i] = j
    bounds = [n_units]
    for c in range(n_chips, 0, -1):
        bounds.append(int(back[c, bounds[-1]]))
    bounds.reverse()
    groups = [(bounds[c], bounds[c + 1]) for c in range(n_chips)]
    return groups, b_star


def partition_model(layers, n_cores: int, strategy: str = "balanced",
                    core: CoreSpec = CoreSpec(), topology=None,
                    cut_weights=None,
                    chip_slack: float = CHIP_LATENCY_SLACK) -> Partition:
    """Partition ``layers`` onto ``n_cores`` logical cores.

    If there are more layers than cores, consecutive layers are first grouped
    into ``n_cores`` contiguous groups balancing the strategy weight (the paper
    maps 54-unit ResNet50 onto 32 logical cores this way), then each group
    becomes one slice.

    The chip-aware strategies (:data:`CHIP_STRATEGIES`) need ``topology`` —
    any :class:`repro.core.topology.Topology`; its chip structure
    (``n_chips`` / ``chip_capacities``) drives a two-level flow: contiguous
    layer-unit groups are DP-allocated to chips (``chip`` minimizes the
    activation bytes crossing chip cuts within a ``chip_slack`` latency band;
    ``chip_balanced`` strictly balances per-chip latency first), then the
    ``balanced`` compute+storage refinement runs within each chip. The
    returned partition carries ``chip_of`` (slice → chip). ``cut_weights``
    (per layer-unit, multiplying the cut cost of a boundary placed after that
    unit) is the co-partition feedback hook ``deploy_model`` uses to fold
    *placed* interchip traffic back into the allocation. On a single-chip
    topology the chip strategies degenerate to ``balanced`` exactly (plus an
    all-zero ``chip_of``); flat topologies and the flat strategies are
    bit-identical to the historical chip-oblivious path.
    """
    layers = list(layers)
    if strategy in CHIP_STRATEGIES:
        if topology is None:
            raise ValueError(f"strategy {strategy!r} needs topology= "
                             "(the chip structure drives the allocation)")
        usable = getattr(topology, "n_alive_cores", topology.n_cores)
        if usable != n_cores:
            raise ValueError(f"topology has {usable} usable cores, "
                             f"asked to partition onto {n_cores}")
        return _partition_chip_aware(layers, strategy, core, topology,
                                     cut_weights, chip_slack)

    if len(layers) > n_cores:
        weights = np.array([_layer_weight(l, strategy, core) for l in layers])
        groups = _group_contiguous(weights, n_cores)
        layers = [_merge_group(layers, a, b) for a, b in groups]
    weights = np.array([_layer_weight(l, strategy, core) for l in layers])
    alloc = _alloc_largest_remainder(weights, n_cores)

    if strategy == "balanced":
        alloc = _refine_alloc(layers, alloc, core)

    slices: list = []
    for li, (layer, k) in enumerate(zip(layers, alloc)):
        slices.extend(_slice_layer(li, layer, int(k)))
    return Partition(slices=slices, core=core, strategy=strategy)


def _partition_chip_aware(layers, strategy: str, core: CoreSpec, topology,
                          cut_weights, chip_slack: float) -> Partition:
    """Two-level chip-aware partitioning (see :func:`partition_model`)."""
    n_cores = getattr(topology, "n_alive_cores", topology.n_cores)
    if topology.n_chips <= 1:
        # single chip: exactly the balanced flow, tagged chip 0
        flat = partition_model(layers, n_cores, "balanced", core)
        return Partition(slices=flat.slices, core=core, strategy=strategy,
                         chip_of=np.zeros(flat.n, dtype=np.int64))

    units = list(layers)
    if len(units) > n_cores:
        w = np.array([_layer_weight(l, "balanced", core) for l in units])
        units = [_merge_group(units, a, b) for a, b in _group_contiguous(w, n_cores)]
    weights = np.array([_layer_weight(l, "balanced", core) for l in units])
    # lay the layer chain along the topology's physically-contiguous chip
    # chain (serpentine on chip grids) so consecutive chips are adjacent and
    # every chip-cut edge crosses exactly one boundary
    order = np.asarray(topology.chip_order(), dtype=np.int64)
    capacities = np.asarray(topology.chip_capacities())[order]
    slack = chip_slack if strategy == "chip" else 0.0
    groups, _ = _chips_dp(units, weights, capacities, core,
                          cut_weights=cut_weights, slack=slack)

    slices: list = []
    chip_of: list = []
    for gi, (a, b) in enumerate(groups):
        if b <= a:
            continue
        chip = int(order[gi])
        cap = int(capacities[gi])
        alloc = _alloc_largest_remainder(weights[a:b], cap)
        alloc = _refine_alloc(units[a:b], alloc, core)
        for off, k in enumerate(alloc):
            new = _slice_layer(a + off, units[a + off], int(k))
            slices.extend(new)
            chip_of.extend([chip] * len(new))
    return Partition(slices=slices, core=core, strategy=strategy,
                     chip_of=np.asarray(chip_of, dtype=np.int64))


def _max_latency(layers, alloc, core) -> float:
    worst = 0.0
    for li, (layer, k) in enumerate(zip(layers, alloc)):
        lat = max(s.latency(core) for s in _slice_layer(li, layer, int(k)))
        worst = max(worst, lat)
    return worst


def _refine_alloc(layers, alloc, core, iters: int = 256) -> np.ndarray:
    """Greedy rebalancing: repeatedly move one core from the least-loaded layer
    to the layer holding the current max-latency slice (paper's balancing of
    total compute+transmission time per slice). Nonlinear spill thresholds make
    this beat the proportional allocation."""
    alloc = alloc.copy()
    n_layers = len(layers)

    def per_layer_lat(a):
        return np.array([
            max(s.latency(core) for s in _slice_layer(li, layers[li], int(a[li])))
            for li in range(n_layers)])

    for _ in range(iters):
        lat = per_layer_lat(alloc)
        worst = int(np.argmax(lat))
        # donor: layer whose latency would rise least after losing one core
        best_gain, donor = 0.0, -1
        for li in range(n_layers):
            if li == worst or alloc[li] <= 1:
                continue
            trial = alloc.copy()
            trial[li] -= 1
            trial[worst] += 1
            new_max = per_layer_lat(trial).max()
            gain = lat.max() - new_max
            if gain > best_gain + 1e-15:
                best_gain, donor = gain, li
        if donor < 0:
            break
        alloc[donor] -= 1
        alloc[worst] += 1
    return alloc
