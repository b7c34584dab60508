"""First-class NoC topology abstraction (paper §3.2, generalized).

The paper evaluates placements on a single many-core chip — a flat 2D
mesh/torus. Real SNN training systems tile *multiple* chips with asymmetric
inter-chip links (slower, costlier than the on-chip NoC). This module turns
the topology into a pluggable abstraction so every layer above it
(:mod:`repro.core.noc_batch` tables, :mod:`repro.deploy.objective` models,
all placement optimizers, the deployment engine) works on any of them:

* :class:`Topology` — the abstract node/link communication graph: directed
  links with per-link ``bandwidth`` / ``energy_per_byte`` / ``latency``
  attributes and a deterministic routing function (``route_ids``). Provides a
  generic per-link reference evaluator (:meth:`Topology.evaluate`).
* :class:`GridTopology` — the 2D mesh/torus machinery (XY dimension-ordered
  routing with the paper's clockwise tie-break). Carries the historical
  ``NoC`` code verbatim, so a uniform grid evaluates **bit-identically** to
  the pre-refactor ``NoC`` (snapshot-pinned in ``tests/test_topology.py``).
  :class:`repro.core.noc.NoC` is its single-chip alias.
* :class:`HierarchicalMesh` — a ``chips_rows × chips_cols`` grid of
  ``core_rows × core_cols`` mesh chips joined by slower, costlier inter-chip
  links. Routing stays global XY (deterministic); only the per-link
  attributes differ, so the whole batched-table stack applies unchanged.
* :func:`parse_topology` — the ``--topology`` spec grammar of the
  ``repro-deploy`` CLI (``mesh:4x8``, ``torus:16x16``,
  ``hier:2x2:4x4[,ibw=1e9,ien=8e-11]``).

Link identity: directed link id ``src_core * 4 + direction`` with directions
L/R/U/D = 0/1/2/3 for grids (the ordering of :meth:`GridTopology.
directional_cdv`); generic topologies may use any dense id scheme as long as
``route_ids``/``link_dst_array`` agree.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np


class InfeasibleTopologyError(ValueError):
    """The surviving fabric cannot host the requested workload.

    Raised when fault injection disconnects a pair of alive cores (no detour
    exists), or when a placement assigns a logical unit to a dropped core.
    Subclasses :class:`ValueError` so existing placement-validation handlers
    keep working unchanged.
    """


@dataclasses.dataclass
class NoCMetrics:
    comm_cost: float            # Σ_edges bytes × hops  == Σ_links traffic
    hop_hist: dict              # hops -> total packets(bytes) at that distance
    mean_hops: float            # traffic-weighted mean hop distance
    link_traffic: dict          # link label -> bytes (grids: ((r,c),(r',c')))
    core_traffic: np.ndarray    # [rows, cols] bytes routed through each core
    max_link: float             # hottest link bytes
    latency: float              # analytic makespan estimate (s)
    throughput: float           # 1 / latency


# Directed-link direction slots for grids; same order as directional_cdv.
L, R, U, D = 0, 1, 2, 3
_OPP = (R, L, D, U)


class Topology:
    """Abstract node/link communication graph with deterministic routing.

    Subclasses must provide ``n_cores``, ``n_links``, ``link_dst_array``,
    ``route_ids`` and ``hops``; everything else (per-link attributes, the
    generic evaluator, cache keys) has workable defaults. Per-link attribute
    methods return ``None`` to mean "uniform" — scalar ``link_bw`` /
    ``hop_latency`` everywhere — which is the condition under which the
    batched evaluator and the energy model take their historical, bit-exact
    scalar paths.
    """

    link_bw: float
    core_flops: float
    hop_latency: float

    # ---- structure (abstract) ---------------------------------------------
    @property
    def n_cores(self) -> int:
        raise NotImplementedError

    @property
    def n_links(self) -> int:
        raise NotImplementedError

    def link_dst_array(self) -> np.ndarray:
        """[n_links] int — destination core of each directed link."""
        raise NotImplementedError

    def link_src_array(self) -> np.ndarray:
        """[n_links] int — source core of each directed link."""
        raise NotImplementedError

    def route_ids(self, src: int, dst: int) -> list:
        """Deterministic route as directed link ids (shortest path)."""
        raise NotImplementedError

    def hops(self, src: int, dst: int) -> int:
        return len(self.route_ids(src, dst))

    def hops_matrix(self) -> np.ndarray:
        """[n, n] int32 all-pairs hop distances (route lengths)."""
        n = self.n_cores
        h = np.zeros((n, n), dtype=np.int32)
        for s in range(n):
            for d in range(n):
                if s != d:
                    h[s, d] = self.hops(s, d)
        return h

    @property
    def grid_shape(self) -> tuple:
        """(rows, cols) used to reshape per-core metric maps."""
        return (1, self.n_cores)

    def link_label(self, lid: int):
        """Hashable label of link ``lid`` used as ``link_traffic`` dict key."""
        return (int(self.link_src_array()[lid]), int(self.link_dst_array()[lid]))

    def link_id_of(self, label) -> int:
        """Inverse of :meth:`link_label`."""
        table = getattr(self, "_label_to_id", None)
        if table is None:
            table = {self.link_label(l): l for l in range(self.n_links)}
            self._label_to_id = table
        return table[label]

    # ---- per-link attributes (None == uniform scalar) ---------------------
    def link_bandwidth(self):
        """[n_links] bytes/s per link, or None for uniform ``link_bw``."""
        return None

    def link_latency(self):
        """[n_links] seconds per hop, or None for uniform ``hop_latency``."""
        return None

    def link_energy_per_byte(self):
        """[n_links] J/byte per link, or None — scalar
        :class:`repro.deploy.objective.EnergyModel` path."""
        return None

    def interchip_mask(self):
        """[n_links] bool — True on inter-chip links; None on flat chips."""
        return None

    # ---- chip structure (flat topologies are one chip) --------------------
    @property
    def n_chips(self) -> int:
        """Number of chips the cores are tiled over (1 on flat topologies —
        the condition under which chip-aware partitioning degenerates to the
        historical chip-oblivious strategies)."""
        return 1

    def chip_of_array(self) -> np.ndarray:
        """[n_cores] int — chip index of every core (all zeros on one chip)."""
        return np.zeros(self.n_cores, dtype=np.int64)

    def cores_of_chip(self, chip: int) -> np.ndarray:
        """Core indices belonging to ``chip``, in deterministic (row-major)
        order — the order chip-respecting initializers fill them in."""
        return np.nonzero(self.chip_of_array() == int(chip))[0]

    def chip_capacities(self) -> np.ndarray:
        """[n_chips] int — cores per chip."""
        return np.bincount(self.chip_of_array(), minlength=self.n_chips)

    def chip_order(self) -> np.ndarray:
        """Chip ids in a physically-contiguous chain order — consecutive
        chips adjacent wherever the fabric allows. Chip-aware partitioning
        lays contiguous layer groups along this chain, so each chip-cut edge
        crosses exactly one boundary instead of routing diagonally."""
        return np.arange(self.n_chips, dtype=np.int64)

    @property
    def uniform_links(self) -> bool:
        """True iff every link shares the scalar bandwidth/latency — the
        bit-exact historical evaluation path applies."""
        return self.link_bandwidth() is None and self.link_latency() is None

    # ---- fault injection (intact topologies carry no faults) --------------
    @property
    def n_alive_cores(self) -> int:
        """Cores that can host logical units (== ``n_cores`` when intact)."""
        return self.n_cores

    def alive_cores(self) -> np.ndarray:
        """Surviving core ids in ascending order."""
        return np.arange(self.n_cores, dtype=np.int64)

    def dropped_links(self) -> frozenset:
        return frozenset()

    def dropped_nodes(self) -> frozenset:
        return frozenset()

    def drop_link(self, lid: int) -> "DegradedTopology":
        """Degraded view with directed link ``lid`` failed (detour-routed)."""
        return DegradedTopology(self, dropped_links=(int(lid),))

    def drop_node(self, core: int) -> "DegradedTopology":
        """Degraded view with ``core`` failed (its links fail with it)."""
        return DegradedTopology(self, dropped_nodes=(int(core),))

    def cache_key(self) -> tuple:
        """Structural identity for the :func:`repro.core.noc_batch.batched_noc`
        table cache."""
        raise NotImplementedError

    def describe(self) -> dict:
        """JSON-able topology summary for deployment reports."""
        rows, cols = self.grid_shape
        return {"kind": type(self).__name__, "rows": rows, "cols": cols,
                "n_cores": self.n_cores}

    # ---- generic per-link evaluation --------------------------------------
    def _check_placement(self, placement: np.ndarray) -> np.ndarray:
        placement = np.asarray(placement, dtype=int)
        if np.unique(placement).size != placement.size:
            raise ValueError("placement must map nodes to distinct cores")
        if placement.max(initial=-1) >= self.n_cores or \
                placement.min(initial=0) < 0:
            raise ValueError("placement out of range")
        return placement

    def evaluate(self, graph, placement: np.ndarray) -> NoCMetrics:
        """Generic reference evaluator reading per-link attributes.

        Uniform grids short-circuit to the historical scalar loop in
        :class:`GridTopology` instead; this path defines the semantics for
        non-uniform topologies and mirrors the batched general path of
        :mod:`repro.core.noc_batch`: per-core serialization time is
        Σ incoming-link traffic / that link's bandwidth, and the path-latency
        term is the slowest route's summed per-link latencies.
        """
        placement = self._check_placement(placement)
        n, n_links = self.n_cores, self.n_links
        bw = self.link_bandwidth()
        inv_bw = (np.full(n_links, 1.0 / self.link_bw) if bw is None
                  else 1.0 / np.asarray(bw, np.float64))
        lat = self.link_latency()
        lat = (np.full(n_links, self.hop_latency) if lat is None
               else np.asarray(lat, np.float64))
        link_dst = np.asarray(self.link_dst_array(), dtype=np.int64)

        lt = np.zeros(n_links)
        hop_hist: dict = {}
        comm_cost = 0.0
        total_bytes = 0.0
        max_path_lat = 0.0
        for i, j, vol in zip(*graph.edge_arrays()):
            ids = np.asarray(self.route_ids(int(placement[i]),
                                            int(placement[j])), dtype=np.int64)
            h = len(ids)
            comm_cost += vol * h
            total_bytes += vol
            hop_hist[h] = hop_hist.get(h, 0.0) + vol
            if h:
                lt[ids] += vol                  # shortest routes never repeat a link
                max_path_lat = max(max_path_lat, float(lat[ids].sum()))

        core_traffic = np.bincount(link_dst, weights=lt, minlength=n)
        comm_time = np.bincount(link_dst, weights=lt * inv_bw, minlength=n)
        comp = np.zeros(n)
        comp[placement] = graph.compute / self.core_flops
        per_core = comp + comm_time
        latency = float(per_core.max() + max_path_lat) if graph.n else 0.0
        rows, cols = self.grid_shape
        return NoCMetrics(
            comm_cost=comm_cost,
            hop_hist=hop_hist,
            mean_hops=comm_cost / total_bytes if total_bytes else 0.0,
            link_traffic={self.link_label(l): lt[l]
                          for l in np.nonzero(lt)[0]},
            core_traffic=core_traffic.reshape(rows, cols),
            max_link=float(lt.max()) if n_links else 0.0,
            latency=latency,
            throughput=1.0 / latency if latency > 0 else float("inf"),
        )

    def core_comm_time(self, m: NoCMetrics) -> np.ndarray:
        """[rows, cols] seconds each core spends serializing its incoming
        traffic — the contention term ``deploy_model(contention_feedback=True)``
        feeds back into per-stage schedule times."""
        bw = self.link_bandwidth()
        if bw is None:
            return m.core_traffic / self.link_bw
        wct = np.zeros(self.n_cores)
        link_dst = self.link_dst_array()
        for label, vol in m.link_traffic.items():
            lid = self.link_id_of(label)
            wct[int(link_dst[lid])] += vol / bw[lid]
        return wct.reshape(self.grid_shape)

    def interchip_bytes(self, link_traffic: dict) -> float:
        """Total bytes crossing inter-chip links (0.0 on flat topologies)."""
        mask = self.interchip_mask()
        if mask is None:
            return 0.0
        return float(sum(vol for label, vol in link_traffic.items()
                         if mask[self.link_id_of(label)]))

    def reward(self, graph, placement: np.ndarray) -> float:
        """Paper Eq. 4: negative total link traffic == negative comm_cost."""
        return -self.evaluate(graph, placement).comm_cost


class GridTopology(Topology):
    """2D mesh/torus grid of cores — the paper's NoC, now one Topology.

    Routing, metrics and tie-breaks are the historical ``NoC`` code moved here
    verbatim: XY (row-first) dimension-ordered shortest paths, shorter-wrap
    with clockwise tie-break on tori, and the scalar-bandwidth evaluation loop
    — so a uniform grid stays bit-identical to the pre-refactor ``NoC``.
    Subclasses with non-uniform links (:class:`HierarchicalMesh`) inherit the
    routing and fall through to the generic per-link evaluator.
    """

    def __init__(self, rows: int, cols: int, torus: bool = False,
                 link_bw: float = 1e9, core_flops: float = 1e9,
                 hop_latency: float = 1e-8):
        self.rows, self.cols, self.torus = rows, cols, torus
        self.link_bw = float(link_bw)
        self.core_flops = float(core_flops)
        self.hop_latency = float(hop_latency)

    @property
    def n_cores(self) -> int:
        return self.rows * self.cols

    @property
    def n_links(self) -> int:
        return 4 * self.n_cores

    @property
    def grid_shape(self) -> tuple:
        return (self.rows, self.cols)

    def coord(self, idx: int):
        return divmod(int(idx), self.cols)

    def index(self, r: int, c: int) -> int:
        return int(r) * self.cols + int(c)

    # ---- routing -------------------------------------------------------------
    def _steps(self, a: int, b: int, size: int):
        """Unit steps along one dimension, shorter wrap on a torus.

        Clockwise tie-break: on an even-size torus the two directions tie at
        size/2 hops; we take the positive (clockwise) direction, as the paper's
        clockwise search does.
        """
        if a == b:
            return []
        if not self.torus:
            step = 1 if b > a else -1
            return [step] * abs(b - a)
        fwd = (b - a) % size
        bwd = (a - b) % size
        if fwd <= bwd:                      # clockwise tie-break
            return [1] * fwd
        return [-1] * bwd

    def route(self, src: int, dst: int):
        """XY (row-first) shortest path: list of ((r,c),(r',c')) unit links."""
        (r0, c0), (r1, c1) = self.coord(src), self.coord(dst)
        links = []
        r, c = r0, c0
        for s in self._steps(c0, c1, self.cols):     # X first
            c2 = (c + s) % self.cols
            links.append(((r, c), (r, c2)))
            c = c2
        for s in self._steps(r0, r1, self.rows):     # then Y
            r2 = (r + s) % self.rows
            links.append(((r, c), (r2, c)))
            r = r2
        return links

    def hops(self, src: int, dst: int) -> int:
        (r0, c0), (r1, c1) = self.coord(src), self.coord(dst)
        if not self.torus:
            return abs(r0 - r1) + abs(c0 - c1)
        dr = min((r1 - r0) % self.rows, (r0 - r1) % self.rows)
        dc = min((c1 - c0) % self.cols, (c0 - c1) % self.cols)
        return dr + dc

    # ---- link-id interface ----------------------------------------------------
    def link_id(self, a, b) -> int:
        """Directed link ((r,c),(r',c')) -> src_core*4 + {L,R,U,D}."""
        (r0, c0), (r1, c1) = a, b
        src = r0 * self.cols + c0
        if r0 == r1:
            d = R if (c1 - c0) % self.cols == 1 else L
        else:
            d = D if (r1 - r0) % self.rows == 1 else U
        return src * 4 + d

    def route_ids(self, src: int, dst: int) -> list:
        return [self.link_id(a, b) for a, b in self.route(src, dst)]

    def link_label(self, lid: int):
        src, d = divmod(int(lid), 4)
        rr, cc = divmod(src, self.cols)
        if d == L:
            other = (rr, (cc - 1) % self.cols)
        elif d == R:
            other = (rr, (cc + 1) % self.cols)
        elif d == U:
            other = ((rr - 1) % self.rows, cc)
        else:
            other = ((rr + 1) % self.rows, cc)
        return ((rr, cc), other)

    def link_id_of(self, label) -> int:
        return self.link_id(*label)

    def link_dst_array(self) -> np.ndarray:
        cached = getattr(self, "_link_dst", None)
        if cached is not None:
            return cached
        rows, cols, n = self.rows, self.cols, self.n_cores
        link_dst = np.empty(self.n_links, dtype=np.int32)
        for core in range(n):
            rr, cc = divmod(core, cols)
            link_dst[core * 4 + L] = rr * cols + (cc - 1) % cols
            link_dst[core * 4 + R] = rr * cols + (cc + 1) % cols
            link_dst[core * 4 + U] = ((rr - 1) % rows) * cols + cc
            link_dst[core * 4 + D] = ((rr + 1) % rows) * cols + cc
        self._link_dst = link_dst
        return link_dst

    def link_src_array(self) -> np.ndarray:
        return np.repeat(np.arange(self.n_cores, dtype=np.int32), 4)

    def cdv_in_ids(self) -> np.ndarray:
        """[n_links] — the receiver-side cdv slot credited by each link
        (link into core c from direction d lands in c's opposite-d slot)."""
        link_dst = self.link_dst_array()
        dirs = np.tile(np.arange(4, dtype=np.int64), self.n_cores)
        opp = np.asarray(_OPP, dtype=np.int64)
        return (link_dst.astype(np.int64) * 4 + opp[dirs]).astype(np.int32)

    def hops_matrix(self) -> np.ndarray:
        n, rows, cols = self.n_cores, self.rows, self.cols
        idx = np.arange(n)
        r, c = idx // cols, idx % cols
        if self.torus:
            dr = np.minimum((r[:, None] - r[None, :]) % rows,
                            (r[None, :] - r[:, None]) % rows)
            dc = np.minimum((c[:, None] - c[None, :]) % cols,
                            (c[None, :] - c[:, None]) % cols)
        else:
            dr = np.abs(r[:, None] - r[None, :])
            dc = np.abs(c[:, None] - c[None, :])
        return (dr + dc).astype(np.int32)

    def cache_key(self) -> tuple:
        return ("grid", self.rows, self.cols, self.torus, self.link_bw,
                self.core_flops, self.hop_latency)

    def describe(self) -> dict:
        return {"kind": "torus" if self.torus else "mesh",
                "rows": self.rows, "cols": self.cols, "torus": self.torus,
                "n_cores": self.n_cores}

    # ---- evaluation (paper Fig 6/7/8 metrics) ---------------------------------
    def evaluate(self, graph, placement: np.ndarray) -> NoCMetrics:
        """Score ``placement`` (array: logical node -> physical core index).

        Placement must be injective (paper Definition C: |A| <= |N|).
        Uniform grids run the historical scalar loop (bit-identical to the
        pre-refactor ``NoC.evaluate``); non-uniform subclasses use the generic
        per-link evaluator of :class:`Topology`.
        """
        if not self.uniform_links:
            return Topology.evaluate(self, graph, placement)
        placement = self._check_placement(placement)

        link_traffic: dict = {}
        core_traffic = np.zeros((self.rows, self.cols))
        hop_hist: dict = {}
        comm_cost = 0.0
        weighted_hops = 0.0
        total_bytes = 0.0
        for i, j, vol in zip(*graph.edge_arrays()):
            src, dst = placement[i], placement[j]
            links = self.route(src, dst)
            h = len(links)
            comm_cost += vol * h
            weighted_hops += vol * h
            total_bytes += vol
            hop_hist[h] = hop_hist.get(h, 0.0) + vol
            for (a, b) in links:
                link_traffic[(a, b)] = link_traffic.get((a, b), 0.0) + vol
                core_traffic[b] += vol          # traffic arriving into router b

        # Analytic latency model: a step's makespan is bounded by the slowest
        # core (compute + its router traffic serialized on link_bw) plus the
        # longest path's hop latency. This is the simulator abstraction the
        # paper's latency/throughput panels (Fig 6b/6c) are built on.
        per_core_comm = core_traffic / self.link_bw
        comp = np.zeros(self.n_cores)
        comp[placement] = graph.compute / self.core_flops
        per_core = comp.reshape(self.rows, self.cols) + per_core_comm
        max_hops = max(hop_hist) if hop_hist else 0
        latency = float(per_core.max() + max_hops * self.hop_latency) if graph.n else 0.0
        mean_hops = weighted_hops / total_bytes if total_bytes else 0.0
        return NoCMetrics(
            comm_cost=comm_cost,
            hop_hist=hop_hist,
            mean_hops=mean_hops,
            link_traffic=link_traffic,
            core_traffic=core_traffic,
            max_link=max(link_traffic.values()) if link_traffic else 0.0,
            latency=latency,
            throughput=1.0 / latency if latency > 0 else float("inf"),
        )

    def directional_cdv(self, graph, placement: np.ndarray):
        """Per-core CDV_{left,right,up,down} (paper Eq. 4 terms): bytes crossing
        each of the four links incident to every core."""
        m = self.evaluate(graph, placement)
        cdv = np.zeros((self.rows, self.cols, 4))  # L, R, U, D
        for ((r0, c0), (r1, c1)), vol in m.link_traffic.items():
            if r0 == r1:  # horizontal
                going_right = ((c1 - c0) % self.cols) == 1
                if going_right:
                    cdv[r0, c0, 1] += vol
                    cdv[r1, c1, 0] += vol
                else:
                    cdv[r0, c0, 0] += vol
                    cdv[r1, c1, 1] += vol
            else:
                going_down = ((r1 - r0) % self.rows) == 1
                if going_down:
                    cdv[r0, c0, 3] += vol
                    cdv[r1, c1, 2] += vol
                else:
                    cdv[r0, c0, 2] += vol
                    cdv[r1, c1, 3] += vol
        return cdv


class HierarchicalMesh(GridTopology):
    """A ``chips_rows × chips_cols`` grid of ``core_rows × core_cols`` mesh
    chips joined by slower, costlier inter-chip links.

    Globally the cores form one ``(chips_rows·core_rows) ×
    (chips_cols·core_cols)`` mesh with deterministic XY routing (chips expose
    boundary-core links to their neighbours), but links that cross a chip
    boundary carry ``interchip_bw`` / ``interchip_energy`` /
    ``interchip_latency`` instead of the on-chip ``link_bw`` / ``e_byte_hop``
    / ``hop_latency``. Placement optimizers therefore trade on-chip locality
    against inter-chip crossings through the per-link latency/energy models
    (and the ``"interchip"`` objective term), while every batched scoring
    path — numpy, jax, pallas — applies unchanged.
    """

    def __init__(self, chips_rows: int, chips_cols: int,
                 core_rows: int, core_cols: int,
                 interchip_bw: float | None = None,
                 interchip_energy: float | None = None,
                 link_bw: float = 1e9, core_flops: float = 1e9,
                 hop_latency: float = 1e-8, e_byte_hop: float = 1e-11,
                 interchip_latency: float | None = None):
        super().__init__(chips_rows * core_rows, chips_cols * core_cols,
                         torus=False, link_bw=link_bw, core_flops=core_flops,
                         hop_latency=hop_latency)
        if min(chips_rows, chips_cols, core_rows, core_cols) < 1:
            raise ValueError("chip grid and per-chip core grid must be >= 1x1")
        self.chips_rows, self.chips_cols = int(chips_rows), int(chips_cols)
        self.core_rows, self.core_cols = int(core_rows), int(core_cols)
        self.e_byte_hop = float(e_byte_hop)
        self.interchip_bw = float(interchip_bw if interchip_bw is not None
                                  else link_bw / 8.0)
        self.interchip_energy = float(interchip_energy
                                      if interchip_energy is not None
                                      else 8.0 * self.e_byte_hop)
        self.interchip_latency = float(interchip_latency
                                       if interchip_latency is not None
                                       else 4.0 * hop_latency)

        # Per-link attribute arrays: a link is inter-chip when its endpoint
        # cores live on different chips. (Mesh wrap link ids exist in the
        # core*4+dir id space but are never routed; their attributes are
        # irrelevant and their traffic is always zero.)
        chips = self.chip_of_array()
        self._interchip = (chips[self.link_src_array().astype(np.int64)]
                           != chips[self.link_dst_array().astype(np.int64)])
        self._bw = np.where(self._interchip, self.interchip_bw, self.link_bw)
        self._lat = np.where(self._interchip, self.interchip_latency,
                             self.hop_latency)
        self._energy = np.where(self._interchip, self.interchip_energy,
                                self.e_byte_hop)

    @property
    def n_chips(self) -> int:
        return self.chips_rows * self.chips_cols

    def chip_of(self, core: int) -> int:
        """Flat chip index of a core (row-major over the chip grid)."""
        return int(self.chip_of_array()[int(core)])

    def chip_of_array(self) -> np.ndarray:
        cached = getattr(self, "_chip_of", None)
        if cached is None:
            idx = np.arange(self.n_cores, dtype=np.int64)
            r, c = idx // self.cols, idx % self.cols
            cached = (r // self.core_rows) * self.chips_cols \
                + c // self.core_cols
            self._chip_of = cached
        return cached

    def chip_order(self) -> np.ndarray:
        """Serpentine over the chip grid: every consecutive pair of chips in
        the chain shares a physical boundary, so the layer chain's chip cuts
        never route diagonally (two boundary crossings) on the global XY
        fabric."""
        order = []
        for r in range(self.chips_rows):
            cols = (range(self.chips_cols) if r % 2 == 0
                    else range(self.chips_cols - 1, -1, -1))
            order.extend(r * self.chips_cols + c for c in cols)
        return np.asarray(order, dtype=np.int64)

    def link_bandwidth(self):
        return self._bw

    def link_latency(self):
        return self._lat

    def link_energy_per_byte(self):
        return self._energy

    def interchip_mask(self):
        return self._interchip

    def cache_key(self) -> tuple:
        return ("hier", self.chips_rows, self.chips_cols, self.core_rows,
                self.core_cols, self.link_bw, self.interchip_bw,
                self.core_flops, self.hop_latency, self.interchip_latency,
                self.e_byte_hop, self.interchip_energy)

    def describe(self) -> dict:
        return {"kind": "hier", "rows": self.rows, "cols": self.cols,
                "n_cores": self.n_cores,
                "chips": [self.chips_rows, self.chips_cols],
                "chip_cores": [self.core_rows, self.core_cols],
                "link_bw": self.link_bw, "interchip_bw": self.interchip_bw,
                "e_byte_hop": self.e_byte_hop,
                "interchip_energy": self.interchip_energy,
                "interchip_latency": self.interchip_latency}


# ---------------------------------------------------------------------------
# fault injection: degraded views with detour routing
# ---------------------------------------------------------------------------


def degrade(topo: Topology, links=(), nodes=()) -> Topology:
    """``topo`` with the given faults applied, or the intact base itself when
    both fault sets are empty — so a no-fault scenario reuses the base
    object's ``cache_key`` (and therefore its cached scorer tables) and stays
    bit-identical to an offline run."""
    base = topo.base if isinstance(topo, DegradedTopology) else topo
    links, nodes = tuple(links), tuple(nodes)
    if not links and not nodes:
        return base
    return DegradedTopology(base, dropped_links=links, dropped_nodes=nodes)


class DegradedTopology(Topology):
    """A base topology with failed links and/or cores.

    Composition, not mutation: the base object is untouched, and the degraded
    view keeps the *same* core/link id space (``n_cores``/``n_links``
    unchanged, dropped entries simply carry no traffic), so
    :func:`repro.core.noc_batch.build_tables` and every scorer backend work
    on it unchanged. Its ``cache_key`` extends the base key with the sorted
    fault sets, keeping intact and degraded table caches separate.

    Routing is deterministic "XY with fallback": a pair whose base route
    survives keeps it verbatim (repairing every fault restores bit-identical
    routes and metrics), otherwise the detour is a greedy walk that at each
    hop takes the lowest-id usable out-link that reduces the BFS distance to
    the destination over the surviving directed graph — horizontal slots sort
    before vertical in the ``core*4 + {L,R,U,D}`` grid id scheme, preserving
    the XY flavour around the hole. Construction raises
    :class:`InfeasibleTopologyError` if any pair of alive cores is
    disconnected. Pairs involving dropped cores route as empty (hops 0) so
    batched table construction over all pairs still works; placements using
    them are rejected by :meth:`_check_placement`.
    """

    def __init__(self, base: Topology, dropped_links=(), dropped_nodes=()):
        if isinstance(base, DegradedTopology):
            dropped_links = tuple(dropped_links) + tuple(base.dropped_links())
            dropped_nodes = tuple(dropped_nodes) + tuple(base.dropped_nodes())
            base = base.base
        self.base = base
        n, n_links = base.n_cores, base.n_links
        dl = frozenset(int(x) for x in dropped_links)
        dn = frozenset(int(x) for x in dropped_nodes)
        if dl and (min(dl) < 0 or max(dl) >= n_links):
            raise ValueError(f"dropped link id out of range [0, {n_links})")
        if dn and (min(dn) < 0 or max(dn) >= n):
            raise ValueError(f"dropped core id out of range [0, {n})")
        self._dropped_links_set, self._dropped_nodes_set = dl, dn
        self._dropped_nodes_arr = np.fromiter(sorted(dn), dtype=np.int64,
                                              count=len(dn))
        self.link_bw = base.link_bw
        self.core_flops = base.core_flops
        self.hop_latency = base.hop_latency

        src = np.asarray(base.link_src_array(), dtype=np.int64)
        dst = np.asarray(base.link_dst_array(), dtype=np.int64)
        # A link id is *physical* iff it is exactly the base one-hop route of
        # its endpoints — this excludes mesh wrap ids (never routed) and
        # duplicate ids on degenerate 2-wide tori from detour routing.
        usable = np.fromiter(
            (base.route_ids(int(src[lid]), int(dst[lid])) == [lid]
             for lid in range(n_links)), dtype=bool, count=n_links)
        if dl:
            usable[sorted(dl)] = False
        alive_mask = np.ones(n, dtype=bool)
        if dn:
            alive_mask[sorted(dn)] = False
        usable &= alive_mask[src] & alive_mask[dst]
        self._usable = usable
        self._alive = np.nonzero(alive_mask)[0].astype(np.int64)
        self._link_dst = dst

        # Per-core usable out-links in ascending id order (the greedy detour
        # preference) + all-pairs BFS distances on the surviving graph.
        self._out = [np.nonzero(usable & (src == c))[0] for c in range(n)]
        rev = [[] for _ in range(n)]
        for lid in np.nonzero(usable)[0]:
            rev[int(dst[lid])].append(int(src[lid]))
        dist = np.full((n, n), -1, dtype=np.int32)
        for d in self._alive:
            d = int(d)
            dist[d, d] = 0
            dq = collections.deque([d])
            while dq:
                c = dq.popleft()
                for p in rev[c]:
                    if dist[p, d] < 0:
                        dist[p, d] = dist[c, d] + 1
                        dq.append(p)
        bad = [(int(s), int(d)) for s in self._alive for d in self._alive
               if dist[s, d] < 0]
        if bad:
            raise InfeasibleTopologyError(
                f"degraded {type(base).__name__} disconnects "
                f"{len(bad)} alive core pair(s), e.g. {bad[0]} "
                f"(dropped links {sorted(dl)}, dropped cores {sorted(dn)})")
        self._dist = dist
        self._hops = np.where(dist < 0, 0, dist).astype(np.int32)
        self._route_cache: dict = {}

    # ---- delegation to the intact base ------------------------------------
    def __getattr__(self, name):
        if name == "base" or name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.base, name)

    @property
    def n_cores(self) -> int:
        return self.base.n_cores

    @property
    def n_links(self) -> int:
        return self.base.n_links

    @property
    def grid_shape(self) -> tuple:
        return self.base.grid_shape

    def link_dst_array(self) -> np.ndarray:
        return self.base.link_dst_array()

    def link_src_array(self) -> np.ndarray:
        return self.base.link_src_array()

    def link_label(self, lid: int):
        return self.base.link_label(lid)

    def link_id_of(self, label) -> int:
        return self.base.link_id_of(label)

    def link_bandwidth(self):
        return self.base.link_bandwidth()

    def link_latency(self):
        return self.base.link_latency()

    def link_energy_per_byte(self):
        return self.base.link_energy_per_byte()

    def interchip_mask(self):
        return self.base.interchip_mask()

    @property
    def n_chips(self) -> int:
        return self.base.n_chips

    def chip_of_array(self) -> np.ndarray:
        return self.base.chip_of_array()

    def chip_order(self) -> np.ndarray:
        return self.base.chip_order()

    # ---- fault state -------------------------------------------------------
    @property
    def n_alive_cores(self) -> int:
        return int(self._alive.size)

    def alive_cores(self) -> np.ndarray:
        return self._alive

    def dropped_links(self) -> frozenset:
        return self._dropped_links_set

    def dropped_nodes(self) -> frozenset:
        return self._dropped_nodes_set

    def repair_link(self, lid: int) -> Topology:
        """View with link ``lid`` restored (the base when no faults remain)."""
        return degrade(self.base, links=self._dropped_links_set - {int(lid)},
                       nodes=self._dropped_nodes_set)

    def repair_node(self, core: int) -> Topology:
        """View with ``core`` restored (the base when no faults remain)."""
        return degrade(self.base, links=self._dropped_links_set,
                       nodes=self._dropped_nodes_set - {int(core)})

    def cores_of_chip(self, chip: int) -> np.ndarray:
        cores = self.base.cores_of_chip(chip)
        if not self._dropped_nodes_set:
            return cores
        return cores[~np.isin(cores, self._dropped_nodes_arr)]

    def chip_capacities(self) -> np.ndarray:
        return np.bincount(self.chip_of_array()[self._alive],
                           minlength=self.n_chips)

    # ---- degraded routing --------------------------------------------------
    def route_ids(self, src: int, dst: int) -> list:
        src, dst = int(src), int(dst)
        if src == dst or src in self._dropped_nodes_set \
                or dst in self._dropped_nodes_set:
            return []
        cached = self._route_cache.get((src, dst))
        if cached is not None:
            return list(cached)
        ids = self.base.route_ids(src, dst)
        if not all(self._usable[lid] for lid in ids):
            ids, cur, dcol = [], src, self._dist[:, dst]
            while cur != dst:
                for lid in self._out[cur]:
                    nxt = int(self._link_dst[lid])
                    if dcol[nxt] == dcol[cur] - 1:
                        ids.append(int(lid))
                        cur = nxt
                        break
                else:       # unreachable: connectivity was checked upfront
                    raise InfeasibleTopologyError(
                        f"no surviving route {src}->{dst}")
        self._route_cache[(src, dst)] = tuple(ids)
        return ids

    def hops(self, src: int, dst: int) -> int:
        return int(self._hops[int(src), int(dst)])

    def hops_matrix(self) -> np.ndarray:
        return self._hops.copy()

    # ---- identity / validation --------------------------------------------
    def cache_key(self) -> tuple:
        return self.base.cache_key() + (
            "degraded", tuple(sorted(self._dropped_links_set)),
            tuple(sorted(self._dropped_nodes_set)))

    def describe(self) -> dict:
        out = dict(self.base.describe())
        out["degraded"] = {
            "dropped_links": sorted(self._dropped_links_set),
            "dropped_nodes": sorted(self._dropped_nodes_set),
            "n_alive_cores": self.n_alive_cores,
        }
        return out

    def _check_placement(self, placement: np.ndarray) -> np.ndarray:
        placement = Topology._check_placement(self, placement)
        if self._dropped_nodes_set:
            on_dropped = np.isin(placement, self._dropped_nodes_arr)
            if on_dropped.any():
                units = np.nonzero(on_dropped)[0].tolist()
                cores = sorted(set(int(c) for c in placement[on_dropped]))
                raise InfeasibleTopologyError(
                    f"placement assigns logical unit(s) {units} to dropped "
                    f"core(s) {cores}; re-place onto the "
                    f"{self.n_alive_cores} surviving cores")
        return placement


# ---------------------------------------------------------------------------
# --topology spec grammar
# ---------------------------------------------------------------------------

#: parse_topology kinds -> required grid segments
TOPOLOGY_KINDS = ("mesh", "torus", "hier")

_PARAM_ALIASES = {
    "bw": "link_bw", "link_bw": "link_bw",
    "flops": "core_flops", "core_flops": "core_flops",
    "lat": "hop_latency", "hop_latency": "hop_latency",
    "ibw": "interchip_bw", "interchip_bw": "interchip_bw",
    "ien": "interchip_energy", "interchip_energy": "interchip_energy",
    "ilat": "interchip_latency", "interchip_latency": "interchip_latency",
    "e": "e_byte_hop", "e_byte_hop": "e_byte_hop",
}


def _parse_grid(seg: str, spec: str) -> tuple:
    parts = seg.lower().split("x")
    if len(parts) != 2:
        raise ValueError(f"bad grid {seg!r} in topology spec {spec!r} "
                         "(want RxC, e.g. 4x8)")
    try:
        r, c = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"bad grid {seg!r} in topology spec {spec!r}") from None
    if r < 1 or c < 1:
        raise ValueError(f"grid {seg!r} must be >= 1x1 in {spec!r}")
    return r, c


def parse_topology(spec: str, link_bw: float = 1e9, core_flops: float = 1e9,
                   hop_latency: float = 1e-8) -> Topology:
    """Parse a ``--topology`` spec string into a :class:`Topology`.

    Grammar (``,key=value`` pairs optional, applied last)::

        mesh:RxC               flat R x C mesh           -> NoC(R, C)
        torus:RxC              flat R x C torus          -> NoC(R, C, torus=True)
        hier:CRxCC:KRxKC       CRxCC chips of KRxKC cores -> HierarchicalMesh

    Recognized keys: ``bw``/``link_bw``, ``flops``/``core_flops``,
    ``lat``/``hop_latency``, and for ``hier`` additionally ``ibw``
    (interchip_bw), ``ien`` (interchip_energy), ``ilat`` (interchip_latency),
    ``e`` (on-chip e_byte_hop). The ``link_bw``/``core_flops``/``hop_latency``
    arguments are the caller's platform defaults, overridable per spec.
    """
    from .noc import NoC        # noc imports this module; resolve lazily

    head, *params = str(spec).strip().split(",")
    segs = head.split(":")
    kind = segs[0].strip().lower()
    if kind not in TOPOLOGY_KINDS:
        raise ValueError(f"unknown topology kind {kind!r} in {spec!r}; "
                         f"choose from {TOPOLOGY_KINDS}")
    kw = {"link_bw": link_bw, "core_flops": core_flops,
          "hop_latency": hop_latency}
    for p in params:
        if not p.strip():
            continue
        if "=" not in p:
            raise ValueError(f"bad parameter {p!r} in topology spec {spec!r} "
                             "(want key=value)")
        k, v = p.split("=", 1)
        key = _PARAM_ALIASES.get(k.strip().lower())
        if key is None:
            raise ValueError(f"unknown topology parameter {k.strip()!r} in "
                             f"{spec!r}; choose from {sorted(set(_PARAM_ALIASES))}")
        kw[key] = float(v)

    if kind in ("mesh", "torus"):
        if len(segs) != 2:
            raise ValueError(f"{kind} spec needs one grid: {kind}:RxC "
                             f"(got {spec!r})")
        bad = [k for k in kw if k.startswith("interchip") or k == "e_byte_hop"]
        if bad:
            raise ValueError(f"parameters {bad} only apply to hier topologies "
                             f"({spec!r})")
        r, c = _parse_grid(segs[1], spec)
        return NoC(r, c, torus=(kind == "torus"), **kw)

    if len(segs) != 3:
        raise ValueError("hier spec needs chip and core grids: "
                         f"hier:CRxCC:KRxKC (got {spec!r})")
    cr, cc = _parse_grid(segs[1], spec)
    kr, kc = _parse_grid(segs[2], spec)
    return HierarchicalMesh(cr, cc, kr, kc, **kw)
