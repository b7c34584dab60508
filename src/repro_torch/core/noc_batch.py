"""Batched, table-driven NoC evaluation — the port's hottest path.

``Topology.evaluate`` re-derives routes edge by edge in Python on every call;
every placement optimizer calls a scorer once per candidate population. This
module precomputes, once per topology (any :class:`.topology.Topology` — flat
``NoC`` grids and ``HierarchicalMesh`` multi-chip systems alike):

* ``hops[n, n]``                  — all-pairs hop distances (== route lengths);
* ``route_links[n, n, max_hops]`` — the deterministic route of every (src, dst)
  pair as padded directed-link ids, built by replaying the topology's own
  router, so tie-breaks match bit for bit;
* ``link_dst[n_links]``           — destination core of every directed link;
* per-link attribute vectors (``inv_bw``, summed route latencies,
  ``energy_per_byte``, the inter-chip mask) when the topology is non-uniform.

Every metric of :class:`.topology.NoCMetrics` then becomes gather +
segment-sum over these tables, batched over a population axis. Backends:

* ``"numpy"`` / ``"batch"`` — float64 on the host; reproduces the reference
  loop exactly on integer-volume graphs, so it is the default scoring backend
  on the CPU (``"auto"`` picks it too);
* ``"torch"`` (alias ``"jax"``) — gathers plus ``scatter_add_``/``index_add_``
  on any device, float32 by default, float64 on request;
* ``"cuda"`` (alias ``"pallas"``) — the torch path with per-link traffic from
  the hand-written kernel :func:`repro_torch.kernels.noc_segsum.link_traffic`.
  Link traffic accumulates in float32 whatever ``dtype`` is asked for. On CPU
  tensors the kernel's plain version runs instead, which is how the CPU tests
  reach this path.

Device tables (hops, flat route ids, ``link_dst``, ``inv_bw``, route
latencies) are cached per ``(topology cache key, device, dtype)``. The torch
backends take ``device=None`` to mean the card.

Entry points: :func:`evaluate_batch`, :func:`comm_cost_batch`,
:func:`directional_cdv_batch`, :func:`make_scorer`, and
:meth:`BatchedNoC.make_fused_scorer` (one pass that computes exactly the
metrics a weighted objective needs).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.noc_segsum import link_traffic
from .graph import LogicalGraph
from .topology import Topology

# Soft cap on elements materialized per numpy scatter chunk (memory guard).
_CHUNK_ELEMS = 20_000_000


# ---------------------------------------------------------------------------
# Topology tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NoCTables:
    """Per-topology routing tensors.

    ``uniform`` marks an all-links-equal topology (flat NoC): the per-link
    attribute fields are None and evaluation takes the historical scalar
    paths bit-for-bit. Non-uniform topologies carry per-link inverse
    bandwidths, the [n, n] summed route latencies, and (optionally) per-link
    energies and the inter-chip mask.
    """
    rows: int
    cols: int
    torus: bool
    hops: np.ndarray          # [n, n] int32 shortest hop distance
    route_links: np.ndarray   # [n, n, max_hops] int32 link ids, padded with n_links
    link_dst: np.ndarray      # [n_links] int32 destination core of each link
    cdv_in_ids: np.ndarray | None   # [n_links] int32 (grids only)
    max_hops: int
    uniform: bool = True
    inv_bw: np.ndarray | None = None          # [n_links] 1/bytes-per-s
    route_lat: np.ndarray | None = None       # [n, n] summed route latency (s)
    energy_per_byte: np.ndarray | None = None  # [n_links] J/byte
    interchip: np.ndarray | None = None        # [n_links] bool

    @property
    def n_cores(self) -> int:
        return self.rows * self.cols

    @property
    def n_links(self) -> int:
        return int(self.link_dst.size)


def build_tables(topo: Topology) -> NoCTables:
    """Replay the topology's router over all (src, dst) pairs into dense
    tables, plus its per-link attribute vectors when non-uniform."""
    n = topo.n_cores
    hops = topo.hops_matrix()
    max_hops = int(hops.max()) if n else 0
    n_links = topo.n_links

    route_links = np.full((n, n, max_hops), n_links, dtype=np.int32)
    for s in range(n):
        for d in range(n):
            if s == d:
                continue
            ids = topo.route_ids(s, d)
            route_links[s, d, :len(ids)] = ids

    link_dst = np.asarray(topo.link_dst_array(), dtype=np.int32)
    cdv_in_ids = (np.asarray(topo.cdv_in_ids(), dtype=np.int32)
                  if hasattr(topo, "cdv_in_ids") else None)

    bw = topo.link_bandwidth()
    lat = topo.link_latency()
    uniform = bw is None and lat is None
    inv_bw = route_lat = None
    if not uniform:
        inv_bw = 1.0 / (np.full(n_links, topo.link_bw)
                        if bw is None else np.asarray(bw, np.float64))
        lat_arr = (np.full(n_links, topo.hop_latency)
                   if lat is None else np.asarray(lat, np.float64))
        lat_pad = np.append(lat_arr, 0.0)       # padding id n_links -> 0 s
        route_lat = (lat_pad[route_links].sum(axis=2) if max_hops
                     else np.zeros((n, n)))
    eb = topo.link_energy_per_byte()
    ic = topo.interchip_mask()
    rows, cols = topo.grid_shape
    return NoCTables(rows, cols, bool(getattr(topo, "torus", False)), hops,
                     route_links, link_dst, cdv_in_ids, max_hops,
                     uniform=uniform, inv_bw=inv_bw, route_lat=route_lat,
                     energy_per_byte=(None if eb is None
                                      else np.asarray(eb, np.float64)),
                     interchip=(None if ic is None
                                else np.asarray(ic, bool)))


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """:class:`NoCTables` as tensors on one device, in one float dtype.
    Pair tables are flattened: entry ``s * n + d`` is the (s, d) pair."""
    hops: torch.Tensor              # [n*n] int64
    routes: torch.Tensor            # [n*n, max_hops] int32, pad n_links
    link_dst: torch.Tensor          # [n_links] int64
    inv_bw: torch.Tensor | None     # [n_links] dtype (non-uniform only)
    route_lat: torch.Tensor | None  # [n*n] dtype (non-uniform only)
    energy_per_byte: torch.Tensor | None   # [n_links] dtype
    interchip: torch.Tensor | None         # [n_links] dtype 0/1


def _device_tables(t: NoCTables, device: torch.device,
                   dtype: torch.dtype) -> DeviceTables:
    n = t.n_cores

    def f(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.float64), dtype=dtype, device=device)
    return DeviceTables(
        hops=torch.as_tensor(t.hops.reshape(-1).astype(np.int64),
                             device=device),
        routes=torch.as_tensor(t.route_links.reshape(n * n, t.max_hops),
                               device=device),
        link_dst=torch.as_tensor(t.link_dst.astype(np.int64), device=device),
        inv_bw=f(t.inv_bw),
        route_lat=None if t.route_lat is None else f(t.route_lat.reshape(-1)),
        energy_per_byte=f(t.energy_per_byte),
        interchip=f(t.interchip))


def _check_placements(placements, n_nodes: int, n_cores: int | None):
    """Coerce to [B, n] int64; validate range + injectivity when ``n_cores``
    is given (the checks ``Topology.evaluate`` performs)."""
    P = np.asarray(placements, dtype=np.int64)
    if P.ndim == 1:
        P = P[None, :]
    if P.ndim != 2 or P.shape[1] != n_nodes:
        raise ValueError(f"placements must be [B, {n_nodes}], got {P.shape}")
    if n_cores is not None and P.size:
        if P.min() < 0 or P.max() >= n_cores:
            raise ValueError("placement out of range")
        s = np.sort(P, axis=1)
        if np.any(s[:, 1:] == s[:, :-1]):
            raise ValueError("placement must map nodes to distinct cores")
    return P


# ---------------------------------------------------------------------------
# Batched metrics container
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchMetrics:
    """Population-axis counterpart of :class:`NoCMetrics` (arrays over B)."""
    comm_cost: np.ndarray     # [B] Σ bytes × hops
    mean_hops: np.ndarray     # [B] traffic-weighted mean hop distance
    max_hops: np.ndarray      # [B] longest routed path (int)
    max_link: np.ndarray      # [B] hottest link bytes
    latency: np.ndarray       # [B] analytic makespan (s)
    throughput: np.ndarray    # [B] 1 / latency
    core_traffic: np.ndarray  # [B, rows, cols] bytes routed through each core
    link_traffic: np.ndarray  # [B, n_links] bytes per directed link (core*4+dir)


#: backend name -> the path that runs it
_BACKENDS = {"auto": "numpy", "numpy": "numpy", "batch": "numpy",
             "torch": "torch", "jax": "torch", "cuda": "cuda", "pallas": "cuda"}

FUSED_TERMS = ("comm_cost", "max_link", "latency", "mean_hops", "energy",
               "interchip")


# ---------------------------------------------------------------------------
# The batched evaluator
# ---------------------------------------------------------------------------

class BatchedNoC:
    """Vectorized evaluator for one :class:`.topology.Topology`.

    Tables are built once at construction (one Python pass over all core
    pairs) and reused for every graph/population scored afterwards; their
    tensor copies are made once per (device, dtype). Use the module cache
    :func:`batched_noc` rather than constructing directly.
    """

    def __init__(self, noc: Topology):
        self.noc = noc
        self.tables = build_tables(noc)
        self._device_tables: dict = {}

    def device_tables(self, device, dtype=torch.float32) -> DeviceTables:
        dev = resolve_device(device)
        key = (str(dev), dtype)
        dt = self._device_tables.get(key)
        if dt is None:
            dt = self._device_tables[key] = _device_tables(self.tables, dev,
                                                           dtype)
        return dt

    # ---- inputs ------------------------------------------------------------
    def edge_arrays(self, graph: LogicalGraph):
        """(src, dst, vol, compute) in the same order as ``graph.edges``."""
        src, dst, vol = graph.edge_arrays()
        return (src, dst, vol, np.asarray(graph.compute, np.float64))

    def _placements(self, placements, n_nodes: int, validate: bool):
        if validate:
            # full Topology.evaluate semantics, the dropped-core rejection
            # of degraded topologies included
            return validate_placements(self.noc, placements, n_nodes)
        return _check_placements(placements, n_nodes, None)

    def _resolve(self, backend: str) -> str:
        if backend == "reference":
            raise ValueError("backend='reference' is the sequential "
                             "Topology.evaluate loop; call noc.evaluate "
                             "directly or use make_scorer(noc, graph, "
                             "'reference')")
        resolved = _BACKENDS.get(backend)
        if resolved is None:
            raise ValueError(f"unknown backend {backend!r}; choose from "
                             f"{tuple(_BACKENDS)}")
        return resolved

    def _edge_tensors(self, graph, device, dtype):
        src, dst, vol, compute = self.edge_arrays(graph)
        return (torch.as_tensor(src, device=device),
                torch.as_tensor(dst, device=device),
                torch.as_tensor(vol, dtype=dtype, device=device),
                torch.as_tensor(compute / self.noc.core_flops, dtype=dtype,
                                device=device))

    # ---- torch building blocks ---------------------------------------------
    def _torch_comm(self, graph, device, dtype):
        """``placements [B, n] (numpy) -> comm cost [B] (float64 numpy)``:
        the gather-only path, shared by the torch and cuda backends."""
        dt = self.device_tables(device, dtype)
        dev, n = dt.hops.device, self.tables.n_cores
        src, dst, vol, _ = self._edge_tensors(graph, dev, dtype)

        def comm(P):
            Pt = torch.as_tensor(P, device=dev)
            h = dt.hops[Pt[:, src] * n + Pt[:, dst]]
            return (h.to(dtype) * vol).sum(dim=1).double().cpu().numpy()
        return comm

    def _link_traffic(self, dt: DeviceTables, idx, vol, kernel: bool):
        """[B, n_links] bytes per link for pair indices ``idx`` [B, E]."""
        ids = dt.routes[idx]                              # [B, E, max_hops]
        B, n_links = ids.shape[0], self.tables.n_links
        w = vol[None, :, None].expand(ids.shape).reshape(B, -1)
        ids = ids.reshape(B, -1)
        if kernel:
            return link_traffic(ids, w.float(), n_links).to(vol.dtype)
        out = torch.zeros(B, n_links + 1, dtype=vol.dtype, device=vol.device)
        return out.scatter_add_(1, ids.long(), w)[:, :n_links]

    @staticmethod
    def _core_sum(dt: DeviceTables, x, n: int):
        """[B, n_links] -> [B, n] sum of link values into their dst core."""
        out = torch.zeros(x.shape[0], n, dtype=x.dtype, device=x.device)
        return out.index_add_(1, dt.link_dst, x)

    @staticmethod
    def _compute_map(P, comp_nodes, n: int):
        """[B, n_cores] per-core compute seconds of each placement."""
        comp = torch.zeros(P.shape[0], n, dtype=comp_nodes.dtype,
                           device=P.device)
        return comp.scatter_(1, P, comp_nodes[None, :].expand(P.shape[0], -1))

    # ---- comm cost only (the optimizer scoring path) -----------------------
    def comm_cost(self, graph: LogicalGraph, placements,
                  backend: str = "auto", validate: bool = True,
                  device=None, dtype=torch.float32) -> np.ndarray:
        src, dst, vol, _ = self.edge_arrays(graph)
        P = self._placements(placements, graph.n, validate)
        if src.size == 0 or P.shape[0] == 0:
            return np.zeros(P.shape[0])
        if self._resolve(backend) != "numpy":
            return self._torch_comm(graph, device, dtype)(P)
        h = self.tables.hops[P[:, src], P[:, dst]]          # [B, E]
        return (h * vol[None, :]).sum(axis=1)

    # ---- full metrics ------------------------------------------------------
    def evaluate(self, graph: LogicalGraph, placements,
                 backend: str = "auto", validate: bool = True,
                 device=None, dtype=torch.float32) -> BatchMetrics:
        t, noc = self.tables, self.noc
        src, dst, vol, compute = self.edge_arrays(graph)
        P = self._placements(placements, graph.n, validate)
        B = P.shape[0]
        if src.size == 0:
            comp = np.zeros((B, t.n_cores))
            if P.size:
                comp[np.arange(B)[:, None], P] = compute[None, :] / noc.core_flops
            latency = comp.max(axis=1) if graph.n else np.zeros(B)
            return BatchMetrics(
                comm_cost=np.zeros(B), mean_hops=np.zeros(B),
                max_hops=np.zeros(B, int), max_link=np.zeros(B),
                latency=latency,
                throughput=np.where(latency > 0, 1.0 / np.maximum(latency, 1e-300),
                                    np.inf),
                core_traffic=np.zeros((B, t.rows, t.cols)),
                link_traffic=np.zeros((B, t.n_links)))
        resolved = self._resolve(backend)
        if resolved == "numpy":
            cc, h_max, lt, core_tr, per_core_max, path_lat = self._numpy_full(
                P, src, dst, vol, compute)
        else:
            with torch.no_grad():
                out = self._torch_full(graph, P, resolved == "cuda", device,
                                       dtype)
            cc, h_max, lt, core_tr, per_core_max, path_lat = (
                None if x is None else x.double().cpu().numpy() for x in out)
            h_max = h_max.astype(np.int64)
        total = vol.sum()
        latency = per_core_max + (h_max * noc.hop_latency if path_lat is None
                                  else path_lat)
        return BatchMetrics(
            comm_cost=cc,
            mean_hops=cc / total if total else np.zeros(B),
            max_hops=h_max,
            max_link=lt.max(axis=1),
            latency=latency,
            throughput=np.where(latency > 0, 1.0 / np.maximum(latency, 1e-300),
                                np.inf),
            core_traffic=core_tr.reshape(B, t.rows, t.cols),
            link_traffic=lt)

    def _torch_full(self, graph, P, kernel: bool, device, dtype):
        """(cc, h_max, lt, core_tr, per_core_max, path_lat|None) tensors."""
        dt = self.device_tables(device, dtype)
        dev, n = dt.hops.device, self.tables.n_cores
        src, dst, vol, comp_nodes = self._edge_tensors(graph, dev, dtype)
        Pt = torch.as_tensor(P, device=dev)
        idx = Pt[:, src] * n + Pt[:, dst]                   # [B, E]
        h = dt.hops[idx]
        cc = (h.to(dtype) * vol).sum(dim=1)
        lt = self._link_traffic(dt, idx, vol, kernel)
        core_tr = self._core_sum(dt, lt, n)
        comp = self._compute_map(Pt, comp_nodes, n)
        if self.tables.uniform:
            per_core_max = (comp + core_tr / self.noc.link_bw).amax(dim=1)
            path_lat = None
        else:
            # per-core serialization at each incoming link's own bandwidth
            wct = self._core_sum(dt, lt * dt.inv_bw, n)
            per_core_max = (comp + wct).amax(dim=1)
            path_lat = dt.route_lat[idx].amax(dim=1)
        return cc, h.amax(dim=1), lt, core_tr, per_core_max, path_lat

    def _numpy_full(self, P, src, dst, vol, compute):
        t, noc = self.tables, self.noc
        B, E = P.shape[0], src.size
        n, n_links, mh = t.n_cores, t.n_links, max(t.max_hops, 1)
        cc = np.empty(B)
        h_max = np.empty(B, dtype=np.int64)
        lt = np.empty((B, n_links))
        core_tr = np.empty((B, n))
        per_core_max = np.empty(B)
        path_lat = None if t.uniform else np.empty(B)
        chunk = max(1, _CHUNK_ELEMS // max(E * mh, 1))
        for b0 in range(0, B, chunk):
            Pb = P[b0:b0 + chunk]
            bsz = Pb.shape[0]
            s, d = Pb[:, src], Pb[:, dst]                    # [b, E]
            h = t.hops[s, d]
            cc[b0:b0 + bsz] = (h * vol[None, :]).sum(axis=1)
            h_max[b0:b0 + bsz] = h.max(axis=1)
            ids = t.route_links[s, d].astype(np.int64)       # [b, E, max_hops]
            ids += (np.arange(bsz) * (n_links + 1))[:, None, None]
            w = np.broadcast_to(vol[None, :, None], ids.shape)
            ltb = np.bincount(ids.ravel(), weights=w.ravel(),
                              minlength=bsz * (n_links + 1))
            ltb = ltb.reshape(bsz, n_links + 1)[:, :n_links]
            lt[b0:b0 + bsz] = ltb
            dst_flat = (t.link_dst.astype(np.int64)[None, :]
                        + (np.arange(bsz) * n)[:, None])
            ctb = np.bincount(dst_flat.ravel(), weights=ltb.ravel(),
                              minlength=bsz * n).reshape(bsz, n)
            core_tr[b0:b0 + bsz] = ctb
            comp = np.zeros((bsz, n))
            comp[np.arange(bsz)[:, None], Pb] = compute[None, :] / noc.core_flops
            if t.uniform:
                per_core_max[b0:b0 + bsz] = (comp + ctb / noc.link_bw).max(axis=1)
            else:
                # per-core serialization at each incoming link's own bandwidth
                wct = np.bincount(dst_flat.ravel(),
                                  weights=(ltb * t.inv_bw[None, :]).ravel(),
                                  minlength=bsz * n).reshape(bsz, n)
                per_core_max[b0:b0 + bsz] = (comp + wct).max(axis=1)
                path_lat[b0:b0 + bsz] = t.route_lat[s, d].max(axis=1)
        return cc, h_max, lt, core_tr, per_core_max, path_lat

    # ---- directional CDV (paper Eq. 4 terms) -------------------------------
    def directional_cdv(self, graph: LogicalGraph, placements,
                        backend: str = "auto", validate: bool = True,
                        device=None, dtype=torch.float32) -> np.ndarray:
        """[B, rows, cols, 4] bytes crossing each L/R/U/D link of every core."""
        t = self.tables
        if t.cdv_in_ids is None:
            raise ValueError("directional CDV is defined for grid topologies "
                             f"only; {type(self.noc).__name__} has no L/R/U/D "
                             "link structure")
        lt = self.evaluate(graph, placements, backend=backend,
                           validate=validate, device=device,
                           dtype=dtype).link_traffic
        B = lt.shape[0]
        cdv = lt.copy()
        np.add.at(cdv, (np.arange(B)[:, None],
                        t.cdv_in_ids.astype(np.int64)[None, :]), lt)
        return cdv.reshape(B, t.rows, t.cols, 4)

    # ---- fused objective scorers (torch/cuda) ------------------------------
    def make_fused_scorer(self, graph: LogicalGraph, terms,
                          e_byte_hop: float = 1e-11,
                          p_core_static: float = 0.05,
                          backend: str = "torch", device=None,
                          dtype=torch.float32):
        """``placements [B, n] -> weighted objective scores [B]`` in one pass
        on the device.

        ``terms`` is ``((metric, weight), ...)`` over :data:`FUSED_TERMS`.
        Only the metrics the objective needs are computed: gathers for
        comm/mean-hops combos, one link-traffic segment sum (``scatter_add_``
        on the torch backend, the CUDA kernel on ``backend="cuda"``) when
        link-level terms appear, and per-core reductions only when latency or
        energy is involved. Energy uses the topology's per-link
        ``energy_per_byte`` when available, else the scalar ``e_byte_hop``;
        ``interchip`` contributes 0 on flat topologies.
        """
        resolved = self._resolve(backend)
        if resolved == "numpy":
            raise ValueError("make_fused_scorer is the torch/cuda fast path; "
                             f"got backend={backend!r}")
        terms = tuple((str(m), float(w)) for m, w in terms)
        unknown = [m for m, _ in terms if m not in FUSED_TERMS]
        if unknown:
            raise ValueError(f"fused scorer cannot compute {unknown}; "
                             f"supported terms: {FUSED_TERMS}")
        w = {}
        for m, weight in terms:
            w[m] = w.get(m, 0.0) + weight
        need_links = any(m in ("max_link", "latency", "energy", "interchip")
                         for m in w)
        need_latency = "latency" in w or "energy" in w
        kernel = resolved == "cuda"
        t, noc = self.tables, self.noc
        n = t.n_cores
        dt = self.device_tables(device, dtype)
        dev = dt.hops.device
        src, dst, vol, comp_nodes = self._edge_tensors(graph, dev, dtype)
        n_edges = int(src.numel())
        static_w = p_core_static * n
        if "mean_hops" in w:
            tv = max(float(vol.sum()), torch.finfo(dtype).tiny)

        def fused(Pt):
            idx = Pt[:, src] * n + Pt[:, dst]               # [B, E]
            h = dt.hops[idx]
            cc = (h.to(dtype) * vol).sum(dim=1)
            total = torch.zeros_like(cc)
            if "comm_cost" in w:
                total = total + w["comm_cost"] * cc
            if "mean_hops" in w:
                total = total + w["mean_hops"] * cc / tv
            if not need_links:
                return total
            lt = self._link_traffic(dt, idx, vol, kernel)
            if "max_link" in w:
                total = total + w["max_link"] * lt.amax(dim=1)
            if "interchip" in w and dt.interchip is not None:
                total = total + w["interchip"] * (lt @ dt.interchip)
            if need_latency:
                comp = self._compute_map(Pt, comp_nodes, n)
                if t.uniform:
                    wct = self._core_sum(dt, lt, n) / noc.link_bw
                    plat = h.amax(dim=1).to(dtype) * noc.hop_latency
                else:
                    wct = self._core_sum(dt, lt * dt.inv_bw, n)
                    plat = dt.route_lat[idx].amax(dim=1)
                latency = (comp + wct).amax(dim=1) + plat
                if "latency" in w:
                    total = total + w["latency"] * latency
                if "energy" in w:
                    dyn = (e_byte_hop * cc if dt.energy_per_byte is None
                           else lt @ dt.energy_per_byte)
                    total = total + w["energy"] * (dyn + static_w * latency)
            return total

        def score(placements):
            P = np.asarray(placements, dtype=np.int64)
            if P.ndim == 1:
                P = P[None, :]
            if P.shape[0] == 0 or n_edges == 0:
                return np.zeros(P.shape[0])
            with torch.no_grad():
                out = fused(torch.as_tensor(P, device=dev))
            return out.double().cpu().numpy()
        return score


# ---------------------------------------------------------------------------
# Module-level cache + functional API
# ---------------------------------------------------------------------------

_CACHE: dict = {}


def batched_noc(noc: Topology) -> BatchedNoC:
    """Cached :class:`BatchedNoC` per topology (structural
    :meth:`Topology.cache_key` — grid shape + per-link attribute params)."""
    key = noc.cache_key()
    b = _CACHE.get(key)
    if b is None:
        b = _CACHE[key] = BatchedNoC(noc)
    return b


def evaluate_batch(noc: Topology, graph: LogicalGraph, placements,
                   backend: str = "auto", device=None,
                   dtype=torch.float32) -> BatchMetrics:
    """Score a [B, n] population of placements in one vectorized call."""
    return batched_noc(noc).evaluate(graph, placements, backend=backend,
                                     device=device, dtype=dtype)


def comm_cost_batch(noc: Topology, graph: LogicalGraph, placements,
                    backend: str = "auto", device=None,
                    dtype=torch.float32) -> np.ndarray:
    """[B] comm_cost (== the CDV objective of Eq. 4, negated reward)."""
    return batched_noc(noc).comm_cost(graph, placements, backend=backend,
                                      device=device, dtype=dtype)


def directional_cdv_batch(noc: Topology, graph: LogicalGraph, placements,
                          backend: str = "auto", device=None,
                          dtype=torch.float32) -> np.ndarray:
    """[B, rows, cols, 4] per-core directional CDV, batched."""
    return batched_noc(noc).directional_cdv(graph, placements,
                                            backend=backend, device=device,
                                            dtype=dtype)


def validate_placements(noc: Topology, placements, n_nodes: int) -> np.ndarray:
    """Check a [B, n] (or [n]) placement array the way ``Topology.evaluate``
    does (injective, in range, and off dropped cores on degraded
    topologies); returns the 2-D int64 array. For validating user input once
    before handing it to an unvalidated scorer. Does not build (or cache)
    routing tables."""
    P = _check_placements(placements, n_nodes, noc.n_cores)
    dropped = getattr(noc, "dropped_nodes", frozenset)()
    if dropped and P.size:
        # reuse the topology's own rejection (clear InfeasibleTopologyError)
        bad = np.isin(P, np.fromiter(dropped, dtype=np.int64,
                                     count=len(dropped)))
        if bad.any():
            noc._check_placement(P[np.nonzero(bad.any(axis=1))[0][0]])
    return P


# Backends accepted by optimizers: "batch"/"numpy"/"auto" (host float64 —
# exact parity with the reference loop on integer-volume graphs), "torch"
# (alias "jax"; gathers and scatters on the device), "cuda" (alias "pallas";
# the torch path with the link-traffic kernel — comm-cost-only scoring has no
# segment sum, so it shares the torch gather), "reference" (the per-edge
# Python loop).
SCORER_BACKENDS = ("batch", "numpy", "torch", "jax", "cuda", "pallas", "auto",
                   "reference")


def _counted_scorer(score, recorder, backend: str, objective_name: str,
                    fused: bool):
    """Wrap a scorer with :class:`repro_torch.obs.Recorder` dispatch/eval
    counters: one ``noc_batch.dispatches`` increment per call and one
    ``noc_batch.evals`` increment per placement scored. The wrapper exists
    only when a recorder is attached."""
    recorder.event("noc_batch.scorer", backend=backend,
                   objective=objective_name, fused=fused)

    def counted(placements):
        out = score(placements)
        recorder.count("noc_batch.dispatches")
        recorder.count("noc_batch.evals", int(np.asarray(out).shape[0]))
        return out
    return counted


def make_scorer(noc: Topology, graph: LogicalGraph, backend: str = "batch",
                objective="comm_cost", recorder=None, device=None):
    """Build ``placements [B, n] -> score [B]`` (numpy float64) for the hot
    loops.

    ``backend="batch"`` keeps optimizer trajectories bit-identical to the
    sequential reference on integer-volume graphs (float64 all the way). The
    torch/cuda backends score on ``device`` (``None``: the card) in float32.

    ``objective`` selects what the score *is*: the default ``"comm_cost"``
    keeps the gather-only comm-cost path; any other spec dispatches to
    :func:`repro_torch.deploy.objective.objective_scorer` (a fused pass on the
    torch/cuda backends). ``recorder`` wraps the scorer with deterministic
    dispatch/eval counters; ``None`` returns the bare closure.
    """
    if backend not in SCORER_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"choose from {SCORER_BACKENDS}")
    obj_name = "comm_cost"
    if objective not in (None, "comm_cost"):
        # deploy sits above core in the layering — import lazily
        from ..deploy.objective import as_objective, objective_scorer
        obj = as_objective(objective)
        if not obj.is_comm_cost:
            score = objective_scorer(noc, graph, obj, backend, device=device)
            if recorder is None:
                return score
            fused = _BACKENDS.get(backend) in ("torch", "cuda")
            return _counted_scorer(score, recorder, backend, obj.name, fused)
    if backend == "reference":
        def score_ref(placements):
            P = np.atleast_2d(np.asarray(placements, dtype=int))
            return np.array([noc.evaluate(graph, p).comm_cost for p in P])
        if recorder is not None:
            return _counted_scorer(score_ref, recorder, backend, obj_name,
                                   False)
        return score_ref
    b = batched_noc(noc)
    # Bind the edge arrays once. No per-call validation: optimizer-generated
    # placements are injective by construction, and callers feeding user
    # input must validate it once up front (see validate_placements).
    src, dst, vol, _ = b.edge_arrays(graph)
    if b._resolve(backend) != "numpy":
        comm = b._torch_comm(graph, device, torch.float32)

        def score(placements):
            P = np.asarray(placements, dtype=np.int64)
            if P.ndim == 1:
                P = P[None, :]
            if P.shape[0] == 0 or src.size == 0:
                return np.zeros(P.shape[0])
            return comm(P)
    else:
        hops = b.tables.hops

        def score(placements):
            P = np.asarray(placements, dtype=np.int64)
            if P.ndim == 1:
                P = P[None, :]
            if P.shape[0] == 0 or src.size == 0:
                return np.zeros(P.shape[0])
            return (hops[P[:, src], P[:, dst]] * vol[None, :]).sum(axis=1)
    if recorder is not None:
        return _counted_scorer(score, recorder, backend, obj_name, False)
    return score
