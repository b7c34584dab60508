"""Pluggable placement objectives over batched NoC metrics (paper §4.3, Eq. 4).

The paper optimizes placements for more than hop-weighted communication volume:
§5 evaluates power, hotspot load (Fig 7/11), and throughput of the deployed
network. Every optimizer in :mod:`repro.core.placement` historically hard-coded
the comm-cost score; this module turns the score into a pluggable
:class:`Objective` — a weighted combination of metrics derived from one
:class:`repro.core.noc_batch.BatchMetrics` evaluation — threaded through
``noc_batch.make_scorer(..., objective=)`` and
``optimize_placement(..., objective=)``.

Base metric terms (all per placement, lower is better):

* ``comm_cost``  — Σ bytes × hops (the Eq. 4 CDV objective; the default).
* ``max_link``   — hottest directed link's bytes (hotspot peak, Fig 7).
* ``latency``    — the analytic makespan estimate of the NoC model (per-link
  bandwidth/latency aware on non-uniform topologies).
* ``mean_hops``  — traffic-weighted mean hop distance.
* ``energy``     — analytic energy per step from the hop/link model: dynamic
  link+router energy plus static leakage integrated over the step
  (``p_core_static × n_cores × latency``), see :class:`EnergyModel`. When the
  topology carries per-link ``energy_per_byte`` attributes (e.g.
  :class:`repro.core.topology.HierarchicalMesh` inter-chip links), the dynamic
  term is Σ link_traffic × that link's J/byte; on flat topologies it is the
  historical scalar ``e_byte_hop × comm_cost`` (bit-identical).
* ``interchip``  — bytes crossing inter-chip links (0 on flat topologies);
  lets multi-chip searches penalize boundary crossings directly.
* ``migration``  — byte-hops to move each logical unit's resident state from
  the core it currently occupies to the candidate placement's core
  (:class:`MigrationSpec`; built with :func:`with_migration`). The online
  re-placement loop (:mod:`repro.deploy.runtime`) uses it to trade recovery
  quality against state-movement cost on warm-started searches.

Chip-aware partitions (``repro.core.partition`` ``strategy="chip"``) tag the
logical graph with their slice→chip assignment; :func:`partition_interchip_bytes`
scores the partition-induced interchip traffic from those tags alone — i.e.
*before* any placement exists — which is what the partition→place co-design
loop in :func:`repro.deploy.deploy_model` compares placed traffic against.

An objective spec (accepted everywhere an ``objective=`` parameter exists) is
a name from :data:`OBJECTIVES`, a ``{metric: weight}`` dict for weighted
combinations, or an :class:`Objective` instance. ``"comm_cost"`` — the default
spec — routes through the exact same scorer code path as before this module
existed, so every optimizer stays seed-for-seed bit-identical unless a
different objective is asked for.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import noc_batch as nb


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    """Analytic per-step energy of a deployed placement.

    ``e_byte_hop`` folds link wire + router traversal energy into one J/byte
    per hop figure (~10 pJ/byte, 28nm-NoC scale); ``p_core_static`` is leakage
    per core, integrated over the step's makespan — so minimizing energy trades
    traffic volume against latency rather than reducing to comm_cost.
    """
    e_byte_hop: float = 1e-11      # J per byte per hop (link + router dynamic)
    p_core_static: float = 0.05    # W leakage per core

    def energy(self, comm_cost, latency, n_cores: int):
        """Works elementwise on [B] arrays and on scalars."""
        return (self.e_byte_hop * comm_cost
                + self.p_core_static * n_cores * latency)

    def energy_from_links(self, dynamic, latency, n_cores: int):
        """Energy with the dynamic term already summed from per-link
        ``energy_per_byte`` attributes (non-uniform topologies)."""
        return dynamic + self.p_core_static * n_cores * latency


#: Metric names an Objective term may reference. ``migration`` is special:
#: it scores the *transition* between placements, needs a
#: :class:`MigrationSpec` context on the Objective, and is evaluated from the
#: candidate placement itself rather than from the NoC metrics.
METRIC_TERMS = ("comm_cost", "max_link", "latency", "mean_hops", "energy",
                "interchip", "migration")


@dataclasses.dataclass(frozen=True)
class MigrationSpec:
    """Where each logical unit's resident state lives right now.

    The ``migration`` objective term charges ``state_bytes[i] ×
    hops(old_placement[i], candidate[i])`` for every unit a candidate
    placement moves — byte-hops over the *current* (possibly degraded) fabric,
    the same unit as ``comm_cost`` — so warm-started re-placement trades
    recovery quality against the cost of actually moving neuron/weight state
    between near-storage cores. ``state_bytes`` comes from the partition
    profile (``LogicalGraph.memory``, resident bytes per slice).
    """
    old_placement: tuple        # unit -> core the state currently occupies
    state_bytes: tuple          # unit -> resident bytes moved on re-place

    def __post_init__(self):
        if len(self.old_placement) != len(self.state_bytes):
            raise ValueError("old_placement and state_bytes length mismatch")

    @staticmethod
    def from_graph(graph, placement) -> "MigrationSpec":
        """Spec for re-placing ``graph`` currently deployed at ``placement``."""
        return MigrationSpec(
            tuple(int(c) for c in np.asarray(placement).tolist()),
            tuple(float(b) for b in np.asarray(graph.memory).tolist()))

    def cost(self, hops_matrix, placements):
        """Byte-hops to migrate state: scalar for a [n] placement, [B] array
        for a [B, n] batch."""
        old = np.asarray(self.old_placement, dtype=np.int64)
        sb = np.asarray(self.state_bytes, dtype=np.float64)
        P = np.asarray(placements, dtype=np.int64)
        hm = np.asarray(hops_matrix)
        if P.ndim == 1:
            return float((sb * hm[old, P]).sum())
        return (sb[None, :] * hm[old[None, :], P]).sum(axis=1)

    def moved_bytes(self, placement) -> float:
        """Total resident bytes that change core (distance-independent)."""
        old = np.asarray(self.old_placement, dtype=np.int64)
        sb = np.asarray(self.state_bytes, dtype=np.float64)
        P = np.asarray(placement, dtype=np.int64)
        return float(sb[P != old].sum())


def _link_dot(link_traffic, weights, topo):
    """Σ link_traffic × weights — over a reference ``NoCMetrics`` dict
    (label-keyed) or a batched ``[B, n_links]`` array."""
    if isinstance(link_traffic, dict):
        return float(sum(vol * weights[topo.link_id_of(label)]
                         for label, vol in link_traffic.items()))
    return link_traffic @ np.asarray(weights, np.float64)


@dataclasses.dataclass(frozen=True)
class Objective:
    """Weighted sum of :data:`METRIC_TERMS`, evaluated from one NoC evaluation.

    ``terms`` is ``((metric, weight), ...)``; weights are the caller's burden
    to scale (comm_cost is bytes×hops, latency seconds, energy joules).
    """
    name: str
    terms: tuple
    energy_model: EnergyModel = EnergyModel()
    migration: MigrationSpec | None = None

    def __post_init__(self):
        # A zero-weight migration term is dropped up front so "migration off"
        # keeps the exact historical terms tuple — and therefore the exact
        # is_comm_cost fast path and seed-for-seed search trajectories.
        if any(m == "migration" and w == 0.0 for m, w in self.terms):
            object.__setattr__(self, "terms", tuple(
                (m, w) for m, w in self.terms
                if not (m == "migration" and w == 0.0)))
        if not self.terms:
            raise ValueError("objective needs at least one term")
        for metric, weight in self.terms:
            if metric not in METRIC_TERMS:
                raise ValueError(f"unknown metric {metric!r}; "
                                 f"choose from {METRIC_TERMS}")
            if not np.isfinite(weight):
                raise ValueError(f"non-finite weight for {metric!r}")
            if metric == "migration" and self.migration is None:
                raise ValueError(
                    "a 'migration' term needs a MigrationSpec context — "
                    "build the objective with with_migration(spec, ...)")

    @property
    def has_migration(self) -> bool:
        return any(m == "migration" for m, _ in self.terms)

    @property
    def is_comm_cost(self) -> bool:
        """True iff this objective is exactly the historical comm-cost score
        (the condition under which scoring takes the fast, bit-identical
        gather-only path instead of a full metrics evaluation)."""
        return self.terms == (("comm_cost", 1.0),)

    def _term_value(self, metric: str, m, noc):
        if metric == "energy":
            eb = noc.link_energy_per_byte()
            if eb is None:
                return self.energy_model.energy(m.comm_cost, m.latency,
                                                noc.n_cores)
            return self.energy_model.energy_from_links(
                _link_dot(m.link_traffic, eb, noc), m.latency, noc.n_cores)
        if metric == "interchip":
            mask = noc.interchip_mask()
            if mask is None:
                return m.comm_cost * 0.0        # flat chip: no crossings
            return _link_dot(m.link_traffic, mask.astype(np.float64), noc)
        return getattr(m, metric)

    def _migration_cost(self, noc, placements):
        if placements is None:
            raise ValueError("objective has a 'migration' term: pass the "
                             "candidate placement(s) to from_metrics/"
                             "from_batch")
        return self.migration.cost(nb.batched_noc(noc).tables.hops,
                                   placements)

    def from_metrics(self, m, noc, placement=None) -> float:
        """Scalar score from a reference
        :class:`repro.core.topology.NoCMetrics`. ``placement`` is only
        required when the objective carries a ``migration`` term."""
        total = 0.0
        for metric, weight in self.terms:
            if metric == "migration":
                total += weight * self._migration_cost(noc, placement)
            else:
                total += weight * self._term_value(metric, m, noc)
        return float(total)

    def from_batch(self, m: nb.BatchMetrics, noc,
                   placements=None) -> np.ndarray:
        """[B] scores from a :class:`repro.core.noc_batch.BatchMetrics`.
        ``placements`` ([B, n]) is only required with a ``migration`` term."""
        total = np.zeros(m.comm_cost.shape[0])
        for metric, weight in self.terms:
            if metric == "migration":
                total += weight * np.asarray(
                    self._migration_cost(noc, placements), np.float64)
            else:
                total += weight * np.asarray(
                    self._term_value(metric, m, noc), np.float64)
        return total


#: Named single-metric objectives. Weighted combinations are spelled as
#: ``{metric: weight}`` dicts; ``as_objective`` normalizes either form.
#: ``migration`` has no standalone entry — it needs a MigrationSpec context
#: (see :func:`with_migration`).
OBJECTIVES = {
    name: Objective(name, ((name, 1.0),))
    for name in METRIC_TERMS if name != "migration"
}


def with_migration(spec, migration: MigrationSpec,
                   weight: float = 1.0) -> Objective:
    """``spec`` (any objective spec) extended with a ``migration`` term.

    ``weight`` scales migration byte-hops against the base terms; 0 returns
    the base objective unchanged (bit-identical scoring), which is how the
    runtime's "migration off" mode is spelled.
    """
    obj = as_objective(spec)
    if obj.has_migration:
        raise ValueError(f"objective {obj.name!r} already has a migration term")
    if weight == 0.0:
        return obj
    return dataclasses.replace(
        obj, name=f"{obj.name}+{weight:g}*migration",
        terms=obj.terms + (("migration", float(weight)),),
        migration=migration)


def as_objective(spec) -> Objective:
    """Normalize an objective spec (name | ``{metric: weight}`` | Objective;
    ``None`` means the default comm-cost objective)."""
    if spec is None:
        return OBJECTIVES["comm_cost"]
    if isinstance(spec, Objective):
        return spec
    if isinstance(spec, str):
        obj = OBJECTIVES.get(spec)
        if obj is None:
            raise ValueError(f"unknown objective {spec!r}; choose from "
                             f"{tuple(OBJECTIVES)} or pass a "
                             "{metric: weight} dict")
        return obj
    if isinstance(spec, dict):
        terms = tuple((str(k), float(v)) for k, v in spec.items())
        name = "+".join(f"{w:g}*{k}" for k, w in terms)
        return Objective(name, terms)
    raise TypeError(f"objective spec must be str, dict, or Objective, "
                    f"got {type(spec).__name__}")


def partition_interchip_bytes(graph) -> float:
    """Partition-induced interchip traffic (bytes/step), scored *before* any
    placement: Σ volumes of logical edges whose endpoints the chip-aware
    partitioner assigned to different chips (``graph.chip_of`` tags). 0.0 for
    chip-oblivious partitions. A lower bound on the placed interchip bytes of
    any chip-respecting placement — the quantity ``deploy_model``'s
    co-partition loop feeds placed traffic back against."""
    return graph.chip_cut_bytes()


def objective_scorer(noc, graph, objective, backend: str = "batch",
                     fused: bool = True, device=None):
    """``placements [B, n] -> scores [B]`` under ``objective``.

    The comm-cost objective delegates to
    :func:`repro_torch.core.noc_batch.make_scorer` (the bit-identical
    historical path). On the torch/cuda backends any other objective runs as
    one fused pass on ``device`` (``None``: the card;
    :meth:`repro_torch.core.noc_batch.BatchedNoC.make_fused_scorer`) that
    never materializes the full
    :class:`~repro_torch.core.noc_batch.BatchMetrics` (``fused=False`` forces
    the generic evaluate-then-combine path). The numpy backends run the full
    batched metrics evaluation and combine terms; same
    no-per-call-validation contract as ``make_scorer`` (validate user input
    once via ``validate_placements``).
    """
    obj = as_objective(objective)
    if obj.is_comm_cost:
        return nb.make_scorer(noc, graph, backend, device=device)
    if backend not in nb.SCORER_BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"choose from {nb.SCORER_BACKENDS}")
    if backend == "reference":
        def score_ref(placements):
            P = np.atleast_2d(np.asarray(placements, dtype=int))
            return np.array([obj.from_metrics(noc.evaluate(graph, p), noc, p)
                             for p in P])
        return score_ref

    b = nb.batched_noc(noc)
    # migration is a host-side gather over the candidate placements; keep it
    # out of the fused device kernel and combine terms on the numpy path
    if fused and not obj.has_migration \
            and b._resolve(backend) != "numpy":
        em = obj.energy_model
        return b.make_fused_scorer(graph, obj.terms,
                                   e_byte_hop=em.e_byte_hop,
                                   p_core_static=em.p_core_static,
                                   backend=backend, device=device)

    def score(placements):
        P = np.asarray(placements, dtype=np.int64)
        if P.ndim == 1:
            P = P[None, :]
        if P.shape[0] == 0:
            return np.zeros(0)
        m = b.evaluate(graph, P, backend=backend, validate=False,
                       device=device)
        return obj.from_batch(m, noc, P)
    return score
