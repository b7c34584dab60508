"""Typed, hashable, serializable deployment requests (the service API).

``deploy_model``'s 18-kwarg surface is great for notebooks and terrible as a
cache key. :class:`DeployRequest` canonicalizes one deployment call into a
frozen value object — model spec, topology identity, objective, search spec,
partition/schedule options — with three guarantees the placement service
(:mod:`repro_torch.deploy.service`) is built on:

* **round-trip**: ``DeployRequest.from_json(json.loads(json.dumps(
  req.to_json())))`` == ``req`` — requests cross process/HTTP boundaries
  losslessly (floats survive exactly: JSON emits shortest round-trip reprs);
* **stable identity**: :meth:`DeployRequest.cache_key` is the sha256 of the
  canonical JSON form, so the same request hashes identically across
  processes, machines and server restarts;
* **exact materialization**: :meth:`materialize_model` /
  :meth:`materialize_topology` / :meth:`deploy_kwargs` rebuild arguments that
  drive :func:`repro_torch.deploy.deploy_model`'s engine to bit-identical
  results.

The canonical JSON, and so every :meth:`DeployRequest.cache_key` and
:meth:`DeployRequest.warm_key`, is the JAX package's byte for byte for the
same call, so plan caches move between the two packages. Two things keep it
so:

* **The device is not part of a request.** Where a plan is computed is an
  argument of execution (``execute_request(request, device=...)``), not of
  identity.
* **Search configs are encoded over the reference's fields only.** The
  port's :class:`~repro_torch.core.placement.PPOConfig` and
  :class:`~repro_torch.core.placement.PolicyConfig` carry test-only
  injection fields (``init_params``, ``eps``, ``gumbel``); a config with one
  of them set raises :class:`RequestEncodeError` (``deploy_model`` then runs
  the engine directly), and one without them encodes exactly as the
  reference's would. Their ``backend`` default differs: ``None`` here
  (resolved by device), ``"batch"`` in the reference. It is encoded as
  given, so a config left at its default keys differently from the
  reference's default and like the reference's ``backend=None``, while an
  explicit ``backend="batch"`` keys like the reference's default
  (``tests/test_torch_request.py`` pins both).

Canonicalization happens at construction: method aliases resolve
(``sa`` -> ``simulated_annealing``), ``partition_strategy="auto"`` resolves
against the topology, objective specs normalize through
:func:`repro_torch.deploy.objective.as_objective`, and the topology is stored
as its structural :meth:`repro_torch.core.topology.Topology.cache_key` tuple —
which also means a :class:`repro_torch.core.topology.DegradedTopology` can
never collide with its healthy base (the fault sets are part of the key).

Inputs that cannot be canonically serialized — custom Topology subclasses,
objectives carrying a :class:`repro_torch.deploy.objective.MigrationSpec`,
non-encodable method kwargs, search configs with injected draws — raise
:class:`RequestEncodeError`; ``deploy_model`` falls back to the direct engine
path for those.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from ..core.partition import CoreSpec, LayerProfile
from ..core.topology import (DegradedTopology, GridTopology, HierarchicalMesh,
                             Topology, degrade)
from ..snn.models import (Classifier, ConvBNLif, MaxPool, Residual, SNNConfig)
from ..snn.neurons import LIFConfig
from .objective import EnergyModel, Objective, as_objective


class RequestEncodeError(TypeError):
    """The input cannot be canonically encoded into a DeployRequest.

    Subclasses :class:`TypeError` — an unencodable input is a type problem,
    and ``deploy_model`` catches exactly this to fall back to the direct
    engine path for exotic (but still valid) inputs.
    """


# ---------------------------------------------------------------------------
# frozen value trees
# ---------------------------------------------------------------------------
# A "frozen tree" is the canonical immutable encoding of a value: primitives
# (None/bool/int/float/str) and tuples of frozen trees only. Container and
# object types are tagged so thawing restores the exact original type:
#   ("@list", (items...)) / ("@tuple", (items...)) / ("@dict", ((k, v)...))
#   ("@nd", dtype.str, (shape...), (flat values...))      numpy arrays
#   ("@dc", ClassName, ((field, value)...))               registered dataclasses
# JSON round-trips turn every tuple into a list; _tuplify undoes that, so
# from_json(to_json(x)) reproduces the identical frozen tree.

_DC_CLASSES = {cls.__name__: cls for cls in
               (SNNConfig, ConvBNLif, Residual, MaxPool, Classifier,
                LIFConfig, CoreSpec, LayerProfile)}

#: search configs -> their test-only fields, which the reference's configs
#: do not have: never encoded, and a config with one set is refused
_SEARCH_INJECTED = {"PPOConfig": ("init_params", "eps"),
                    "PolicyConfig": ("init_params", "gumbel")}


def _dc_class(name: str):
    cls = _DC_CLASSES.get(name)
    if cls is not None:
        return cls
    # search configs live beside torch-heavy modules; resolve them lazily so
    # importing repro_torch.deploy stays light
    if name in _SEARCH_INJECTED:
        from ..core.placement.policy_baseline import PolicyConfig
        from ..core.placement.ppo import PPOConfig
        return {"PPOConfig": PPOConfig, "PolicyConfig": PolicyConfig}[name]
    raise RequestEncodeError(f"unknown dataclass tag {name!r} in request")


def _freeze(value):
    """Value -> frozen tree (raises RequestEncodeError when impossible)."""
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        if not np.isfinite(value):
            raise RequestEncodeError(f"non-finite float {value!r} in request")
        return value
    if isinstance(value, (np.bool_, np.integer, np.floating)):
        return _freeze(value.item())
    if isinstance(value, np.ndarray):
        return ("@nd", value.dtype.str, tuple(int(s) for s in value.shape),
                tuple(_freeze(v) for v in value.reshape(-1).tolist()))
    if isinstance(value, tuple):
        return ("@tuple", tuple(_freeze(v) for v in value))
    if isinstance(value, list):
        return ("@list", tuple(_freeze(v) for v in value))
    if isinstance(value, dict):
        items = []
        for k in sorted(value, key=str):
            if not isinstance(k, str):
                raise RequestEncodeError(
                    f"dict keys in a request must be str, got {k!r}")
            items.append((k, _freeze(value[k])))
        return ("@dict", tuple(items))
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        name = type(value).__name__
        _dc_class(name)                      # known tag or RequestEncodeError
        injected = _SEARCH_INJECTED.get(name, ())
        set_ = [k for k in injected if getattr(value, k) is not None]
        if set_:
            raise RequestEncodeError(
                f"{name} with injected {set_} cannot be encoded: injected "
                "weights and draws are not part of a request")
        return ("@dc", name,
                tuple((f.name, _freeze(getattr(value, f.name)))
                      for f in dataclasses.fields(value)
                      if f.name not in injected))
    raise RequestEncodeError(
        f"cannot encode {type(value).__name__!r} value into a DeployRequest "
        "(callables, custom objects and non-finite floats are not "
        "serializable)")


_TAGS = ("@nd", "@tuple", "@list", "@dict", "@dc")


def _thaw(tree):
    """Frozen tree -> original value (exact inverse of :func:`_freeze`)."""
    if not isinstance(tree, tuple):
        return tree
    tag = tree[0] if tree and isinstance(tree[0], str) else None
    if tag == "@nd":
        _, dtype, shape, flat = tree
        return np.array([_thaw(v) for v in flat],
                        dtype=np.dtype(dtype)).reshape(shape)
    if tag == "@tuple":
        return tuple(_thaw(v) for v in tree[1])
    if tag == "@list":
        return [_thaw(v) for v in tree[1]]
    if tag == "@dict":
        return {k: _thaw(v) for k, v in tree[1]}
    if tag == "@dc":
        cls = _dc_class(tree[1])
        return cls(**{k: _thaw(v) for k, v in tree[2]})
    return tuple(_thaw(v) for v in tree)


def _tuplify(x):
    """Deep lists -> tuples: undo JSON's tuple->list coercion."""
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


# ---------------------------------------------------------------------------
# topology <-> structural key
# ---------------------------------------------------------------------------

#: Topology classes whose cache_key tuples round-trip through
#: :func:`topology_from_key` (NoC is registered by _topology_key lazily).
_KEYABLE_TOPOLOGIES = (GridTopology, HierarchicalMesh)


def _topology_key(topo: Topology) -> tuple:
    """Structural key of a topology, verified re-buildable."""
    if isinstance(topo, DegradedTopology):
        _topology_key(topo.base)             # base must itself be keyable
        return _freeze_key(topo.cache_key())
    from ..core.noc import NoC               # noc imports topology; lazy
    if type(topo) in (GridTopology, NoC, HierarchicalMesh):
        return _freeze_key(topo.cache_key())
    raise RequestEncodeError(
        f"cannot encode topology type {type(topo).__name__!r}: only grid "
        "meshes/tori (NoC), HierarchicalMesh and their degraded views have "
        "re-buildable cache keys")


def _freeze_key(key) -> tuple:
    """cache_key tuples hold primitives and nested tuples only; normalize
    numpy scalars so the frozen form is JSON-native."""
    out = []
    for v in key:
        if isinstance(v, tuple):
            out.append(_freeze_key(v))
        elif isinstance(v, (np.bool_, np.integer, np.floating)):
            out.append(v.item())
        elif v is None or isinstance(v, (bool, int, float, str)):
            out.append(v)
        else:
            raise RequestEncodeError(f"non-primitive {v!r} in topology key")
    return tuple(out)


def topology_from_key(key) -> Topology:
    """Rebuild a live topology from its structural cache-key tuple.

    Supports the ``("grid", ...)`` / ``("hier", ...)`` keys of
    :class:`repro_torch.core.topology.GridTopology` (and its ``NoC`` alias) /
    :class:`repro_torch.core.topology.HierarchicalMesh`, plus the
    ``(... , "degraded", links, nodes)`` extension of
    :class:`repro_torch.core.topology.DegradedTopology`.
    """
    from ..core.noc import NoC
    key = _tuplify(tuple(key))
    if len(key) >= 3 and key[-3] == "degraded":
        base = topology_from_key(key[:-3])
        return degrade(base, links=key[-2], nodes=key[-1])
    kind = key[0]
    if kind == "grid":
        _, rows, cols, torus, link_bw, core_flops, hop_latency = key
        return NoC(int(rows), int(cols), torus=bool(torus),
                   link_bw=link_bw, core_flops=core_flops,
                   hop_latency=hop_latency)
    if kind == "hier":
        (_, chips_rows, chips_cols, core_rows, core_cols, link_bw,
         interchip_bw, core_flops, hop_latency, interchip_latency,
         e_byte_hop, interchip_energy) = key
        return HierarchicalMesh(
            int(chips_rows), int(chips_cols), int(core_rows), int(core_cols),
            interchip_bw=interchip_bw, interchip_energy=interchip_energy,
            link_bw=link_bw, core_flops=core_flops, hop_latency=hop_latency,
            e_byte_hop=e_byte_hop, interchip_latency=interchip_latency)
    raise ValueError(f"unknown topology key kind {kind!r} in {key!r}")


# ---------------------------------------------------------------------------
# model / objective specs
# ---------------------------------------------------------------------------

def _model_spec(model) -> tuple:
    """model argument -> ("model_cfg", tree) | ("profiles", (trees...))."""
    if isinstance(model, SNNConfig):
        return ("model_cfg", _freeze(model))
    try:
        layers = list(model)
    except TypeError:
        raise RequestEncodeError(
            f"model must be an SNNConfig or a list of LayerProfile, got "
            f"{type(model).__name__!r}") from None
    if not all(isinstance(l, LayerProfile) for l in layers):
        raise RequestEncodeError(
            "model must be an SNNConfig or a list of LayerProfile")
    return ("profiles", tuple(_freeze(l) for l in layers))


def _objective_spec(objective) -> tuple:
    """objective spec -> (name, terms, e_byte_hop, p_core_static)."""
    obj = as_objective(objective)
    if obj.has_migration:
        raise RequestEncodeError(
            "objectives with a migration term are transition-specific "
            "(they carry the live placement) and cannot be cached/served")
    terms = tuple((str(m), float(w)) for m, w in obj.terms)
    em = obj.energy_model
    return (obj.name, terms, float(em.e_byte_hop), float(em.p_core_static))


# ---------------------------------------------------------------------------
# the request
# ---------------------------------------------------------------------------

#: JSON field order of to_json (also the dataclass field order).
_FIELDS = ("model", "topology", "objective", "method", "backend", "budget",
           "seed", "partition_strategy", "schedule", "n_units", "batch",
           "training", "spike_density", "bwd_ratio", "contention_feedback",
           "copartition_iters", "core", "method_kw")


@dataclasses.dataclass(frozen=True)
class DeployRequest:
    """One canonical, hashable deployment request (see module docstring).

    Build with :meth:`from_call` (the ``deploy_model`` argument surface) or
    :meth:`from_json`; never mutate — equality and :meth:`cache_key` define
    request identity for the plan cache.
    """
    model: tuple                  # ("model_cfg", tree) | ("profiles", trees)
    topology: tuple               # Topology.cache_key() (frozen)
    objective: tuple              # (name, terms, e_byte_hop, p_core_static)
    method: str                   # alias-resolved optimize_placement method
    backend: str | None
    budget: int | None
    seed: int
    partition_strategy: str       # resolved ("auto" never stored)
    schedule: str
    n_units: int
    batch: int
    training: bool
    spike_density: float
    bwd_ratio: float
    contention_feedback: bool
    copartition_iters: int
    core: tuple                   # (sram_bytes, flops_per_s, stream_bw)
    method_kw: tuple              # sorted ((name, frozen value), ...)

    # ---- construction ------------------------------------------------------
    @classmethod
    def from_call(cls, model, noc, partition_strategy: str = "auto",
                  method: str = "ppo", objective="comm_cost",
                  schedule: str = "fpdeep", n_units: int = 8,
                  batch: int = 8, training: bool = True,
                  spike_density: float = 0.15, core: CoreSpec = CoreSpec(),
                  seed: int = 0, budget: int | None = None,
                  backend: str | None = None, bwd_ratio: float = 2.0,
                  contention_feedback: bool = False,
                  copartition_iters: int = 0,
                  method_kw: dict | None = None) -> "DeployRequest":
        """Canonicalize one ``deploy_model`` call. Raises
        :class:`RequestEncodeError` for unencodable inputs and the same
        ``TypeError``/``ValueError`` as the engine for invalid specs
        (unknown schedule/objective/method, typo'd method kwargs)."""
        from ..core.placement.optimizer import (METHOD_ALIASES,
                                                validate_method_kw)
        from .engine import SCHEDULES, resolve_partition_strategy

        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}; "
                             f"choose from {SCHEDULES}")
        method = METHOD_ALIASES.get(method, method)
        method_kw = dict(method_kw or {})
        validate_method_kw(method, method_kw, backend=backend)
        if not isinstance(core, CoreSpec):
            raise RequestEncodeError("core must be a CoreSpec")
        return cls(
            model=_model_spec(model),
            topology=_topology_key(noc),
            objective=_objective_spec(objective),
            method=str(method),
            backend=None if backend is None else str(backend),
            budget=None if budget is None else int(budget),
            seed=int(seed),
            partition_strategy=resolve_partition_strategy(
                str(partition_strategy), noc),
            schedule=str(schedule),
            n_units=int(n_units),
            batch=int(batch),
            training=bool(training),
            spike_density=float(spike_density),
            bwd_ratio=float(bwd_ratio),
            contention_feedback=bool(contention_feedback),
            copartition_iters=int(copartition_iters),
            core=(float(core.sram_bytes), float(core.flops_per_s),
                  float(core.stream_bw)),
            method_kw=tuple(sorted((str(k), _freeze(v))
                                   for k, v in method_kw.items())),
        )

    # ---- serialization -----------------------------------------------------
    def to_json(self) -> dict:
        """JSON-able dict (tuples become lists on dump; :meth:`from_json`
        restores them)."""
        return {f: getattr(self, f) for f in _FIELDS}

    @classmethod
    def from_json(cls, d: dict) -> "DeployRequest":
        unknown = sorted(set(d) - set(_FIELDS))
        if unknown:
            raise ValueError(f"unknown DeployRequest field(s) {unknown}; "
                             f"expected {list(_FIELDS)}")
        missing = sorted(set(_FIELDS) - set(d))
        if missing:
            raise ValueError(f"missing DeployRequest field(s) {missing}")
        return cls(**{f: _tuplify(d[f]) for f in _FIELDS})

    # ---- identity ----------------------------------------------------------
    def canonical_json(self) -> str:
        """The canonical serialized form :meth:`cache_key` hashes."""
        return json.dumps(self.to_json(), sort_keys=True,
                          separators=(",", ":"))

    def cache_key(self) -> str:
        """sha256 hex digest of the canonical JSON form — the exact-identity
        plan-cache key, stable across processes and restarts."""
        return hashlib.sha256(self.canonical_json().encode()).hexdigest()

    def warm_key(self) -> str:
        """Hash of the fields that fix the *logical graph* (model, topology,
        partition) — requests sharing a warm key differ only in objective /
        method / backend / budget / seed / method kwargs, so a cached
        placement of one is a valid ``init=`` warm start for another."""
        sub = {f: getattr(self, f) for f in
               ("model", "topology", "partition_strategy", "batch",
                "training", "spike_density", "core", "copartition_iters")}
        blob = json.dumps(sub, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()

    # ---- materialization ---------------------------------------------------
    def materialize_model(self):
        """Rebuild the model argument (SNNConfig or list[LayerProfile])."""
        kind, payload = self.model
        if kind == "model_cfg":
            return _thaw(payload)
        return [_thaw(p) for p in payload]

    def materialize_topology(self) -> Topology:
        return topology_from_key(self.topology)

    def materialize_objective(self) -> Objective:
        name, terms, e_byte_hop, p_core_static = self.objective
        return Objective(str(name), tuple((str(m), float(w))
                                          for m, w in terms),
                         energy_model=EnergyModel(float(e_byte_hop),
                                                  float(p_core_static)))

    def materialize_core(self) -> CoreSpec:
        sram, flops, bw = self.core
        return CoreSpec(sram_bytes=sram, flops_per_s=flops, stream_bw=bw)

    def materialize_method_kw(self) -> dict:
        return {k: _thaw(v) for k, v in self.method_kw}

    def deploy_kwargs(self) -> dict:
        """Flat engine kwargs (everything but model/noc/recorder), with the
        method kwargs merged in — ``_deploy(model, noc, **kw)`` ready."""
        return {
            "partition_strategy": self.partition_strategy,
            "method": self.method,
            "objective": self.materialize_objective(),
            "schedule": self.schedule,
            "n_units": self.n_units,
            "batch": self.batch,
            "training": self.training,
            "spike_density": self.spike_density,
            "core": self.materialize_core(),
            "seed": self.seed,
            "budget": self.budget,
            "backend": self.backend,
            "bwd_ratio": self.bwd_ratio,
            "contention_feedback": self.contention_feedback,
            "copartition_iters": self.copartition_iters,
            **self.materialize_method_kw(),
        }

    def describe(self) -> str:
        """One-line human summary (CLI/server logs)."""
        kind, payload = self.model
        if kind == "model_cfg":
            name = dict(payload[2])["name"]
        else:
            name = f"profiled[{len(payload)}]"
        return (f"{name} via {self.method} (objective={self.objective[0]}, "
                f"seed={self.seed}, budget={self.budget}) on "
                f"{self.topology[0]}:{self.topology[1]}x{self.topology[2]}")
