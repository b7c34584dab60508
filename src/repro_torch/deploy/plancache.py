"""Serializable LRU cache of deployment plans keyed by DeployRequest identity.

One entry per :meth:`repro_torch.deploy.request.DeployRequest.cache_key` — the
sha256 of the canonical request JSON, i.e. ``(model-spec, topology cache_key,
objective, method/backend/budget/seed/method_kw, partition + schedule
options)``. An entry stores everything needed to answer a repeat request
without redeploying (placement, costs, the full report) *and* the request
JSON itself, so a reloaded cache can re-materialize plans
(:func:`repro_torch.deploy.engine.instantiate_plan`) in a fresh process.

Entries also carry the request's
:meth:`~repro_torch.deploy.request.DeployRequest.warm_key` — the hash of the
fields that fix the logical graph. A miss whose
warm key matches a cached entry is a *near miss* (same model/topology/
partition, different objective/method/budget/seed): :meth:`find_warm` returns
the best donor placement for the service's warm-start path.

The cache is plain JSON on disk (:meth:`save`/:meth:`load`), so cache hits
survive server restarts — a seeded search is deterministic, and its key
captures every input, so serving the stored result *is* re-running it.

The file format is the JAX package's (``version: 1``, the same keys), so a
cache written by either package loads in the other and re-keys to the same
keys. Each entry here also records where its plan was computed: ``device``
and ``resolved_backend`` (the scoring backend ``backend=None`` resolved to
there). They sit outside the key — a request's identity does not name a
device — and ``load`` keeps unknown entry fields in both packages.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..device import resolve_backend, resolve_device
from .request import DeployRequest


def _entry_from_plan(request: DeployRequest, plan, device=None) -> dict:
    r = plan.placement            # PlacementResult
    dev = resolve_device(device)
    return {
        "cache_key": request.cache_key(),
        "warm_key": request.warm_key(),
        "request": request.to_json(),
        "placement": [int(p) for p in np.asarray(r.placement).reshape(-1)],
        "objective": request.objective[0],
        "objective_cost": float(r.objective_cost),
        "comm_cost": float(r.comm_cost),
        "report": plan.report(),
        "device": str(dev),
        "resolved_backend": resolve_backend(request.backend, dev),
    }


def _obj_blob(objective) -> str:
    # tuple/list asymmetry (JSON round-trips tuples into lists) washes out
    # under dumps — both serialize to the same array syntax
    return json.dumps(objective, sort_keys=True)


class PlanCache:
    """In-memory plan store with LRU eviction and JSON persistence."""

    def __init__(self, max_entries: int = 1024):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = int(max_entries)
        self._entries: dict[str, dict] = {}
        self._seq = 0                 # monotonic access clock (recency)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, cache_key: str) -> bool:
        return cache_key in self._entries

    def _touch(self, entry: dict) -> None:
        self._seq += 1
        entry["last_seq"] = self._seq

    # ---- core ops ----------------------------------------------------------
    def get(self, cache_key: str) -> dict | None:
        """The entry for an exact request key (bumps hit count + recency)."""
        entry = self._entries.get(cache_key)
        if entry is None:
            return None
        entry["hits"] = entry.get("hits", 0) + 1
        self._touch(entry)
        return entry

    def put(self, request: DeployRequest, plan, device=None) -> dict:
        """Insert (or refresh) the plan for ``request``, computed on
        ``device`` (``None``: the card); returns the entry."""
        entry = _entry_from_plan(request, plan, device)
        old = self._entries.get(entry["cache_key"])
        entry["hits"] = old.get("hits", 0) if old else 0
        self._entries[entry["cache_key"]] = entry
        self._touch(entry)
        while len(self._entries) > self.max_entries:
            lru = min(self._entries.values(), key=lambda e: e["last_seq"])
            del self._entries[lru["cache_key"]]
        return entry

    def find_warm(self, request: DeployRequest) -> dict | None:
        """Best warm-start donor for a near-miss request: an entry sharing
        the request's warm key (same logical graph) under a different exact
        key. Prefers same-objective donors (their cost is directly
        comparable), then lower objective cost, then recency."""
        wk, ck = request.warm_key(), request.cache_key()
        obj = _obj_blob(request.objective)
        cands = [e for e in self._entries.values()
                 if e["warm_key"] == wk and e["cache_key"] != ck]
        if not cands:
            return None
        return min(cands, key=lambda e: (
            _obj_blob(e["request"]["objective"]) != obj,
            e["objective_cost"],
            -e["last_seq"]))

    def entries(self) -> list[dict]:
        """All entries, least recently used first."""
        return sorted(self._entries.values(), key=lambda e: e["last_seq"])

    # ---- persistence -------------------------------------------------------
    def save(self, path: str) -> None:
        tmp = f"{path}.tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"version": 1, "max_entries": self.max_entries,
                       "entries": self.entries()}, f)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, max_entries: int | None = None) -> "PlanCache":
        with open(path) as f:
            blob = json.load(f)
        cache = cls(max_entries=max_entries or blob.get("max_entries", 1024))
        for entry in blob["entries"]:
            # re-key through the request: a cache written by a different
            # code version re-hashes consistently with *this* version
            req = DeployRequest.from_json(entry["request"])
            entry = dict(entry)
            entry["cache_key"] = req.cache_key()
            entry["warm_key"] = req.warm_key()
            entry["request"] = req.to_json()
            cache._entries[entry["cache_key"]] = entry
            cache._seq = max(cache._seq, entry.get("last_seq", 0))
        while len(cache._entries) > cache.max_entries:
            lru = min(cache._entries.values(), key=lambda e: e["last_seq"])
            del cache._entries[lru["cache_key"]]
        return cache
