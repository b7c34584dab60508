"""Placement-as-a-service: a persistent deployment server with plan caching.

Every ``deploy_model`` call used to rebuild topology tables and run a cold
search. The paper's setting is the opposite: one long-lived near-storage
system, many SNN models repeatedly (re)deployed onto it. This module is the
serving layer that amortizes the search:

* **exact hits** — requests are canonical
  :class:`~repro_torch.deploy.request.DeployRequest` values; a repeat of the same key (model-spec hash, topology
  ``cache_key``, objective, method/backend/budget/seed/method-kwargs) is
  answered straight from the
  :class:`~repro_torch.deploy.plancache.PlanCache` —
  legitimate because a seeded search is deterministic and the key captures
  every input. The cache is JSON on disk, so hits survive server restarts.
* **warm starts** — a *near miss* (same model/topology/partition ``warm_key``,
  different objective/budget/seed) reuses the cached placement as the
  search's ``init=`` at a fraction of the full budget, escalating like
  :func:`repro_torch.deploy.runtime.run_scenario` until the warm cost is
  within
  ``warm_threshold`` of the donor's. The init-seeded searches keep the best
  candidate seen — warm results never regress below the donor.
* **fused batches** — concurrent cold requests on the same topology+graph
  (think: a seed/parameter sweep arriving together) become *rows of one
  batched scorer* (:func:`repro_torch.core.noc_batch.make_scorer` already
  scores ``[B, n]`` populations in one call). The fused SA/RS loop replays
  each row's solo RNG stream in lock step, so fused results are
  **bit-identical** to serial ones — batching is purely a throughput
  optimization.

Requests run on the service's ``device`` (``None``: the card), where a
request's ``backend=None`` resolves to ``"cuda"``: float32 scoring on the
card. A fused ``[k, n]`` call there must give each row exactly what the solo
``[1, n]`` call gives. When every volume is an integer multiple of ``g``, a
power of two, float32 sums of the terms are exact, in any order, while they
stay below ``g · 2^24``, and every partial sum of a row is at most its comm
cost (every byte-hop, link load and per-core sum is part of it). So on a
float32 backend a row goes through the fused call when the graph's volumes
are integers, the objective's terms are such sums or are computed
elementwise from them (:func:`_rows_exact`), and the row's comm cost,
computed on the host in float64, is below ``g · 2^24``; any other row is
scored by itself, as the solo search scores it.

:class:`PlacementService` is the in-process core (usable directly in tests
and benchmarks); :func:`make_server` wraps it in a stdlib
``ThreadingHTTPServer`` whose ``POST /deploy`` handler funnels concurrent
connections through a :class:`repro_torch.launch.serve.MicroBatchQueue` — the
same continuous-batching idiom as the token server. Per-request latencies land
in the service :class:`repro_torch.obs.Recorder` as ``service.latency_s``
histograms
(p50/p99 via ``/stats``), and hit/miss/warm/fused counts as counters.

HTTP surface: ``POST /deploy`` (one request JSON -> DeployResponse JSON,
micro-batched), ``POST /deploy_batch`` (``{"requests": [...]}`` -> fused as
one group), ``GET /plan/<cache_key>``, ``GET /stats``, ``GET /healthz``.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np

from ..core.noc_batch import batched_noc
from ..core.partition import partition_model
from ..device import resolve_backend
from ..launch.serve import MicroBatchQueue
from ..obs import Recorder
from .engine import _profiles, execute_request
from .plancache import PlanCache, _obj_blob
from .request import DeployRequest

#: methods whose searches accept an ``init=`` warm start and keep the best
#: candidate seen (so warm-start cost can never regress below the donor's)
_WARM_METHODS = frozenset({"random_search", "simulated_annealing", "genetic",
                           "population_random_search",
                           "population_simulated_annealing"})

#: optimize_placement's per-method default evaluation budgets
_DEFAULT_BUDGET = {"random_search": 2000, "simulated_annealing": 5000,
                   "genetic": 6400, "population_random_search": 2000,
                   "population_simulated_annealing": 16000}

#: methods the fused batch path replays bit-exactly
_FUSE_METHODS = frozenset({"simulated_annealing", "random_search"})

#: below this many multiples of their common power of two, float32 sums of
#: integers are exact whatever their order
_F32_EXACT = 2.0 ** 24

#: objective terms a float32 scorer builds from sums of integer terms, or
#: elementwise from them, on any topology
_INTEGER_TERMS = frozenset({"comm_cost", "mean_hops", "max_link",
                            "interchip"})


@dataclasses.dataclass
class DeployResponse:
    """One service answer: where the plan came from and what it is.

    ``status`` is ``"hit"`` (served from cache), ``"warm"`` (near-miss
    warm-started from ``warm_from``'s placement) or ``"miss"`` (cold search;
    ``fused=True`` when it ran as a row of a batched dispatch). ``latency_s``
    is the service-side wall time of this request (for fused rows: of the
    whole batch). ``request`` + ``placement`` are enough to re-materialize a
    live plan via :func:`repro_torch.deploy.engine.instantiate_plan`.
    """
    status: str
    cache_key: str
    request: dict
    placement: list
    objective_cost: float
    comm_cost: float
    report: dict
    latency_s: float
    warm_from: str | None = None
    attempts: int = 1
    fused: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DeployResponse":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class PlacementService:
    """The in-process placement service (cache + warm starts + fused batches).

    ``cache`` defaults to a fresh in-memory :class:`PlanCache` (load one from
    disk for restart persistence). ``recorder`` collects the service metrics
    (a private one is created when omitted); the deployment engine itself
    runs un-instrumented — results are bit-identical either way and a
    long-lived server must not accumulate per-iteration search events.

    Warm-start control mirrors ``run_scenario``: the first attempt runs at
    ``warm_budget_frac`` of the full budget seeded with the donor placement;
    while the cost is above ``(1 + warm_threshold) x`` the donor's (only
    comparable for same-objective donors) the budget escalates ``x
    escalation`` up to ``max_retries`` extra attempts (never beyond the full
    budget). ``fuse=False`` disables batched dispatch (every request runs
    serially — for A/B measurement; results are identical by construction).

    ``device`` (``None``: the card) is where every search runs; it is
    recorded in each cache entry, outside the key.
    """

    def __init__(self, cache: PlanCache | None = None, recorder=None,
                 warm_budget_frac: float = 0.4, warm_threshold: float = 0.05,
                 escalation: float = 2.0, max_retries: int = 1,
                 fuse: bool = True, device=None):
        self.cache = cache if cache is not None else PlanCache()
        self.recorder = recorder if recorder is not None else Recorder()
        self.warm_budget_frac = float(warm_budget_frac)
        self.warm_threshold = float(warm_threshold)
        self.escalation = float(escalation)
        self.max_retries = int(max_retries)
        self.fuse = bool(fuse)
        self.device = device
        self._topologies: dict = {}     # topology key tuple -> live Topology
        self._models: dict = {}         # model spec tuple -> live model
        self._lock = threading.RLock()

    # ---- public API --------------------------------------------------------
    def submit(self, request: DeployRequest) -> DeployResponse:
        """Answer one request: cache hit, warm start, or cold search."""
        with self._lock:
            return self._submit(request)

    def submit_batch(self, requests) -> list:
        """Answer several concurrent requests, fusing cold same-graph
        SA/RS groups into one batched scorer dispatch. Response order matches
        the input. Every fused row is bit-identical to its *solo cold*
        ``deploy_model`` result — batch composition never changes an answer.
        (Serially submitting the same sequence can differ legitimately:
        earlier requests' entries become warm-start donors for later ones.)
        """
        with self._lock:
            requests = list(requests)
            responses: list = [None] * len(requests)
            groups: dict = {}
            for idx, req in enumerate(requests):
                key = self._fuse_key(req)
                if key is None or req.cache_key() in self.cache:
                    responses[idx] = self._submit(req)
                else:
                    groups.setdefault(key, []).append(idx)
            for idxs in groups.values():
                cold, seen = [], set()
                for i in idxs:
                    req = requests[i]
                    ck = req.cache_key()
                    if ck in seen:
                        continue        # duplicate row: hits the cache below
                    if self._warm_startable(req) and \
                            self.cache.find_warm(req) is not None:
                        responses[i] = self._submit(req)   # warm is cheaper
                    else:
                        cold.append(i)
                        seen.add(ck)
                if len(cold) == 1:
                    responses[cold[0]] = self._submit(requests[cold[0]])
                elif cold:
                    fused = self._submit_fused([requests[i] for i in cold])
                    for i, resp in zip(cold, fused):
                        responses[i] = resp
            # anything left (in-batch duplicates) is now a cache hit
            for idx, resp in enumerate(responses):
                if resp is None:
                    responses[idx] = self._submit(requests[idx])
            return responses

    def stats(self) -> dict:
        """Cache size + service counters + latency histogram summaries."""
        with self._lock:
            return {"cache_entries": len(self.cache),
                    "counters": self.recorder.counters,
                    "latency": self.recorder.histogram_summaries()}

    # ---- request handling --------------------------------------------------
    def _submit(self, request: DeployRequest) -> DeployResponse:
        t0 = time.perf_counter()
        rec = self.recorder
        ck = request.cache_key()
        rec.count("service.requests")
        entry = self.cache.get(ck)
        if entry is not None:
            rec.count("service.hits")
            return self._finish(entry, "hit", t0)
        donor = (self.cache.find_warm(request)
                 if self._warm_startable(request) else None)
        if donor is not None:
            try:
                with rec.span("service.deploy", status="warm", key=ck[:12]):
                    plan, attempts = self._deploy_warm(request, donor)
            except ValueError:
                donor = None            # incompatible donor: run cold
            else:
                rec.count("service.warm_starts")
                entry = self.cache.put(request, plan, self.device)
                return self._finish(entry, "warm", t0,
                                    warm_from=donor["cache_key"],
                                    attempts=attempts)
        with rec.span("service.deploy", status="miss", key=ck[:12]):
            model, noc = self._materialize(request)
            plan = execute_request(request, model=model, noc=noc,
                                   device=self.device)
        rec.count("service.misses")
        entry = self.cache.put(request, plan, self.device)
        return self._finish(entry, "miss", t0)

    def _finish(self, entry: dict, status: str, t0: float,
                warm_from: str | None = None, attempts: int = 1,
                fused: bool = False) -> DeployResponse:
        dt = time.perf_counter() - t0
        self.recorder.observe("service.latency_s", dt)
        self.recorder.observe(f"service.latency_s.{status}", dt)
        return DeployResponse(
            status=status, cache_key=entry["cache_key"],
            request=dict(entry["request"]),
            placement=list(entry["placement"]),
            objective_cost=float(entry["objective_cost"]),
            comm_cost=float(entry["comm_cost"]), report=entry["report"],
            latency_s=dt, warm_from=warm_from, attempts=attempts, fused=fused)

    def _materialize(self, request: DeployRequest):
        """Live (model, topology) for a request — memoized per spec, so a
        long-lived server rebuilds a DegradedTopology's BFS tables once."""
        noc = self._topologies.get(request.topology)
        if noc is None:
            noc = request.materialize_topology()
            self._topologies[request.topology] = noc
        model = self._models.get(request.model)
        if model is None:
            model = request.materialize_model()
            self._models[request.model] = model
        return model, noc

    # ---- warm starts -------------------------------------------------------
    def _warm_startable(self, request: DeployRequest) -> bool:
        return (request.method in _WARM_METHODS
                and request.copartition_iters == 0
                and "init" not in dict(request.method_kw))

    def _full_budget(self, request: DeployRequest):
        """(override-kwarg-name, full budget) — explicit ``iters`` wins over
        ``budget`` in the searches, so the warm fraction must scale whichever
        the request actually drives."""
        mk = request.materialize_method_kw()
        if mk.get("iters"):
            return "iters", int(mk["iters"])
        if request.budget:
            return "budget", int(request.budget)
        return "budget", _DEFAULT_BUDGET[request.method]

    def _deploy_warm(self, request: DeployRequest, donor: dict):
        model, noc = self._materialize(request)
        init = np.asarray(donor["placement"], dtype=int)
        kind, full = self._full_budget(request)
        same_obj = (_obj_blob(donor["request"]["objective"])
                    == _obj_blob(request.objective))
        target = (1.0 + self.warm_threshold) * float(donor["objective_cost"])
        b = max(1, int(round(self.warm_budget_frac * full)))
        attempts, best = 0, None
        while True:
            attempts += 1
            plan = execute_request(request, model=model, noc=noc,
                                   device=self.device, init=init,
                                   **{kind: b})
            if best is None or (plan.placement.objective_cost
                                < best.placement.objective_cost):
                best = plan
            if not same_obj or best.placement.objective_cost <= target:
                break
            if attempts > self.max_retries or b >= full:
                break
            b = min(full, max(b + 1, int(round(b * self.escalation))))
        return best, attempts

    # ---- fused batches -----------------------------------------------------
    def _fuse_key(self, request: DeployRequest):
        """Grouping key for fusable cold requests, or None. Rows of a group
        share everything that shapes the search (graph, objective, method,
        budget, tuning kwargs) — only the seed may differ."""
        if not self.fuse or request.method not in _FUSE_METHODS:
            return None
        if request.backend not in (None, "batch"):
            return None
        if request.copartition_iters != 0:
            return None
        return (request.warm_key(), request.method, request.backend,
                _obj_blob(request.objective), request.budget,
                json.dumps(request.method_kw, sort_keys=True, default=str))

    def _submit_fused(self, requests) -> list:
        t0 = time.perf_counter()
        rec = self.recorder
        req0 = requests[0]
        model, noc = self._materialize(req0)
        seeds = [r.seed for r in requests]
        with rec.span("service.fused_search", rows=len(requests),
                      method=req0.method):
            placements = _fused_cold_search(req0, model, noc, seeds,
                                            self.device)
        rec.count("service.fused_batches")
        rec.count("service.fused_rows", len(requests))
        out = []
        for req, pl in zip(requests, placements):
            rec.count("service.requests")
            rec.count("service.misses")
            plan = execute_request(req, model=model, noc=noc,
                                   device=self.device, _fixed_placement=pl)
            entry = self.cache.put(req, plan, self.device)
            out.append(self._finish(entry, "miss", t0, fused=True))
        return out


# ---------------------------------------------------------------------------
# fused cold search: lock-step bit-exact replay of the solo SA/RS loops
# ---------------------------------------------------------------------------

def _rows_exact(score, graph, noc, backend: str, objective):
    """``score`` made safe to call on ``[k, n]`` rows: each row gets what the
    solo ``[1, n]`` call gives it.

    On the numpy float64 backends a row's score is a sum of its own terms
    only, so ``score`` is returned as it is. On the float32 device backends a
    row goes through the batched call only when every partial sum of it is
    exact in float32 (see the module docstring); every other row is scored
    by itself."""
    b = batched_noc(noc)
    if b._resolve(backend) == "numpy":
        return score
    src, dst, vol, _ = b.edge_arrays(graph)
    t = b.tables
    terms = {m for m, _ in objective.terms}
    batchable = bool(np.array_equal(vol, np.round(vol))) and (
        terms <= _INTEGER_TERMS
        or (t.uniform and t.energy_per_byte is None))
    if batchable:
        ints = vol[vol > 0].astype(np.int64)
        # the largest power of two dividing every volume: its lowest set bit
        step = int(np.min(ints & -ints)) if ints.size else 1
        limit = _F32_EXACT * step

    def score_rows(placements):
        P = np.asarray(placements, dtype=np.int64)
        if P.shape[0] <= 1:
            return score(P)
        if batchable:
            out = np.array(score(P), dtype=np.float64)
            comm = (t.hops[P[:, src], P[:, dst]] * vol).sum(axis=1)
            alone = np.nonzero(comm >= limit)[0]
        else:
            out, alone = np.empty(P.shape[0]), range(P.shape[0])
        for r in alone:
            out[r] = score(P[r:r + 1])[0]
        return out
    return score_rows


def _fused_cold_search(request: DeployRequest, model, noc, seeds,
                       device=None) -> list:
    """Placements for ``len(seeds)`` same-graph cold requests from ONE
    batched-scorer search on ``device``. Each row replays the exact solo
    semantics of :func:`repro_torch.core.placement.baselines.
    simulated_annealing` / :func:`~repro_torch.core.placement.baselines.
    random_search` — same per-row RNG streams (acceptance draws included),
    same init resolution, same scorer rows (:func:`_rows_exact`) — so every
    returned placement is bit-identical to the serial run; only the scoring
    calls are shared.
    """
    from ..core.noc_batch import make_scorer
    from ..core.placement.optimizer import _chip_seed

    _, profiles = _profiles(model, request.batch, request.training,
                            request.spike_density)
    n_usable = getattr(noc, "n_alive_cores", noc.n_cores)
    part = partition_model(profiles, n_usable, request.partition_strategy,
                           request.materialize_core(), topology=noc)
    graph = part.to_graph()
    backend = resolve_backend(request.backend, device)
    objective = request.materialize_objective()
    score = _rows_exact(make_scorer(noc, graph, backend, objective,
                                    device=device),
                        graph, noc, backend, objective)
    mk = request.materialize_method_kw()
    init = mk.get("init")
    if init is None:
        init = _chip_seed(graph, noc)   # same seeding optimize_placement does
    if request.method == "simulated_annealing":
        iters = mk.get("iters") or request.budget or 5000
        return _fused_sa(graph, noc, score, seeds, iters=int(iters),
                         t0=mk.get("t0", 0.05),
                         t_end_frac=mk.get("t_end_frac", 1e-3), init=init,
                         decay_on_degenerate=mk.get("decay_on_degenerate",
                                                    False))
    iters = mk.get("iters") or request.budget or 2000
    return _fused_rs(graph, noc, score, seeds, iters=int(iters), init=init)


def _fused_sa(graph, noc, score, seeds, iters, t0, t_end_frac, init,
              decay_on_degenerate) -> list:
    """B independent SA chains, batch-scored: per iteration, every chain
    draws its own proposal; the proposing rows are scored in one ``[k, n]``
    scorer call; acceptance RNG draws happen only when a row's new cost is
    worse (the solo loop's short-circuit). Degenerate proposals skip scoring
    and (historically) temperature decay, exactly like the solo loop."""
    from ..core.noc_batch import validate_placements
    from ..core.placement.baselines import core_pool, zigzag

    n = graph.n
    base = np.array(init if init is not None else zigzag(n, noc))
    validate_placements(noc, base, n)
    pool = core_pool(noc)
    cands = range(pool) if isinstance(pool, int) else pool.tolist()
    free = [i for i in cands if i not in set(base.tolist())]
    row = np.concatenate([base, np.asarray(free, dtype=int)])
    B, n_slots = len(seeds), len(row)
    slots = np.tile(row, (B, 1))
    rngs = [np.random.default_rng(s) for s in seeds]
    cost0 = float(score(row[None, :n])[0])
    cost = np.full(B, cost0)
    best = np.tile(row[:n], (B, 1))
    best_cost = cost.copy()
    t = np.full(B, max(t0 * max(cost0, 1.0), 1e-9))
    cooling = t_end_frac ** (1.0 / max(iters, 1))
    for _ in range(iters):
        proposing, pairs = [], []
        for b in range(B):
            i, j = rngs[b].integers(0, n_slots, 2)
            if i == j or (i >= n and j >= n):
                if decay_on_degenerate:
                    t[b] *= cooling
                continue
            s = slots[b]
            s[i], s[j] = s[j], s[i]
            proposing.append(b)
            pairs.append((int(i), int(j)))
        if not proposing:
            continue
        new_costs = score(slots[proposing][:, :n])
        for k, b in enumerate(proposing):
            nc = float(new_costs[k])
            i, j = pairs[k]
            if nc <= cost[b] or \
                    rngs[b].random() < np.exp((cost[b] - nc) /
                                              max(t[b], 1e-9)):
                cost[b] = nc
                if nc < best_cost[b]:
                    best[b], best_cost[b] = slots[b, :n].copy(), nc
            else:
                s = slots[b]
                s[i], s[j] = s[j], s[i]
            t[b] *= cooling
    return [best[b].copy() for b in range(B)]


def _fused_rs(graph, noc, score, seeds, iters, init) -> list:
    """B independent random searches, batch-scored one ``[B, n]`` call per
    iteration; first-strict-minimum keeps, like the solo loop."""
    from ..core.noc_batch import validate_placements
    from ..core.placement.baselines import core_pool

    n, B = graph.n, len(seeds)
    rngs = [np.random.default_rng(s) for s in seeds]
    best: list = [None] * B
    best_cost = np.full(B, np.inf)
    if init is not None:
        init = np.asarray(init, dtype=int)
        validate_placements(noc, init, n)
        c0 = float(score(init[None, :])[0])
        best = [init] * B
        best_cost[:] = c0
    pool = core_pool(noc)
    for _ in range(iters):
        props = np.stack([rngs[b].permutation(pool)[:n] for b in range(B)])
        cs = score(props)
        for b in range(B):
            c = float(cs[b])
            if c < best_cost[b]:
                best[b], best_cost[b] = props[b].copy(), c
    return best


# ---------------------------------------------------------------------------
# HTTP layer (stdlib only)
# ---------------------------------------------------------------------------

def make_server(service: PlacementService, host: str = "127.0.0.1",
                port: int = 0, max_batch: int = 8, window_s: float = 0.01):
    """A ``ThreadingHTTPServer`` serving ``service``. ``POST /deploy``
    requests from concurrent connections funnel through one
    :class:`MicroBatchQueue` (requests landing within ``window_s`` fuse into
    one ``submit_batch``). The queue is at ``server.queue`` — call
    ``server.queue.close()`` after ``server.shutdown()``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    queue = MicroBatchQueue(service.submit_batch, max_batch=max_batch,
                            window_s=window_s)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet: metrics live in /stats
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, {"ok": True})
            if self.path == "/stats":
                return self._json(200, service.stats())
            if self.path.startswith("/plan/"):
                key = self.path[len("/plan/"):]
                with service._lock:
                    entry = service.cache.get(key)
                if entry is None:
                    return self._json(404, {"error": f"no plan {key!r}"})
                return self._json(200, {
                    k: entry[k] for k in ("cache_key", "request", "placement",
                                          "objective_cost", "comm_cost",
                                          "report")})
            return self._json(404, {"error": f"unknown path {self.path!r}"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                return self._json(400, {"error": f"bad JSON: {e}"})
            try:
                if self.path == "/deploy":
                    req = DeployRequest.from_json(body)
                    return self._json(200, queue.submit(req).to_dict())
                if self.path == "/deploy_batch":
                    reqs = [DeployRequest.from_json(d)
                            for d in body["requests"]]
                    resps = service.submit_batch(reqs)
                    return self._json(200,
                                      {"responses": [r.to_dict()
                                                     for r in resps]})
            except (TypeError, ValueError, KeyError) as e:
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})
            return self._json(404, {"error": f"unknown path {self.path!r}"})

    return ThreadingHTTPServer((host, port), Handler), queue


def request_over_http(url: str, request: DeployRequest,
                      timeout: float = 300.0) -> DeployResponse:
    """Client helper: POST one request to a running server's ``/deploy``."""
    import urllib.request

    data = json.dumps(request.to_json()).encode()
    http_req = urllib.request.Request(
        url.rstrip("/") + "/deploy", data=data,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(http_req, timeout=timeout) as resp:
        return DeployResponse.from_dict(json.loads(resp.read()))


def fetch_plan(src: str, timeout: float = 60.0) -> dict:
    """A cached-plan dict (``request`` + ``placement`` + ``report``) from a
    JSON file or a server URL (``http://host:port/plan/<cache_key>``, or any
    endpoint returning a saved DeployResponse/plan entry)."""
    if src.startswith(("http://", "https://")):
        import urllib.request

        with urllib.request.urlopen(src, timeout=timeout) as resp:
            return json.loads(resp.read())
    with open(src) as f:
        return json.load(f)
