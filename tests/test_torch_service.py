"""Port parity of the placement service (``deploy/service.py``) against the
JAX package's (``tests/test_service.py``): hits, warm near misses, fused
batches bit-identical to serial searches and to the reference's, the cache
across a restart, and the HTTP surface on localhost. The guard that keeps a
fused float32 scorer call row-for-row equal to solo calls is driven on the
CPU through the ``torch`` backend."""
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro import deploy as r_deploy  # noqa: E402
from repro.core import NoC as RNoC  # noqa: E402
from repro.snn import spike_resnet18 as r_resnet18  # noqa: E402

from repro_torch import deploy as p_deploy  # noqa: E402
from repro_torch.core import graph as p_graph  # noqa: E402
from repro_torch.core import topology as p_topology  # noqa: E402
from repro_torch.core.noc import NoC  # noqa: E402
from repro_torch.core.noc_batch import make_scorer  # noqa: E402
from repro_torch.deploy import service as p_service  # noqa: E402
from repro_torch.snn import spike_resnet18 as p_resnet18  # noqa: E402


def _req(seed=0, budget=120, side="port", shape=(4, 4), **kw):
    dep, noc_cls, resnet = ((p_deploy, NoC, p_resnet18) if side == "port"
                            else (r_deploy, RNoC, r_resnet18))
    kw.setdefault("method", "simulated_annealing")
    kw.setdefault("schedule", "none")
    return dep.DeployRequest.from_call(resnet(n_classes=10, in_res=32, T=4),
                                       noc_cls(*shape), seed=seed,
                                       budget=budget, **kw)


def _service(**kw):
    return p_deploy.PlacementService(device="cpu", **kw)


def test_miss_hit_warm_match_reference():
    svc, ref = _service(), r_deploy.PlacementService()
    got = [svc.submit(_req(0)), svc.submit(_req(0)), svc.submit(_req(9)),
           svc.submit(_req(0, objective="max_link"))]
    want = [ref.submit(_req(0, side="ref")), ref.submit(_req(0, side="ref")),
            ref.submit(_req(9, side="ref")),
            ref.submit(_req(0, side="ref", objective="max_link"))]
    assert [r.status for r in got] == ["miss", "hit", "warm", "warm"]
    for g, w in zip(got, want):
        for k in ("status", "cache_key", "request", "placement",
                  "objective_cost", "comm_cost", "warm_from", "attempts",
                  "fused"):
            assert getattr(g, k) == getattr(w, k), k
    assert got[2].objective_cost <= got[0].objective_cost
    assert svc.stats()["counters"] == ref.stats()["counters"]
    assert p_deploy.DeployResponse.from_dict(got[2].to_dict()) == got[2]
    entry = svc.cache.get(got[0].cache_key)
    assert entry["device"] == "cpu" and entry["resolved_backend"] == "batch"


@pytest.mark.parametrize("method", ["simulated_annealing", "random_search"])
def test_fused_batch_bit_identical_to_serial_and_reference(method):
    seeds = (11, 12, 13)
    reqs = [_req(s, method=method) for s in seeds]
    svc = _service(fuse=True)
    resps = svc.submit_batch(reqs + [reqs[0]])        # a duplicate hits
    assert all(r.status == "miss" and r.fused for r in resps[:3])
    assert resps[3].status == "hit"
    ref = r_deploy.PlacementService(fuse=True).submit_batch(
        [_req(s, method=method, side="ref") for s in seeds])
    for req, resp, want in zip(reqs, resps, ref):
        solo = p_deploy.execute_request(req, device="cpu")
        np.testing.assert_array_equal(np.asarray(resp.placement),
                                      solo.placement.placement)
        assert resp.objective_cost == solo.placement.objective_cost
        assert resp.placement == want.placement
    c = svc.stats()["counters"]
    assert c["service.fused_batches"] == 1 and c["service.fused_rows"] == 3


@pytest.mark.parametrize("objective", ["comm_cost", "max_link", "latency"])
def test_fused_float32_search_matches_solo(objective):
    """The card's path on the CPU: a request whose backend resolves to a
    float32 device scorer, fused over three seeds, gives each row exactly
    its solo search's placement."""
    seeds = (1, 2, 3)
    reqs = [_req(s, budget=150, backend="torch", objective=objective)
            for s in seeds]
    model, noc = p_resnet18(n_classes=10, in_res=32, T=4), NoC(4, 4)
    fused = p_service._fused_cold_search(reqs[0], model, noc, seeds, "cpu")
    for req, pl in zip(reqs, fused):
        solo = p_deploy.execute_request(req, device="cpu")
        np.testing.assert_array_equal(pl, solo.placement.placement)


def _spy(score, calls):
    def spied(P):
        calls.append(np.asarray(P).shape[0])
        return score(P)
    return spied


def test_rows_exact_guard():
    """Rows whose comm cost reaches 2^24 times the volumes' common power of
    two (float32 sums no longer exact), non-integer volumes and
    order-dependent terms are scored alone; the rest share one call. Every
    row equals its solo score."""
    rng = np.random.default_rng(0)
    base = p_graph.random_dag(12, p=0.3, seed=1)
    edge = base.adj > 0
    big = np.round(base.adj) * 430 + edge     # odd volumes, costs near 2^24
    mesh, hier = NoC(4, 4), p_topology.parse_topology("hier:2x2:2x2")
    P = np.stack([rng.permutation(16)[:12] for _ in range(8)])
    cases = [(mesh, np.round(base.adj), "comm_cost", 1),
             (mesh, big, "max_link", 1),
             (mesh, big * 2.0 ** 12, "comm_cost", 2 ** 12),
             (mesh, base.adj + 0.5 * edge, "comm_cost", None),
             (hier, np.round(base.adj), "latency", None),
             (hier, (big - edge) * 2.0, "interchip", 4)]
    saw_split = False
    for topo, adj, objective, step in cases:
        g = p_graph.LogicalGraph(adj, base.compute, base.memory)
        obj = p_deploy.as_objective(objective)
        score = make_scorer(topo, g, "torch", obj, device="cpu")
        calls = []
        rows = p_service._rows_exact(_spy(score, calls), g, topo, "torch",
                                     obj)
        got = rows(P)
        want = np.array([score(P[r:r + 1])[0] for r in range(len(P))])
        np.testing.assert_array_equal(got, want)
        src, dst, vol = g.edge_arrays()
        comm = (topo.hops_matrix()[P[:, src], P[:, dst]] * vol).sum(axis=1)
        if step is not None:
            alone = int((comm >= 2.0 ** 24 * step).sum())
            assert calls == [len(P)] + [1] * alone
            saw_split |= 0 < alone < len(P)
        else:
            assert calls == [1] * len(P)
    assert saw_split
    g = p_graph.LogicalGraph(big, base.compute, base.memory)
    batch = make_scorer(mesh, g, "batch", "comm_cost")
    assert p_service._rows_exact(batch, g, mesh, "batch",
                                 p_deploy.as_objective("comm_cost")) is batch


def test_cache_survives_restart(tmp_path):
    path = tmp_path / "plans.json"
    svc = _service()
    cold = svc.submit(_req(0))
    svc.cache.save(str(path))
    svc2 = _service(cache=p_deploy.PlanCache.load(str(path)))
    hit = svc2.submit(_req(0))
    assert hit.status == "hit" and hit.placement == cold.placement


def test_http_roundtrip():
    svc = _service(fuse=True)
    server, queue = p_service.make_server(svc, port=0, window_s=0.05)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = _req(0)
        miss = p_service.request_over_http(url, req)
        hit = p_service.request_over_http(url, req)
        assert (miss.status, hit.status) == ("miss", "hit")
        assert hit.placement == miss.placement
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["cache_entries"] == 1
        assert stats["latency"]["service.latency_s"]["count"] == 2
        entry = p_service.fetch_plan(f"{url}/plan/{miss.cache_key}")
        live = p_deploy.instantiate_plan(
            p_deploy.DeployRequest.from_json(entry["request"]),
            entry["placement"], device="cpu")
        assert live.placement.objective_cost == miss.objective_cost
        # concurrent cold posts (another graph, so no warm donor)
        # micro-batch; each row stays its solo search
        resps = [None] * 2

        def post(i):
            resps[i] = p_service.request_over_http(url,
                                                   _req(20 + i, shape=(2, 8)))
        threads = [threading.Thread(target=post, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        for i, resp in enumerate(resps):
            solo = p_deploy.execute_request(_req(20 + i, shape=(2, 8)),
                                            device="cpu")
            assert resp.placement == list(map(int, solo.placement.placement))
        bad = urllib.request.Request(url + "/deploy", data=b"{not json",
                                     headers={"Content-Type":
                                              "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/plan/deadbeef", timeout=30)
        assert ei.value.code == 404
    finally:
        server.shutdown()
        server.server_close()
        queue.close()
