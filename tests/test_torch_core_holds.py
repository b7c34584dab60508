"""The reference's ``tests/test_pipeline.py`` and ``tests/test_noc.py`` held
on the port's ``repro_torch.core``, exactly: every schedule's events and
makespan, and every NoC route, hop count and metric, equal the reference's
on the same inputs, and the reference's properties hold on the port.
"""
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import NoC as r_NoC  # noqa: E402
from repro.core import chain_graph as r_chain  # noqa: E402
from repro.core import pipeline as r_pipe  # noqa: E402
from repro.core import random_dag as r_dag  # noqa: E402
from repro.core.placement.baselines import sigmate as r_sigmate  # noqa: E402
from repro_torch.core import NoC, chain_graph, pipeline, random_dag  # noqa: E402
from repro_torch.core.placement.baselines import sigmate  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
    HAS_HYP = True
except ImportError:
    HAS_HYP = False


def _same_schedule(got, want):
    assert got.makespan == want.makespan
    assert got.events == want.events
    assert got.mean_utilization() == want.mean_utilization()
    for a, b in zip(got.utilization_waveform(50),
                    want.utilization_waveform(50)):
        np.testing.assert_array_equal(a, b)


# ---- tests/test_pipeline.py -----------------------------------------------------

@pytest.mark.parametrize("kind,args", [
    ("layerwise", ([1.0, 2.0, 1.5, 0.5], 16)),
    ("fpdeep", ([1.0, 2.0, 1.5, 0.5], 16)),
    ("layerwise", ([1.0, 2.0], 4, 2.0)),
    ("fpdeep", ([1.0, 3.0, 2.0], 8, 2.0, False)),
    ("fpdeep", ([1.0, 1.0], 4, 2.0, False)),
    ("one_f_one_b", (4, 8)), ("one_f_one_b", (3, 6, 1.0, 2.0)),
    ("one_f_one_b", (4, 8, 1.0, 2.0)), ("one_f_one_b", (3, 6)),
    ("layerwise", ([], 4)), ("fpdeep", ([], 4)),
    ("layerwise", ([0.0, 0.0], 3)),
    ("fpdeep", ([1.0, 1.0, 1.0], 8, 2.0, False)),
    ("fpdeep", ([1.0, 1.0, 1.0], 8, 2.0, True))])
def test_schedules_equal_the_reference(kind, args):
    _same_schedule(getattr(pipeline, kind)(*args),
                   getattr(r_pipe, kind)(*args))


def test_fpdeep_beats_layerwise_makespan():
    times = [1.0, 2.0, 1.5, 0.5]
    lw, fp = pipeline.layerwise(times, 16), pipeline.fpdeep(times, 16)
    assert fp.makespan < lw.makespan
    assert fp.mean_utilization() > lw.mean_utilization()


@pytest.mark.parametrize("times,m,expected", [
    ([1.0, 2.0], 4, 4 + 8 + 16 + 8),            # layerwise, bwd_ratio 2
    ([1.0, 3.0, 2.0], 8, 6.0 + 7 * 3.0)])       # fpdeep inference bound
def test_makespans_exact(times, m, expected):
    sch = (pipeline.layerwise(times, m, bwd_ratio=2.0) if len(times) == 2
           else pipeline.fpdeep(times, m, training=False))
    assert sch.makespan == pytest.approx(expected)


def test_fpdeep_respects_dependencies():
    fp = pipeline.fpdeep([1.0, 1.0], 4, training=False)
    start = {(s, u): t0 for (s, u, ph, t0, t1) in fp.events}
    end = {(s, u): t1 for (s, u, ph, t0, t1) in fp.events}
    for u in range(4):
        assert start[(1, u)] >= end[(0, u)] - 1e-9
    for u in range(3):
        assert start[(0, u + 1)] >= end[(0, u)] - 1e-9


def _phases(sch):
    start, end = {}, {}
    for (s, m, ph, t0, t1) in sch.events:
        start[(ph, s, m)] = t0
        end[(ph, s, m)] = t1
    return start, end


@pytest.mark.parametrize("prop", ["complete", "dependencies", "engines",
                                  "local_fwd"])
def test_one_f_one_b_properties(prop):
    """All microbatches run; stage and local-forward dependencies hold; one
    engine never runs two ops of one phase at once."""
    if prop == "complete":
        sch = pipeline.one_f_one_b(4, 8)
        for ph in ("fwd", "bwd"):
            assert len({(s, m) for (s, m, p, *_) in sch.events
                        if p == ph}) == 32
    elif prop == "dependencies":
        start, end = _phases(pipeline.one_f_one_b(3, 6, 1.0, 2.0))
        for m in range(6):
            for s in range(1, 3):
                assert start[("fwd", s, m)] >= end[("fwd", s - 1, m)] - 1e-9
            for s in range(2):
                assert start[("bwd", s, m)] >= end[("bwd", s + 1, m)] - 1e-9
    elif prop == "engines":
        by_stage: dict = {}
        for (s, m, ph, t0, t1) in pipeline.one_f_one_b(4, 8, 1.0,
                                                       2.0).events:
            by_stage.setdefault((s, ph), []).append((t0, t1))
        for spans in by_stage.values():
            spans.sort()
            for (a0, a1), (b0, b1) in zip(spans[:-1], spans[1:]):
                assert b0 >= a1 - 1e-9
    else:
        start, end = _phases(pipeline.one_f_one_b(3, 6))
        for (ph, s, m), t0 in start.items():
            if ph == "bwd":
                assert t0 >= end[("fwd", s, m)] - 1e-9


@pytest.mark.parametrize("times,n_units,bwd_ratio,training", [
    ([1.0], 1, 2.0, True), ([1.0, 1.0, 1.0], 4, 2.0, True),
    ([5.0, 0.1, 0.1], 8, 1.0, False),
    ([0.5, 2.5, 1.0, 1.0, 3.0], 16, 3.0, True), ([2.0, 2.0], 1, 2.0, False)])
def test_fpdeep_never_beaten_by_layerwise(times, n_units, bwd_ratio,
                                          training):
    lw = pipeline.layerwise(times, n_units, bwd_ratio, training)
    fp = pipeline.fpdeep(times, n_units, bwd_ratio, training)
    _same_schedule(fp, r_pipe.fpdeep(times, n_units, bwd_ratio, training))
    assert fp.makespan <= lw.makespan + 1e-9
    assert len(fp.events) == len(lw.events)


def test_utilization_at_zero_makespan_and_waveform_bounds():
    for sch in (pipeline.layerwise([], 4), pipeline.fpdeep([], 4),
                pipeline.layerwise([0.0, 0.0], 3)):
        assert sch.makespan == 0.0 and sch.mean_utilization() == 0.0
        t, u = sch.utilization_waveform(50)
        assert len(t) == len(u) == 50 and np.all(u == 0.0)
    t, u = pipeline.fpdeep([1.0, 1.0, 1.0], 8,
                           training=False).utilization_waveform(100)
    assert len(t) == len(u) == 100
    assert 0.0 <= u.min() and 0.9 < u.max() <= 1.0
    _, ut = pipeline.fpdeep([1.0, 1.0, 1.0], 8,
                            training=True).utilization_waveform(100)
    assert ut.max() <= 1.0


# ---- tests/test_noc.py ------------------------------------------------------------

if HAS_HYP:
    @given(st.integers(2, 8), st.integers(2, 8), st.integers(0, 63),
           st.integers(0, 63), st.booleans())
    @settings(max_examples=50, deadline=None)
    def test_hops_and_routes_equal_the_reference(rows, cols, a, b, torus):
        """Mesh hops are Manhattan, torus hops no more than the mesh's and
        within the half-perimeter; routes equal the reference's."""
        a, b = a % (rows * cols), b % (rows * cols)
        noc = NoC(rows, cols, torus=torus)
        assert noc.route(a, b) == r_NoC(rows, cols, torus=torus).route(a, b)
        assert len(noc.route(a, b)) == noc.hops(a, b)
        mesh = NoC(rows, cols, torus=False)
        (r0, c0), (r1, c1) = mesh.coord(a), mesh.coord(b)
        if torus:
            assert noc.hops(a, b) <= mesh.hops(a, b)
            assert noc.hops(a, b) <= rows // 2 + cols // 2 + 2
        else:
            assert noc.hops(a, b) == abs(r0 - r1) + abs(c0 - c1)


def test_route_is_contiguous():
    noc, ref = NoC(4, 4, torus=True), r_NoC(4, 4, torus=True)
    for a in range(16):
        for b in range(16):
            path = noc.route(a, b)
            assert path == ref.route(a, b)
            if not path:
                assert a == b
                continue
            assert path[0][0] == noc.coord(a)
            assert path[-1][1] == noc.coord(b)
            for (x, y), (x2, y2) in zip(path[:-1], path[1:]):
                assert y == x2


def _same_metrics(got, want):
    for f in ("comm_cost", "mean_hops", "latency", "throughput"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.link_traffic == want.link_traffic
    assert got.hop_hist == want.hop_hist


@pytest.mark.parametrize("case", ["comm_cost", "eq4", "chain", "latency"])
def test_metrics_equal_the_reference(case):
    """comm cost is the link traffic's and the hop histogram's sum; the
    Eq. 4 CDV counts each link twice; a chain along a row pays one hop an
    edge and the serpentine beats row-major; faster links cut latency."""
    if case == "comm_cost":
        g, rg = random_dag(12, seed=3), r_dag(12, seed=3)
        m = NoC(4, 4).evaluate(g, np.arange(12))
        _same_metrics(m, r_NoC(4, 4).evaluate(rg, np.arange(12)))
        assert m.comm_cost == pytest.approx(sum(m.link_traffic.values()))
        assert m.comm_cost == pytest.approx(
            sum(h * v for h, v in m.hop_hist.items()))
    elif case == "eq4":
        g, rg, pl = random_dag(10, seed=1), r_dag(10, seed=1), np.arange(10)
        cdv = NoC(4, 4).directional_cdv(g, pl)
        np.testing.assert_array_equal(cdv,
                                      r_NoC(4, 4).directional_cdv(rg, pl))
        cost = NoC(4, 4).evaluate(g, pl).comm_cost
        assert cdv.sum() == pytest.approx(2 * cost)
        assert NoC(4, 4).reward(g, pl) == pytest.approx(-cost)
        assert NoC(4, 4).reward(g, pl) == r_NoC(4, 4).reward(rg, pl)
    elif case == "chain":
        g, rg = chain_graph([100.0] * 7), r_chain([100.0] * 7)
        m = NoC(1, 8).evaluate(g, np.arange(8))
        _same_metrics(m, r_NoC(1, 8).evaluate(rg, np.arange(8)))
        assert m.mean_hops == pytest.approx(1.0)
        assert m.comm_cost == pytest.approx(700.0)
        noc2 = NoC(2, 4)
        order = sigmate(8, noc2)
        np.testing.assert_array_equal(order, r_sigmate(8, r_NoC(2, 4)))
        m_sig = noc2.evaluate(g, order)
        assert m_sig.mean_hops == pytest.approx(1.0)
        assert m_sig.comm_cost < noc2.evaluate(g, np.arange(8)).comm_cost
    else:
        g, rg = random_dag(8, seed=0, vol_scale=1e6), r_dag(8, seed=0,
                                                           vol_scale=1e6)
        slow = NoC(3, 3, link_bw=1e8).evaluate(g, np.arange(8))
        fast = NoC(3, 3, link_bw=1e10).evaluate(g, np.arange(8))
        _same_metrics(slow, r_NoC(3, 3, link_bw=1e8).evaluate(
            rg, np.arange(8)))
        _same_metrics(fast, r_NoC(3, 3, link_bw=1e10).evaluate(
            rg, np.arange(8)))
        assert fast.latency < slow.latency
        assert fast.throughput > slow.throughput


def test_placement_must_be_injective():
    with pytest.raises(ValueError):
        NoC(2, 2).evaluate(chain_graph([1.0]), np.array([0, 0]))


# ---- tests/test_topology.py: hierarchical topologies, fused scorers, GA ------

from repro.core import HierarchicalMesh as r_Hier  # noqa: E402
from repro.core import LogicalGraph as r_Graph  # noqa: E402
from repro.core import noc_batch as r_nb  # noqa: E402
from repro.core.placement import optimize_placement as r_opt  # noqa: E402
from repro.core.placement.population import (  # noqa: E402
    genetic_population as r_ga)
from repro.deploy import objective as r_obj  # noqa: E402
from repro_torch.core import GridTopology, HierarchicalMesh  # noqa: E402
from repro_torch.core import LogicalGraph, Topology  # noqa: E402
from repro_torch.core import noc_batch as p_nb  # noqa: E402
from repro_torch.core.placement import optimize_placement  # noqa: E402
from repro_torch.core.placement.population import (  # noqa: E402
    genetic_population)
from repro_torch.deploy import objective as p_obj  # noqa: E402

PKG = {"ref": (r_NoC, r_Hier, r_Graph, r_dag, r_nb, r_obj, r_opt, r_ga),
       "port": (NoC, HierarchicalMesh, LogicalGraph, random_dag, p_nb, p_obj,
                optimize_placement, genetic_population)}


def _int_graph(pkg, n, seed):
    _, _, graph_cls, dag, *_ = PKG[pkg]
    g = dag(n, seed=seed)
    return graph_cls(np.round(g.adj), g.compute, g.memory)


def _hier(pkg, **kw):
    kw.setdefault("interchip_bw", 2e8)
    kw.setdefault("link_bw", 1.6e9)
    kw.setdefault("core_flops", 2e9)
    kw.setdefault("hop_latency", 1e-8)
    return PKG[pkg][1](2, 2, 3, 3, **kw)


def _both(fn):
    """``fn(pkg)`` for the reference and the port."""
    return fn("ref"), fn("port")


def test_noc_is_a_topology_as_the_reference():
    noc = NoC(3, 4, torus=True)
    assert isinstance(noc, GridTopology) and isinstance(noc, Topology)
    assert noc.uniform_links and noc.interchip_mask() is None
    assert noc.link_bandwidth() is None and noc.link_energy_per_byte() is None
    assert noc.describe() == r_NoC(3, 4, torus=True).describe()
    for lid in range(noc.n_links):
        assert noc.link_id_of(noc.link_label(lid)) == lid


@pytest.mark.parametrize("torus", [False, True])
def test_perlink_evaluator_equals_the_reference(torus):
    """A uniform grid spelled as per-link arrays (the generic evaluator)
    against the scalar loop, in both packages, equal across them."""
    def run(pkg):
        noc_cls = PKG[pkg][0]
        grid_cls = noc_cls.__mro__[1]

        class Explicit(grid_cls):
            def link_bandwidth(self):
                return np.full(self.n_links, self.link_bw)

            def link_latency(self):
                return np.full(self.n_links, self.hop_latency)

            def cache_key(self):
                return ("explicit-uniform",) + super().cache_key()
        kw = dict(torus=torus, link_bw=8e9, core_flops=25.6e9,
                  hop_latency=2e-8)
        noc, exp = noc_cls(4, 4, **kw), Explicit(4, 4, **kw)
        g = _int_graph(pkg, 12, 3)
        rng = np.random.default_rng(0)
        out = []
        for _ in range(3):
            p = rng.permutation(16)[:12]
            ref, gen = noc.evaluate(g, p), exp.evaluate(g, p)
            assert gen.comm_cost == ref.comm_cost
            assert dict(gen.link_traffic) == dict(ref.link_traffic)
            mb = PKG[pkg][4].evaluate_batch(exp, g, p, backend="numpy")
            out.append((gen.comm_cost, gen.max_link, gen.hop_hist,
                        gen.latency, float(mb.comm_cost[0]),
                        float(mb.latency[0])))
        return out
    ref, port = _both(run)
    assert port == ref


def test_hier_structure_equals_the_reference():
    hm, rh = _hier("port"), _hier("ref")
    assert (hm.rows, hm.cols, hm.n_chips) == (rh.rows, rh.cols, rh.n_chips)
    assert not hm.uniform_links
    for s, d in [(0, 35), (7, 28), (20, 3), (14, 15)]:
        assert hm.route(s, d) == rh.route(s, d)
        assert hm.hops(s, d) == rh.hops(s, d)
    assert [hm.chip_of(i) for i in range(36)] == [rh.chip_of(i)
                                                  for i in range(36)]
    for name in ("interchip_mask", "link_bandwidth", "link_energy_per_byte",
                 "link_latency", "link_src_array", "link_dst_array"):
        np.testing.assert_array_equal(getattr(hm, name)(),
                                      getattr(rh, name)())


def test_hier_batched_equals_the_reference():
    def run(pkg):
        nb = PKG[pkg][4]
        hm, g = _hier(pkg), _int_graph(pkg, 30, 5)
        rng = np.random.default_rng(1)
        P = np.stack([rng.permutation(36)[:30] for _ in range(5)])
        mb = nb.evaluate_batch(hm, g, P, backend="numpy")
        cdv = nb.directional_cdv_batch(hm, g, P, backend="numpy")
        return (mb.comm_cost, mb.max_link, mb.latency, mb.core_traffic,
                np.asarray(cdv))
    ref, port = _both(run)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


def test_hier_torch_backend_matches_numpy():
    """The reference's jax/pallas backends' check on the port's torch
    backend (float32, CPU)."""
    hm, g = _hier("port"), _int_graph("port", 30, 5)
    rng = np.random.default_rng(2)
    P = np.stack([rng.permutation(36)[:30] for _ in range(4)])
    m_np = p_nb.evaluate_batch(hm, g, P, backend="numpy")
    m = p_nb.evaluate_batch(hm, g, P, backend="torch", device="cpu")
    for k in ("comm_cost", "max_link", "latency"):
        np.testing.assert_allclose(getattr(m, k), getattr(m_np, k),
                                   rtol=1e-5)
    np.testing.assert_allclose(m.core_traffic, m_np.core_traffic, rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_array_equal(m.max_hops, m_np.max_hops)


@pytest.mark.parametrize("spec", ["interchip", "energy"])
def test_link_objectives_equal_the_reference(spec):
    def run(pkg):
        nb, obj_mod = PKG[pkg][4], PKG[pkg][5]
        hm, g = _hier(pkg), _int_graph(pkg, 30, 5)
        rng = np.random.default_rng(3)
        P = np.stack([rng.permutation(36)[:30] for _ in range(4)])
        obj = obj_mod.as_objective(spec)
        m = nb.evaluate_batch(hm, g, P, backend="numpy")
        flat = PKG[pkg][0](6, 6)
        return (obj.from_batch(m, hm),
                [obj.from_metrics(hm.evaluate(g, p), hm) for p in P],
                obj.from_batch(nb.evaluate_batch(flat, g, P,
                                                 backend="numpy"), flat))
    ref, port = _both(run)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    if spec == "interchip":
        assert np.all(port[2] == 0.0)


def test_fused_scorer_matches_the_batch_path():
    """The reference's jax/pallas fused-scorer check on the port's torch
    backend; the batch path equal to the reference's."""
    specs = ["max_link", "energy", "latency", "mean_hops",
             {"comm_cost": 1.0, "energy": 2e9},
             {"max_link": 2.0, "interchip": 0.5}]
    for topo_of in (lambda pkg: PKG[pkg][0](4, 4, torus=True), _hier):
        topo, rtopo = topo_of("port"), topo_of("ref")
        n = topo.n_cores - 2
        g, rg = _int_graph("port", n, 7), _int_graph("ref", n, 7)
        rng = np.random.default_rng(5)
        P = np.stack([rng.permutation(topo.n_cores)[:n] for _ in range(6)])
        for spec in specs:
            full = p_obj.objective_scorer(topo, g, spec, backend="batch")(P)
            np.testing.assert_array_equal(
                full, r_obj.objective_scorer(rtopo, rg, spec,
                                             backend="batch")(P))
            for fused in (True, False):
                got = p_obj.objective_scorer(topo, g, spec, backend="torch",
                                             fused=fused, device="cpu")(P)
                np.testing.assert_allclose(got, full, rtol=2e-5)


def test_fused_scorer_rejects_what_the_reference_rejects():
    b, g = p_nb.batched_noc(NoC(3, 3)), _int_graph("port", 6, 0)
    with pytest.raises(ValueError, match="fused scorer"):
        b.make_fused_scorer(g, (("hops_cubed", 1.0),), device="cpu")
    with pytest.raises(ValueError):
        b.make_fused_scorer(g, (("max_link", 1.0),), backend="batch")


def test_genetic_snapshot_equals_the_reference():
    def run(pkg):
        noc_cls, _, _, dag, *_, opt, _ = PKG[pkg]
        kw = {"device": "cpu"} if pkg == "port" else {}
        r = opt(dag(12, seed=3), noc_cls(4, 4), method="genetic", seed=0,
                budget=320, pop_size=16, **kw)
        return r.placement.tolist(), r.comm_cost
    ref, port = _both(run)
    assert port == ref == ([8, 0, 2, 3, 7, 6, 5, 4, 1, 9, 10, 11],
                           25809.015070443573)


def test_genetic_population_equals_the_reference():
    def run(pkg):
        ga = PKG[pkg][7]
        kw = {"device": "cpu"} if pkg == "port" else {}
        g, noc = _int_graph(pkg, 14, 4), PKG[pkg][0](4, 4)
        best = ga(g, noc, generations=30, pop_size=16, seed=0, **kw)
        again = ga(g, noc, generations=30, pop_size=16, seed=0, **kw)
        np.testing.assert_array_equal(best, again)
        return best, noc.evaluate(g, best).comm_cost
    ref, port = _both(run)
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1] == ref[1]
    assert np.unique(port[0]).size == 14


@pytest.mark.parametrize("objective", ["comm_cost",
                                       {"comm_cost": 1.0, "interchip": 2.0}])
def test_genetic_on_hier_equals_the_reference(objective):
    """GA against random search on the hierarchical mesh (the reference's
    acceptance case) and its objective plumbing, seed for seed."""
    def run(pkg):
        opt = PKG[pkg][6]
        kw = {"device": "cpu"} if pkg == "port" else {}
        hm, g = _hier(pkg), _int_graph(pkg, 30, 5)
        if objective == "comm_cost":
            rs = opt(g, hm, method="random_search", budget=2000, seed=0, **kw)
            ga = opt(g, hm, method="genetic", budget=2000, seed=0,
                     pop_size=40, **kw)
            return [(r.placement.tolist(), r.comm_cost) for r in (rs, ga)]
        r = opt(g, hm, method="genetic", budget=500, seed=0, pop_size=10,
                objective=objective, **kw)
        return [(r.placement.tolist(), r.objective, r.objective_cost)]
    ref, port = _both(run)
    assert port == ref
    if objective == "comm_cost":
        assert port[1][1] < port[0][1]


def test_genetic_rejects_bad_inputs_as_the_reference():
    g, noc = _int_graph("port", 4, 0), NoC(2, 3)
    with pytest.raises(ValueError, match="pop_size"):
        genetic_population(g, noc, generations=2, pop_size=1, device="cpu")
    with pytest.raises(ValueError):
        genetic_population(g, noc, generations=2, pop_size=4,
                           init=[0, 0, 1, 2], device="cpu")


@pytest.mark.parametrize("method,kw", [
    ("zigzag", {}), ("sigmate", {}), ("simulated_annealing", {"budget": 200}),
    ("population_simulated_annealing", {"budget": 200, "pop_size": 4})])
def test_methods_on_hier_equal_the_reference(method, kw):
    def run(pkg):
        hier_cls, opt = PKG[pkg][1], PKG[pkg][6]
        extra = {"device": "cpu"} if pkg == "port" else {}
        hm = hier_cls(2, 2, 2, 2, interchip_bw=2e8, link_bw=1.6e9)
        r = opt(_int_graph(pkg, 12, 8), hm, method=method, seed=0, **kw,
                **extra)
        return r.placement.tolist(), r.comm_cost
    ref, port = _both(run)
    assert port == ref and port[1] > 0


def test_core_comm_time_equals_the_reference():
    def run(pkg):
        noc_cls, hier_cls = PKG[pkg][:2]
        g, p = _int_graph(pkg, 12, 3), np.arange(12)
        noc = noc_cls(4, 4, link_bw=8e9)
        hm = hier_cls(2, 2, 2, 2, interchip_bw=1e8, link_bw=8e9)
        return (noc.core_comm_time(noc.evaluate(g, p)),
                hm.core_comm_time(hm.evaluate(g, p)))
    ref, port = _both(run)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


# ---- tests/test_copartition.py: chip-aware partitioning, the loop, the CLI ---

from repro.core import LayerProfile as r_Layer  # noqa: E402
from repro.core import partition_model as r_partition  # noqa: E402
from repro.core.placement import chip_init as r_chip_init  # noqa: E402
from repro.deploy import deploy_model as r_deploy  # noqa: E402
from repro.deploy.engine import (  # noqa: E402
    resolve_partition_strategy as r_resolve)
from repro.snn import profile_model as r_profile  # noqa: E402
from repro.snn import spike_resnet18 as r_rn18  # noqa: E402
from repro.snn import spike_resnet50 as r_rn50  # noqa: E402
from repro_torch.core import CHIP_STRATEGIES, LayerProfile  # noqa: E402
from repro_torch.core import partition_model  # noqa: E402
from repro_torch.core.placement import chip_init  # noqa: E402
from repro_torch.deploy import deploy_model  # noqa: E402
from repro_torch.deploy.engine import resolve_partition_strategy  # noqa: E402
from repro_torch.deploy.objective import (  # noqa: E402
    partition_interchip_bytes)
from repro_torch.snn import profile_model, spike_resnet18  # noqa: E402
from repro_torch.snn import spike_resnet50  # noqa: E402

CO = {"ref": dict(hier=r_Hier, noc=r_NoC, part=r_partition, prof=r_profile,
                  rn18=r_rn18, rn50=r_rn50, layer=r_Layer, deploy=r_deploy,
                  chip_init=r_chip_init, opt=r_opt, kw={}),
      "port": dict(hier=HierarchicalMesh, noc=NoC, part=partition_model,
                   prof=profile_model, rn18=spike_resnet18,
                   rn50=spike_resnet50, layer=LayerProfile,
                   deploy=deploy_model, chip_init=chip_init,
                   opt=optimize_placement, kw={"device": "cpu"})}


def _hm(pkg, cr=2, cc=2, kr=2, kc=2):
    return CO[pkg]["hier"](cr, cc, kr, kc, link_bw=8e9, core_flops=25.6e9,
                           hop_latency=2e-8)


def _prof(pkg, model="rn18"):
    return CO[pkg]["prof"](CO[pkg][model](n_classes=10, in_res=32, T=4),
                           batch=8, training=True)


def _slices(part):
    return ([(s.layer, s.name, s.frac, s.flops, s.weight_bytes, s.out_bytes)
             for s in part.slices],
            None if part.chip_of is None else part.chip_of.tolist(),
            part.strategy)


@pytest.mark.parametrize("strategy,grid,model", [
    ("chip", (2, 2, 4, 4), "rn18"), ("chip_balanced", (2, 2, 4, 4), "rn18"),
    ("chip", (2, 2, 2, 2), "rn50"), ("balanced", None, "rn18")])
def test_chip_partitions_equal_the_reference(strategy, grid, model):
    assert set(CHIP_STRATEGIES) == {"chip", "chip_balanced"}

    def run(pkg):
        if grid is None:
            return _slices(CO[pkg]["part"](_prof(pkg, model), 16, strategy))
        hm = _hm(pkg, *grid)
        p = CO[pkg]["part"](_prof(pkg, model), hm.n_cores, strategy,
                            topology=hm)
        assert (np.bincount(p.chip_of, minlength=hm.n_chips)
                <= hm.chip_capacities()).all()
        return _slices(p) + (p.interchip_bytes(), p.chip_loads().tolist())
    ref, port = _both(run)
    assert port == ref


def test_interchip_tagging_equals_the_reference():
    def run(pkg):
        hm = _hm(pkg, 2, 2, 4, 4)
        g = CO[pkg]["part"](_prof(pkg), hm.n_cores, "chip",
                            topology=hm).to_graph()
        return (g.chip_of.tolist(), g.chip_cut_mask().tolist(),
                g.chip_cut_bytes(), sorted(g.edges))
    ref, port = _both(run)
    assert port == ref
    hm = _hm("port", 2, 2, 4, 4)
    g = partition_model(_prof("port"), hm.n_cores, "chip",
                        topology=hm).to_graph()
    assert partition_interchip_bytes(g) == port[2]
    flat = partition_model(_prof("port"), 16, "balanced").to_graph()
    assert flat.chip_of is None and flat.chip_cut_bytes() == 0.0


def test_cut_weights_and_single_chip_equal_the_reference():
    def run(pkg):
        c = CO[pkg]
        hm = c["hier"](1, 2, 2, 2)
        layers = [c["layer"](f"l{i}", flops=1e9, weight_bytes=1e5,
                             out_bytes=1e3, c_out=64) for i in range(6)]
        base = c["part"](layers, hm.n_cores, "chip", topology=hm)
        w = np.ones(6)
        w[max(s.layer for i, s in enumerate(base.slices)
              if base.chip_of[i] == 0)] = 1e6
        moved = c["part"](layers, hm.n_cores, "chip", topology=hm,
                          cut_weights=w)
        single = c["part"](_prof(pkg), 16, "chip", topology=c["noc"](4, 4))
        return [(_slices(p), max(s.layer for i, s in enumerate(p.slices)
                                 if p.chip_of[i] == 0))
                for p in (base, moved, single)]
    ref, port = _both(run)
    assert port == ref
    assert port[0][1] != port[1][1]        # the boundary moved
    for bad, match in [(dict(n=16), "needs topology"),
                       (dict(n=32, topology=_hm("port")), "cores"),
                       (dict(n=16, strategy="bogus"), "unknown strategy")]:
        with pytest.raises(ValueError, match=match):
            partition_model(_prof("port"), bad.pop("n"),
                            bad.pop("strategy", "chip"), **bad)


def test_flat_deploys_equal_the_reference_snapshots():
    def run(pkg):
        c = CO[pkg]
        cfg = c["rn18"](n_classes=10, in_res=32, T=4)
        a = c["deploy"](cfg, c["noc"](4, 4), method="simulated_annealing",
                        budget=200, seed=0, schedule="fpdeep", n_units=4,
                        **c["kw"])
        b = c["deploy"](cfg, c["noc"](4, 4, torus=True),
                        method="random_search", budget=100, seed=0,
                        schedule="layerwise", n_units=4, **c["kw"])
        return [(p.placement.placement.tolist(), p.placement.comm_cost,
                 p.schedule.makespan, p.partition.strategy) for p in (a, b)]
    ref, port = _both(run)
    assert port == ref
    assert port[0][1] == 3864576.0 and port[1][1] == 4386816.0


def test_auto_strategy_and_chip_seeding_equal_the_reference():
    assert resolve_partition_strategy("auto", NoC(4, 4)) == r_resolve(
        "auto", r_NoC(4, 4)) == "balanced"
    assert resolve_partition_strategy("auto", _hm("port")) == "chip"
    assert resolve_partition_strategy("storage", _hm("port")) == "storage"

    def run(pkg):
        c = CO[pkg]
        hm = _hm(pkg)
        plan = c["deploy"](c["rn18"](n_classes=10, in_res=32, T=4), hm,
                           method="zigzag", schedule="none", **c["kw"])
        g = c["part"](_prof(pkg), hm.n_cores, "chip", topology=hm).to_graph()
        init = c["chip_init"](g, hm)
        found = []
        for method in ("simulated_annealing", "random_search", "genetic"):
            kw = {"pop_size": 8} if method == "genetic" else {}
            r = c["opt"](g, hm, method=method, budget=32, seed=0, **kw,
                         **c["kw"])
            found.append((r.placement.tolist(), r.objective_cost))
        return (plan.partition.strategy, plan.report()["partition"],
                init.tolist(), hm.evaluate(g, init).comm_cost, found)
    ref, port = _both(run)
    assert port == ref
    assert all(cost <= port[3] + 1e-9 for _, cost in port[4])


def test_copartition_loop_equals_the_reference():
    def run(pkg):
        c = CO[pkg]
        cfg = c["rn18"](n_classes=10, in_res=32, T=4)
        loop = c["deploy"](cfg, _hm(pkg), method="genetic", budget=160,
                           pop_size=8, seed=0, schedule="fpdeep", n_units=4,
                           copartition_iters=2, **c["kw"])
        flat = c["deploy"](cfg, c["noc"](4, 4), method="zigzag",
                           schedule="none", copartition_iters=3, **c["kw"])
        return (loop.copartition_iters, loop.placement.placement.tolist(),
                loop.placement.objective_cost, flat.copartition_iters)
    ref, port = _both(run)
    assert port == ref and port[3] == 0


def test_cli_partition_chip_roundtrip_equals_the_reference(tmp_path, capsys):
    from repro.deploy.cli import main as r_main
    from repro_torch.deploy.cli import main as p_main
    args = [["--models", "spike_resnet18", "--methods", "zigzag",
             "--objectives", "comm_cost", "--topology",
             "hier:2x2:2x2,ibw=1e9", "--partition", "chip",
             "--copartition-iters", "1", "--schedule", "none"],
            ["--models", "spike_resnet18", "--methods", "zigzag",
             "--objectives", "comm_cost", "--cores", "16", "--strategy",
             "chip_balanced", "--schedule", "none"]]
    for a in args:
        reps = {}
        for who, main, extra in (("ref", r_main, []),
                                 ("port", p_main, ["--device", "cpu"])):
            path = tmp_path / f"{who}.json"
            assert main(a + ["--json", str(path)] + extra) == 0
            capsys.readouterr()
            with open(path) as f:
                (reps[who],) = json.load(f)
        assert reps["port"]["partition"] == reps["ref"]["partition"]
        for key in ("method", "objective", "objective_cost", "comm_cost",
                    "mean_hops", "max_link", "latency_s"):
            assert reps["port"]["placement"][key] == \
                reps["ref"]["placement"][key], key
