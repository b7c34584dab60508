"""The reference's ``tests/test_pipeline.py`` and ``tests/test_noc.py`` held
on the port's ``repro_torch.core``, exactly: every schedule's events and
makespan, and every NoC route, hop count and metric, equal the reference's
on the same inputs, and the reference's properties hold on the port.
"""
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
