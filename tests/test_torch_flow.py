"""Port parity of ``obs/flow.py`` and the recorder's timing helpers against
the JAX package's (``tests/test_obs.py``): every ``FlowReport`` field exact
on integer-volume graphs over a flat mesh, a hierarchical mesh and a
degraded mesh, and equal to ``Topology.evaluate``."""
import os

import numpy as np
import pytest

pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.core import graph as r_graph  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.obs import flow as r_flow  # noqa: E402
from repro.obs import recorder as r_recorder  # noqa: E402

from repro_torch.core import graph as p_graph  # noqa: E402
from repro_torch.core import topology as p_topology  # noqa: E402
from repro_torch.core.placement import optimize_placement  # noqa: E402
from repro_torch.obs import (ascii_heatmap, bench_percentiles,  # noqa: E402
                             bench_time, cov, flow_report, gini, percentiles,
                             timed)

CASES = {
    "mesh": ("mesh:4x4", (), (), 16),
    "hier": ("hier:2x2:4x4", (), (), 40),
    "degraded": ("mesh:4x4", (3, 17), (5,), 12),
}


def _case(name, seed=0):
    spec, links, nodes, n = CASES[name]
    g = r_graph.random_dag(n, p=0.25, seed=seed)
    adj = np.round(g.adj)
    ref_topo = r_topology.degrade(r_topology.parse_topology(spec),
                                  links=links, nodes=nodes)
    port_topo = p_topology.degrade(p_topology.parse_topology(spec),
                                   links=links, nodes=nodes)
    alive = [c for c in range(ref_topo.n_cores) if c not in nodes]
    placement = np.random.default_rng(seed + 1).permutation(alive)[:n]
    return (ref_topo, r_graph.LogicalGraph(adj, g.compute, g.memory),
            port_topo, p_graph.LogicalGraph(adj, g.compute, g.memory),
            placement)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("top_k", [3, 10])
def test_flow_report_exact(name, top_k):
    ref_topo, rg, port_topo, pg, placement = _case(name)
    want = r_flow.flow_report(ref_topo, rg, placement, top_k=top_k)
    got = flow_report(port_topo, pg, placement, top_k=top_k)
    assert got.to_dict() == want.to_dict()
    np.testing.assert_array_equal(got.link_loads, want.link_loads)
    np.testing.assert_array_equal(got.core_traffic, want.core_traffic)
    assert got.render(top_k=top_k) == want.render(top_k=top_k)
    assert got.render(max_heatmap_cells=4) == \
        want.render(max_heatmap_cells=4)
    m = port_topo.evaluate(pg, placement)
    assert got.byte_hops == m.comm_cost == float(got.link_loads.sum())
    assert got.max_link == m.max_link == got.top_links[0]["bytes"]
    if name == "hier":
        assert got.interchip_bytes == \
            port_topo.interchip_bytes(m.link_traffic) > 0


def test_flow_report_accepts_placement_result():
    _, _, topo, graph, _ = _case("mesh")
    res = optimize_placement(graph, topo, method="zigzag", device="cpu")
    assert flow_report(topo, graph, res).byte_hops == \
        flow_report(topo, graph, res.placement).byte_hops


def test_indices_and_heatmap_match_reference():
    rng = np.random.default_rng(0)
    for x in ([1.0, 1.0, 1.0], [0.0, 0.0, 10.0], [], rng.random(50)):
        assert gini(x) == r_flow.gini(x)
        assert cov(x) == r_flow.cov(x)
    grid = rng.random((4, 6))
    assert ascii_heatmap(grid, width=3) == r_flow.ascii_heatmap(grid, width=3)
    with pytest.raises(ValueError, match="2-D"):
        ascii_heatmap(np.zeros(3))


def test_timing_helpers():
    calls = []
    assert bench_time(lambda: calls.append(1), repeats=3) >= 0
    out, us = timed(lambda a, b=0: a + b, 2, b=3)
    assert out == 5 and us >= 0
    st = bench_percentiles(lambda: calls.append(1), repeats=7, warmup=2)
    assert st["n"] == 7 and set(st) == {"n", "min", "max", "mean", "p50",
                                         "p99"}
    assert st["min"] <= st["p50"] <= st["p99"] <= st["max"]
    assert len(calls) == 3 + 9
    xs = np.random.default_rng(3).random(31).tolist()
    assert percentiles(xs, qs=(50, 90, 99)) == \
        r_recorder.percentiles(xs, qs=(50, 90, 99))
