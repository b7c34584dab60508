"""Port parity: the host searches (``baselines``, ``population``) and the
multilevel V-cycle of ``repro_torch.core.placement``, against the JAX
package on the CPU.

These draw from numpy RNG and score through the numpy float64 backend
(``backend="batch"``), so every grade here is exact, seed for seed, on
integer-volume graphs: the live reference's placements, and the values of the
seven passing ``SNAPSHOTS`` rows of ``tests/test_deploy.py`` through the
port's ``optimize_placement``. ``multilevel_placement(backend="device")`` is
held to invariants.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402,F401  (reference side; stays on the CPU)

from repro.core import graph as r_graph  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.core.placement import baselines as r_bl  # noqa: E402
from repro.core.placement import multilevel as r_ml  # noqa: E402
from repro.core.placement import population as r_pop  # noqa: E402

from repro_torch.core import graph as p_graph  # noqa: E402
from repro_torch.core import topology as p_topology  # noqa: E402
from repro_torch.core.placement import baselines as p_bl  # noqa: E402
from repro_torch.core.placement import multilevel as p_ml  # noqa: E402
from repro_torch.core.placement import optimize_placement  # noqa: E402
from repro_torch.core.placement import population as p_pop  # noqa: E402
from repro_torch.obs import Recorder  # noqa: E402
from test_deploy import SNAPSHOTS, _SNAPSHOT_CASES  # noqa: E402

CPU = "cpu"


def _graphs(n, seed, p=0.3):
    g = r_graph.random_dag(n, p=p, seed=seed)
    adj = np.round(g.adj)
    return (r_graph.LogicalGraph(adj, g.compute, g.memory),
            p_graph.LogicalGraph(adj, g.compute, g.memory))


def _topos(spec, nodes=()):
    ref, port = (r_topology.parse_topology(spec),
                 p_topology.parse_topology(spec))
    if nodes:
        ref = r_topology.degrade(ref, nodes=nodes)
        port = p_topology.degrade(port, nodes=nodes)
    return ref, port


# (search name, reference fn, port fn, kwargs)
HOST_SEARCHES = [
    ("random_search", r_bl.random_search, p_bl.random_search,
     dict(iters=80, seed=2)),
    ("random_search_init", r_bl.random_search, p_bl.random_search,
     dict(iters=40, seed=1, init=np.arange(14)[::-1].copy())),
    ("simulated_annealing", r_bl.simulated_annealing,
     p_bl.simulated_annealing, dict(iters=300, seed=4)),
    ("simulated_annealing_decay", r_bl.simulated_annealing,
     p_bl.simulated_annealing,
     dict(iters=300, seed=5, decay_on_degenerate=True)),
    ("random_search_population", r_pop.random_search_population,
     p_pop.random_search_population, dict(iters=70, pop_size=16, seed=3)),
    ("simulated_annealing_population", r_pop.simulated_annealing_population,
     p_pop.simulated_annealing_population,
     dict(iters=40, pop_size=8, seed=6)),
    ("genetic_population", r_pop.genetic_population, p_pop.genetic_population,
     dict(generations=12, pop_size=12, seed=7)),
]


@pytest.mark.parametrize("name,ref_fn,port_fn,kw", HOST_SEARCHES,
                         ids=[c[0] for c in HOST_SEARCHES])
@pytest.mark.parametrize("spec,nodes", [("mesh:4x5", ()),
                                        ("torus:4x5", (6,))])
def test_host_search_exact(name, ref_fn, port_fn, kw, spec, nodes):
    """Same seed, same placement, and the same recorder trajectory."""
    r_noc, p_noc = _topos(spec, nodes)
    rg, pg = _graphs(14, seed=11)
    if "init" in kw and nodes:
        kw = dict(kw, init=np.asarray(p_bl.zigzag(14, p_noc)[::-1]))
    r_rec, p_rec = Recorder(), Recorder()
    want = ref_fn(rg, r_noc, backend="batch", recorder=r_rec, **kw)
    got = port_fn(pg, p_noc, backend="batch", recorder=p_rec, device=CPU,
                  **kw)
    np.testing.assert_array_equal(got, want)
    assert [(e["name"], e["attrs"]) for e in p_rec.events] == \
        [(e["name"], e["attrs"]) for e in r_rec.events]
    assert p_rec.counters == r_rec.counters


@pytest.mark.parametrize("name,ref_fn,port_fn,kw", HOST_SEARCHES,
                         ids=[c[0] for c in HOST_SEARCHES])
def test_host_search_default_backend_on_cpu_is_batch(name, ref_fn, port_fn,
                                                     kw):
    """``backend`` left out on ``device="cpu"`` scores with ``"batch"``: the
    reference's placement, seed for seed."""
    r_noc, p_noc = _topos("mesh:4x5")
    rg, pg = _graphs(14, seed=11)
    np.testing.assert_array_equal(port_fn(pg, p_noc, device=CPU, **kw),
                                  ref_fn(rg, r_noc, backend="batch", **kw))


class _Scored(Exception):
    pass


@pytest.mark.parametrize("port_fn", [p_bl.random_search,
                                     p_bl.simulated_annealing,
                                     p_pop.random_search_population,
                                     p_pop.simulated_annealing_population,
                                     p_pop.genetic_population])
def test_host_search_default_backend_on_the_card_is_cuda(port_fn,
                                                         monkeypatch):
    """``backend`` and ``device`` left out: the scorer is asked for
    ``"cuda"`` on the card when one is present, and without one the call
    raises instead of running on the CPU."""
    asked = []

    def fake_scorer(noc, graph, backend, objective, recorder=None,
                    device=None):
        asked.append((backend, device))
        raise _Scored

    monkeypatch.setattr(p_bl, "make_scorer", fake_scorer)
    monkeypatch.setattr(p_pop, "make_scorer", fake_scorer)
    _, p_noc = _topos("mesh:4x5")
    _, pg = _graphs(14, seed=11)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_fn(pg, p_noc)
    assert asked == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(_Scored):
        port_fn(pg, p_noc)
    with pytest.raises(_Scored):
        port_fn(pg, p_noc, backend="torch", device=CPU)
    assert asked == [("cuda", None), ("torch", CPU)]


@pytest.mark.parametrize("spec,nodes", [("mesh:4x5", ()), ("torus:3x5", ()),
                                        ("mesh:4x5", (2, 7))])
def test_greedy_exact(spec, nodes):
    r_noc, p_noc = _topos(spec, nodes)
    rg, pg = _graphs(12, seed=3)
    want = r_bl.greedy(rg, r_noc)
    np.testing.assert_array_equal(p_bl.greedy(pg, p_noc), want)
    np.testing.assert_array_equal(p_bl._greedy_reference(pg, p_noc),
                                  r_bl._greedy_reference(rg, r_noc))
    np.testing.assert_array_equal(p_bl._greedy_reference(pg, p_noc), want)


def test_ox_crossover_exact():
    for seed in range(20):
        rng_r, rng_p = (np.random.default_rng(seed) for _ in range(2))
        p1 = np.random.default_rng(seed + 100).permutation(16)
        p2 = np.random.default_rng(seed + 200).permutation(16)
        np.testing.assert_array_equal(p_pop._ox_crossover(rng_p, p1, p2),
                                      r_pop._ox_crossover(rng_r, p1, p2))


SNAPSHOT_ROWS = ["zigzag", "sigmate", "greedy", "random_search",
                 "simulated_annealing", "population_random_search",
                 "population_simulated_annealing"]


@pytest.mark.parametrize("method", SNAPSHOT_ROWS)
def test_snapshot_rows_through_port_optimizer(method):
    """The seven rows that pass on the reference, through the port's
    ``optimize_placement`` on the CPU (``backend=None`` -> ``"batch"``)."""
    g = p_graph.random_dag(12, seed=3)
    noc = p_topology.parse_topology("mesh:4x4")
    r = optimize_placement(g, noc, method=method, seed=0,
                           objective="comm_cost", device=CPU,
                           **_SNAPSHOT_CASES[method])
    placement, comm_cost, _ = SNAPSHOTS[method]
    assert r.placement.tolist() == placement
    assert r.comm_cost == comm_cost
    assert r.objective == "comm_cost" and r.objective_cost == r.comm_cost


@pytest.mark.parametrize("method,kw", [
    ("rs", dict(budget=50)), ("genetic", dict(budget=200, pop_size=8)),
    ("sa", dict(budget=100, objective="max_link")),
    ("population_simulated_annealing", dict(budget=80, pop_size=4))])
def test_optimizer_host_methods_match_reference(method, kw):
    from repro.core.placement import optimize_placement as r_opt
    r_noc, p_noc = _topos("hier:2x2:2x2")
    rg, pg = _graphs(14, seed=9)
    want = r_opt(rg, r_noc, method=method, seed=1, **kw)
    got = optimize_placement(pg, p_noc, method=method, seed=1, device=CPU,
                             **kw)
    np.testing.assert_array_equal(got.placement, want.placement)
    assert got.summary() | {"wall_time_s": 0} == \
        want.summary() | {"wall_time_s": 0}


# ---------------------------------------------------------------------------
# Multilevel
# ---------------------------------------------------------------------------

def _layered(n_layers=16, width=16):
    """A ~256-node layered DAG with shuffled ids (integer volumes), as the
    reference's multilevel benchmark shuffles its headline graph."""
    g = r_graph.layered_dag(n_layers, width, seed=0)
    perm = np.random.default_rng(1).permutation(g.n)
    adj = np.round(g.adj[np.ix_(perm, perm)])
    args = (adj, g.compute[perm], g.memory[perm])
    return r_graph.LogicalGraph(*args), p_graph.LogicalGraph(*args)


def test_coarsening_exact():
    rg, pg = _layered()
    np.testing.assert_array_equal(p_ml.heavy_edge_matching(pg),
                                  r_ml.heavy_edge_matching(rg))
    r_lv, p_lv = r_ml.coarsen(rg, 16), p_ml.coarsen(pg, 16)
    assert len(p_lv) == len(r_lv) >= 3
    for a, b in zip(p_lv, r_lv):
        assert a.fine_n == b.fine_n and a.ratio == b.ratio
        np.testing.assert_array_equal(a.node_map, b.node_map)
        for f in ("adj", "compute", "memory"):
            np.testing.assert_array_equal(getattr(a.graph, f),
                                          getattr(b.graph, f))


def test_project_and_refine_exact():
    rg, pg = _layered()
    lv_r, lv_p = r_ml.coarsen(rg, 64), p_ml.coarsen(pg, 64)
    coarse_n = lv_p[0].graph.n
    grid = p_ml._pick_grid(p_ml._grid_sequence(16, 16), coarse_n)
    assert grid == r_ml._pick_grid(r_ml._grid_sequence(16, 16), coarse_n)
    parent = np.random.default_rng(2).permutation(grid[0] * grid[1])[
        :coarse_n]
    args = (parent, lv_p[0].node_map, grid, (16, 16), (16, 16))
    proj = p_ml.project_placement(*args)
    np.testing.assert_array_equal(proj, r_ml.project_placement(*args))
    assert np.unique(proj).size == proj.size
    for torus in (False, True):
        got = p_ml.refine_placement(pg, (16, 16), torus, proj, 3,
                                    np.random.default_rng(5))
        want = r_ml.refine_placement(rg, (16, 16), torus, proj, 3,
                                     np.random.default_rng(5))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] and got[2] < got[1]
    assert p_ml.grid_comm_cost(pg, p_topology.parse_topology("mesh:16x16"),
                               proj) == \
        r_ml.grid_comm_cost(rg, r_topology.parse_topology("mesh:16x16"), proj)


@pytest.mark.parametrize("coarse_method", ["sa", "greedy"])
def test_multilevel_placement_exact(coarse_method):
    rg, pg = _layered()
    kw = dict(coarsen_to=32, refine_iters=2, coarse_method=coarse_method,
              seed=3, backend="batch")
    if coarse_method == "sa":
        kw["iters"] = 300
    r_rec, p_rec = Recorder(), Recorder()
    want = r_ml.multilevel_placement(rg, r_topology.parse_topology(
        "mesh:16x16"), recorder=r_rec, **kw)
    got = p_ml.multilevel_placement(pg, p_topology.parse_topology(
        "mesh:16x16"), recorder=p_rec, device=CPU, **kw)
    np.testing.assert_array_equal(got, want)
    strip = lambda rec: [(e["name"], {k: v for k, v in e["attrs"].items()  # noqa: E731
                                      if k != "wall_s"})
                         for e in rec.events if e["kind"] == "event"]
    assert strip(p_rec) == strip(r_rec)


def test_multilevel_device_backend_valid():
    _, pg = _layered()
    noc = p_topology.parse_topology("mesh:16x16")
    r = optimize_placement(pg, noc, method="multilevel", backend="device",
                           coarsen_to=32, refine_iters=2, iters=300,
                           restarts=2, device=CPU)
    assert r.method == "multilevel"
    assert np.unique(r.placement).size == pg.n
    assert r.placement.min() >= 0 and r.placement.max() < noc.n_cores
    assert r.comm_cost == p_ml.grid_comm_cost(pg, noc, r.placement)
    zig = p_ml.grid_comm_cost(pg, noc, np.arange(pg.n))
    assert r.comm_cost < zig
