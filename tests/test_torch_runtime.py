"""Port parity of the online re-placement runtime (``deploy/runtime.py``)
against the JAX package's (``tests/test_runtime.py``,
``tests/test_degraded.py``). On the CPU the searches score through numpy
float64 and draw from seeded numpy streams, so every control decision, and
the whole ``ScenarioResult``, equals the reference's step for step: the
link-drop, drift and node-drop scenarios of ``benchmarks/fault_replace.py``
at its smoke size, and the unit scenarios of the reference's tests."""
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.core import graph as r_graph  # noqa: E402
from repro.core import topology as r_topology  # noqa: E402
from repro.deploy import runtime as r_runtime  # noqa: E402
from repro.snn import spike_resnet18 as r_resnet18  # noqa: E402

from repro_torch.core import graph as p_graph  # noqa: E402
from repro_torch.core import topology as p_topology  # noqa: E402
from repro_torch.core.noc import NoC  # noqa: E402
from repro_torch.core.placement import optimize_placement  # noqa: E402
from repro_torch.deploy import deploy_model, runtime as p_runtime  # noqa: E402
from repro_torch.obs import Recorder  # noqa: E402
from repro_torch.snn import spike_resnet18 as p_resnet18  # noqa: E402

# benchmarks/fault_replace.py's operating point at its smoke size
THRESHOLD, MIGRATION_WEIGHT, WARM_T0, DEPLOY_FACTOR = 0.02, 0.12, 0.005, 16
SMOKE_BUDGET, DEAD_CORE = 512, 5


def _hier(topology):
    return topology.HierarchicalMesh(2, 2, 2, 2, link_bw=8e9,
                                     core_flops=25.6e9, hop_latency=2e-8)


def _both(scenario, spec="hier", **kw):
    """The same run_scenario call through both packages: (ref, port)."""
    out = []
    for runtime, topology, resnet18, extra in (
            (r_runtime, r_topology, r_resnet18, {}),
            (p_runtime, p_topology, p_resnet18, {"device": "cpu"})):
        noc = (_hier(topology) if spec == "hier"
               else topology.parse_topology(spec))
        if kw.get("pre_links"):
            noc = topology.degrade(noc, links=kw["pre_links"])
        call = {k: v for k, v in kw.items() if k != "pre_links"}
        out.append(runtime.run_scenario(
            resnet18(n_classes=10, in_res=32, T=4), noc, scenario,
            **call, **extra))
    return out


def _same(ref, port):
    assert port.to_dict() == ref.to_dict()
    np.testing.assert_array_equal(port.initial_placement,
                                  ref.initial_placement)
    np.testing.assert_array_equal(np.asarray(port.final_graph.adj),
                                  np.asarray(ref.final_graph.adj))


def _busiest_interchip_link(deploy_budget):
    """benchmarks/fault_replace.py's drop target, through the port."""
    hm = _hier(p_topology)
    plan = deploy_model(p_resnet18(n_classes=10, in_res=32, T=4), hm,
                        method="simulated_annealing", seed=0,
                        budget=deploy_budget, schedule="none", device="cpu")
    lt = hm.evaluate(plan.graph, plan.placement.placement).link_traffic
    loads = np.zeros(hm.n_links)
    for label, vol in lt.items():
        loads[hm.link_id_of(label)] = vol
    return int(np.argmax(np.where(hm.interchip_mask(), loads, -1.0)))


COMMON = dict(method="simulated_annealing", objective="comm_cost",
              budget=SMOKE_BUDGET, deploy_budget=SMOKE_BUDGET * DEPLOY_FACTOR,
              migration_weight=MIGRATION_WEIGHT, warm_kw={"t0": WARM_T0},
              seed=0)


@pytest.mark.parametrize("name", ["link_drop", "drift", "node_drop"])
def test_fault_replace_smoke_scenarios_match_reference(name):
    if name == "link_drop":
        lid = _busiest_interchip_link(SMOKE_BUDGET * DEPLOY_FACTOR)
        ref, port = _both(f"steps=6;fault=link:{lid}@2", threshold=THRESHOLD,
                          compare_cold=True,
                          cold_budget=SMOKE_BUDGET * DEPLOY_FACTOR, **COMMON)
        assert port.n_replacements >= 1
        assert "cold_reference" in port.recoveries[0]
    elif name == "drift":
        ref, port = _both("steps=8;drift=diurnal:0.4:8", threshold=0.15,
                          **COMMON)
    else:
        ref, port = _both(f"steps=5;fault=node:{DEAD_CORE}@1;"
                          f"repair=node:{DEAD_CORE}@3", threshold=0.15,
                          **COMMON)
        assert all(r["repartitioned"] for r in port.recoveries)
    _same(ref, port)


@pytest.mark.parametrize("scenario,kw", [
    ("steps=0", dict(migration_weight=0.0)),
    ("steps=4", dict(migration_weight=0.0)),
    ("steps=4;drift=diurnal:0.6:4;fault=link:5@1",
     dict(threshold=0.05, migration_weight=0.1)),
    ("steps=4;fault=node:5@1;repair=node:5@3", dict(migration_weight=0.0)),
    ("steps=3;fault=link:7@1", dict(migration_weight=0.0, threshold=10.0,
                                    pre_links=(5,))),
    ("steps=4;drift=bursty:2.0:0.5;seed=3",
     dict(threshold=0.05, migration_weight=0.1, max_retries=1,
          compare_cold=True)),
])
def test_reference_unit_scenarios_match(scenario, kw):
    ref, port = _both(scenario, spec="mesh:4x4",
                      method="simulated_annealing", budget=48, seed=0, **kw)
    _same(ref, port)


def test_recorder_on_off_identical_and_events():
    kw = dict(method="simulated_annealing", budget=48, seed=0,
              threshold=0.05, migration_weight=0.1, device="cpu")
    scenario = "steps=4;drift=diurnal:0.6:4;fault=link:5@1"
    model, noc = p_resnet18(n_classes=10, in_res=32, T=4), NoC(4, 4)
    off = p_runtime.run_scenario(model, noc, scenario, **kw)
    rec = Recorder()
    on = p_runtime.run_scenario(model, noc, scenario, recorder=rec, **kw)
    assert off.to_dict() == on.to_dict()
    names = {e["name"] for e in rec.events}
    assert {"runtime.step", "runtime.deploy", "runtime.monitor",
            "runtime.fault"} <= names
    assert rec.counters["runtime.drop_link"] == 1


def test_plan_argument_and_rejections():
    model, noc = p_resnet18(n_classes=10, in_res=32, T=4), NoC(4, 4)
    kw = dict(method="simulated_annealing", budget=48, seed=0, device="cpu")
    plan = deploy_model(model, noc, schedule="none", **kw)
    direct = p_runtime.run_scenario(model, noc, "steps=2", schedule="none",
                                    migration_weight=0.0, **kw)
    via_plan = p_runtime.run_scenario(None, noc, "steps=2", plan=plan,
                                      schedule="none", migration_weight=0.0,
                                      **kw)
    assert direct.to_dict() == via_plan.to_dict()
    obj = p_runtime.with_migration(
        "comm_cost", p_runtime.MigrationSpec((0,), (1.0,)), weight=0.5)
    with pytest.raises(ValueError, match="migration_weight"):
        p_runtime.run_scenario(model, noc, "steps=0", objective=obj,
                               device="cpu")
    # ppo and policy refuse degraded fabrics (tests/test_degraded.py)
    g = p_graph.random_dag(6, seed=0)
    for method in ("ppo", "policy"):
        with pytest.raises(ValueError, match="degraded"):
            optimize_placement(g, noc.drop_node(5), method=method, budget=4,
                               device="cpu")


def test_parsing_and_drift_match_reference(tmp_path):
    for spec in ("link:3,node:7", " link:1 , link:2 ", ""):
        assert p_runtime.parse_faults(spec) == r_runtime.parse_faults(spec)
    for bad in ("core:3", "3"):
        with pytest.raises(ValueError, match="want link"):
            p_runtime.parse_faults(bad)
    specs = ["steps=12;drift=diurnal:0.4:8;fault=link:21@3;"
             "repair=link:21@9;seed=7",
             "steps=5;drift=bursty:2.0:0.25;fault=node:5@2"]
    for spec in specs:
        ref, port = r_runtime.parse_scenario(spec), \
            p_runtime.parse_scenario(spec)
        assert port.to_dict() == ref.to_dict()
        assert p_runtime.parse_scenario(json.dumps(port.to_dict())) == port
        path = tmp_path / "s.json"
        path.write_text(json.dumps(ref.to_dict()))
        assert p_runtime.parse_scenario(str(path)) == port
    for bad in ("steps=2;cadence=daily", "steps=2;fault=link:3"):
        with pytest.raises(ValueError):
            p_runtime.parse_scenario(bad)
    g = r_graph.random_dag(10, seed=0)
    pg = p_graph.LogicalGraph(g.adj, g.compute, g.memory)
    for drift in (("diurnal", 0.4, 8), ("bursty", 2.0, 0.25),
                  ("diurnal", 1.0, 8)):
        for t in (0, 3, 6):
            np.testing.assert_array_equal(
                p_runtime.drift_graph(pg, drift, t, seed=5).adj,
                r_runtime.drift_graph(g, drift, t, seed=5).adj)
    assert p_runtime.drift_graph(pg, None, t=3) is pg
