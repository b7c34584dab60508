"""Tests for repro.obs: recorder semantics, trace export round-trips, flow
introspection invariants, search-trajectory telemetry, and the bit-identity
guarantee (recorder on/off must not change any seeded result)."""
import json

import numpy as np
import pytest

from repro.core import NoC, random_dag
from repro.core.noc_batch import make_scorer
from repro.core.placement.optimizer import optimize_placement
from repro.core.topology import parse_topology
from repro.deploy import deploy_model
from repro.deploy.cli import main as cli_main
from repro.obs import (NULL_RECORDER, Recorder, bench_percentiles, flow_report,
                       gini, maybe_span, percentiles, read_jsonl)
from repro.snn import spike_resnet18


# ---------------------------------------------------------------------------
# Recorder primitives
# ---------------------------------------------------------------------------

def test_span_nesting_depth_and_attrs():
    rec = Recorder()
    with rec.span("outer", stage="a"):
        with rec.span("inner"):
            pass
    # events append on exit: inner first
    inner, outer = rec.events
    assert inner["name"] == "inner" and inner["depth"] == 1
    assert outer["name"] == "outer" and outer["depth"] == 0
    assert outer["attrs"] == {"stage": "a"}
    assert inner["dur"] <= outer["dur"]


def test_span_duration_set_even_when_disabled():
    rec = Recorder(enabled=False)
    with rec.span("x") as sp:
        pass
    assert sp.duration_s >= 0.0
    assert rec.events == []


def test_null_recorder_and_maybe_span():
    with NULL_RECORDER.span("x") as sp:
        pass
    assert sp.duration_s >= 0.0 and NULL_RECORDER.events == []
    with maybe_span(None, "y") as sp2:
        pass
    assert sp2.duration_s >= 0.0


def test_port_spans_open_profiler_ranges_only_under_a_profiler(monkeypatch):
    """The port's recorder spans and ``maybe_span`` open the profiler range
    ``repro_torch.<name>`` while ``torch.profiler`` runs, and nothing
    without one; the recorder's own events are the same either way."""
    pytest.importorskip("torch")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs as t_obs
    from repro_torch.obs import recorder as t_recorder
    entered = []

    class Counting:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    def spans():
        rec = t_obs.Recorder()
        with rec.span("deploy.place", method="sa"):
            with t_obs.maybe_span(None, "place.sa"):
                pass
        with t_obs.maybe_span(rec, "place.ga"):
            pass
        return [(e["name"], e["depth"]) for e in rec.events]

    monkeypatch.setattr(t_recorder, "_RecordFunctionFast", Counting)
    off = spans()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = spans()
    assert on == off == [("deploy.place", 0), ("place.ga", 0)]
    assert entered == ["repro_torch.deploy.place", "repro_torch.place.sa",
                       "repro_torch.place.ga"]
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert sorted(names) == sorted(entered)


def test_counter_and_gauge_semantics():
    rec = Recorder()
    rec.count("c")
    rec.count("c", 4)
    rec.gauge("g", 1.5)
    rec.gauge("g", 2.5)        # last value wins
    assert rec.counters == {"c": 5}
    assert rec.gauges == {"g": 2.5}


def test_disabled_recorder_stores_nothing():
    rec = Recorder(enabled=False)
    rec.event("e", a=1)
    rec.count("c")
    rec.gauge("g", 1.0)
    rec.observe("h", 2.0)
    assert rec.events == [] and rec.counters == {}
    assert rec.gauges == {} and rec.histogram("h") == []


def test_histogram_summary_percentiles():
    rec = Recorder()
    for v in range(1, 101):
        rec.observe("lat", float(v))
    s = rec.histogram_summary("lat")
    assert s["count"] == 100 and s["min"] == 1.0 and s["max"] == 100.0
    assert s["p50"] == pytest.approx(np.percentile(range(1, 101), 50))
    assert s["p99"] == pytest.approx(np.percentile(range(1, 101), 99))
    assert rec.histogram_summary("absent") is None


def test_percentiles_matches_numpy():
    rng = np.random.default_rng(0)
    xs = rng.random(37).tolist()
    out = percentiles(xs, qs=(50, 90, 99))
    for q in (50, 90, 99):
        assert out[f"p{q}"] == pytest.approx(np.percentile(xs, q))
    with pytest.raises(ValueError):
        percentiles([])


def test_bench_percentiles_shape():
    out = bench_percentiles(lambda: None, repeats=5, warmup=1)
    assert out["n"] == 5
    assert out["min"] <= out["p50"] <= out["p99"] <= out["max"]


# ---------------------------------------------------------------------------
# Export round-trips
# ---------------------------------------------------------------------------

def test_jsonl_round_trip(tmp_path):
    rec = Recorder()
    with rec.span("s", k=1):
        rec.event("e", x=2)
    rec.count("c", 3)
    rec.observe("h", 0.5)
    path = rec.write_jsonl(tmp_path / "t.jsonl")
    evs = read_jsonl(path)
    kinds = [e["kind"] for e in evs]
    assert kinds == ["event", "span", "counters", "histogram"]
    assert evs[2]["values"] == {"c": 3}
    assert evs[3]["summary"]["count"] == 1


def test_chrome_trace_structure(tmp_path):
    rec = Recorder()
    with rec.span("stage", method="sa"):
        rec.event("tick")
    rec.gauge("temp", 0.7)
    rec.count("n", 2)
    path = tmp_path / "trace.json"
    rec.write_chrome_trace(path)
    ct = json.loads(path.read_text())
    phases = {e["ph"] for e in ct["traceEvents"]}
    assert phases == {"X", "i", "C"}
    x = next(e for e in ct["traceEvents"] if e["ph"] == "X")
    assert x["name"] == "stage" and x["args"] == {"method": "sa"}
    assert x["dur"] >= 0 and {"pid", "tid", "ts"} <= set(x)
    assert ct["otherData"]["counters"] == {"n": 2}


# ---------------------------------------------------------------------------
# Flow introspection
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_case():
    noc = NoC(4, 4)
    graph = random_dag(16, p=0.2, seed=0)
    placement = np.random.default_rng(1).permutation(16)
    return noc, graph, placement


def test_flow_report_link_loads_sum_to_byte_hops(mesh_case):
    noc, graph, placement = mesh_case
    rep = flow_report(noc, graph, placement)
    comm = noc.evaluate(graph, placement).comm_cost
    assert rep.byte_hops == pytest.approx(comm)
    assert np.asarray(rep.link_loads).sum() == pytest.approx(comm)


def test_flow_report_top_link_matches_max_link(mesh_case):
    noc, graph, placement = mesh_case
    rep = flow_report(noc, graph, placement, top_k=3)
    m = noc.evaluate(graph, placement)
    assert rep.max_link == pytest.approx(m.max_link)
    assert rep.top_links[0]["bytes"] == pytest.approx(m.max_link)
    assert len(rep.top_links) <= 3
    bs = [t["bytes"] for t in rep.top_links]
    assert bs == sorted(bs, reverse=True)


def test_flow_report_hierarchical_chip_breakdown():
    noc = parse_topology("hier:2x2:2x2")
    graph = random_dag(16, p=0.25, seed=2)
    placement = np.random.default_rng(3).permutation(16)
    rep = flow_report(noc, graph, placement)
    assert set(rep.per_chip_bytes) <= {0, 1, 2, 3}
    assert rep.interchip_bytes > 0
    ic = noc.interchip_bytes(noc.evaluate(graph, placement).link_traffic)
    assert rep.interchip_bytes == pytest.approx(ic)
    text = rep.render()
    assert "interchip bytes" in text and "heatmap" in text


def test_flow_report_render_and_dict(mesh_case):
    noc, graph, placement = mesh_case
    rep = flow_report(noc, graph, placement)
    d = rep.to_dict()
    assert d["n_active_links"] == rep.n_active_links
    assert 0.0 <= d["gini"] <= 1.0
    text = rep.render(top_k=2)
    assert "flow report" in text and "gini" in text


def test_flow_report_accepts_placement_result(mesh_case):
    noc, graph, placement = mesh_case
    res = optimize_placement(graph, noc, method="zigzag")
    rep = flow_report(noc, graph, res)
    rep2 = flow_report(noc, graph, res.placement)
    assert rep.byte_hops == rep2.byte_hops


def test_gini_bounds():
    assert gini([1.0, 1.0, 1.0]) == pytest.approx(0.0)
    assert gini([0.0, 0.0, 10.0]) == pytest.approx(2 / 3)


# ---------------------------------------------------------------------------
# Search-trajectory telemetry + bit-identity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def search_case():
    noc = NoC(4, 4)
    graph = random_dag(12, p=0.2, seed=0)
    return graph, noc


def test_sa_event_count_matches_iters(search_case):
    graph, noc = search_case
    rec = Recorder()
    optimize_placement(graph, noc, method="simulated_annealing", seed=0,
                       iters=100, recorder=rec)
    sa = [e for e in rec.events
          if e["kind"] == "event" and e["name"] == "sa.iter"]
    assert len(sa) == 100
    assert [e["attrs"]["iter"] for e in sa] == list(range(100))
    assert rec.counters["sa.accepted"] >= 1
    # the whole dispatch ran inside a place.<method> span
    assert any(e["kind"] == "span" and e["name"] == "place.simulated_annealing"
               for e in rec.events)


def test_genetic_event_count_matches_generations(search_case):
    graph, noc = search_case
    rec = Recorder()
    optimize_placement(graph, noc, method="genetic", seed=0, generations=7,
                       pop_size=8, recorder=rec)
    ga = [e for e in rec.events
          if e["kind"] == "event" and e["name"] == "ga.gen"]
    assert len(ga) == 8            # initial scoring (gen=-1) + 7 generations
    assert ga[0]["attrs"]["gen"] == -1
    assert all(0.0 <= e["attrs"]["diversity"] <= 1.0 for e in ga)


def test_population_sa_event_count(search_case):
    graph, noc = search_case
    rec = Recorder()
    optimize_placement(graph, noc, method="population_simulated_annealing",
                       seed=0, iters=25, pop_size=4, recorder=rec)
    evs = [e for e in rec.events
           if e["kind"] == "event" and e["name"] == "population_sa.iter"]
    assert len(evs) == 25
    assert all(0.0 <= e["attrs"]["accept_frac"] <= 1.0 for e in evs)


def test_rs_events_and_scorer_counters(search_case):
    graph, noc = search_case
    rec = Recorder()
    optimize_placement(graph, noc, method="random_search", seed=0, iters=30,
                       recorder=rec)
    rs = [e for e in rec.events
          if e["kind"] == "event" and e["name"] == "rs.iter"]
    assert len(rs) == 30
    assert rec.counters["noc_batch.dispatches"] == 30
    assert rec.counters["noc_batch.evals"] == 30
    scorer_ev = [e for e in rec.events
                 if e["kind"] == "event" and e["name"] == "noc_batch.scorer"]
    assert scorer_ev and scorer_ev[0]["attrs"]["backend"] == "batch"


@pytest.mark.parametrize("method,kw", [
    ("simulated_annealing", {"iters": 150}),
    ("random_search", {"iters": 40}),
    ("genetic", {"generations": 6, "pop_size": 8}),
    ("population_simulated_annealing", {"iters": 20, "pop_size": 4}),
])
def test_recorder_does_not_change_results(search_case, method, kw):
    graph, noc = search_case
    off = optimize_placement(graph, noc, method=method, seed=5, **kw)
    on = optimize_placement(graph, noc, method=method, seed=5,
                            recorder=Recorder(), **kw)
    assert np.array_equal(off.placement, on.placement)
    assert off.comm_cost == on.comm_cost
    assert off.objective_cost == on.objective_cost


@pytest.mark.slow
def test_ppo_recorder_parity_and_events(search_case):
    graph, noc = search_case
    kw = dict(budget=3, batch_size=8)
    off = optimize_placement(graph, noc, method="ppo", seed=1, **kw)
    rec = Recorder()
    on = optimize_placement(graph, noc, method="ppo", seed=1, recorder=rec,
                            **kw)
    assert np.array_equal(off.placement, on.placement)
    assert off.comm_cost == on.comm_cost
    evs = [e for e in rec.events
           if e["kind"] == "event" and e["name"] == "ppo.iter"]
    assert len(evs) == 3
    assert {"mean_cost", "best_cost", "actor_loss",
            "critic_loss"} <= set(evs[0]["attrs"])


def test_counted_scorer_batch_semantics(search_case):
    graph, noc = search_case
    rec = Recorder()
    score = make_scorer(noc, graph, "batch", recorder=rec)
    P = np.stack([np.random.default_rng(k).permutation(16)[:12]
                  for k in range(5)])
    ref = make_scorer(noc, graph, "batch")(P)
    out = score(P)
    np.testing.assert_array_equal(out, ref)
    assert rec.counters == {"noc_batch.dispatches": 1, "noc_batch.evals": 5}


# ---------------------------------------------------------------------------
# Deployment engine + CLI integration
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_deploy_model_trace_chrome_loadable(tmp_path):
    rec = Recorder()
    noc = parse_topology("mesh:4x4")
    plan = deploy_model(spike_resnet18(n_classes=10, in_res=32, T=4), noc,
                        method="sigmate", n_units=4, recorder=rec)
    # stage times are the span durations
    span_names = {e["name"] for e in rec.events if e["kind"] == "span"}
    assert {"deploy.profile", "deploy.partition", "deploy.place",
            "deploy.schedule"} <= span_names
    for stage in ("profile", "partition", "place", "schedule"):
        assert plan.stage_times_s[stage] >= 0.0
    assert rec.counters["deploy.deployments"] == 1
    path = tmp_path / "trace.json"
    rec.write_chrome_trace(path)
    ct = json.loads(path.read_text())
    assert isinstance(ct["traceEvents"], list) and ct["traceEvents"]
    assert all({"ph", "ts", "pid", "tid"} <= set(e)
               for e in ct["traceEvents"])


@pytest.mark.slow
def test_cli_report_subcommand(tmp_path, capsys):
    out_json = tmp_path / "rep.json"
    trace = tmp_path / "rep_trace.jsonl"
    rc = cli_main(["report", "--topology", "hier:2x2:4x4",
                   "--method", "sigmate", "--top-k", "4",
                   "--json", str(out_json), "--trace", str(trace)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "flow report" in text and "interchip bytes" in text
    assert "top 4 links" in text and "heatmap" in text
    d = json.loads(out_json.read_text())
    assert "flow" in d and "plan" in d
    assert d["flow"]["byte_hops"] > 0
    assert all(isinstance(e, dict) for e in read_jsonl(trace))


@pytest.mark.slow
def test_cli_sweep_trace_flag(tmp_path):
    trace = tmp_path / "sweep.jsonl"
    chrome = tmp_path / "sweep_chrome.json"
    rc = cli_main(["--smoke", "--trace", str(trace),
                   "--chrome-trace", str(chrome)])
    assert rc == 0
    evs = read_jsonl(trace)
    assert any(e["kind"] == "span" and e["name"] == "deploy.place"
               for e in evs)
    ct = json.loads(chrome.read_text())
    assert ct["traceEvents"]
