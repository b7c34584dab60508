"""The benchmark's harness on the CPU: its files against the contract,
cells and readers found by name, the FLOP and roofline counts against
hand counts, the references against the port at smoke sizes, and no JAX
in a run."""
from __future__ import annotations

import importlib
import json
import re
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, SMOKE_CELLS, smoke_cell, write_smoke

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert DOC["paths"] == ["bench"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert all(_line(w) for w in DOC["command"])
    assert (ROOT / DOC["command"][1]).is_file()
    assert len(json.dumps(DOC)) < 64 * 1024


@pytest.mark.parametrize("entry", DOC["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _line(entry["source"])
    assert _line(entry["why"]) and entry["file"].startswith("bench/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cfg
        assert not (key.endswith(("_dim", "_rank", "headdim", "_state"))
                    or "expand" in key or "experts_per" in key
                    or (key.endswith("_size") and key != "chunk_size")), key
    assert importlib.import_module(f"bench.families.{cfg['family']}")


@pytest.mark.parametrize("entry", DOC["workloads"], ids=lambda e: e["name"])
def test_workload_entry(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["traffic"])
    assert entry["chips"] in (1, 4) and _line(entry["why"])
    spec = json.loads(
        (BENCH / "workloads" / f"{entry['name']}.json").read_text())
    assert spec["config"] == entry["config"]
    assert spec["traffic"]["name"] == entry["traffic"]
    assert spec["why"] == entry["why"]
    from bench.harness.check import ORDER
    assert {"loss_gap", "nonfinite", "dtype_faults"} <= set(spec["limits"])
    assert set(spec["limits"]) <= set(ORDER)
    assert spec["limits"]["nonfinite"] == spec["limits"]["dtype_faults"] == 0
    assert entry["config"] in {c["name"] for c in DOC["configs"]}


def test_cells_and_pairs_unique():
    names = [w["name"] for w in DOC["workloads"]]
    pairs = [(w["config"], w["traffic"]) for w in DOC["workloads"]]
    assert len(set(names)) == len(names) and len(set(pairs)) == len(pairs)
    used = {w["config"] for w in DOC["workloads"]}
    assert used == {c["name"] for c in DOC["configs"]}


@pytest.mark.parametrize("metric", DOC["end_to_end"] + DOC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                               "bound", "source"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                               "source", "layer", "moves"}
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in DOC["end_to_end"]}
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
        assert callable(smoke_cell(ROOT, DOC["workloads"][0]["name"])
                        .reader(metric["name"]))
    names = {w["name"] for w in DOC["workloads"]}
    assert set(metric.get("workloads", names)) <= names


def test_every_cell_reports_setup_and_a_layer_metric():
    for w in DOC["workloads"]:
        cell = smoke_cell(ROOT, w["name"])
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer()


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    """A workload, a configuration and a per-layer reader added as files
    under a copy of the benchmark are found by their names."""
    root = write_smoke(tmp_path)
    (root / "bench" / "metrics" / "steps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["per_layer"].append({"name": "steps_traced", "unit": "steps",
                             "better": "higher", "source": "device_trace",
                             "layer": "device",
                             "moves": "train_tokens_per_s",
                             "workloads": ["train.smoke-dense.b4s32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    cell = smoke_cell(root, "train.smoke-dense.b4s32")
    assert cell.config["name"] == "smoke-dense"
    assert cell.spec["traffic"]["batch"] == 4
    assert "steps_traced" in {m["name"] for m in cell.per_layer()}

    class Ctx:
        steps = 2
    assert cell.reader("steps_traced")(Ctx()) == 2.0


def test_internlm2_flops_a_token():
    from bench.families import dense_gqa
    cfg = json.loads((BENCH / "configs" / "internlm2-1.8b.json").read_text())
    n = 24 * (2048 * 2048 * 2 + 2 * 2048 * 1024 + 3 * 2048 * 8192) \
        + 2048 * 92544
    assert dense_gqa.matmul_params(cfg) == n
    f4k = dense_gqa.model_flops_per_token(cfg, 4096)
    f32k = dense_gqa.model_flops_per_token(cfg, 32768)
    assert f4k == 6 * n + 24 * 6 * 4096 * 16 * 128
    assert round(f4k / 1e9, 1) == 11.4 and round(f32k / 1e9, 1) == 19.9


@pytest.mark.parametrize("batch", [1, 3])
def test_reference_blocks_change_nothing(batch):
    """The reference's attention and MLP, cut into blocks of positions that
    fit the card, compute what they compute whole."""
    from bench.reference import common
    g = torch.Generator().manual_seed(batch)
    q = torch.randn(batch, 40, 4, 8, generator=g, dtype=torch.float64)
    k, v = (torch.randn(batch, 40, 2, 8, generator=g, dtype=torch.float64)
            for _ in range(2))
    whole = common.causal_attention(q, k, v)
    cut = common.causal_attention(q, k, v, rows_a_block=7 * batch)
    assert torch.allclose(whole, cut, rtol=1e-12, atol=1e-12)
    x = torch.randn(batch, 40, 8, generator=g, dtype=torch.float64)
    ws = [torch.randn(*s, generator=g, dtype=torch.float64)
          for s in ((8, 16), (8, 16), (16, 8))]
    assert torch.allclose(common.swiglu(x, *ws),
                          common.swiglu_blocks(x, *ws, tokens_a_block=9 * batch),
                          rtol=1e-12, atol=1e-12)


def test_flash_roofline_counts_by_hand():
    fwd = importlib.import_module("bench.metrics.flash_fwd_roofline")
    bwd = importlib.import_module("bench.metrics.flash_bwd_roofline")
    call = {"B": 2, "H": 4, "Hkv": 2, "S": 8, "D": 16, "causal": True,
            "elt": 2}
    assert fwd.call_cost(call) == (2 * 2 * 4 * 64 * 16,
                                   2 * (2 * 2 * 8 * 4 * 16
                                        + 2 * 2 * 8 * 2 * 16) + 4 * 2 * 4 * 8)
    assert bwd.call_cost(call) == (5 * 2 * 4 * 64 * 16,
                                   2 * (4 * 2 * 8 * 4 * 16
                                        + 4 * 2 * 8 * 2 * 16) + 4 * 2 * 4 * 8)
    from bench.harness import peaks
    t, bound = peaks.least_seconds(*fwd.call_cost(
        {"B": 8, "H": 16, "Hkv": 8, "S": 4096, "D": 128, "causal": True,
         "elt": 2}))
    assert bound == "compute" and abs(t - 2 * 8 * 16 * 4096 ** 2 * 128
                                      / 989e12) < 1e-12


def test_profile_arithmetic():
    from bench.harness import profile as P
    trace = P.DeviceTrace(
        kernels=[("gemm_a", 10, 20), ("flash_fwd_x", 15, 30),
                 ("other", 50, 60)],
        ops=[("gemm_a", 10, 20), ("flash_fwd_x", 15, 30), ("other", 50, 60),
             ("Memcpy", 70, 75)],
        spans=[("window", 0, 100), ("train_step", 0, 40), ("sync", 40, 100)],
        window=(0, 100), steps=2)
    assert P.busy_ns(trace) == 35
    assert P.kernel_count(trace) == 3
    gaps = P.idle_gaps(trace)
    assert gaps[0] == ["sync", 25e-9] and gaps[1] == ["train_step", 20e-9]
    assert P.host_span_at(trace, 0) == "train_step" and len(gaps) == 4
    assert P.matching_seconds(trace, lambda n: "flash" in n) == 15e-9


def test_tokens_repeat_by_seed_and_differ_by_step():
    from bench.harness.tokens import TokenFeed
    a = TokenFeed(92544, 2, 64, 2 ** 31 + 12345)
    b = TokenFeed(92544, 2, 64, 2 ** 31 + 12345)
    assert (a.rows(3) == b.rows(3)).all()
    assert not (a.rows(3) == a.rows(4)).all()
    r = a.rows(0)
    assert r.shape == (2, 65) and r.min() >= 0 and r.max() < 92544


@pytest.mark.parametrize("name", sorted(SMOKE_CELLS))
def test_reference_agrees_with_the_port_in_float32(smoke_root, name):
    """At a smoke size in float32 the reference's loss and gradients are
    the port's to rounding."""
    from bench.harness import check, train
    from bench.harness import weights as W
    from repro_torch.models import lm
    cell = smoke_cell(smoke_root, name)
    cell.config["port"]["replace"].update(param_dtype="float32",
                                          dtype="float32")
    cell.config["training"]["param_dtype"] = "float32"
    port = cell.family.port_config(cell.config)
    specs = lm.lm_specs(port)
    dev = torch.device("cpu")
    feed = train.Feed(train.TokenFeed.from_traffic(
        cell.spec["traffic"], cell.config["vocab_size"], 5), dev)
    bt = feed(0)
    params = W.draw(specs, 5, dev)
    leaves_p = [p.requires_grad_() for _, p in _leaves(params)]
    loss_p, _ = lm.lm_loss(params, port, bt["tokens"], bt["labels"])
    grads_p = torch.autograd.grad(loss_p, leaves_p)
    stacked = W.stacked_paths(specs)
    ref_leaves = {}
    for path, t in _leaves(W.draw(specs, 5, dev)):
        for key, sl in check.layer_slices([(path, t)], stacked).items():
            ref_leaves[key] = sl.clone().requires_grad_()
    loss_r = cell.reference().loss(ref_leaves, cell.config, bt["tokens"],
                                   bt["labels"])
    grads_r = dict(zip(ref_leaves, torch.autograd.grad(
        loss_r, list(ref_leaves.values()))))
    lp, lr = float(loss_p.detach()), float(loss_r.detach())
    assert abs(lp - lr) < 1e-5 * lr
    for (path, _), g in zip(_leaves(params), grads_p):
        for key, sl in check.layer_slices([(path, g)], stacked).items():
            ref = grads_r[key]
            scale = max(float(ref.abs().max()), 1e-12)
            assert float((sl - ref).abs().max()) <= 2e-4 * scale, key


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k], path + (k,)))
        return out
    return [(path, tree)]


def test_forbidden_modules_compares_whole_names(monkeypatch):
    sys.path.insert(0, str(BENCH))
    run = importlib.import_module("run")
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in run.forbidden_modules()


def test_a_run_loads_no_jax(smoke_root):
    """A whole smoke run, in a process of its own, leaves no module of
    jax, jaxlib, flax or repro loaded."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import time, conftest\n"
        "from pathlib import Path\n"
        "from bench.harness import train\n"
        "cell = conftest.smoke_cell(Path(%r), 'train.smoke-dense.b4s32')\n"
        "out = train.run(cell, 3, 0.2, False, time.perf_counter(), "
        "device='cpu')\n"
        "assert out['correct'], out\n"
        "sys.path.insert(0, %r)\n"
        "import run\n"
        "print('BAD', run.forbidden_modules())\n"
    ) % (str(ROOT), str(ROOT / "src"), str(BENCH / "tests"),
         str(smoke_root), str(BENCH))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "BAD []" in p.stdout


def test_run_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        DOC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_profile_reduces_a_real_trace():
    """The profiler's own events reduce to the harness's spans (on the
    CPU no device events: the readers then find nothing to read)."""
    from bench.harness import profile as P
    with P.traced() as prof:
        with P.span("window"):
            with P.span("train_step"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    trace = P.reduce(prof, 1)
    assert {n for n, _, _ in trace.spans} == {"window", "train_step"}
    assert trace.window_s > 0 and P.busy_ns(trace) == len(trace.kernels) == 0
