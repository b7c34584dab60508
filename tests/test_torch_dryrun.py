"""The dry run (``repro_torch.launch.dryrun``) on a 256-rank world of the
``fake`` backend, the ``(16, 16)`` production mesh, with depth and width
cut by ``overrides``: a base cell (internlm2-1.8b), an FSDP and
expert-parallel cell (qwen3-moe-30b-a3b) and an enc-dec cell
(seamless-m4t-medium), each at ``train_4k``. Every record is ``ok`` and
meets ``tests/test_system.py::test_dryrun_artifacts_when_present``'s
conditions; the FSDP cell all-gathers its parameters over ``data`` and
reduce-scatters their gradients there, and the MoE cell's dispatch is an
all-to-all over ``model``.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models.lm import Segment  # noqa: E402


def _cut(arch):
    cfg = get_config(arch)
    if arch == "seamless-m4t-medium":
        return {"n_enc_layers": 1, "n_dec_layers": 1, "d_model": 256,
                "d_head": 16, "d_ff": 512, "vocab": 4096}
    kw = {"segments": (Segment(cfg.segments[0].kind, cfg.segments[0].mlp,
                               1),),
          "d_model": 256, "d_ff": 512, "vocab": 4096}
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, d_ff=64)
    return kw


CASES = {"internlm2-1.8b": None, "qwen3-moe-30b-a3b": True,
         "seamless-m4t-medium": None}


def _coherent(rec):
    assert rec["ok"], rec.get("traceback")
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["memory"]["peak_bytes_per_device"] > 0
    t = rec["roofline"]
    assert t["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert 0 <= t["roofline_fraction"] <= 1.01


@pytest.mark.parametrize("arch", sorted(CASES))
def test_run_cell_on_the_production_mesh(arch, tmp_path):
    assert not dist.is_initialized()
    rec = D.run_cell(arch, "train_4k", False, str(tmp_path),
                     overrides=_cut(arch), fsdp=CASES[arch])
    assert not dist.is_initialized()          # the fake world is gone
    _coherent(rec)
    assert rec["n_chips"] == 256 and rec["kind"] == "train"
    with open(tmp_path / f"{arch}__train_4k__pod.json") as f:
        assert json.load(f)["cost"] == rec["cost"]
    axes = rec["collectives"]["by_axis"]
    assert set(axes) <= {"data", "model", "other"}
    if rec["fsdp"]:
        assert axes["data"]["all-gather"]["count"] > 0
        assert axes["data"]["reduce-scatter"]["count"] > 0
    else:
        assert "all-gather" not in axes.get("data", {})
    if arch.startswith("qwen3"):
        assert axes["model"]["all-to-all"]["count"] >= 2
    links = rec["collectives"]["by_link"]
    total = sum(v["operand_bytes"] for v in links.values())
    assert total == pytest.approx(rec["collectives"]["operand_bytes"])


@pytest.mark.parametrize("arch,shape", [("internlm2-1.8b", "prefill_32k"),
                                        ("internlm2-1.8b", "decode_32k"),
                                        ("seamless-m4t-medium",
                                         "decode_32k"),
                                        ("qwen3-moe-30b-a3b", "decode_32k"),
                                        ("minicpm3-4b", "decode_32k")])
def test_serving_cells_on_the_production_mesh(arch, shape, tmp_path):
    """Prefill and decode cells: the batch over ``data``, the caches laid
    out by the cell's rules and written on each rank's own rows
    (``sharding.rules.write_seq``); decode runs attention, MLA's absorbed
    attention and a MoE layer's few tokens on local shards
    (``layers._sharded_decode``, ``mla._sharded_absorbed_decode``,
    ``moe._moe_gathered_tokens``). Their values are held in the gloo
    world (``test_torch_sharding.py``)."""
    rec = D.run_cell(arch, shape, False, str(tmp_path),
                     overrides=_cut(arch))
    assert not dist.is_initialized()
    _coherent(rec)
    assert rec["kind"] == shape.split("_")[0]
    assert rec["memory"]["alias_bytes"] > 0      # the caches, in place
    assert rec["memory"]["argument_bytes"] >= rec["memory"]["alias_bytes"]


def test_failures_are_recorded_as_data(tmp_path):
    rec = D.run_cell("internlm2-1.8b", "train_4k", False, str(tmp_path),
                     overrides={"n_heads": 3})
    assert rec["ok"] is False and "error" in rec
    assert not dist.is_initialized()


def test_roofline_terms_by_link():
    coll = {"operand_bytes": 150e9, "wire_bytes": 300e9,
            "by_link": {"nvlink": {"operand_bytes": 100e9,
                                   "wire_bytes": 200e9},
                        "ib": {"operand_bytes": 50e9, "wire_bytes": 100e9}}}
    t = D.roofline_terms(989e12, 3.35e12, coll, 989e12 * 256, 256)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(100e9 / 450e9 + 1.0)
    assert t["dominant"] == "collective_s"
    assert D.link_of(range(8, 16)) == "nvlink"
    assert D.link_of([0, 8]) == "ib"


def test_xlstm_trains_on_a_model_axis_wider_than_its_heads():
    """xlstm-125m cut to d_model 256, vocab 4096 and its own mLSTM ->
    sLSTM order, 8 x 64 tokens on a (1, 8) mesh of an 8-rank fake world:
    4 heads on a model axis of 8. The head norm's flat gradient came back
    sharded over 8 ranks on the head dim and the backward's head split
    raised; now the training cell traces."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.core.trace_analysis import analyze_trace
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_test_mesh
    cfg = dataclasses.replace(
        get_config("xlstm-125m"), d_model=256, vocab=4096,
        segments=(Segment("mlstm", "none", 1), Segment("slstm", "none", 1)))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        cell = build_cell("xlstm-125m", ShapeSpec("x", 64, 8, "train"),
                          make_test_mesh((1, 8)), cfg=cfg)
        trace, memory = cell.trace()
    finally:
        dist.destroy_process_group()
    assert analyze_trace(trace)["flops"] > 0
    assert memory["peak_bytes_per_device"] > memory["argument_bytes"] > 0
