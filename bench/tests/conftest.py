"""Fixtures of the benchmark's tests: the repository's ``src`` and root on
the path, and a benchmark of CPU-sized cells written to a temporary root
(the real cells' files beside a smoke-sized configuration)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_TRAINING = {"param_dtype": "bfloat16", "moments": "float32",
                  "lr": 0.001, "b1": 0.9, "b2": 0.95, "eps": 1e-08,
                  "weight_decay": 0.0, "grad_clip": 1.0, "remat": "full",
                  "logit_chunk": 16}
SMOKE_PORT = {"param_dtype": "bfloat16", "dtype": "bfloat16",
              "remat": "full", "logit_chunk": 16}

SMOKE_CONFIGS = {
    "smoke-dense": {
        "name": "smoke-dense", "family": "dense_gqa",
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "vocab_size": 512, "rope_theta": 10000.0,
        "tie_word_embeddings": False,
        "port": {"registry": "internlm2-1.8b", "smoke": True,
                 "replace": dict(SMOKE_PORT, rope_theta=10000.0)},
        "training": SMOKE_TRAINING},
}

# smoke cell: (configuration, batch, sequence, the real cell whose limits
# it holds).
SMOKE_CELLS = {
    "train.smoke-dense.b4s32": ("smoke-dense", 4, 32,
                                "train.internlm2-1.8b.b32s4k"),
}


def write_smoke(root: Path):
    """The real benchmark plus the smoke configurations and cells under
    ``root``; each smoke cell holds the limits of its real cell."""
    shutil.copytree(BENCH / "configs", root / "bench" / "configs")
    shutil.copytree(BENCH / "workloads", root / "bench" / "workloads")
    shutil.copytree(BENCH / "metrics", root / "bench" / "metrics")
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in SMOKE_CONFIGS.items():
        f = f"bench/configs/{name}.json"
        (root / f).write_text(json.dumps(cfg))
        doc["configs"].append({"name": name, "source": "smoke", "file": f,
                               "reduced": [], "why": "CPU smoke size"})
    for cell, (cfg, batch, seq, real) in SMOKE_CELLS.items():
        spec = json.loads((BENCH / "workloads" / f"{real}.json").read_text())
        spec["config"] = cfg
        spec["traffic"].update(name=f"b{batch}s{seq}", batch=batch, seq=seq)
        (root / "bench" / "workloads" / f"{cell}.json").write_text(
            json.dumps(spec))
        doc["workloads"].append({"name": cell, "config": cfg,
                                 "traffic": spec["traffic"]["name"],
                                 "chips": 1, "why": "CPU smoke size"})
        for m in doc["per_layer"]:
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    return root


@pytest.fixture
def smoke_root(tmp_path):
    return write_smoke(tmp_path)


def smoke_cell(root: Path, name: str):
    from bench.harness.spec import Cell
    return Cell(name, root=root, bench=root / "bench")
