"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root, ``bench/workloads/<cell>.json``, the configuration file it names,
the family module that file names (``bench/families/<family>.py``) and
its reference (``bench/reference/<family>.py``), and one reader a
per-layer metric (``bench/metrics/<metric>.py``). Adding any of them is
adding a file; nothing here lists them."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, name: str, root: Path = ROOT, bench: Path = BENCH):
        self.root, self.bench = root, bench
        self.doc = benchmark(root)
        self.entry = _named(self.doc["workloads"], name, "workload")
        self.name = name
        self.spec = json.loads(
            (bench / "workloads" / f"{name}.json").read_text())
        if self.spec["traffic"]["name"] != self.entry["traffic"]:
            raise ValueError(f"{name}: its file's traffic "
                             f"{self.spec['traffic']['name']!r} is not "
                             f"BENCHMARK.json's {self.entry['traffic']!r}")
        centry = _named(self.doc["configs"], self.entry["config"],
                        "configuration")
        self.config = json.loads((root / centry["file"]).read_text())
        self.family = importlib.import_module(
            f"bench.families.{self.config['family']}")
        self.chips = self.entry["chips"]

    def reference(self):
        return importlib.import_module(
            f"bench.reference.{self.family.REFERENCE}")

    def end_to_end(self) -> list:
        return [m for m in self.doc["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        return [m for m in self.doc["per_layer"]
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``bench/metrics/<metric>.py``."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + re.sub(r"\W", "_", metric), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
