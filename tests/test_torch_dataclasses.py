"""Every dataclass that has the same name in the port (``repro_torch``) and
in the JAX package (``repro``) has the reference's fields, in the
reference's order, but for the port's recorded additions and renames below.
A field the port drops (``TrainConfig.compression_block``, which the
reference keeps unused) or adds without a record fails here.

The modules of both packages are imported in a subprocess: importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host devices, which
must not leak into the processes other tests start.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# fields the port has and the reference lacks: the reference's draws
# injected (``init_params``, ``gumbel``) and the PPO update's epsilon
# (``eps``); the recorded collective's ranks and repeat count
ADDED = {"PPOConfig": ("init_params", "eps"),
         "PolicyConfig": ("init_params", "gumbel"),
         "CollectiveOp": ("group_ranks", "count")}
# a cell holds its arguments' specs, from which ``Cell.args`` makes fake
# tensors; the reference's holds the arguments (``ShapeDtypeStruct``s)
RENAMED = {"Cell": {"args": "arg_specs"}}

COLLECT = """
import dataclasses, importlib, json, os, sys
sys.path.insert(0, SRC)
out = {}
for pkg in ("repro", "repro_torch"):
    found = out[pkg] = {}
    for d, _, files in os.walk(os.path.join(SRC, pkg)):
        for f in sorted(files):
            if not f.endswith(".py") or f == "__main__.py":
                continue
            rel = os.path.relpath(os.path.join(d, f), SRC)[:-3]
            name = rel.replace(os.sep, ".").removesuffix(".__init__")
            mod = importlib.import_module(name)
            for cls in vars(mod).values():
                if (isinstance(cls, type) and dataclasses.is_dataclass(cls)
                        and cls.__module__ == name):
                    found.setdefault(cls.__name__, {})[
                        name.split(".", 1)[1]] = [
                        f.name for f in dataclasses.fields(cls)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def both():
    out = subprocess.run(
        [sys.executable, "-c", f"SRC = {os.path.abspath(SRC)!r}\n"
         + textwrap.dedent(COLLECT)], capture_output=True, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    return found["repro"], found["repro_torch"]


def _pairs(ref, port):
    """``(name, module, reference fields, port fields)`` of every dataclass
    named in both packages; a name defined in several modules of either
    package pairs the modules of the same path."""
    for name in sorted(set(ref) & set(port)):
        r, p = ref[name], port[name]
        if len(r) == 1 and len(p) == 1:
            yield name, next(iter(r)), next(iter(r.values())), \
                next(iter(p.values()))
            continue
        for mod in sorted(set(r) & set(p)):
            yield name, mod, r[mod], p[mod]


def test_shared_dataclasses_have_the_references_fields(both):
    ref, port = both
    pairs = list(_pairs(ref, port))
    assert len(pairs) >= 40
    names = {name for name, *_ in pairs}
    assert {"TrainConfig", "AdamWConfig", "LMConfig", "Cell",
            "ShapeSpec", "PPOConfig", "CollectiveOp"} <= names
    for name, mod, rf, pf in pairs:
        want = [RENAMED.get(name, {}).get(f, f) for f in rf]
        got = [f for f in pf if f not in ADDED.get(name, ())]
        assert got == want, (name, mod, rf, pf)


def test_train_config_takes_the_references_compression_block():
    from repro_torch.train.step import TrainConfig
    assert TrainConfig().compression_block == 2048
    assert TrainConfig(compression_block=512).compression_block == 512
