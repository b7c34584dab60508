"""The port stands alone: every module of ``repro_torch`` and
``chip_smoke.py`` import with ``jax`` and the JAX package made unimportable,
and ``chip_smoke.py`` fails without a result where there is no CUDA card."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]

BLOCKER = r"""
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"{name} is blocked for the port")
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, SRC)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
assert {"repro_torch.sharding.rules", "repro_torch.launch.mesh",
        "repro_torch.launch.cells", "repro_torch.launch.dryrun",
        "repro_torch.core.trace_analysis",
        "repro_torch.core.gpu_adapter"} <= set(names)
for name in names:
    __import__(name)
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_reference():
    code = f"SRC, ROOT = {str(ROOT / 'src')!r}, {str(ROOT)!r}\n" + BLOCKER
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_result(tmp_path, alone):
    """Without a card (CUDA hidden), or copied into a directory that holds
    nothing else of the repo, the script exits non-zero and prints no
    result line."""
    script, env = ROOT / "chip_smoke.py", dict(os.environ)
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
        env.pop("PYTHONPATH", None)
    else:
        env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=tmp_path, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
