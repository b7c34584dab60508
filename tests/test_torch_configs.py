"""The port's per-model config modules (``repro_torch.configs.<name>``)
against the JAX package's: each module's ``CONFIG`` and ``SMOKE`` equal the
reference module's field by field, with JAX dtypes mapped to torch's
(EncDecConfig's class attributes included).
"""
import dataclasses
import importlib
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402

MODULES = ["deepseek_v3_671b", "h2o_danube_1_8b", "internlm2_1_8b",
           "llava_next_34b", "minicpm3_4b", "phi3_medium_14b",
           "qwen3_moe_30b_a3b", "seamless_m4t_medium", "xlstm_125m",
           "zamba2_2_7b"]
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _fields(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for name in ("param_dtype", "dtype", "window", "segments",
                 "n_layers_prop", "n_layers"):
        if hasattr(cfg, name):
            out[name] = getattr(cfg, name)
    for k, v in out.items():
        if dataclasses.is_dataclass(v):
            out[k] = dataclasses.asdict(v)
        elif isinstance(v, tuple):
            out[k] = tuple(dataclasses.asdict(x) for x in v)
        else:
            out[k] = _DTYPES.get(v, v)
    return out


def test_the_ten_modules_are_all_the_reference_has():
    import pathlib

    import repro.configs as r_configs
    import repro_torch.configs as p_configs
    names = {p.stem for p in pathlib.Path(r_configs.__file__).parent.glob(
        "*.py")} - {"__init__", "registry"}
    assert sorted(names) == MODULES
    assert {p.stem for p in pathlib.Path(p_configs.__file__).parent.glob(
        "*.py")} - {"__init__", "registry"} == names


@pytest.mark.parametrize("name", MODULES)
def test_config_module_matches_reference(name):
    ref = importlib.import_module(f"repro.configs.{name}")
    port = importlib.import_module(f"repro_torch.configs.{name}")
    for attr in ("CONFIG", "SMOKE"):
        rc, pc = getattr(ref, attr), getattr(port, attr)
        assert type(pc).__name__ == type(rc).__name__
        assert _fields(pc) == _fields(rc), (name, attr)
    assert port.SMOKE.name == port.CONFIG.name + "-smoke"
