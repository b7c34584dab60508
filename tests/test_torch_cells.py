"""The dry-run cells (``repro_torch.launch.cells``) against the
reference's (``repro.launch.cells``), on the CPU with no tensor made.

Exact, for all 40 ``registry.cells()`` on both production meshes (a
stand-in mesh with a ``{axis: size}`` shape, as ``test_torch_sharding.py``
uses): every parameter, optimizer, cache and batch partition of the port's
cell equals the reference's ``spec_partition`` / ``batch_partition`` under
the reference's own ``_pick_rules``; ``fsdp``, ``kind``, ``n_params``,
``n_active_params`` and ``model_flops`` equal those of the reference's
``build_cell`` on a one-device ``(1, 1)`` jax mesh, which allocates
nothing. The thresholds are the reference's.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import registry as r_reg  # noqa: E402
from repro.launch import cells as r_cells  # noqa: E402
from repro.models import encdec as r_encdec  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.models.specs import ParamSpec  # noqa: E402
from repro.sharding import rules as r_rules  # noqa: E402
from repro.train import optim as r_optim  # noqa: E402
from repro.train import step as r_step  # noqa: E402
from repro_torch.launch import cells as p_cells  # noqa: E402


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(c["arch"], c["shape"]) for c in r_reg.cells()]


def _as_tuple(spec):
    return tuple(tuple(p) if isinstance(p, (list, tuple)) else p
                 for p in spec)


def _leaves(tree, path=()):
    if isinstance(tree, ParamSpec):
        return [(path, tree)]
    return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]


def _port_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tuple(tree.spec)


@pytest.fixture(scope="module")
def one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1], dtype=object).reshape(1, 1),
                ("data", "model"))


def test_thresholds_are_the_references():
    assert p_cells.FSDP_THRESHOLD == r_cells.FSDP_THRESHOLD
    assert p_cells.INT8_OPT_THRESHOLD == r_cells.INT8_OPT_THRESHOLD


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_equals_the_reference(arch, shape, one_device_mesh):
    ref = r_cells.build_cell(arch, shape, one_device_mesh)
    cfg = r_reg.get_config(arch)
    sh = r_reg.SHAPES[shape]
    is_encdec = isinstance(cfg, r_encdec.EncDecConfig)
    specs = (r_encdec.encdec_specs(cfg) if is_encdec
             else r_lm.lm_specs(cfg))
    b, s = sh.global_batch, sh.seq_len
    for name, shape_ in MESHES.items():
        fm = FakeMesh(shape_)
        cell = p_cells.build_cell(arch, shape, fm)
        for key in ("kind", "fsdp", "n_params", "n_active_params",
                    "model_flops"):
            assert getattr(cell, key) == getattr(ref, key), (name, key)
        rules = r_cells._pick_rules(cfg, fm, cell.fsdp, sh.kind)
        trees = {"params": (cell.in_shardings[0], specs)}
        if sh.kind == "train":
            tcfg = r_step.TrainConfig(adam=r_optim.AdamWConfig(
                lr=3e-4, grad_clip=1.0, state_dtype="int8" if cell.n_params
                > r_cells.INT8_OPT_THRESHOLD else "fp32"))
            o_specs = r_step.optimizer_specs(specs, tcfg)
            trees["opt"] = (cell.in_shardings[1],
                            {"m": o_specs["m"], "v": o_specs["v"]})
            extra_dp = bool(getattr(cfg, "prefer_dp", False))
            axes = ("pod", "data", "model") if extra_dp else r_rules.BATCH_AXES
            batch = cell.in_shardings[2]
        else:
            if is_encdec:
                enc = s // 2 if sh.kind == "prefill" else 4096
                dec = s // 2 if sh.kind == "prefill" else s
                c_specs = r_encdec.cache_specs(cfg, b, dec, enc)
            else:
                c_specs = r_lm.cache_specs(cfg, b, s)
            c_shard = cell.in_shardings[1 if sh.kind == "decode" else 2]
            trees["cache"] = (c_shard, c_specs)
            axes = r_rules.BATCH_AXES
            batch = (cell.in_shardings[1] if sh.kind == "prefill"
                     else {"token": cell.in_shardings[2]})
        n = 0
        for tree_name, (port_tree, ref_specs) in trees.items():
            for path, spec in _leaves(ref_specs):
                want = _as_tuple(r_rules.spec_partition(fm, spec, rules))
                assert _port_leaf(port_tree, path) == want, (name, tree_name,
                                                            path)
                n += 1
        assert n > 0
        for key, sharding in batch.items():
            arg = cell.arg_specs[2 if sh.kind == "decode" else
                                 (2 if sh.kind == "train" else 1)]
            shp = arg.shape if key == "token" else arg[key].shape
            want = r_rules.batch_partition(fm, len(shp), batch_size=shp[0],
                                           axes=axes)
            assert tuple(sharding.spec) == _as_tuple(want), (name, key)
        assert cell.donate_argnums == ref.donate_argnums
