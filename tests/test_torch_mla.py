"""The port's MLA block (``repro_torch.models.mla``) against the JAX
package's, on the CPU.

Weights and inputs are made with numpy from a seed and handed to both
packages; the reference runs its plain JAX functions (its MLA reaches no
Pallas kernel). A prefill fills the latent cache at [0, S) through the
materialised per-head K/V and blockwise attention, then absorbed decode
steps read and write it. Outputs and caches within ``ATOL`` 2e-5 (float32,
the reference's own attention bound against its dense oracle).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_reg  # noqa: E402
from repro.models import mla as r_mla  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.models import mla as p_mla  # noqa: E402
from repro_torch.models import specs as p_specs  # noqa: E402

ATOL = 2e-5
SMOKE_ARCHS = ["minicpm3-4b", "deepseek-v3-671b"]


def _weights(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in p_specs.tree_leaves(p_mla.mla_specs(
            cfg.d_model, cfg.n_heads, cfg.mla, torch.float32)):
        if s.init == "ones":      # norm scales: off 1 so they matter
            a = 1 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = rng.standard_normal(s.shape) * p_specs.init_std(s)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = a.astype(np.float32)
    return out


def _tree(w, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in w.items()}


def _configs(arch, seq_shard):
    rcfg = dataclasses.replace(r_reg.get_smoke_config(arch),
                               seq_shard_attn=seq_shard, q_chunk=16,
                               k_chunk=16)
    pcfg = dataclasses.replace(p_reg.get_smoke_config(arch),
                               seq_shard_attn=seq_shard, q_chunk=16,
                               k_chunk=16)
    return rcfg, pcfg


def test_mla_specs_match_reference():
    for arch in SMOKE_ARCHS:
        for get in ("get_config", "get_smoke_config"):
            rc, pc = getattr(r_reg, get)(arch), getattr(p_reg, get)(arch)
            rs = r_mla.mla_specs(rc.d_model, rc.n_heads, rc.mla)
            ps = p_mla.mla_specs(pc.d_model, pc.n_heads, pc.mla)
            got = {"/".join(p): (s.shape, s.axes, s.init, s.scale)
                   for p, s in p_specs.tree_leaves(ps)}
            want = {k: (s.shape, s.axes, s.init, s.scale)
                    for k, s in _flat_ref(rs).items()}
            assert got == want


def _flat_ref(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_ref(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_mla_prefill_and_absorbed_decode_match_reference(arch, seq_shard):
    rcfg, pcfg = _configs(arch, seq_shard)
    w = _weights(pcfg, seed=3)
    rp, pp = _tree(w, jnp.asarray), _tree(w, torch.tensor)
    rng = np.random.default_rng(4)
    b, s, mx = 2, 45, 48
    x = rng.standard_normal((b, s, pcfg.d_model)).astype(np.float32)
    m = pcfg.mla
    r_cache = {"ckv": jnp.zeros((b, mx, m.kv_lora_rank)),
               "kr": jnp.zeros((b, mx, m.qk_rope_dim))}
    p_cache = {"ckv": torch.zeros(b, mx, m.kv_lora_rank),
               "kr": torch.zeros(b, mx, m.qk_rope_dim)}
    n = s - 3
    want, r_cache = r_mla.mla_block(rp, jnp.asarray(x[:, :n]), jnp.arange(n),
                                    rcfg, r_cache)
    got, p_cache = p_mla.mla_block(pp, torch.tensor(x[:, :n]),
                                   torch.arange(n), pcfg, p_cache)
    assert got.shape == (b, n, pcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for pos in range(n, s):
        want, r_cache = r_mla.mla_block(
            rp, jnp.asarray(x[:, pos:pos + 1]),
            pos + jnp.zeros((1,), jnp.int32), rcfg, r_cache, jnp.int32(pos))
        got, p_cache = p_mla.mla_block(
            pp, torch.tensor(x[:, pos:pos + 1]), torch.full((1,), pos), pcfg,
            p_cache, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for key in ("ckv", "kr"):
        np.testing.assert_allclose(p_cache[key].numpy(),
                                   np.asarray(r_cache[key]), atol=ATOL)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_mla_without_cache_matches_reference(arch):
    rcfg, pcfg = _configs(arch, False)
    w = _weights(pcfg, seed=5)
    x = np.random.default_rng(6).standard_normal(
        (2, 40, pcfg.d_model)).astype(np.float32)
    want, r_none = r_mla.mla_block(_tree(w, jnp.asarray), jnp.asarray(x),
                                   jnp.arange(40), rcfg)
    got, p_none = p_mla.mla_block(_tree(w, torch.tensor), torch.tensor(x),
                                  torch.arange(40), pcfg)
    assert r_none is None and p_none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_absorbed_decode_equals_materialised_attention():
    """The port alone: each decode step's output equals the last row of the
    materialised (prefill) path over the same prefix, within 1e-5."""
    _, pcfg = _configs("deepseek-v3-671b", False)
    pp = _tree(_weights(pcfg, seed=7), torch.tensor)
    x = torch.tensor(np.random.default_rng(8).standard_normal(
        (1, 12, pcfg.d_model)).astype(np.float32))
    m = pcfg.mla
    cache = {"ckv": torch.zeros(1, 12, m.kv_lora_rank),
             "kr": torch.zeros(1, 12, m.qk_rope_dim)}
    p_mla.mla_block(pp, x[:, :6], torch.arange(6), pcfg, cache)
    for pos in range(6, 12):
        step, cache = p_mla.mla_block(pp, x[:, pos:pos + 1],
                                      torch.full((1,), pos), pcfg, cache, pos)
        full, _ = p_mla.mla_block(pp, x[:, :pos + 1], torch.arange(pos + 1),
                                  pcfg)
        np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                                   atol=1e-5)
