"""The port's LM layers, model and configs against the JAX package, on the
CPU.

Inputs are made with numpy and handed to both packages; the reference's
weights are carried across with ``lm.from_reference_params``. Tolerances:
the attention functions, rope and rmsnorm within atol 2e-5 (float32, the
reference's own ``test_attention.py`` bound against its dense oracle); the
smoke models' logits within atol 1e-4 (float32 through two layers of
matmuls summed in another order) and their MoE aux within 1e-6; configs,
parameter counts, cells and ``transformer_graph`` exactly.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_reg  # noqa: E402
from repro.core.graph import transformer_graph as r_tgraph  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import lm as r_lm  # noqa: E402
from repro.models import specs as r_specs  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.core.graph import transformer_graph as p_tgraph  # noqa: E402
from repro_torch.models import layers as p_layers  # noqa: E402
from repro_torch.models import lm as p_lm  # noqa: E402
from repro_torch.models import specs as p_specs  # noqa: E402

SERVED_ARCHS = ["internlm2-1.8b", "h2o-danube-1.8b", "phi3-medium-14b",
                "llava-next-34b", "minicpm3-4b", "qwen3-moe-30b-a3b",
                "deepseek-v3-671b"]
UNPORTED_ARCHS = ["xlstm-125m", "zamba2-2.7b"]
ATOL = 2e-5
MODEL_ATOL = 1e-4


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _bshd(rng, b, s, h, d, scale=0.4):
    return (rng.standard_normal((b, s, h, d)) * scale).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


# ---- layers ------------------------------------------------------------------

def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        p_layers.rmsnorm({"scale": _t(scale)}, _t(x)).numpy(),
        np.asarray(r_layers.rmsnorm({"scale": jnp.asarray(scale)},
                                    jnp.asarray(x))), atol=ATOL, rtol=1e-5)
    xr = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    pos = np.arange(5, 13)
    np.testing.assert_allclose(
        p_layers.apply_rope(_t(xr), _t(pos), 5e5).numpy(),
        np.asarray(r_layers.apply_rope(jnp.asarray(xr), jnp.asarray(pos),
                                       5e5)), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("s", [17, 64, 160, 256])
@pytest.mark.parametrize("window", [None, 23])
def test_blockwise_attention_matches_reference(s, window):
    rng = np.random.default_rng(s)
    q, k = _bshd(rng, 2, s, 4, 32), _bshd(rng, 2, s, 2, 32)
    v = _bshd(rng, 2, s, 2, 32, 1.0)
    want = r_layers.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), window=window,
                                        q_chunk=64, k_chunk=64)
    got = p_layers.blockwise_attention(_t(q), _t(k), _t(v), window=window,
                                       q_chunk=64, k_chunk=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_noncausal_cross_attention_matches_reference():
    rng = np.random.default_rng(1)
    q, k = _bshd(rng, 2, 64, 4, 32), _bshd(rng, 2, 96, 4, 32)
    v = _bshd(rng, 2, 96, 4, 32, 1.0)
    want = r_layers.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=False,
                                        q_chunk=32, k_chunk=32)
    got = p_layers.blockwise_attention(_t(q), _t(k), _t(v), causal=False,
                                       q_chunk=32, k_chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("window,pos", [(None, 23), (8, 31), (8, 3),
                                        (None, 0)])
def test_decode_attention_matches_reference(window, pos):
    rng = np.random.default_rng(pos)
    q = _bshd(rng, 2, 1, 4, 16)
    k, v = _bshd(rng, 2, 32, 2, 16), _bshd(rng, 2, 32, 2, 16, 1.0)
    want = r_layers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), pos, window=window)
    got = p_layers.decode_attention(_t(q), _t(k), _t(v), pos, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-1.8b",
                                  "phi3-medium-14b"])
def test_attention_block_with_cache_matches_reference(arch):
    """Prefill fills the cache at [0, S), then two decode steps read and
    write it (repeat_kv, a window, seq_shard_attn across the three)."""
    rcfg, pcfg = r_reg.get_smoke_config(arch), p_reg.get_smoke_config(arch)
    rp = r_specs.materialize(jax.random.PRNGKey(3), r_layers.attn_specs(
        rcfg.d_model, rcfg.n_heads, rcfg.n_kv_heads, rcfg.d_head,
        jnp.float32))
    pp = {k: _t(v) for k, v in _np_tree(rp).items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 30, rcfg.d_model)).astype(np.float32)
    shp = (2, 32, rcfg.n_kv_heads, rcfg.d_head)
    r_cache = {"k": jnp.zeros(shp), "v": jnp.zeros(shp)}
    p_cache = {"k": torch.zeros(shp), "v": torch.zeros(shp)}
    want, r_cache = r_layers.attention_block(
        rp, jnp.asarray(x[:, :28]), jnp.arange(28), rcfg, r_cache)
    got, p_cache = p_layers.attention_block(pp, _t(x[:, :28]),
                                            torch.arange(28), pcfg, p_cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for pos in (28, 29):
        want, r_cache = r_layers.attention_block(
            rp, jnp.asarray(x[:, pos:pos + 1]), pos + jnp.zeros((1,),
                                                                 jnp.int32),
            rcfg, r_cache, jnp.int32(pos))
        got, p_cache = p_layers.attention_block(
            pp, _t(x[:, pos:pos + 1]), torch.full((1,), pos), pcfg, p_cache,
            pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(p_cache[key].numpy(),
                                   np.asarray(r_cache[key]), atol=ATOL)


# ---- the model -----------------------------------------------------------------

def _model_pair(arch, seed=0):
    rcfg, pcfg = r_reg.get_smoke_config(arch), p_reg.get_smoke_config(arch)
    rp = r_specs.materialize(jax.random.PRNGKey(seed), r_lm.lm_specs(rcfg))
    pp = p_lm.from_reference_params(pcfg, _np_tree(rp), device="cpu")
    return rcfg, pcfg, rp, pp


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    rcfg, pcfg, rp, pp = _model_pair(arch)
    rng = np.random.default_rng(7)
    s = 72
    mx = s + rcfg.prefix_len
    toks = rng.integers(0, rcfg.vocab, (2, s))
    prefix = (rng.standard_normal((2, rcfg.prefix_len, rcfg.d_model))
              .astype(np.float32) if rcfg.prefix_len else None)
    jpre = None if prefix is None else jnp.asarray(prefix)
    tpre = None if prefix is None else _t(prefix)
    want, r_aux = r_lm.forward(rp, rcfg, jnp.asarray(toks), jpre)
    got, aux = p_lm.forward(pp, pcfg, _t(toks), tpre)
    assert got.shape == (2, s + pcfg.prefix_len, pcfg.vocab)
    assert aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(r_aux), atol=1e-6)
    assert (float(aux) > 0) == (pcfg.moe is not None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODEL_ATOL)

    n = s
    r_cache = r_specs.materialize(jax.random.PRNGKey(0),
                                  r_lm.cache_specs(rcfg, 2, mx))
    p_cache = p_specs.materialize(p_lm.cache_specs(pcfg, 2, mx),
                                  device="cpu")
    want, r_cache = r_lm.prefill(rp, rcfg, jnp.asarray(toks[:, :n - 2]),
                                 r_cache, jpre)
    got, p_cache = p_lm.prefill(pp, pcfg, _t(toks[:, :n - 2]), p_cache, tpre)
    assert got.shape == (2, 1, pcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=MODEL_ATOL)
    if prefix is not None:
        return          # the reference decodes text-only caches
    for i in range(n - 2, n):
        want, r_cache = r_lm.decode_step(rp, rcfg, r_cache,
                                         jnp.asarray(toks[:, i:i + 1]),
                                         jnp.int32(i))
        got, p_cache = p_lm.decode_step(pp, pcfg, p_cache,
                                        _t(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MODEL_ATOL)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-1.8b",
                                  "minicpm3-4b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b"])
def test_decode_matches_forward(arch):
    """The reference's ``test_models.py`` property, in the port alone: prefill
    and decode logits equal full-sequence logits (atol 2e-4)."""
    _, pcfg, _, pp = _model_pair(arch, seed=1)
    s, mx = 40, 44
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, pcfg.vocab,
                                                             (2, s)))
    full, _ = p_lm.forward(pp, pcfg, toks)
    cache = p_specs.materialize(p_lm.cache_specs(pcfg, 2, mx), device="cpu")
    pre, cache = p_lm.prefill(pp, pcfg, toks[:, :s - 3], cache)
    errs = [(pre[:, 0] - full[:, s - 4]).abs().max().item()]
    for i in range(s - 3, s):
        lg, cache = p_lm.decode_step(pp, pcfg, cache, toks[:, i:i + 1], i)
        errs.append((lg[:, 0] - full[:, i]).abs().max().item())
    assert max(errs) < 2e-4, errs


def _without(tree, path):
    """``tree`` with the leaf at ``path`` removed (copies along the path)."""
    out = dict(tree)
    if len(path) == 1:
        del out[path[0]]
    else:
        out[path[0]] = _without(tree[path[0]], path[1:])
    return out


def _with(tree, path, leaf):
    out = dict(tree)
    out[path[0]] = leaf if len(path) == 1 else _with(tree[path[0]], path[1:],
                                                     leaf)
    return out


# a leaf of each block kind, and (deepseek) the MTP subtree's
_LEAVES = {"internlm2-1.8b": ("seg0", "attn", "wq"),
           "minicpm3-4b": ("seg0", "attn", "w_uk"),
           "qwen3-moe-30b-a3b": ("seg0", "mlp", "w_gate"),
           "deepseek-v3-671b": ("mtp", "layer", "attn", "w_uv")}


@pytest.mark.parametrize("arch", sorted(_LEAVES))
def test_reference_params_round_trip_and_errors(arch):
    """Every leaf carries across exactly (bf16 leaves as bf16, the router
    in float32), and back; a missing, surplus or misshapen leaf raises."""
    rcfg = dataclasses.replace(r_reg.get_smoke_config(arch),
                               param_dtype=jnp.bfloat16)
    pcfg = dataclasses.replace(p_reg.get_smoke_config(arch),
                               param_dtype=torch.bfloat16)
    rp = r_specs.materialize(jax.random.PRNGKey(0), r_lm.lm_specs(rcfg))
    ref = {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
           for k, v in rp.items()}
    pp = p_lm.from_reference_params(pcfg, ref, device="cpu")
    back = p_lm.to_reference_params(pp)
    flat_a = p_specs.tree_leaves(back)
    flat_b = p_specs.tree_leaves(ref)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(a, np.asarray(b, np.float32)), path
    for (path, t), (_, s) in zip(p_specs.tree_leaves(pp), p_specs.tree_leaves(
            p_lm.lm_specs(pcfg))):
        assert t.dtype == s.dtype, path
        want = (torch.float32 if path[-1] in ("router", "scale")
                else torch.bfloat16)
        assert t.dtype == want, path
    assert ("mtp" in ref) == pcfg.mtp
    leaf = _LEAVES[arch]
    with pytest.raises(ValueError, match="missing"):
        p_lm.from_reference_params(pcfg, _without(ref, ("head",)),
                                   device="cpu")
    with pytest.raises(ValueError, match="missing"):
        p_lm.from_reference_params(pcfg, _without(ref, leaf), device="cpu")
    with pytest.raises(ValueError, match="surplus"):
        p_lm.from_reference_params(pcfg, {**ref, "extra": np.zeros(1)},
                                   device="cpu")
    with pytest.raises(ValueError, match="surplus"):
        p_lm.from_reference_params(
            pcfg, _with(ref, leaf[:-1] + ("extra",), np.zeros(1)),
            device="cpu")
    with pytest.raises(ValueError, match="shape"):
        p_lm.from_reference_params(
            pcfg, {**ref, "final_norm": {"scale": np.zeros(3)}},
            device="cpu")
    with pytest.raises(ValueError, match="shape"):
        p_lm.from_reference_params(pcfg, _with(ref, leaf, np.zeros(3)),
                                   device="cpu")


@pytest.mark.parametrize("arch", UNPORTED_ARCHS)
def test_unported_families_raise(arch):
    cfg = p_reg.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        p_lm.lm_specs(cfg)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        p_lm.cache_specs(cfg, 1, 8)


# ---- specs -----------------------------------------------------------------------

def test_materialize_draws_the_reference_distributions():
    """``jax.random`` cannot be reproduced, so each normal leaf's sample std
    is held to a band around the reference's rule (fan-in of the first
    non-``layers`` axis, or ``scale``): within 5% for leaves of at least 4096
    elements; zeros and ones exact; dtype and shape as specified."""
    cfg = dataclasses.replace(p_reg.get_smoke_config("internlm2-1.8b"),
                              param_dtype=torch.bfloat16)
    specs = p_lm.lm_specs(cfg)
    params = p_specs.materialize(specs, torch.Generator().manual_seed(0),
                                 device="cpu")
    checked = 0
    for (path, s), (_, x) in zip(p_specs.tree_leaves(specs),
                                 p_specs.tree_leaves(params)):
        assert x.shape == s.shape and x.dtype == s.dtype, path
        if s.init == "ones":
            assert torch.equal(x, torch.ones_like(x))
        elif x.numel() >= 4096:
            std = x.float().std().item()
            want = p_specs.init_std(s)
            assert abs(std / want - 1) < 0.05, (path, std, want)
            checked += 1
    assert checked >= 8
    again = p_specs.materialize(specs, torch.Generator().manual_seed(0),
                                device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(p_specs.tree_leaves(params), p_specs.tree_leaves(again)))
    with pytest.raises(ValueError, match="generator"):
        p_specs.materialize(specs, device="cpu")


def test_materialize_draws_large_leaves_in_chunks(monkeypatch):
    """A leaf past ``MAX_DRAW`` elements is drawn in chunks of whole rows
    along its leading axes, in row order, from the one generator: each chunk
    equals a draw of that chunk's shape in turn. A stacked bf16 MoE leaf
    drawn so still holds the std band of the test above; a leaf within
    ``MAX_DRAW`` is one draw, as before."""
    cfg = dataclasses.replace(p_reg.get_smoke_config("qwen3-moe-30b-a3b"),
                              param_dtype=torch.bfloat16)
    specs = p_lm.lm_specs(cfg)
    leaf = specs["seg0"]["mlp"]["w_gate"]          # [2, 8, 64, 32]
    assert leaf.shape == (2, 8, 64, 32)
    # within the bound: one draw, the values of an unchunked draw
    small = p_specs.materialize({"w": leaf}, torch.Generator().manual_seed(5),
                                device="cpu")["w"]
    gen = torch.Generator().manual_seed(5)
    std = p_specs.init_std(leaf)
    assert torch.equal(small, (torch.randn(leaf.shape, generator=gen) * std)
                       .to(torch.bfloat16))
    # a chunk bound of 3 expert matrices: one layer's 8 in chunks of 3, 3, 2
    monkeypatch.setattr(p_specs, "MAX_DRAW", 3 * 64 * 32)
    got = p_specs.materialize({"w": leaf}, torch.Generator().manual_seed(5),
                              device="cpu")["w"]
    gen = torch.Generator().manual_seed(5)
    want = torch.cat([torch.randn((n, 64, 32), generator=gen) * std
                      for _ in range(2) for n in (3, 3, 2)])
    assert torch.equal(got, want.reshape(leaf.shape).to(torch.bfloat16))
    # rows of the last axis when one row is past the bound: 3-row chunks
    emb = specs["embed"]["table"]                 # [512, 64]
    monkeypatch.setattr(p_specs, "MAX_DRAW", 200)
    got = p_specs.materialize({"t": emb}, torch.Generator().manual_seed(6),
                              device="cpu")["t"]
    gen = torch.Generator().manual_seed(6)
    rows = [torch.randn((min(3, 512 - r), 64), generator=gen) * 0.02
            for r in range(0, 512, 3)]
    assert torch.equal(got, torch.cat(rows).to(torch.bfloat16))
    # the bands, with every leaf of the model in chunks of at most 1024
    monkeypatch.setattr(p_specs, "MAX_DRAW", 1024)
    params = p_specs.materialize(specs, torch.Generator().manual_seed(0),
                                 device="cpu")
    checked = 0
    for (path, s), (_, x) in zip(p_specs.tree_leaves(specs),
                                 p_specs.tree_leaves(params)):
        assert x.shape == s.shape and x.dtype == s.dtype, path
        if s.init == "normal" and x.numel() >= 4096:
            std = x.float().std().item()
            assert abs(std / p_specs.init_std(s) - 1) < 0.05, (path, std)
            checked += 1
    assert checked >= 8


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_spec_counts_and_axes_match_reference(arch):
    for smoke in (False, True):
        get = "get_smoke_config" if smoke else "get_config"
        rs = r_lm.lm_specs(getattr(r_reg, get)(arch))
        ps = p_lm.lm_specs(getattr(p_reg, get)(arch))
        assert p_specs.n_params(ps) == r_specs.n_params(rs)
        assert p_specs.param_bytes(ps) == r_specs.param_bytes(rs)
        assert p_specs.logical_axes(ps) == r_specs.logical_axes(rs)
        meta = p_specs.shape_structs(ps)
        assert meta["embed"]["table"].device.type == "meta"


# ---- registry ----------------------------------------------------------------------

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _fields(cfg):
    """Config fields as comparable values, reference dtypes mapped to torch;
    EncDecConfig's class attributes included."""
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


@pytest.mark.parametrize("arch", sorted(r_reg.ARCHS))
def test_registry_matches_reference(arch):
    assert sorted(p_reg.ARCHS) == sorted(r_reg.ARCHS)
    for get in ("get_config", "get_smoke_config"):
        rc, pc = getattr(r_reg, get)(arch), getattr(p_reg, get)(arch)
        assert type(pc).__name__ == type(rc).__name__
        assert _fields(pc) == _fields(rc)
        assert p_reg.active_param_count(pc) == r_reg.active_param_count(rc)


def test_shapes_cells_and_lookup_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in p_reg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_reg.SHAPES.items()}
    assert p_reg.LONG_OK == r_reg.LONG_OK
    assert p_reg.cells() == r_reg.cells()
    with pytest.raises(KeyError, match="unknown arch"):
        p_reg.get_config("gpt-5")


# ---- transformer_graph -------------------------------------------------------------

@pytest.mark.parametrize("which", ["internlm2", "qwen3-moe-smoke"])
def test_transformer_graph_matches_reference(which):
    if which == "internlm2":
        kw = dict(n_shards=2, seq_len=128)
        rg = r_tgraph("internlm2-1.8b", **kw)
        pg = p_tgraph("internlm2-1.8b", **kw)
    else:
        rg = r_tgraph(r_reg.get_smoke_config("qwen3-moe-30b-a3b"), n_shards=2,
                      seq_len=64)
        pg = p_tgraph(p_reg.get_smoke_config("qwen3-moe-30b-a3b"), n_shards=2,
                      seq_len=64)
    assert pg.names == rg.names
    assert np.array_equal(pg.adj, rg.adj)
    assert np.array_equal(pg.compute, rg.compute)
    assert np.array_equal(pg.memory, rg.memory)
