"""The port's enc-dec model (seamless-m4t's backbone) against the JAX
package's, on the CPU.

Inputs are made with numpy and handed to both packages; the reference's
weights are carried across with ``encdec.from_reference_params``. The
smoke config is bfloat16 in both packages (``dtype`` and ``param_dtype``
are class attributes), and the two round bfloat16 in other places, so the
tight checks run float32 subclasses of both configs: encoder output and
logits within rtol 1e-5 / atol 1e-5, the loss within rtol 1e-5 and every
gradient within rtol 1e-4 / atol 1e-6 (the same float32 sums in another
order). The bfloat16 smoke config is held at the bound stated by its test.
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
from repro.models import encdec as r_encdec  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models import specs as r_specs  # noqa: E402
from repro_torch.configs import registry as p_reg  # noqa: E402
from repro_torch.models import encdec as p_encdec  # noqa: E402
from repro_torch.models import layers as p_layers  # noqa: E402
from repro_torch.models import specs as p_specs  # noqa: E402

ARCH = "seamless-m4t-medium"
B, S_ENC, S_DEC = 2, 16, 12


class _RefF32(r_encdec.EncDecConfig):
    param_dtype = jnp.float32
    dtype = jnp.float32


class _PortF32(p_encdec.EncDecConfig):
    param_dtype = torch.float32
    dtype = torch.float32


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          path + (k,))]
    return [(path, tree)]


def _f32(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _configs(f32=True, **kw):
    """The smoke config of both packages (float32 subclasses where ``f32``)
    with the fields in ``kw`` replaced."""
    rcfg = r_reg.get_smoke_config(ARCH)
    pcfg = p_reg.get_smoke_config(ARCH)
    if f32:
        rcfg = _RefF32(**{f.name: getattr(rcfg, f.name)
                          for f in dataclasses.fields(rcfg)})
        pcfg = _PortF32(**{f.name: getattr(pcfg, f.name)
                           for f in dataclasses.fields(pcfg)})
    return dataclasses.replace(rcfg, **kw), dataclasses.replace(pcfg, **kw)


def _inputs(rcfg, pcfg, seed=0, s_enc=S_ENC, s_dec=S_DEC):
    """Seeded frames, tokens and labels (-1 = pad), the reference's seeded
    weights and their copy in the port."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, s_enc, rcfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, rcfg.vocab, (B, s_dec)).astype(np.int32)
    labels = rng.integers(-1, rcfg.vocab, (B, s_dec)).astype(np.int32)
    rp = r_specs.materialize(jax.random.PRNGKey(seed + 1),
                             r_encdec.encdec_specs(rcfg))
    pp = p_encdec.from_reference_params(pcfg, _np_tree(rp), device="cpu")
    return frames, tokens, labels, rp, pp


@pytest.mark.parametrize("remat", ["none", "full"])
def test_encode_and_decode_train_match_reference(remat):
    rcfg, pcfg = _configs(remat=remat)
    frames, tokens, _, rp, pp = _inputs(rcfg, pcfg)
    r_enc = r_encdec.encode(rp, rcfg, jnp.asarray(frames))
    r_logits = r_encdec.decode_train(rp, rcfg, jnp.asarray(tokens), r_enc)
    with torch.no_grad():
        p_enc = p_encdec.encode(pp, pcfg, torch.tensor(frames))
        p_logits = p_encdec.decode_train(pp, pcfg, torch.tensor(tokens).long(),
                                         p_enc)
    assert p_enc.dtype == p_logits.dtype == torch.float32
    assert tuple(p_logits.shape) == (B, S_DEC, pcfg.vocab)
    np.testing.assert_allclose(p_enc.numpy(), np.asarray(r_enc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(p_logits.numpy(), np.asarray(r_logits),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_encdec_loss_and_grads_match_reference(chunk, remat):
    """``encdec_loss`` and every gradient against ``jax.value_and_grad``;
    with ``logit_chunk`` 8 the CE runs over chunks under checkpoint."""
    rcfg, pcfg = _configs(logit_chunk=chunk, remat=remat)
    frames, tokens, labels, rp, pp = _inputs(rcfg, pcfg, s_dec=16)

    def r_loss(p):
        return r_encdec.encdec_loss(p, rcfg, jnp.asarray(frames),
                                    jnp.asarray(tokens), jnp.asarray(labels))

    (r_l, r_m), r_g = jax.jit(jax.value_and_grad(r_loss, has_aux=True))(rp)
    leaves = [t.requires_grad_() for _, t in _leaves(pp)]
    p_l, p_m = p_encdec.encdec_loss(pp, pcfg, torch.tensor(frames),
                                    torch.tensor(tokens).long(),
                                    torch.tensor(labels).long())
    p_g = torch.autograd.grad(p_l, leaves)
    np.testing.assert_allclose(float(p_l.detach()), float(r_l), rtol=1e-5)
    for k in ("ce", "aux", "mtp"):
        np.testing.assert_allclose(float(p_m[k].detach()), float(r_m[k]),
                                   rtol=1e-5, atol=1e-7)
    for (path, want), got in zip(_leaves(_np_tree(r_g)), p_g):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6,
                                   err_msg=str(path))


@pytest.mark.parametrize("enc_len", [S_ENC, 10])
def test_prefill_and_decode_match_reference(enc_len):
    """Prefill over a 10-token prompt, then two decode steps, against the
    reference's, logits and every cache entry; and against the port's own
    ``decode_train`` over the same tokens. A cache made for another source
    length (``enc_len`` 10 for 16 frames) takes the source's cross K/V as
    the reference's does: ``xk``/``xv`` are replaced by the source's."""
    rcfg, pcfg = _configs()
    frames, tokens, _, rp, pp = _inputs(rcfg, pcfg)
    s, mx = S_DEC, S_DEC + 2
    rc = r_specs.materialize(jax.random.PRNGKey(0),
                             r_encdec.cache_specs(rcfg, B, mx, enc_len))
    pc = p_specs.materialize(p_encdec.cache_specs(pcfg, B, mx, enc_len),
                             device="cpu")
    pt = torch.tensor(tokens).long()
    r_logits, rc = r_encdec.prefill(rp, rcfg, jnp.asarray(frames),
                                    jnp.asarray(tokens[:, :s - 2]), rc)
    with torch.no_grad():
        p_logits, out = p_encdec.prefill(pp, pcfg, torch.tensor(frames),
                                         pt[:, :s - 2], pc)
        assert out is pc
        full = p_encdec.decode_train(
            pp, pcfg, pt, p_encdec.encode(pp, pcfg, torch.tensor(frames)))
        seen = [(p_logits, r_logits, s - 3)]
        for i in range(s - 2, s):
            r_logits, rc = r_encdec.decode_step(rp, rcfg, rc,
                                                jnp.asarray(tokens[:, i:i + 1]),
                                                jnp.int32(i))
            p_logits, out = p_encdec.decode_step(pp, pcfg, pc, pt[:, i:i + 1],
                                                 i)
            assert out is pc
            seen.append((p_logits, r_logits, i))
    for got, want, i in seen:
        assert tuple(got.shape) == (B, 1, pcfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=1e-5, atol=2e-5)
    assert tuple(pc["dec"]["xk"].shape) == (pcfg.n_dec_layers, B, S_ENC,
                                            pcfg.n_kv_heads, pcfg.d_head)
    for (path, got), (_, want) in zip(_leaves(pc), _leaves(_np_tree(rc))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=str(path))


@pytest.mark.parametrize("enc_len", [S_ENC, 10])
def test_prefill_refuses_a_one_token_prompt(enc_len):
    """A one-token prompt: the reference's prefill fails (its self-attention
    takes S == 1 with a cache for a decode step, which has no position),
    and the port's raises ``ValueError`` before it touches the cache."""
    rcfg, pcfg = _configs()
    frames, tokens, _, rp, pp = _inputs(rcfg, pcfg)
    rc = r_specs.materialize(jax.random.PRNGKey(0),
                             r_encdec.cache_specs(rcfg, B, 3, enc_len))
    with pytest.raises(Exception):
        r_encdec.prefill(rp, rcfg, jnp.asarray(frames),
                         jnp.asarray(tokens[:, :1]), rc)
    pc = p_specs.materialize(p_encdec.cache_specs(pcfg, B, 3, enc_len),
                             device="cpu")
    before = [t.clone() for _, t in _leaves(pc)]
    with pytest.raises(ValueError, match="at least 2 tokens"):
        p_encdec.prefill(pp, pcfg, torch.tensor(frames),
                         torch.tensor(tokens[:, :1]).long(), pc)
    assert all(torch.equal(a, t) for a, (_, t) in zip(before, _leaves(pc)))


# bfloat16 smoke config, port against reference: the two round bf16
# activations in other places, one rounding at 2^-9 relative each, through
# 2 + 2 layers and bf16 logits. Over the inputs of seeds 0-3: the loss
# within 6.2e-6 relative at seed 0 (at most 2.4e-5), the logits within
# relative L2 7.4e-3 (6.6e-3 to 7.4e-3); held at 1e-4 and 2e-2.
BF16_LOSS_RTOL = 1e-4
BF16_LOGITS_REL = 2e-2


def test_bf16_smoke_matches_reference():
    rcfg, pcfg = _configs(f32=False)
    assert pcfg.dtype == pcfg.param_dtype == torch.bfloat16
    frames, tokens, labels, rp, pp = _inputs(rcfg, pcfg, s_dec=16)
    r_l, _ = r_encdec.encdec_loss(rp, rcfg, jnp.asarray(frames),
                                  jnp.asarray(tokens), jnp.asarray(labels))
    r_logits = r_encdec.decode_train(
        rp, rcfg, jnp.asarray(tokens),
        r_encdec.encode(rp, rcfg, jnp.asarray(frames)))
    with torch.no_grad():
        p_l, _ = p_encdec.encdec_loss(pp, pcfg, torch.tensor(frames),
                                      torch.tensor(tokens).long(),
                                      torch.tensor(labels).long())
        p_logits = p_encdec.decode_train(
            pp, pcfg, torch.tensor(tokens).long(),
            p_encdec.encode(pp, pcfg, torch.tensor(frames)))
    assert p_logits.dtype == torch.bfloat16
    np.testing.assert_allclose(float(p_l), float(r_l), rtol=BF16_LOSS_RTOL)
    want = _f32(r_logits)
    rel = np.linalg.norm(_f32(p_logits) - want) / np.linalg.norm(want)
    assert rel <= BF16_LOGITS_REL, rel


def _with(tree, path, value):
    out = dict(tree)
    out[path[0]] = value if len(path) == 1 else _with(tree[path[0]],
                                                      path[1:], value)
    return out


def _without(tree, path):
    out = dict(tree)
    if len(path) == 1:
        del out[path[0]]
    else:
        out[path[0]] = _without(tree[path[0]], path[1:])
    return out


def test_reference_params_round_trip_and_errors():
    """Every leaf carries across exactly in its spec's dtype (bf16 but the
    norm scales) and back; a missing, surplus or misshapen leaf raises."""
    rcfg, pcfg = _configs(f32=False)
    rp = _np_tree(r_specs.materialize(jax.random.PRNGKey(0),
                                      r_encdec.encdec_specs(rcfg)))
    pp = p_encdec.from_reference_params(pcfg, rp, device="cpu")
    back = p_encdec.to_reference_params(pp)
    flat_a, flat_b = p_specs.tree_leaves(back), p_specs.tree_leaves(rp)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert np.array_equal(a, np.asarray(b, np.float32)), path
    for (path, t), (_, s) in zip(p_specs.tree_leaves(pp), p_specs.tree_leaves(
            p_encdec.encdec_specs(pcfg))):
        assert t.dtype == s.dtype == (torch.float32 if path[-1] == "scale"
                                      else torch.bfloat16), path
    leaf = ("dec", "cross_attn", "wk")
    with pytest.raises(ValueError, match="missing"):
        p_encdec.from_reference_params(pcfg, _without(rp, leaf),
                                       device="cpu")
    with pytest.raises(ValueError, match="missing"):
        p_encdec.from_reference_params(pcfg, _without(rp, ("enc_norm",)),
                                       device="cpu")
    with pytest.raises(ValueError, match="surplus"):
        p_encdec.from_reference_params(pcfg, _with(rp, ("enc", "extra"),
                                                   np.zeros(1)),
                                       device="cpu")
    with pytest.raises(ValueError, match="shape"):
        p_encdec.from_reference_params(pcfg, _with(rp, leaf, np.zeros(3)),
                                       device="cpu")
    # an LM tree is not an enc-dec tree
    with pytest.raises(ValueError, match="missing"):
        p_encdec.from_reference_params(pcfg, _without(rp, ("enc",)),
                                       device="cpu")


@pytest.mark.parametrize("s,skv", [(17, 17), (64, 64), (160, 160),
                                   (64, 96), (1, 40), (40, 16)])
def test_noncausal_blockwise_attention_matches_reference(s, skv):
    """Non-causal attention (the encoder at ``S_q == S_kv``, cross-attention
    at any ``S_kv``) and its gradients against the reference's
    ``blockwise_attention`` and ``jax.vjp``, within atol 2e-5 (float32)."""
    rng = np.random.default_rng(s * 1000 + skv)
    q = (rng.standard_normal((2, s, 4, 16)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((2, skv, 4, 16)) * 0.4).astype(np.float32)
    v = rng.standard_normal((2, skv, 4, 16)).astype(np.float32)
    g = rng.standard_normal((2, s, 4, 16)).astype(np.float32)

    def ref(q, k, v):
        return r_layers.blockwise_attention(q, k, v, causal=False,
                                            q_chunk=32, k_chunk=32)

    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    r_grads = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = p_layers.blockwise_attention(*leaves, causal=False, q_chunk=32,
                                       k_chunk=32)
    p_grads = torch.autograd.grad(got, leaves, torch.tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    for a, b in zip(p_grads, r_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)
