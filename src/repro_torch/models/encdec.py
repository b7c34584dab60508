"""Encoder-decoder transformer (``repro.models.encdec``, the seamless-m4t
backbone).

The speech/text frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``[B, S_enc, d]``. The encoder is
bidirectional; decoder layers are causal self-attention, cross-attention
over the encoded source and a SwiGLU MLP. Serving caches hold the decoder's
self-attention K/V and the cross-attention K/V of the encoded source.

On the card, the encoder's attention and cross-attention with ``S_dec ==
S_enc`` run the flash kernels non-causal, and the decoder's self-attention
runs them causal (``layers.blockwise_attention``); cross-attention over a
source of another length (decode's one-token query, a prompt shorter than
the source) runs the reference's chunked algorithm. Layers are
rematerialised as ``cfg.remat`` says, with ``lm._maybe_remat``; the
reference's ``lax.scan`` over stacked layers is ``loop.scan``. Caches are
written in place and the same dicts are returned. As in the reference, the
dtype and window attributes are class attributes, not fields.
"""
from __future__ import annotations

import dataclasses

import torch

from . import layers as L
from .lm import _maybe_remat, _stack, chunked_ce
from .lm import to_reference_params  # noqa: F401  (the same for both)
from .loop import scan
from .specs import ParamSpec, load_reference, param, tree_map
from ..sharding.rules import (activation_constraint, gather_params,
                              settle_grad)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    n_enc_layers: int
    n_dec_layers: int
    rope_theta: float = 1e4
    param_dtype = torch.bfloat16
    dtype = torch.bfloat16
    q_chunk: int = 1024
    k_chunk: int = 1024
    remat: str = "none"
    window = None
    logit_chunk: int = 0
    segments = ()          # LM-compat fields used by shared helpers
    n_layers_prop = None

    @property
    def n_layers(self):
        return self.n_enc_layers + self.n_dec_layers


# ------------------------------------------------------------------ specs ----

def _enc_layer_specs(cfg: EncDecConfig):
    return {
        "norm1": L.rmsnorm_specs(cfg.d_model),
        "attn": L.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, cfg.param_dtype),
        "norm2": L.rmsnorm_specs(cfg.d_model),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, cfg.param_dtype),
    }


def _dec_layer_specs(cfg: EncDecConfig):
    return {
        "norm1": L.rmsnorm_specs(cfg.d_model),
        "self_attn": L.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.d_head, cfg.param_dtype),
        "norm_x": L.rmsnorm_specs(cfg.d_model),
        "cross_attn": L.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.d_head, cfg.param_dtype),
        "norm2": L.rmsnorm_specs(cfg.d_model),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, cfg.param_dtype),
    }


def encdec_specs(cfg: EncDecConfig):
    return {
        "embed": L.embed_specs(cfg.vocab, cfg.d_model, cfg.param_dtype),
        "enc": _stack(_enc_layer_specs(cfg), cfg.n_enc_layers),
        "dec": _stack(_dec_layer_specs(cfg), cfg.n_dec_layers),
        "enc_norm": L.rmsnorm_specs(cfg.d_model),
        "final_norm": L.rmsnorm_specs(cfg.d_model),
        "head": param((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                      dtype=cfg.param_dtype, scale=0.02),
    }


def cache_specs(cfg: EncDecConfig, batch: int, max_len: int, enc_len: int):
    kv = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    ax = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    ckv = (batch, enc_len, cfg.n_kv_heads, cfg.d_head)
    per_dec = {
        "k": ParamSpec(kv, cfg.dtype, ax, "zeros"),
        "v": ParamSpec(kv, cfg.dtype, ax, "zeros"),
        "xk": ParamSpec(ckv, cfg.dtype, ax, "zeros"),
        "xv": ParamSpec(ckv, cfg.dtype, ax, "zeros"),
    }
    return {"dec": _stack(per_dec, cfg.n_dec_layers)}


# ---------------------------------------------------------------- forward ----

def _attn_qkv(p, x, positions, cfg: EncDecConfig, rope: bool = True):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _layer(stack, i: int):
    """Layer ``i`` of a stacked parameter (or cache) tree."""
    return tree_map(lambda a: a[i], stack)


def _embed(params, cfg: EncDecConfig, tokens):
    """The decoder's token embeddings, batch-sharded on a mesh (the
    vocab-sharded lookup's masked partial sum is reduced here)."""
    return settle_grad(activation_constraint(
        L.embed(gather_params(params["embed"]), tokens).to(cfg.dtype)))


def encode(params, cfg: EncDecConfig, frames):
    """frames [B,S_enc,d] -> encoded [B,S_enc,d] (bidirectional)."""
    x = frames.to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def layer(x, p):
        p = gather_params(p)
        h = L.rmsnorm(p["norm1"], x)
        q, k, v = _attn_qkv(p["attn"], h, positions, cfg)
        y = L.blockwise_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                                  k_chunk=cfg.k_chunk)
        x = x + activation_constraint(
            torch.einsum("bshk,hkd->bsd", y, p["attn"]["wo"]))
        return activation_constraint(
            x + activation_constraint(L.mlp(p["mlp"],
                                            L.rmsnorm(p["norm2"], x))))

    def step(x, i):
        p = _layer(params["enc"], i)
        return _maybe_remat(lambda xx: layer(xx, p), cfg)(x), None

    x, _ = scan(step, x, cfg.n_enc_layers)
    return L.rmsnorm(gather_params(params["enc_norm"]), x)


def _dec_layer(p, cfg: EncDecConfig, x, enc_out, positions, cache, pos):
    """One decoder layer; ``cache`` None (train) or this layer's cache dict
    (prefill, decode), written in place. In decode (``S == 1`` with a
    cache) cross-attention reads ``xk``/``xv`` from the cache; otherwise it
    projects ``enc_out``, and a prefill stores that projection in the
    cache (``prefill`` sizes ``xk``/``xv`` to the source first). Returns
    ``(x, cache)``."""
    p = gather_params(p)
    self_cache = None if cache is None else {"k": cache["k"],
                                             "v": cache["v"]}
    h = L.rmsnorm(p["norm1"], x)
    y, _ = L.attention_block(p["self_attn"], h, positions, cfg, self_cache,
                             pos)
    x = x + activation_constraint(y)
    # cross attention
    h = L.rmsnorm(p["norm_x"], x)
    q = torch.einsum("bsd,dhk->bshk", h, p["cross_attn"]["wq"])
    if cache is not None and x.shape[1] == 1:
        xk, xv = cache["xk"], cache["xv"]
    else:
        xk = torch.einsum("bsd,dhk->bshk", enc_out, p["cross_attn"]["wk"])
        xv = torch.einsum("bsd,dhk->bshk", enc_out, p["cross_attn"]["wv"])
        if cache is not None:
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
    y = L.blockwise_attention(q, xk, xv, causal=False, q_chunk=cfg.q_chunk,
                              k_chunk=cfg.k_chunk)
    x = x + activation_constraint(
        torch.einsum("bshk,hkd->bsd", y, p["cross_attn"]["wo"]))
    x = activation_constraint(
        x + activation_constraint(L.mlp(p["mlp"], L.rmsnorm(p["norm2"], x))))
    return x, cache


def decode_train_hidden(params, cfg: EncDecConfig, tokens, enc_out):
    """The decoder's final-normed hidden states ``[B, S, d]`` over the whole
    of ``tokens`` (teacher forcing)."""
    x = _embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    def step(x, i):
        p = _layer(params["dec"], i)
        return _maybe_remat(
            lambda xx, ee: _dec_layer(p, cfg, xx, ee, positions, None,
                                      None)[0], cfg)(x, enc_out), None

    x, _ = scan(step, x, cfg.n_dec_layers)
    return L.rmsnorm(gather_params(params["final_norm"]), x)


def decode_train(params, cfg: EncDecConfig, tokens, enc_out):
    """Logits ``[B, S, V]`` over the whole of ``tokens``."""
    return (decode_train_hidden(params, cfg, tokens, enc_out)
            @ gather_params(params["head"]))


# ------------------------------------------------------------------- loss ----

def encdec_loss(params, cfg: EncDecConfig, frames, tokens, labels):
    """The mean token CE of the decoder over ``labels`` (-1 = pad), chunked
    as ``lm.lm_loss`` chunks it when ``cfg.logit_chunk`` divides the
    length. Returns ``(loss, {"ce", "aux", "mtp"})``, aux and mtp 0."""
    enc_out = encode(params, cfg, frames)
    hidden = decode_train_hidden(params, cfg, tokens, enc_out)
    labels = torch.as_tensor(labels, device=hidden.device)
    ce = chunked_ce(lambda h: h @ gather_params(params["head"]), hidden,
                    labels, cfg.logit_chunk)
    zero = torch.zeros((), device=hidden.device)
    return ce, {"ce": ce, "aux": zero, "mtp": zero}


# ---------------------------------------------------------------- serving ----

def _run_cached(params, cfg: EncDecConfig, cache, x, enc_out, positions,
                pos):
    def step(x, i):
        return _dec_layer(_layer(params["dec"], i), cfg, x, enc_out,
                          positions, _layer(cache["dec"], i), pos)[0], None

    x, _ = scan(step, x, cfg.n_dec_layers)
    return L.rmsnorm(gather_params(params["final_norm"]), x)


def prefill(params, cfg: EncDecConfig, frames, tokens, cache):
    """Encode ``frames``, fill the caches over the decoder prompt
    ``tokens`` and return the last position's logits ``[B, 1, V]`` and the
    (same, filled) cache. As in the reference, the cross-attention K/V of
    the source replace ``xk``/``xv`` whatever length the cache was made
    for: where it differs, the two cache entries are new tensors of the
    source's length. Raises ``ValueError`` on a one-token prompt: the
    self-attention would take it for a decode step without a position, as
    the reference's does (its prefill fails there)."""
    if tokens.shape[1] < 2:
        raise ValueError(f"prefill needs a prompt of at least 2 tokens, "
                         f"got {tokens.shape[1]}")
    enc_out = encode(params, cfg, frames)
    dec = cache["dec"]
    shape = (cfg.n_dec_layers,) + tuple(enc_out.shape[:2]) + (
        cfg.n_kv_heads, cfg.d_head)
    for name in ("xk", "xv"):
        if tuple(dec[name].shape) != shape:
            dec[name] = torch.zeros(shape, dtype=dec[name].dtype,
                                    device=dec[name].device)
    x = _embed(params, cfg, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_cached(params, cfg, cache, x, enc_out, positions, None)
    return x[:, -1:] @ gather_params(params["head"]), cache


def decode_step(params, cfg: EncDecConfig, cache, tokens, pos: int):
    """One decode step. tokens [B,1]; pos: the current index (int).
    Returns ``(logits [B, 1, V], cache)``."""
    pos = int(pos)
    x = _embed(params, cfg, tokens)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    x = _run_cached(params, cfg, cache, x, None, positions, pos)
    return x @ gather_params(params["head"]), cache


# --------------------------------------------------- reference parameters ----

def from_reference_params(cfg: EncDecConfig, params, device=None):
    """The reference's enc-dec parameters (nested dicts of numpy arrays, e.g.
    ``materialize(key, encdec_specs(cfg))``) as the port's tensors on
    ``device`` (``None``: the card), each in its spec's dtype. Raises on a
    missing or surplus leaf and on a wrong shape."""
    return load_reference(encdec_specs(cfg), params, device)
