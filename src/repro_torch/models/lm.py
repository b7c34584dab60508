"""Generic decoder LM over block segments (``repro.models.lm``): the
serving forward and the training loss.

A model is a tuple of :class:`Segment`s (block kind, mlp kind, count).
Consecutive layers of a segment share structure, so their parameters are
stacked on a leading "layers" axis, as in the reference; the reference's
``lax.scan`` over that axis is ``models.loop.scan`` here, a Python loop
that a dry run's trace folds.

Entry points:

* ``forward``: logits over full sequences;
* ``prefill``: last-position logits, filling the caches;
* ``decode_step``: one token against the caches;
* ``cache_specs``: the ParamSpec tree of the serving caches;
* ``lm_loss``: the mean token cross-entropy, chunked over the sequence when
  ``cfg.logit_chunk`` divides it, each chunk's head and CE under
  ``torch.utils.checkpoint`` as the reference wraps them in
  ``jax.checkpoint``, plus the MoE auxiliary loss and DeepSeek's
  multi-token prediction (MTP) loss.

Layers are rematerialised as ``cfg.remat`` says (``_maybe_remat``): ``full``
checkpoints each layer, ``dots`` saves only the outputs of matrix products
with no batch dimension (the reference's
``dots_with_no_batch_dims_saveable``). Every use of parameters goes through
``sharding.rules.gather_params`` (ZeRO-3's gather under ``FSDP_RULES``, an
identity otherwise), a layer's inside its rematerialised body.

Ported: attention and MLA blocks with a dense (SwiGLU), MoE or no MLP,
Mamba2 and xLSTM (mLSTM, sLSTM) blocks, and zamba2's hybrid shared
attention block, which covers every decoder LM of the registry, and
DeepSeek's MTP head (depth 1) in the loss. Caches are updated in place (the
reference donates them) and the same dicts are returned.

Hybrid models (zamba2) run one shared-parameter attention + MLP block over
``concat(x, emb)`` after every ``hybrid_period`` Mamba2 layers, ``emb`` the
embedding output; each application has its own slice of the ``"shared"``
K/V caches and is rematerialised on its own under ``cfg.remat``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import checkpoint as _ckpt

from . import layers as L
from . import mamba2 as M
from . import xlstm as X
from .loop import recomputed, scan
from .mla import MLAConfig, mla_block, mla_specs
from .moe import MoEConfig, moe_apply, moe_specs
from .specs import ParamSpec, load_reference, param, tree_map
from ..obs import profile_range
from ..sharding.rules import (activation_constraint, carry_context,
                              gather_params, settle_grad, unshard_dim)


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str              # attn | mla | mamba2 | mlstm | slstm
    mlp: str               # dense | moe | none
    count: int


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    segments: tuple
    window: int | None = None          # sliding-window attention
    rope_theta: float = 1e4
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: M.SSMConfig | None = None
    xlstm: X.XLSTMConfig | None = None
    hybrid_period: int = 0             # zamba2: shared attn every N layers
    hybrid_d_attn: int = 0             # shared-attn width (2*d for zamba2)
    mtp: bool = False                  # deepseek multi-token prediction head
    mtp_weight: float = 0.3
    param_dtype: Any = torch.bfloat16
    dtype: Any = torch.bfloat16
    q_chunk: int = 1024
    k_chunk: int = 1024
    remat: str = "none"                # none | full | dots
    seq_shard_attn: bool = False       # heads not divisible by model axis
    repeat_kv: bool = False            # GQA kv heads not divisible: repeat
    prefer_dp: bool = False            # small models: batch over data x model
    logit_chunk: int = 0               # chunked CE (0 = off)
    prefix_len: int = 0                # vlm: image tokens prepended
    tie_embeddings: bool = False

    @property
    def n_layers(self) -> int:
        return sum(s.count for s in self.segments)


# ------------------------------------------------------------------ specs ----

def _stack(specs, count: int):
    return tree_map(lambda s: ParamSpec((count,) + s.shape, s.dtype,
                                        ("layers",) + s.axes, s.init,
                                        s.scale), specs)


def _layer_specs(cfg: LMConfig, seg: Segment):
    d, dt = cfg.d_model, cfg.param_dtype
    out = {"norm1": L.rmsnorm_specs(d)}
    if seg.kind == "attn":
        out["attn"] = L.attn_specs(d, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.d_head, dt)
    elif seg.kind == "mla":
        out["attn"] = mla_specs(d, cfg.n_heads, cfg.mla, dt)
    elif seg.kind == "mamba2":
        out["mix"] = M.mamba_specs(d, cfg.ssm, dt)
    elif seg.kind == "mlstm":
        out["mix"] = X.mlstm_specs(d, cfg.xlstm, dt)
    elif seg.kind == "slstm":
        out["mix"] = X.slstm_specs(d, cfg.xlstm, dt)
    else:
        raise ValueError(seg.kind)
    if seg.mlp == "dense":
        out["norm2"] = L.rmsnorm_specs(d)
        out["mlp"] = L.mlp_specs(d, cfg.d_ff, dt)
    elif seg.mlp == "moe":
        out["norm2"] = L.rmsnorm_specs(d)
        out["mlp"] = moe_specs(d, cfg.moe, dt)
    return out


def _shared_dims(cfg: LMConfig):
    """The shared block's attention width and head dim (``hybrid_d_attn //
    n_heads``, not ``cfg.d_head``)."""
    da = cfg.hybrid_d_attn or 2 * cfg.d_model
    return da, da // cfg.n_heads


def _shared_block_specs(cfg: LMConfig):
    """Zamba2-style shared attention+MLP block over concat(x, emb)."""
    da, dh = _shared_dims(cfg)
    return {
        "norm1": L.rmsnorm_specs(da),
        "attn": {
            "wq": param((da, cfg.n_heads, dh), ("embed", "heads", "head_dim"),
                        dtype=cfg.param_dtype),
            "wk": param((da, cfg.n_kv_heads, dh), ("embed", "kv_heads",
                                                   "head_dim"),
                        dtype=cfg.param_dtype),
            "wv": param((da, cfg.n_kv_heads, dh), ("embed", "kv_heads",
                                                   "head_dim"),
                        dtype=cfg.param_dtype),
            "wo": param((cfg.n_heads, dh, cfg.d_model),
                        ("heads", "head_dim", "embed"), dtype=cfg.param_dtype),
        },
        "norm2": L.rmsnorm_specs(cfg.d_model),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, cfg.param_dtype),
    }


def lm_specs(cfg: LMConfig):
    out = {"embed": L.embed_specs(cfg.vocab, cfg.d_model, cfg.param_dtype),
           "final_norm": L.rmsnorm_specs(cfg.d_model)}
    for i, seg in enumerate(cfg.segments):
        out[f"seg{i}"] = _stack(_layer_specs(cfg, seg), seg.count)
    if cfg.hybrid_period:
        out["shared"] = _shared_block_specs(cfg)
    if not cfg.tie_embeddings:
        out["head"] = param((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                            dtype=cfg.param_dtype, scale=0.02)
    if cfg.mtp:
        out["mtp"] = {
            "norm_h": L.rmsnorm_specs(cfg.d_model),
            "norm_e": L.rmsnorm_specs(cfg.d_model),
            "proj": param((2 * cfg.d_model, cfg.d_model), ("mlp", "embed"),
                          dtype=cfg.param_dtype),
            "layer": _layer_specs(cfg, Segment(
                "mla" if cfg.mla else "attn", "dense", 1)),
        }
    return out


# ----------------------------------------------------------------- caches ----

def _layer_cache_specs(cfg: LMConfig, seg: Segment, batch: int,
                       max_len: int):
    d = cfg.d_model
    if seg.kind == "mla":
        m = cfg.mla
        return {
            "ckv": ParamSpec((batch, max_len, m.kv_lora_rank), cfg.dtype,
                             ("cache_batch", "cache_seq", "kv_lora"),
                             "zeros"),
            "kr": ParamSpec((batch, max_len, m.qk_rope_dim), cfg.dtype,
                            ("cache_batch", "cache_seq", "head_dim"),
                            "zeros"),
        }
    if seg.kind == "mamba2":
        s = cfg.ssm
        h = M.n_heads_ssm(d, s)
        conv_ch = M.d_inner(d, s) + 2 * s.n_groups * s.d_state
        return {
            "h": ParamSpec((batch, h, s.head_dim, s.d_state), torch.float32,
                           ("cache_batch", "heads", "head_dim", "ssm_state"),
                           "zeros"),
            "conv": ParamSpec((batch, s.d_conv - 1, conv_ch), cfg.dtype,
                              ("cache_batch", "conv_k", "mlp"), "zeros"),
        }
    if seg.kind == "mlstm":
        xc = cfg.xlstm
        dh = int(d * xc.up_factor) // xc.n_heads
        ax = ("cache_batch", "heads", "head_dim", "head_dim2")
        return {"c": ParamSpec((batch, xc.n_heads, dh, dh), torch.float32, ax,
                               "zeros"),
                "n": ParamSpec((batch, xc.n_heads, dh), torch.float32, ax[:3],
                               "zeros"),
                "m": ParamSpec((batch, xc.n_heads), torch.float32, ax[:2],
                               "zeros")}
    if seg.kind == "slstm":
        xc = cfg.xlstm
        ax = ("cache_batch", "heads", "head_dim")
        return {k: ParamSpec((batch, xc.n_heads, d // xc.n_heads),
                             torch.float32, ax, "zeros")
                for k in ("h", "c", "n", "m")}
    if seg.kind != "attn":
        raise ValueError(seg.kind)
    shp = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    axes = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": ParamSpec(shp, cfg.dtype, axes, "zeros"),
            "v": ParamSpec(shp, cfg.dtype, axes, "zeros")}


def cache_specs(cfg: LMConfig, batch: int, max_len: int):
    """The serving caches. mLSTM and sLSTM stabilisers ``m`` start at 0, as
    in the reference (a fresh scan starts them at -1e30)."""
    out = {f"seg{i}": _stack(_layer_cache_specs(cfg, seg, batch, max_len),
                             seg.count)
           for i, seg in enumerate(cfg.segments)}
    if cfg.hybrid_period:
        _, dh = _shared_dims(cfg)
        shp = (cfg.n_layers // cfg.hybrid_period, batch, max_len,
               cfg.n_kv_heads, dh)
        axes = ("layers", "cache_batch", "cache_seq", "kv_heads", "head_dim")
        out["shared"] = {"k": ParamSpec(shp, cfg.dtype, axes, "zeros"),
                         "v": ParamSpec(shp, cfg.dtype, axes, "zeros")}
    return out


# ---------------------------------------------------------------- forward ----

def _layer_fwd(p, seg: Segment, cfg: LMConfig, x, positions, cache, pos):
    """One layer: ``(x, aux, cache)``, aux the MoE's load-balance loss
    (float32; None for other MLPs, whose aux is 0). Under
    ``torch.profiler`` it is the range ``repro_torch.model.layer``, opened
    again when the layer is recomputed."""
    with profile_range("model.layer"):
        return _layer_body(p, seg, cfg, x, positions, cache, pos)


def _layer_body(p, seg: Segment, cfg: LMConfig, x, positions, cache, pos):
    h = L.rmsnorm(p["norm1"], x)
    if seg.kind == "attn":
        y, new_cache = L.attention_block(p["attn"], h, positions, cfg, cache,
                                         pos)
    elif seg.kind == "mla":
        y, new_cache = mla_block(p["attn"], h, positions, cfg, cache, pos)
    elif seg.kind == "mamba2":
        y, new_cache = M.mamba_block(p["mix"], h, cfg, cfg.ssm, cache)
    elif seg.kind == "mlstm":
        y, new_cache = X.mlstm_block(p["mix"], h, cfg.xlstm, cache)
    elif seg.kind == "slstm":
        y, new_cache = X.slstm_block(p["mix"], h, cfg.xlstm, cache)
    else:
        raise ValueError(seg.kind)
    x = x + _constrain_batch(y)
    aux = None
    if seg.mlp == "dense":
        x = x + _constrain_batch(L.mlp(p["mlp"], L.rmsnorm(p["norm2"], x)))
    elif seg.mlp == "moe":
        y, aux = moe_apply(p["mlp"], L.rmsnorm(p["norm2"], x), cfg.moe)
        x = x + _constrain_batch(y)
    return _constrain_batch(x), aux, new_cache


def _constrain_batch(x):
    """Pin the activations' batch sharding (an identity outside a mesh
    context and on plain tensors). Applied to each sublayer's output before
    the residual add too: a product contracted over heads or the MLP width
    leaves a partial sum over ``model``, which is all-reduced there, as
    Megatron's row-parallel layers do; left partial, DTensor carried it into
    the next norm and gathered the next layer's products over the whole
    batch. The gradient is laid out as the activations are
    (``settle_grad``: a partial sum all-reduced, as Megatron's backward
    does at a sublayer's input): left partial, DTensor ran the sublayers'
    weight-gradient products whole on every model rank."""
    return settle_grad(activation_constraint(x))


def _save_unbatched_products(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the outputs of matrix products without a
    batch dimension (``mm``, and ``bmm`` over a batch of 1, which is how
    ``einsum`` runs an unbatched contraction); recompute the rest."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op == aten.bmm.default and args[0].shape[0] == 1):
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, cfg: LMConfig):
    """``fn`` as ``cfg.remat`` rematerialises it when autograd records (with
    grad disabled, as in serving, it runs as it is)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "full":
        kw = {}
    elif cfg.remat == "dots":
        kw = {"context_fn": lambda: _ckpt.create_selective_checkpoint_contexts(
            _save_unbatched_products)}
    else:
        raise ValueError(cfg.remat)

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return _ckpt.checkpoint(carry_context(recomputed(fn)), *args,
                                use_reentrant=False, **kw)
    return remat


def _shared_block_fwd(p, cfg: LMConfig, x, emb, positions, cache, pos):
    """Zamba2 shared block: attention over concat(x, emb) + MLP, residual to
    x."""
    p = gather_params(p)
    h = L.rmsnorm(p["norm1"], torch.cat([x, emb], dim=-1))
    y, _ = L.attention_block(p["attn"], h, positions, cfg, cache, pos)
    x = x + _constrain_batch(y)
    return _constrain_batch(
        x + _constrain_batch(L.mlp(p["mlp"], L.rmsnorm(p["norm2"], x))))


def _run_segment(p_stack, seg: Segment, cfg: LMConfig, x, positions,
                 cache=None, pos=None, shared=None, emb=None,
                 shared_cache=None):
    """The segment's stacked layers one after another, each rematerialised
    as ``cfg.remat`` says when there is no cache. In a hybrid model's Mamba2
    segment the shared block (``shared``, over ``concat(x, emb)``) runs
    after every ``cfg.hybrid_period`` layers, its g-th application with
    slice g of ``shared_cache`` and rematerialised on its own. Returns
    ``(x, aux, cache)``, aux the sum of the layers' auxiliary losses (None
    where no layer has one); each layer and application writes its slice
    of the stacked caches in place.

    The layers go through ``models.loop.scan`` (the reference's
    ``lax.scan``), one period a step: ``hybrid_period`` layers (a loop of
    their own) and the shared block in a hybrid segment, else one layer;
    layers past the last whole period run after it."""
    per = cfg.hybrid_period if seg.kind == "mamba2" else 0
    k = per or 1

    def layer(x, li):
        with profile_range("model.layer_params"):
            p_layer = tree_map(lambda a: a[li], p_stack)
        if cache is None:
            body = _maybe_remat(
                lambda xx: _layer_fwd(gather_params(p_layer), seg, cfg, xx,
                                      positions, None, pos)[:2], cfg)
            return body(x)
        c_layer = tree_map(lambda a: a[li], cache)
        x, a, _ = _layer_fwd(gather_params(p_layer), seg, cfg, x, positions,
                             c_layer, pos)
        return x, a

    def period(x, g):
        x, auxes = scan(lambda xx, j: layer(xx, g * k + j), x, k)
        if per and cache is None:
            x = _maybe_remat(
                lambda xx, ee: _shared_block_fwd(shared, cfg, xx, ee,
                                                 positions, None, pos),
                cfg)(x, emb)
        elif per:
            x = _shared_block_fwd(shared, cfg, x, emb, positions,
                                  tree_map(lambda a: a[g], shared_cache),
                                  pos)
        return x, auxes

    n = seg.count // k
    x, ys = scan(period, x, n)
    auxes = [a for y in ys for a in y]
    for li in range(n * k, seg.count):
        x, a = layer(x, li)
        auxes.append(a)
    aux = None
    for a in auxes:
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux, cache


def _embed_tokens(params, cfg: LMConfig, tokens, prefix_embeds=None):
    x = _constrain_batch(
        L.embed(gather_params(params["embed"]), tokens).to(cfg.dtype))
    if prefix_embeds is not None:
        x = _constrain_batch(torch.cat([prefix_embeds.to(cfg.dtype), x],
                                       dim=1))
    return x


def _head(params, cfg: LMConfig, x):
    table = (params["embed"]["table"].T if cfg.tie_embeddings
             else params["head"])
    return x @ gather_params(table)


def forward(params, cfg: LMConfig, tokens, prefix_embeds=None,
            return_hidden: bool = False):
    """Full-sequence logits. tokens [B,S] int. Returns ``(logits, aux)``."""
    x = _embed_tokens(params, cfg, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    aux_total = torch.zeros((), device=x.device)
    emb0 = x
    for i, seg in enumerate(cfg.segments):
        x, aux, _ = _run_segment(params[f"seg{i}"], seg, cfg, x, positions,
                                 shared=params.get("shared"), emb=emb0)
        if aux is not None:
            aux_total = aux_total + aux
    x = L.rmsnorm(gather_params(params["final_norm"]), x)
    if return_hidden:
        return x, aux_total
    return _head(params, cfg, x), aux_total


def _run_cached(params, cfg: LMConfig, cache, x, positions, pos=None):
    """Prefill (``pos`` None) or one decode step through every segment,
    writing the caches in place. Returns the final-normed hidden states and
    the (same) cache."""
    emb0 = x
    new_cache = {}
    for i, seg in enumerate(cfg.segments):
        x, _, new_cache[f"seg{i}"] = _run_segment(
            params[f"seg{i}"], seg, cfg, x, positions, cache=cache[f"seg{i}"],
            pos=pos, shared=params.get("shared"), emb=emb0,
            shared_cache=cache.get("shared"))
    if "shared" in cache:
        new_cache["shared"] = cache["shared"]
    return L.rmsnorm(gather_params(params["final_norm"]), x), new_cache


def prefill(params, cfg: LMConfig, tokens, cache, prefix_embeds=None):
    """Fill the caches over the prompt; return the last position's logits
    ``[B, 1, V]`` and the (same, filled) cache."""
    x = _embed_tokens(params, cfg, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, new_cache = _run_cached(params, cfg, cache, x, positions)
    return _head(params, cfg, x[:, -1:]), new_cache


def decode_step(params, cfg: LMConfig, cache, tokens, pos: int):
    """One decode step. tokens [B,1]; pos: the current index (int)."""
    pos = int(pos)
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    x, new_cache = _run_cached(params, cfg, cache, x, positions, pos)
    return _head(params, cfg, x), new_cache


# ------------------------------------------------------------------- loss ----

def _ce_sum(logits, labels):
    """Summed CE (fp32) over the valid labels and their count. logits
    [B,S,V], labels [B,S] (-1 = pad)."""
    with profile_range("model.ce"):
        logits = unshard_dim(logits.float(), -1)  # the gather reads all V
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          labels.clamp(min=0)[..., None].long())[..., 0]
        valid = labels >= 0
        return (torch.where(valid, lse - ll, torch.zeros_like(lse)).sum(),
                valid.sum())


def _token_ce(logits, labels):
    """Mean CE over tokens (fp32). logits [B,S,V], labels [B,S] (-1 = pad)."""
    total, count = _ce_sum(logits, labels)
    return total / count.clamp(min=1)


def chunked_ce(head, hidden, labels, chunk: int):
    """Mean token CE of ``head(hidden)`` against ``labels``; over chunks of
    ``chunk`` positions when that divides the sequence, each chunk's head
    and CE under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint``), so that only one chunk's ``[B, C, V]`` float32
    logits is alive at a time. Under ``torch.profiler`` a chunk's head and
    CE are the range ``repro_torch.model.ce_chunk``, opened again when the
    chunk is recomputed."""
    if not (chunk and hidden.shape[1] % chunk == 0):
        return _token_ce(head(hidden), labels)
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)

    def ce_chunk(h, lab):
        with profile_range("model.ce_chunk"):
            return _ce_sum(head(h), lab)

    def step(carry, i):
        s, n = _ckpt.checkpoint(
            carry_context(recomputed(ce_chunk)),
            hidden[:, i * chunk:(i + 1) * chunk],
            labels[:, i * chunk:(i + 1) * chunk], use_reentrant=False)
        return (carry[0] + s, carry[1] + n), None

    (tot, cnt), _ = scan(step, (tot, cnt), hidden.shape[1] // chunk)
    return tot / cnt.clamp(min=1)


def lm_loss(params, cfg: LMConfig, tokens, labels, prefix_embeds=None):
    """CE + the MoE auxiliary loss + ``cfg.mtp_weight`` times the MTP loss
    (where ``cfg.mtp``). The CE is chunked when ``cfg.logit_chunk`` divides
    the (unprefixed) sequence (:func:`chunked_ce`). Returns ``(loss, {"ce",
    "aux", "mtp"})``."""
    hidden, aux = forward(params, cfg, tokens, prefix_embeds,
                          return_hidden=True)
    if cfg.prefix_len:
        hidden = hidden[:, cfg.prefix_len:]
    labels = torch.as_tensor(labels, device=hidden.device)
    ce = chunked_ce(lambda h: _head(params, cfg, h), hidden, labels,
                    cfg.logit_chunk)
    mtp_loss = (_mtp_loss(params, cfg, hidden, labels) if cfg.mtp
                else torch.zeros((), device=hidden.device))
    loss = ce + aux + cfg.mtp_weight * mtp_loss
    return loss, {"ce": ce, "aux": aux, "mtp": mtp_loss}


def _mtp_loss(params, cfg: LMConfig, hidden, labels):
    """DeepSeek-V3 MTP (depth 1): predict token t+2 from ``(h_t,
    emb(t+1))`` through one attention (MLA) + dense layer, its CE unchunked
    as in the reference."""
    p = gather_params(params["mtp"])
    emb_next = _constrain_batch(
        L.embed(gather_params(params["embed"]),
                labels.clamp(min=0)).to(cfg.dtype))
    cat = torch.cat([L.rmsnorm(p["norm_h"], hidden),
                     L.rmsnorm(p["norm_e"], emb_next)], dim=-1)
    h = cat @ p["proj"]
    seg = Segment("mla" if cfg.mla else "attn", "dense", 1)
    positions = torch.arange(h.shape[1], device=h.device)
    h, _, _ = _layer_fwd(p["layer"], seg, cfg, h, positions, None, None)
    logits = _head(params, cfg, h[:, :-1])
    return _token_ce(logits, labels[:, 1:])      # token t+2 at position t


# --------------------------------------------------- reference parameters ----

def from_reference_params(cfg: LMConfig, params, device=None):
    """The reference's LM parameters (nested dicts of numpy arrays under its
    pytree paths, e.g. ``materialize(key, lm_specs(cfg))``) as the port's
    tensors on ``device`` (``None``: the card), each in its spec's dtype.
    Raises on a missing or surplus leaf and on a wrong shape."""
    return load_reference(lm_specs(cfg), params, device)


def to_reference_params(params):
    """The port's parameters as nested dicts of float32 numpy arrays under
    the reference's pytree paths (numpy has no bfloat16)."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), params)
