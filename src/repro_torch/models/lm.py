"""Generic decoder LM over block segments (``repro.models.lm``): the
serving forward and the training loss.

A model is a tuple of :class:`Segment`s (block kind, mlp kind, count).
Consecutive layers of a segment share structure, so their parameters are
stacked on a leading "layers" axis, as in the reference; the reference's
``lax.scan`` over that axis is a Python loop here.

Entry points:

* ``forward``: logits over full sequences;
* ``prefill``: last-position logits, filling the caches;
* ``decode_step``: one token against the caches;
* ``cache_specs``: the ParamSpec tree of the serving caches;
* ``lm_loss``: the mean token cross-entropy, chunked over the sequence when
  ``cfg.logit_chunk`` divides it, each chunk's head and CE under
  ``torch.utils.checkpoint`` as the reference wraps them in
  ``jax.checkpoint``.

Layers are rematerialised as ``cfg.remat`` says (``_maybe_remat``): ``full``
checkpoints each layer, ``dots`` saves only the outputs of matrix products
with no batch dimension (the reference's
``dots_with_no_batch_dims_saveable``).

Ported so far: attention blocks with dense (SwiGLU) or no MLP, which covers
internlm2, h2o-danube, phi3-medium and llava-next. MLA, MoE, Mamba2, xLSTM,
the hybrid shared block and the MTP head raise ``NotImplementedError``
naming their ROADMAP item. Caches are updated in place (the reference
donates them) and the same dicts are returned.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from ..device import resolve_device
from . import layers as L
from . import mamba2 as M
from . import xlstm as X
from .mla import MLAConfig
from .moe import MoEConfig
from .specs import ParamSpec, check_tree, is_spec, param, tree_map


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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP queue 1 item 10)")


# ------------------------------------------------------------------ specs ----

def _stack(specs, count: int):
    return tree_map(lambda s: ParamSpec((count,) + s.shape, s.dtype,
                                        ("layers",) + s.axes, s.init,
                                        s.scale), specs)


def _check_supported(cfg: LMConfig, seg: Segment) -> None:
    if seg.kind != "attn":
        raise (_not_ported(f"the {seg.kind} block")
               if seg.kind in ("mla", "mamba2", "mlstm", "slstm")
               else ValueError(seg.kind))
    if seg.mlp == "moe":
        raise _not_ported("the MoE layer")
    if cfg.hybrid_period:
        raise _not_ported("the hybrid shared attention block")
    if cfg.mtp:
        raise _not_ported("the multi-token prediction head")


def _layer_specs(cfg: LMConfig, seg: Segment):
    _check_supported(cfg, seg)
    d, dt = cfg.d_model, cfg.param_dtype
    out = {"norm1": L.rmsnorm_specs(d),
           "attn": L.attn_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                                dt)}
    if seg.mlp == "dense":
        out["norm2"] = L.rmsnorm_specs(d)
        out["mlp"] = L.mlp_specs(d, cfg.d_ff, dt)
    return out


def lm_specs(cfg: LMConfig):
    out = {"embed": L.embed_specs(cfg.vocab, cfg.d_model, cfg.param_dtype),
           "final_norm": L.rmsnorm_specs(cfg.d_model)}
    for i, seg in enumerate(cfg.segments):
        out[f"seg{i}"] = _stack(_layer_specs(cfg, seg), seg.count)
    if not cfg.tie_embeddings:
        out["head"] = param((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                            dtype=cfg.param_dtype, scale=0.02)
    return out


# ----------------------------------------------------------------- caches ----

def _layer_cache_specs(cfg: LMConfig, seg: Segment, batch: int,
                       max_len: int):
    _check_supported(cfg, seg)
    shp = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    axes = ("cache_batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": ParamSpec(shp, cfg.dtype, axes, "zeros"),
            "v": ParamSpec(shp, cfg.dtype, axes, "zeros")}


def cache_specs(cfg: LMConfig, batch: int, max_len: int):
    return {f"seg{i}": _stack(_layer_cache_specs(cfg, seg, batch, max_len),
                              seg.count)
            for i, seg in enumerate(cfg.segments)}


# ---------------------------------------------------------------- forward ----

def _layer_fwd(p, seg: Segment, cfg: LMConfig, x, positions, cache, pos):
    _check_supported(cfg, seg)
    h = L.rmsnorm(p["norm1"], x)
    y, new_cache = L.attention_block(p["attn"], h, positions, cfg, cache, pos)
    x = x + y
    if seg.mlp == "dense":
        x = x + L.mlp(p["mlp"], L.rmsnorm(p["norm2"], x))
    return x, new_cache


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
        return _ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return remat


def _run_segment(p_stack, seg: Segment, cfg: LMConfig, x, positions,
                 cache=None, pos=None):
    """The segment's stacked layers one after another, each rematerialised
    as ``cfg.remat`` says when there is no cache. Returns ``(x, cache)``;
    each layer writes its slice of the stacked cache in place. (No ported
    block has an auxiliary loss: the reference's aux is the MoE's.)"""
    for li in range(seg.count):
        p_layer = tree_map(lambda a: a[li], p_stack)
        if cache is None:
            body = _maybe_remat(
                lambda xx, pl=p_layer: _layer_fwd(pl, seg, cfg, xx,
                                                  positions, None, pos)[0],
                cfg)
            x = body(x)
        else:
            c_layer = tree_map(lambda a: a[li], cache)
            x, _ = _layer_fwd(p_layer, seg, cfg, x, positions, c_layer, pos)
    return x, cache


def _embed_tokens(params, cfg: LMConfig, tokens, prefix_embeds=None):
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.dtype), x], dim=1)
    return x


def _head(params, cfg: LMConfig, x):
    table = (params["embed"]["table"].T if cfg.tie_embeddings
             else params["head"])
    return x @ table


def forward(params, cfg: LMConfig, tokens, prefix_embeds=None,
            return_hidden: bool = False):
    """Full-sequence logits. tokens [B,S] int. Returns ``(logits, aux)``."""
    x = _embed_tokens(params, cfg, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    for i, seg in enumerate(cfg.segments):
        x, _ = _run_segment(params[f"seg{i}"], seg, cfg, x, positions)
    aux_total = torch.zeros((), device=x.device)
    x = L.rmsnorm(params["final_norm"], x)
    if return_hidden:
        return x, aux_total
    return _head(params, cfg, x), aux_total


def prefill(params, cfg: LMConfig, tokens, cache, prefix_embeds=None):
    """Fill the caches over the prompt; return the last position's logits
    ``[B, 1, V]`` and the (same, filled) cache."""
    x = _embed_tokens(params, cfg, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    new_cache = {}
    for i, seg in enumerate(cfg.segments):
        x, new_cache[f"seg{i}"] = _run_segment(
            params[f"seg{i}"], seg, cfg, x, positions, cache=cache[f"seg{i}"])
    x = L.rmsnorm(params["final_norm"], x)
    return _head(params, cfg, x[:, -1:]), new_cache


def decode_step(params, cfg: LMConfig, cache, tokens, pos: int):
    """One decode step. tokens [B,1]; pos: the current index (int)."""
    pos = int(pos)
    x = _embed_tokens(params, cfg, tokens)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    new_cache = {}
    for i, seg in enumerate(cfg.segments):
        x, new_cache[f"seg{i}"] = _run_segment(
            params[f"seg{i}"], seg, cfg, x, positions, cache=cache[f"seg{i}"],
            pos=pos)
    x = L.rmsnorm(params["final_norm"], x)
    return _head(params, cfg, x), new_cache


# ------------------------------------------------------------------- loss ----

def _ce_sum(logits, labels):
    """Summed CE (fp32) over the valid labels and their count. logits
    [B,S,V], labels [B,S] (-1 = pad)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    valid = labels >= 0
    return (torch.where(valid, lse - ll, torch.zeros_like(lse)).sum(),
            valid.sum())


def _token_ce(logits, labels):
    """Mean CE over tokens (fp32). logits [B,S,V], labels [B,S] (-1 = pad)."""
    total, count = _ce_sum(logits, labels)
    return total / count.clamp(min=1)


def lm_loss(params, cfg: LMConfig, tokens, labels, prefix_embeds=None):
    """CE (+ the aux losses of blocks not ported yet, all 0 here). Uses
    chunked CE when ``cfg.logit_chunk`` divides the (unprefixed) sequence:
    the head and CE of each chunk run under ``torch.utils.checkpoint``, so
    only one chunk's ``[B, C, V]`` float32 logits is alive at a time.
    Returns ``(loss, {"ce", "aux", "mtp"})``."""
    if cfg.mtp:
        raise _not_ported("the multi-token prediction head")
    hidden, aux = forward(params, cfg, tokens, prefix_embeds,
                          return_hidden=True)
    if cfg.prefix_len:
        hidden = hidden[:, cfg.prefix_len:]
    labels = torch.as_tensor(labels, device=hidden.device)
    if cfg.logit_chunk and hidden.shape[1] % cfg.logit_chunk == 0:
        c = cfg.logit_chunk
        tot = torch.zeros((), device=hidden.device)
        cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
        for i in range(hidden.shape[1] // c):
            s, n = _ckpt.checkpoint(
                lambda h, lab: _ce_sum(_head(params, cfg, h), lab),
                hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
                use_reentrant=False)
            tot, cnt = tot + s, cnt + n
        ce = tot / cnt.clamp(min=1)
    else:
        ce = _token_ce(_head(params, cfg, hidden), labels)
    mtp_loss = torch.zeros((), device=hidden.device)
    loss = ce + aux + cfg.mtp_weight * mtp_loss
    return loss, {"ce": ce, "aux": aux, "mtp": mtp_loss}


# --------------------------------------------------- reference parameters ----

def from_reference_params(cfg: LMConfig, params, device=None):
    """The reference's LM parameters (nested dicts of numpy arrays under its
    pytree paths, e.g. ``materialize(key, lm_specs(cfg))``) as the port's
    tensors on ``device`` (``None``: the card), each in its spec's dtype.
    Raises on a missing or surplus leaf and on a wrong shape."""
    dev = resolve_device(device)
    specs = lm_specs(cfg)
    check_tree(specs, params)

    def load(spec_tree, tree):
        return {k: (torch.tensor(np.asarray(tree[k], np.float32))
                    .to(device=dev, dtype=v.dtype) if is_spec(v)
                    else load(v, tree[k]))
                for k, v in spec_tree.items()}

    return load(specs, params)


def to_reference_params(params):
    """The port's parameters as nested dicts of float32 numpy arrays under
    the reference's pytree paths (numpy has no bfloat16)."""
    return tree_map(lambda t: t.detach().float().cpu().numpy(), params)
