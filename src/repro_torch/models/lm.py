"""Generic decoder LM over block segments (``repro.models.lm``), the serving
forward.

A model is a tuple of :class:`Segment`s (block kind, mlp kind, count).
Consecutive layers of a segment share structure, so their parameters are
stacked on a leading "layers" axis, as in the reference; the reference's
``lax.scan`` over that axis is a Python loop here.

Entry points:

* ``forward``: logits over full sequences;
* ``prefill``: last-position logits, filling the caches;
* ``decode_step``: one token against the caches;
* ``cache_specs``: the ParamSpec tree of the serving caches.

Ported so far: attention blocks with dense (SwiGLU) or no MLP, which covers
internlm2, h2o-danube, phi3-medium and llava-next. MLA, MoE, Mamba2, xLSTM,
the hybrid shared block and the MTP head raise ``NotImplementedError``
naming their ROADMAP item; ``lm_loss`` and rematerialisation come with LM
training. Caches are updated in place (the reference donates them) and the
same dicts are returned.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from . import layers as L
from . import mamba2 as M
from . import xlstm as X
from .mla import MLAConfig
from .moe import MoEConfig
from .specs import ParamSpec, is_spec, param, tree_map


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


def _run_segment(p_stack, seg: Segment, cfg: LMConfig, x, positions,
                 cache=None, pos=None):
    """The segment's stacked layers one after another. Returns ``(x,
    cache)``; each layer writes its slice of the stacked cache in place. (No
    ported block has an auxiliary loss: the reference's aux is the MoE's.)"""
    for li in range(seg.count):
        p_layer = tree_map(lambda a: a[li], p_stack)
        c_layer = None if cache is None else tree_map(lambda a: a[li], cache)
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


# --------------------------------------------------- reference parameters ----

def _check_tree(spec_tree, tree, path=()):
    where = ".".join(path) or "params"
    if not isinstance(tree, Mapping):
        raise ValueError(f"{where}: expected a dict, got {type(tree)}")
    missing = sorted(set(spec_tree) - set(tree))
    surplus = sorted(set(tree) - set(spec_tree))
    if missing or surplus:
        raise ValueError(f"{where}: missing leaves {missing}, surplus leaves "
                         f"{surplus}")
    for k, v in spec_tree.items():
        if is_spec(v):
            shape = tuple(np.shape(tree[k]))
            if shape != v.shape:
                raise ValueError(f"{where}.{k}: shape {shape}, expected "
                                 f"{v.shape}")
        else:
            _check_tree(v, tree[k], path + (k,))


def from_reference_params(cfg: LMConfig, params, device=None):
    """The reference's LM parameters (nested dicts of numpy arrays under its
    pytree paths, e.g. ``materialize(key, lm_specs(cfg))``) as the port's
    tensors on ``device`` (``None``: the card), each in its spec's dtype.
    Raises on a missing or surplus leaf and on a wrong shape."""
    dev = resolve_device(device)
    specs = lm_specs(cfg)
    _check_tree(specs, params)

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
