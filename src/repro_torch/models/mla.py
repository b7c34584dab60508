"""Multi-head Latent Attention (``repro.models.mla``; DeepSeek-V2/V3,
MiniCPM3).

Prefill materialises per-head K/V from the compressed latent and runs
``layers.blockwise_attention`` (on the card, the flash kernel) with V padded
from ``v_head_dim`` to the q/k head dim, as the reference does, so one
attention call serves both; the result is cut back to ``v_head_dim``.

Decode is the absorbed formulation over the latent cache (``ckv [B, Smax,
r]``, ``kr [B, Smax, dr]``): per-head scores ``(q_nope W_uk) . c + q_rope .
k_rope`` and values ``(p . c) W_uv``, in float32 as the reference computes
them. Like ``layers.decode_attention``, the port reads only the visible
cache rows ``[0, pos]``; the reference masks the rest with -1e30, whose
softmax weights are exactly 0, so the sums are the same.

The reference's ``seq_shard_attn`` K/V constraint is a sharding annotation,
an identity on one card; only its single q chunk is kept.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .layers import apply_rope, blockwise_attention, rmsnorm, rmsnorm_specs
from .specs import param


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


def mla_specs(d: int, n_heads: int, m: MLAConfig, dtype=torch.bfloat16):
    dq, r = m.q_lora_rank, m.kv_lora_rank
    dn, dr, dv = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
    return {
        "w_dq": param((d, dq), ("embed", "q_lora"), dtype=dtype),
        "q_norm": rmsnorm_specs(dq),
        "w_uq": param((dq, n_heads, dn + dr), ("q_lora", "heads", "head_dim"),
                      dtype=dtype),
        "w_dkv": param((d, r), ("embed", "kv_lora"), dtype=dtype),
        "kv_norm": rmsnorm_specs(r),
        "w_kr": param((d, dr), ("embed", "head_dim"), dtype=dtype),
        "w_uk": param((r, n_heads, dn), ("kv_lora", "heads", "head_dim"),
                      dtype=dtype),
        "w_uv": param((r, n_heads, dv), ("kv_lora", "heads", "head_dim"),
                      dtype=dtype),
        "wo": param((n_heads, dv, d), ("heads", "head_dim", "embed"),
                    dtype=dtype),
    }


def _project_q(p, x, positions, m: MLAConfig, theta: float):
    cq = rmsnorm(p["q_norm"], x @ p["w_dq"])
    q = torch.einsum("bsq,qhk->bshk", cq, p["w_uq"])
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(q_rope, positions, theta)


def mla_block(p, x, positions, cfg, cache=None, pos=None):
    """MLA sublayer. ``cfg`` needs ``.mla``, ``.n_heads``, ``.rope_theta``
    and ``.q_chunk``/``.k_chunk``. Returns ``(out [B, S, d_model], cache or
    None)``; the cache (``{"ckv": [B, Smax, r], "kr": [B, Smax, dr]}``) is
    written in place, at ``pos`` in decode (S == 1) and at [0, S) in
    prefill, and returned."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_rope = _project_q(p, x, positions, m, cfg.rope_theta)
    ckv = rmsnorm(p["kv_norm"], x @ p["w_dkv"])
    kr = apply_rope((x @ p["w_kr"])[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0, :]                 # [B,S,dr]

    if cache is not None and s == 1:
        cache["ckv"][:, pos] = ckv[:, 0]
        cache["kr"][:, pos] = kr[:, 0]
        out = _absorbed_decode(p, q_nope, q_rope, cache["ckv"], cache["kr"],
                               pos, m)
    else:
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["w_uk"])
        v = torch.einsum("bsr,rhk->bshk", ckv, p["w_uv"])
        k_rope = kr[:, :, None, :].expand(b, s, cfg.n_heads, m.qk_rope_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope], dim=-1)
        # pad v's head dim up to the q/k head dim: one attention call
        dqk = m.qk_nope_dim + m.qk_rope_dim
        v_pad = F.pad(v, (0, dqk - m.v_head_dim))
        q_chunk = s if getattr(cfg, "seq_shard_attn", False) else cfg.q_chunk
        out = blockwise_attention(q, k, v_pad, q_chunk=q_chunk,
                                  k_chunk=cfg.k_chunk)[..., : m.v_head_dim]
        if cache is not None:
            cache["ckv"][:, :s] = ckv
            cache["kr"][:, :s] = kr
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, cache


def _absorbed_decode(p, q_nope, q_rope, ckv, kr, pos: int, m: MLAConfig):
    """Latent-cache decode. q_nope [B,1,H,dn], q_rope [B,1,H,dr], ckv
    [B,Smax,r], kr [B,Smax,dr] with the current token at ``pos`` -> out
    [B,1,H,dv], over the cache rows [0, pos] in float32."""
    scale = 1.0 / ((m.qk_nope_dim + m.qk_rope_dim) ** 0.5)
    # absorb W_uk into q: q_eff [B,H,r]
    q_eff = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])[:, 0]
    c_vis = ckv[:, :pos + 1].float()
    s_lat = torch.einsum("bhr,bsr->bhs", q_eff.float(), c_vis)
    s_rope = torch.einsum("bhk,bsk->bhs", q_rope[:, 0].float(),
                          kr[:, :pos + 1].float())
    pattn = torch.softmax((s_lat + s_rope) * scale, dim=-1)    # [B,H,S]
    lat = torch.einsum("bhs,bsr->bhr", pattn, c_vis)
    out = torch.einsum("bhr,rhk->bhk", lat, p["w_uv"].float())
    return out[:, None].to(q_nope.dtype)                        # [B,1,H,dv]
