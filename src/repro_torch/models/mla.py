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
softmax weights are exactly 0, so the sums are the same. On a mesh it runs
on each rank's local shard, as ``layers.decode_attention`` does.

Under ``seq_shard_attn`` K/V go through ``kv_replicated_constraint`` (inside
a mesh context, the all-gather of sequence-parallel attention) and q keeps
its sequence shard, as in the reference (``layers._SeqShardAttention``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from .layers import apply_rope, blockwise_attention, rmsnorm, rmsnorm_specs
from .specs import param
from ..sharding.rules import kv_replicated_constraint, write_seq


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
        write_seq(cache["ckv"], pos, ckv)
        write_seq(cache["kr"], pos, kr)
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
        q_chunk = cfg.q_chunk
        if getattr(cfg, "seq_shard_attn", False):
            k = kv_replicated_constraint(k)
            v_pad = kv_replicated_constraint(v_pad)
            q_chunk = s
        out = blockwise_attention(q, k, v_pad, q_chunk=q_chunk,
                                  k_chunk=cfg.k_chunk)[..., : m.v_head_dim]
        if cache is not None:
            write_seq(cache["ckv"], 0, ckv)
            write_seq(cache["kr"], 0, kr)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, cache


def _sharded_absorbed_decode(p, q_nope, q_rope, ckv, kr, pos: int,
                             m: MLAConfig):
    """:func:`_absorbed_decode` of DTensors on each rank's local shard, as
    ``layers._sharded_decode`` does: the batch stays split where q and
    both caches split it on one mesh axis, and the heads where q and
    ``w_uk``/``w_uv`` split them; anything else (a cache split over its
    sequence, heads a mesh axis does not divide) is gathered first. The
    output has q's local layout."""
    mesh = q_nope.device_mesh
    w = {k: p[k] if isinstance(p[k], DTensor) else
         DTensor.from_local(p[k], mesh, [Replicate()] * mesh.ndim)
         for k in ("w_uk", "w_uv")}

    def keep(i):
        pq = q_nope.placements[i]
        if pq == Shard(0) and all(t.placements[i] == Shard(0)
                                  for t in (q_rope, ckv, kr)):
            return pq
        if pq == Shard(2) and q_rope.placements[i] == pq and all(
                t.placements[i] == Shard(1) for t in w.values()):
            return pq
        return Replicate()
    pl_q = [keep(i) for i in range(mesh.ndim)]
    pl_c = [pq if pq == Shard(0) else Replicate() for pq in pl_q]
    pl_w = [Shard(1) if pq == Shard(2) else Replicate() for pq in pl_q]
    ql, rl = (t.redistribute(mesh, pl_q).to_local() for t in (q_nope, q_rope))
    cl, kl = (t.redistribute(mesh, pl_c).to_local() for t in (ckv, kr))
    wl = {k: t.redistribute(mesh, pl_w).to_local() for k, t in w.items()}
    out = _absorbed_decode(wl, ql, rl, cl, kl, pos, m)
    return DTensor.from_local(out, mesh, pl_q)


def _absorbed_decode(p, q_nope, q_rope, ckv, kr, pos: int, m: MLAConfig):
    """Latent-cache decode. q_nope [B,1,H,dn], q_rope [B,1,H,dr], ckv
    [B,Smax,r], kr [B,Smax,dr] with the current token at ``pos`` -> out
    [B,1,H,dv], over the cache rows [0, pos] in float32. On DTensors it
    runs on each rank's local shard (:func:`_sharded_absorbed_decode`)."""
    if isinstance(q_nope, DTensor):
        return _sharded_absorbed_decode(p, q_nope, q_rope, ckv, kr, pos, m)
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
