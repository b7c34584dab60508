"""Mixture-of-Experts with sort-based capacity dispatch (``repro.models.moe``).

Tokens are sorted by expert id (a stable sort, as ``jnp.argsort`` is), each
assignment's position within its expert follows from the group offsets, and
a flat gather index ``[E*C]`` collects the kept tokens into ``buf [E, C,
D]``. The experts run as batched products ``[E,C,D] x [E,D,F]``; assignments
past an expert's capacity are dropped (the token keeps its residual path).
Routing is top-k softmax in float32 with the top-k weights renormalised
(Qwen3), optionally with shared experts (DeepSeek), and the load-balance
auxiliary loss.

The combine is deterministic: where the reference scatter-adds each
assignment into its token (atomics on the card, an order that changes from
run to run), the port inverts the sort, gathers each token's k
contributions in their ``(token, j)`` order and sums them over j in float32.
That is the reference's sum in another order, within float32 rounding, and
it repeats bit for bit, also under ``torch.use_deterministic_algorithms``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .specs import param


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden dim
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_dtype: str = "float32"


def moe_specs(d: int, cfg: MoEConfig, dtype=torch.bfloat16):
    e, f = cfg.n_experts, cfg.d_ff
    out = {
        "router": param((d, e), ("embed", "expert"), dtype=torch.float32,
                        scale=0.02),
        "w_gate": param((e, d, f), ("expert", "embed", "mlp"), dtype=dtype),
        "w_up": param((e, d, f), ("expert", "embed", "mlp"), dtype=dtype),
        "w_down": param((e, f, d), ("expert", "mlp", "embed"), dtype=dtype),
    }
    if cfg.n_shared:
        fs = f * cfg.n_shared
        out["shared_gate"] = param((d, fs), ("embed", "mlp"), dtype=dtype)
        out["shared_up"] = param((d, fs), ("embed", "mlp"), dtype=dtype)
        out["shared_down"] = param((fs, d), ("mlp", "embed"), dtype=dtype)
    return out


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)       # round up to 8


def _route(p, xf, cfg: MoEConfig):
    """Router: returns (top_p [T,k], top_ids [T,k], density [E],
    mean_prob [E]), all float32 but the ids."""
    e, k = cfg.n_experts, cfg.top_k
    t = xf.shape[0]
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    density = torch.bincount(top_ids.reshape(-1), minlength=e).float() / (
        t * k)
    return top_p, top_ids, density, probs.mean(dim=0)


def _dispatch(xf, top_ids, top_p, e: int, cap: int):
    """Sort assignments by expert -> (buf [E,C,D], combine metadata
    ``(order, slot, keep, gate)``, each over the sorted assignments)."""
    t, d = xf.shape
    k = top_ids.shape[1]
    flat_expert = top_ids.reshape(-1)                           # [T*k]
    flat_token = torch.arange(t, device=xf.device).repeat_interleave(k)
    order = torch.sort(flat_expert, stable=True).indices
    se, st, sg = flat_expert[order], flat_token[order], top_p.reshape(-1)[
        order]
    counts = torch.bincount(se, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts                  # exclusive
    pos = torch.arange(t * k, device=xf.device) - offsets[se]   # in expert
    keep = pos < cap
    slot = se * cap + pos                                       # flat slot
    # dropped assignments write the spare entry e*cap, cut off below
    gather_idx = torch.full((e * cap + 1,), t, dtype=torch.long,
                            device=xf.device)
    gather_idx[torch.where(keep, slot, e * cap)] = st
    xf_pad = torch.cat([xf, xf.new_zeros(1, d)], dim=0)
    buf = xf_pad[gather_idx[:e * cap]].reshape(e, cap, d)
    return buf, (order, slot, keep, sg)


def _combine(y_flat, meta, t: int, k: int, dtype):
    """Each token's k expert outputs, weighted by their gates, summed over
    j in float32 in ``(token, j)`` order (no atomics)."""
    order, slot, keep, sg = meta
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    idx = torch.where(keep, slot, 0)[inv]                       # [T*k]
    gate = torch.where(keep, sg, 0.0)[inv]
    contrib = y_flat[idx].float() * gate[:, None]
    return contrib.reshape(t, k, -1).sum(dim=1).to(dtype)


def _expert_ffn(p, buf):
    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    return torch.bmm(F.silu(g) * u, p["w_down"])


def _shared_ffn(p, x):
    gs = x @ p["shared_gate"]
    us = x @ p["shared_up"]
    return (F.silu(gs) * us) @ p["shared_down"]


def moe_apply(p, x, cfg: MoEConfig):
    """x [B,S,D] -> (y [B,S,D], aux_loss scalar float32).

    The reference's single-device formulation. Its expert-parallel path
    (``_moe_ep``: ``shard_map`` with an all-to-all over a mesh's model
    axis) needs a device mesh, which the port does not have yet (ROADMAP
    queue 1 item 11), so this always takes the single-device path.
    """
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    top_p, top_ids, density, mean_prob = _route(p, xf, cfg)
    aux = cfg.aux_loss_coef * cfg.n_experts * torch.sum(density * mean_prob)
    cap = _capacity(t, cfg)
    buf, meta = _dispatch(xf, top_ids, top_p, cfg.n_experts, cap)
    y = _expert_ffn(p, buf).reshape(cfg.n_experts * cap, d)
    out = _combine(y, meta, t, cfg.top_k, x.dtype).reshape(b, s, d)
    if cfg.n_shared:
        out = out + _shared_ffn(p, x)
    return out, aux
