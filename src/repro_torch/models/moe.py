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

Inside a mesh context whose ``model`` axis divides the experts and the
sequence, ``moe_apply`` runs expert-parallel (``_moe_ep``, the reference's
``shard_map``): each rank routes its own tokens, and an all-to-all over the
model axis's process group carries the ``[n_ep, e_loc, cap, d]`` buffer to
the ranks that hold those experts and back.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed._functional_collectives import (
    all_to_all_single_autograd)
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .specs import param
from ..sharding.rules import (_mesh_shape, batch_partition, context_mesh,
                              placements)


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


def _counts(ids, e: int):
    """How many of ``ids`` name each of ``e`` experts: ``torch.bincount(ids,
    minlength=e)``, as a sum of integers into a tensor of static shape (a
    fake tensor holds no ids to size bincount's result by)."""
    return torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def _route(p, xf, cfg: MoEConfig):
    """Router: returns (top_p [T,k], top_ids [T,k], density [E],
    mean_prob [E]), all float32 but the ids."""
    e, k = cfg.n_experts, cfg.top_k
    t = xf.shape[0]
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    density = _counts(top_ids.reshape(-1), e).float() / (t * k)
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
    counts = _counts(se, e)
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

    Single-device formulation. Under a mesh context with n_experts and the
    sequence divisible by the model axis, dispatch runs expert-parallel
    (``_moe_ep``): tokens stay on their rank, only the top-k activations
    cross the model axis. Other DTensor inputs (a decode step's one token
    a row) take ``_moe_gathered_tokens``.
    """
    mesh = context_mesh()
    if mesh is not None:
        n_ep = _mesh_shape(mesh).get("model")
        if (n_ep is not None and cfg.n_experts % n_ep == 0
                and x.shape[1] % n_ep == 0):
            return _moe_ep(p, x, cfg, mesh)
    if isinstance(x, DTensor):
        return _moe_gathered_tokens(p, x, cfg)
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


def _moe_gathered_tokens(p, x, cfg: MoEConfig):
    """The single-device formulation on a mesh where the tokens do not
    split for ``_moe_ep`` (a decode step's ``[B, 1, D]``): every rank
    gathers all tokens and routes and dispatches them as one device does
    (the same capacity, so the same drops), runs the experts of its own
    shard where ``model`` divides them, and an all-gather over ``model``
    brings every expert's output back for the combine. The result is
    laid out as ``x``."""
    mesh = x.device_mesh
    b, s, d = x.shape
    t = b * s
    rep = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    n_ep = _mesh_shape(mesh).get("model", 1)
    split = cfg.n_experts % n_ep == 0
    exp_pl = placements(mesh, ("model", None, None)) if split else rep
    xf = _local(x, mesh, rep, rep).reshape(t, d)
    pl = {"router": _local(p["router"], mesh, rep, rep)}
    for k in ("w_gate", "w_up", "w_down"):
        pl[k] = _local(p[k], mesh, exp_pl, exp_pl)
    top_p, top_ids, density, mean_prob = _route(pl, xf, cfg)
    aux = cfg.aux_loss_coef * cfg.n_experts * torch.sum(density * mean_prob)
    cap = _capacity(t, cfg)
    buf, meta = _dispatch(xf, top_ids, top_p, cfg.n_experts, cap)
    if split:
        e_loc = cfg.n_experts // n_ep
        r = mesh.get_local_rank(names.index("model"))
        buf = buf[r * e_loc:(r + 1) * e_loc]
    y = DTensor.from_local(_expert_ffn(pl, buf), mesh, exp_pl)
    y = y.full_tensor().reshape(cfg.n_experts * cap, d)
    out = _combine(y, meta, t, cfg.top_k, x.dtype).reshape(b, s, d)
    out = DTensor.from_local(out, mesh, rep).redistribute(mesh, x.placements)
    aux = DTensor.from_local(aux, mesh, rep)
    if cfg.n_shared:
        out = out + _shared_ffn(p, x)
    return out, aux


class _MeanOver(torch.autograd.Function):
    """The mean of a tensor over the ranks of ``groups`` (the reference's
    ``pmean``). Its result is the same on every rank and is used as a
    replicated value, so each rank's share of the gradient is the
    incoming gradient over the rank count; nothing is sent backward."""

    @staticmethod
    def forward(ctx, x, groups, n):
        x = x.clone()
        for g in groups:
            dist.all_reduce(x, group=g)
        ctx.n = n
        return x / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def _local(t, mesh, pl, grad_pl):
    """The local shard of ``t`` (a plain tensor counts as replicated) laid
    out as ``pl``; its gradient leaves as ``grad_pl``."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
    return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)


def _moe_ep(p, x, cfg: MoEConfig, mesh):
    """Expert-parallel MoE: tokens split over the batch axes x model(seq);
    each rank routes its own tokens, an all-to-all on the model axis
    regroups the top-k activations by expert shard, the local experts run,
    the inverse all-to-all brings them back and the combine is local.
    Shared experts run outside, on the DTensors. Returns DTensors: ``y``
    laid out as the split tokens, ``aux`` replicated."""
    b, s, d = x.shape
    names = list(mesh.mesh_dim_names)
    n_ep = _mesh_shape(mesh)["model"]
    e, e_loc = cfg.n_experts, cfg.n_experts // n_ep
    # the batch axes that divide b (the reference's fall-back)
    bspec = batch_partition(mesh, 3, batch_size=b)[0]
    batch_axes = (() if bspec is None else
                  (bspec,) if isinstance(bspec, str) else bspec)
    x_pl = placements(mesh, (bspec, "model", None))
    # mesh dims over which the ranks hold different tokens: the gradients
    # of what they share are partial sums there
    split = [names.index(a) for a in batch_axes + ("model",)]
    rep = [Replicate()] * mesh.ndim
    shared_grad = [Partial() if i in split else Replicate()
                   for i in range(mesh.ndim)]
    exp_pl = placements(mesh, ("model", None, None))
    exp_grad = [Shard(0) if names[i] == "model" else shared_grad[i]
                for i in range(mesh.ndim)]

    xl = _local(x, mesh, x_pl, x_pl)
    pl = {"router": _local(p["router"], mesh, rep, shared_grad)}
    for k in ("w_gate", "w_up", "w_down"):
        pl[k] = _local(p[k], mesh, exp_pl, exp_grad)
    b_loc, s_loc, _ = xl.shape
    t = b_loc * s_loc
    xf = xl.reshape(t, d)
    top_p, top_ids, density, mean_prob = _route(pl, xf, cfg)
    groups = [mesh.get_group(i) for i in split]
    n = math.prod(mesh.size(i) for i in split)
    aux = cfg.aux_loss_coef * e * torch.sum(
        _MeanOver.apply(density, groups, n)
        * _MeanOver.apply(mean_prob, groups, n))
    cap = _capacity(t, cfg)
    buf, meta = _dispatch(xf, top_ids, top_p, e, cap)           # [E, cap, d]
    # EP all-to-all: tokens regroup onto their expert's shard
    group = mesh.get_group(names.index("model"))
    buf = all_to_all_single_autograd(
        buf.reshape(n_ep, e_loc, cap, d).contiguous(), None, None, group)
    buf = buf.transpose(0, 1).reshape(e_loc, n_ep * cap, d)
    y = _expert_ffn(pl, buf)                                    # [e_loc,n*cap,d]
    y = y.reshape(e_loc, n_ep, cap, d).transpose(0, 1)
    y = all_to_all_single_autograd(y.contiguous(), None, None,
                                   group).reshape(e * cap, d)
    out = _combine(y, meta, t, cfg.top_k, xl.dtype).reshape(b_loc, s_loc, d)
    out = DTensor.from_local(out, mesh, x_pl)
    aux = DTensor.from_local(aux, mesh, rep)
    if cfg.n_shared:
        out = out + _shared_ffn(p, x)
    return out, aux
