"""xLSTM blocks (``repro.models.xlstm``): mLSTM (matrix memory) and sLSTM
(scalar memory, recurrent mixing).

Both cells are the exact stabilised recurrences of the xLSTM formulation.
The reference's ``lax.scan`` over time is ``loop.scan`` here, in chunks:
each chunk's body runs under ``torch.utils.checkpoint`` while autograd
records (the reference's ``jax.checkpoint``, whatever ``cfg.remat`` says),
so only chunk-boundary states are saved for the backward. Decode carries
(C, n, m) / (h, c, n, m) states, written into the cache in place.

Simplifications the reference makes against the published xLSTM, kept:
no causal conv1d front-end inside the mLSTM branch, sigmoid forget gates,
per-head RMSNorm instead of GroupNorm.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils import checkpoint as _ckpt

from .layers import rmsnorm_specs
from .loop import recomputed, scan
from .specs import param
from ..sharding.rules import (carry_context, contraction_split,
                              local_pointwise, on_local_shards, settle_grad)

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    up_factor: float = 2.0       # mLSTM projection expansion
    slstm_ff: float = 4.0 / 3.0  # sLSTM post-FFN expansion
    chunk: int = 64              # remat chunk length


def _chunked(body, state, n_chunks: int):
    """``state, out_i = body(state, i)`` over chunks ``i`` (``loop.scan``),
    each under non-reentrant checkpoint while autograd records. Returns
    ``(state, [out_i])``."""
    def chunk(st, i):
        if torch.is_grad_enabled():
            return _ckpt.checkpoint(carry_context(recomputed(body)), st, i,
                                    use_reentrant=False)
        return body(st, i)
    return scan(chunk, state, n_chunks)


def _chunk_len(s: int, chunk: int) -> int:
    l = min(chunk, s)
    return s if s % l else l


def _head_norm(h_seq, scale, shape, dtype):
    """Per-head RMSNorm of ``h_seq [B, S, H, dh]``, flattened to ``shape``
    ``[B, S, H * dh]``. On a DTensor the flat output's gradient is laid out
    as the output is (``settle_grad``) before the flattening's backward
    splits the heads again: the next product's backward may shard that
    gradient's flat dim over more ranks than there are heads (4 heads, a
    model axis of 8 or 16), which a head split cannot take."""
    hn = h_seq.float()
    var = hn.square().mean(dim=-1, keepdim=True)
    return settle_grad(
        (hn * torch.rsqrt(var + 1e-5) * scale).reshape(shape).to(dtype))


# ---------------------------------------------------------------- mLSTM ----

def mlstm_specs(d: int, cfg: XLSTMConfig, dtype=torch.bfloat16):
    di = int(d * cfg.up_factor)
    h = cfg.n_heads
    dh = di // h
    return {
        "w_up": param((d, 2 * di), ("embed", "mlp"), dtype=dtype),
        "w_q": param((di, h, dh), ("mlp", "heads", "head_dim"), dtype=dtype),
        "w_k": param((di, h, dh), ("mlp", "heads", "head_dim"), dtype=dtype),
        "w_v": param((di, h, dh), ("mlp", "heads", "head_dim"), dtype=dtype),
        "w_if": param((di, h, 2), ("mlp", "heads", "head_dim"),
                      dtype=torch.float32, scale=0.01),
        "b_if": param((h, 2), ("heads", "head_dim"), init="zeros",
                      dtype=torch.float32),
        "head_norm": rmsnorm_specs(dh),
        "w_down": param((di, d), ("mlp", "embed"), dtype=dtype),
    }


def _mlstm_init_state(b, h, dh, device):
    return (torch.zeros(b, h, dh, dh, device=device),
            torch.zeros(b, h, dh, device=device),
            torch.full((b, h), NEG, device=device))


def _mlstm_cell_step(state, inp):
    """state: (C [B,H,dv,dk], n [B,H,dk], m [B,H]); inp: q,k,v [B,H,dh],
    i/f [B,H]. Returns (state, h [B,H,dh])."""
    c, n, m = state
    q, k, v, ig, fg = inp
    log_f = local_pointwise(F.logsigmoid, fg)
    m_new = torch.maximum(log_f + m, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p[..., None, None] * c + i_p[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n_new = f_p[..., None] * n + i_p[..., None] * k
    num = (c_new @ q[..., None])[..., 0]
    den = torch.maximum((n_new * q).sum(-1).abs(), torch.exp(-m_new))
    return (c_new, n_new, m_new), num / den[..., None]


def mlstm_scan_recurrent(q, k, v, ig, fg, state=None, chunk: int = 64):
    """Step-by-step reference form (exact): chunks of steps, each chunk
    checkpointed. q/k/v [B,S,H,dh], gates [B,S,H]. Returns (h [B,S,H,dh],
    final (C, n, m))."""
    b, s, h, dh = q.shape
    if state is None:
        state = _mlstm_init_state(b, h, dh, q.device)
    l = _chunk_len(s, chunk)

    def body(st, ci):
        def step(st, j):
            t = ci * l + j
            return _mlstm_cell_step(st, (q[:, t], k[:, t], v[:, t], ig[:, t],
                                         fg[:, t]))
        st, hs = scan(step, st, l)
        return st, torch.stack(hs, dim=1)

    state, hs = _chunked(body, tuple(state), s // l)
    return torch.cat(hs, dim=1), state


def mlstm_scan(q, k, v, ig, fg, state=None, chunk: int = 64):
    """Chunkwise-parallel stabilised mLSTM: within a chunk the recurrence
    unrolls to a masked quadratic form; across chunks a loop carries the
    stabilised (C, n, m) state.

    q/k/v [B,S,H,dh] float32 (k pre-scaled 1/sqrt(dh)), gates ig/fg
    [B,S,H]. Returns (h [B,S,H,dh], final (C, n, m)).
    """
    b, s, h, dh = q.shape
    if state is None:
        state = _mlstm_init_state(b, h, dh, q.device)
    l = _chunk_len(s, chunk)
    nc = s // l

    def heads_first(t):               # [B,S,H,...] -> [B,H,S,...]
        return t.transpose(1, 2)

    qh, kh, vh = heads_first(q), heads_first(k), heads_first(v)
    ih, fh = heads_first(ig), heads_first(fg)
    causal = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()

    def body(carry, ci):
        c_prev, n_prev, m_prev = carry            # [B,H,dh,dh],[B,H,dh],[B,H]
        sl = slice(ci * l, (ci + 1) * l)
        qb, kb, vb = qh[:, :, sl], kh[:, :, sl], vh[:, :, sl]  # [B,H,L,dh]
        ib, fb = ih[:, :, sl], fh[:, :, sl]       # [B,H,L]
        lf = F.logsigmoid(fb)
        bcum = torch.cumsum(lf, dim=-1)           # b_t
        # D_tj = b_t - b_j + i_j  (j <= t)
        d_mat = bcum[..., :, None] - bcum[..., None, :] + ib[..., None, :]
        d_mat = d_mat.masked_fill(~causal, NEG)
        m_intra = d_mat.amax(dim=-1)              # [B,H,L]
        m_row = torch.maximum(bcum + m_prev[..., None], m_intra)
        scores = qb @ kb.transpose(-1, -2)
        w_mat = torch.exp(d_mat - m_row[..., None])
        inter_scale = torch.exp(bcum + m_prev[..., None] - m_row)  # [B,H,L]
        ws = w_mat * scores
        num = ws @ vb + inter_scale[..., None] * (qb @ c_prev.transpose(-1,
                                                                      -2))
        den_dot = ws.sum(-1) + inter_scale * (qb @ n_prev[..., None])[..., 0]
        den = torch.maximum(den_dot.abs(), torch.exp(-m_row))
        h_out = num / den[..., None]              # [B,H,L,dh]

        # carry update (end of chunk)
        b_end = bcum[..., -1]                     # [B,H]
        m_new = torch.maximum(b_end + m_prev,
                              (b_end[..., None] - bcum + ib).amax(dim=-1))
        decay_j = torch.exp(b_end[..., None] - bcum + ib - m_new[..., None])
        carry_f = torch.exp(b_end + m_prev - m_new)
        c_new = (carry_f[..., None, None] * c_prev
                 + (vb * decay_j[..., None]).transpose(-1, -2) @ kb)
        n_new = (carry_f[..., None] * n_prev
                 + (decay_j[..., None, :] @ kb)[..., 0, :])
        return (c_new, n_new, m_new), h_out

    state, hs = _chunked(body, tuple(state), nc)
    return torch.cat(hs, dim=2).transpose(1, 2), state


def _heads_proj(x, w):
    """``x [B, S, d]`` times ``w [d, H, k]``: ``[B, S, H, k]``; or, where
    each head reads its own row (``x [B, S, H, d]``), head by head."""
    if x.ndim == 3:
        return torch.einsum("bse,ehk->bshk", x, w)
    return torch.einsum("bshe,ehk->bshk", x, w)


def _mlstm_inputs(u, w_q, w_k, w_v, w_if, b_if):
    """The mLSTM scan's inputs ``(q, k, v, ig, fg)`` (float32, k scaled
    1/sqrt(dh)) projected from ``u`` (:func:`_heads_proj`)."""
    dh = w_q.shape[-1]
    q = _heads_proj(u, w_q).float()
    k = _heads_proj(u, w_k).float() / (dh ** 0.5)
    v = _heads_proj(u, w_v).float()
    gates = _heads_proj(u.float(), w_if) + b_if
    return q, k, v, gates[..., 0], gates[..., 1]


def mlstm_block(p, x, cfg: XLSTMConfig, cache=None):
    """x [B,S,d]. cache: {"c","n","m"}; decode (S == 1) reads and advances
    it, prefill starts from it and fills it, in place. Returns (out,
    cache or None). On DTensors the projections into the scan and the
    scan run together on each rank's local shards
    (``sharding.rules.on_local_shards``: its rows, its heads or its (row,
    head) pairs), so that each rank projects only what its scan reads."""
    b, s, d = x.shape
    di = int(d * cfg.up_factor)
    # the halves' gradients meet laid out as the product is: joined
    # otherwise, DTensor gathers them and runs the weight gradient whole
    # on every model rank
    up = settle_grad(x @ p["w_up"])
    u, z = up[..., :di], up[..., di:]
    ws = tuple(p[k] for k in ("w_q", "w_k", "w_v", "w_if", "b_if"))
    state = None
    if cache is not None:
        state = (cache["c"], cache["n"], cache["m"])

    if cache is not None and s == 1:
        q, k, v, ig, fg = _mlstm_inputs(u, *ws)
        state, h_out = _mlstm_cell_step(
            state, (q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0]))
        h_seq = h_out[:, None]
    elif isinstance(u, DTensor):
        out = on_local_shards(
            lambda u, *t: _flat(mlstm_scan(
                *_mlstm_inputs(u, *t[:5]),
                None if t[5] is None else t[5:], cfg.chunk)),
            (u,) + ws + tuple(state or (None,) * 3),
            ((0, None),) + ((None, 1),) * 4 + ((None, 0),)
            + ((0, 1),) * 3, ((0, 2),) + ((0, 1),) * 3, cfg.n_heads)
        h_seq, state = out[0], out[1:]
    else:
        h_seq, state = mlstm_scan(*_mlstm_inputs(u, *ws), state, cfg.chunk)
    if cache is not None:
        for key, t in zip(("c", "n", "m"), state):
            cache[key].copy_(t)

    hn = _head_norm(h_seq, p["head_norm"]["scale"], (b, s, di), x.dtype)
    return contraction_split(hn * F.silu(z), p["w_down"]) @ p["w_down"], cache


# ---------------------------------------------------------------- sLSTM ----

def slstm_specs(d: int, cfg: XLSTMConfig, dtype=torch.bfloat16):
    h = cfg.n_heads
    dh = d // h
    f = int(d * cfg.slstm_ff)
    return {
        "w_gates": param((d, h, 4 * dh), ("embed", "heads", "head_dim"),
                         dtype=dtype),
        "r_gates": param((h, dh, 4 * dh), ("heads", "head_dim", "mlp"),
                         dtype=dtype, scale=0.02),
        "b_gates": param((h, 4 * dh), ("heads", "head_dim"), init="zeros",
                         dtype=torch.float32),
        "head_norm": rmsnorm_specs(dh),
        "w_ff_gate": param((d, f), ("embed", "mlp"), dtype=dtype),
        "w_ff_up": param((d, f), ("embed", "mlp"), dtype=dtype),
        "w_ff_down": param((f, d), ("mlp", "embed"), dtype=dtype),
    }


def _slstm_cell_step(params_r, state, wx):
    """state: (h, c, n, m) each [B,H,dh]; wx [B,H,4dh] input
    pre-activations. Returns (state, h_new)."""
    r, b_g = params_r
    h_prev, c, n, m = state
    pre = wx + torch.einsum("bhd,hdg->bhg", h_prev, r) + b_g
    dh = h_prev.shape[-1]
    zt, it, ft, ot = (pre[..., :dh], pre[..., dh:2 * dh],
                      pre[..., 2 * dh:3 * dh], pre[..., 3 * dh:])
    z = torch.tanh(zt)
    log_f = local_pointwise(F.logsigmoid, ft)
    m_new = torch.maximum(log_f + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(ot) * c_new / n_new.clamp_min(1e-6)
    return (h_new, c_new, n_new, m_new), h_new


def slstm_scan(wx, r, bg, state=None, chunk: int = 64):
    """The sLSTM recurrence over ``wx [B,S,H,4dh]`` (input
    pre-activations) from ``state`` (h, c, n, m, each ``[B,H,dh]``; None:
    the zero state), in chunks of steps. Returns (h [B,S,H,dh], final
    state)."""
    b, s, h, g = wx.shape
    if state is None:
        state = tuple(torch.zeros(b, h, g // 4, device=wx.device)
                      for _ in range(3)) + (
            torch.full((b, h, g // 4), NEG, device=wx.device),)
    l = _chunk_len(s, chunk)

    def body(st, ci):
        st, hs = scan(lambda st, j: _slstm_cell_step(
            (r, bg), st, wx[:, ci * l + j]), st, l)
        return st, torch.stack(hs, dim=1)

    state, hs = _chunked(body, tuple(state), s // l)
    return torch.cat(hs, dim=1), state


def _flat(out):
    """``(h, state)`` as one tuple."""
    return (out[0],) + tuple(out[1])


def slstm_block(p, x, cfg: XLSTMConfig, cache=None):
    """x [B,S,d]. cache: {"h","c","n","m"} each [B,H,dh]; decode (S == 1)
    reads and advances it, prefill starts from it and fills it, in place.
    Returns (out, cache or None). On DTensors the input projection and the
    scan run on local shards, as in :func:`mlstm_block`."""
    b, s, d = x.shape
    ws = (p["w_gates"], p["r_gates"], p["b_gates"])
    state = None
    if cache is not None:
        state = (cache["h"], cache["c"], cache["n"], cache["m"])

    def scan_of(x, w, r, bg, *st):
        return _flat(slstm_scan(_heads_proj(x, w).float(), r.float(), bg,
                                None if st[0] is None else st, cfg.chunk))
    if cache is not None and s == 1:
        state, h_out = _slstm_cell_step(
            (ws[1].float(), ws[2]), state,
            torch.einsum("bsd,dhg->bshg", x, ws[0]).float()[:, 0])
        h_seq = h_out[:, None]
    elif isinstance(x, DTensor):
        out = on_local_shards(
            scan_of, (x,) + ws + tuple(state or (None,) * 4),
            ((0, None), (None, 1), (None, 0), (None, 0)) + ((0, 1),) * 4,
            ((0, 2),) + ((0, 1),) * 4, cfg.n_heads)
        h_seq, state = out[0], out[1:]
    else:
        out = scan_of(x, *ws, *(state or (None,)))
        h_seq, state = out[0], out[1:]
    if cache is not None:
        for key, t in zip(("h", "c", "n", "m"), state):
            cache[key].copy_(t)

    hn = _head_norm(h_seq, p["head_norm"]["scale"], (b, s, d), x.dtype)
    # gated FFN (proj factor 4/3); jax.nn.gelu is the tanh approximation
    g = hn @ p["w_ff_gate"]
    u = hn @ p["w_ff_up"]
    return (F.gelu(g, approximate="tanh") * u) @ p["w_ff_down"], cache
