"""Shared transformer building blocks (``repro.models.layers``).

Activation layout is BSHD (``[batch, seq, heads, head_dim]``), as in the
reference; parameters are nested dicts of tensors under the reference's
names (``wq [d, H, Dh]``, ``wo [H, Dh, d]``, ...).

Attention is the reference's flash attention with its custom VJP: the
forward keeps only ``(q, k, v, out, lse)``, and the backward recomputes each
kv block's scores from them, so no layer keeps its score blocks for
autograd. Two ``torch.autograd.Function``s carry it, chosen by the arguments
and by no switch:

* on a CUDA tensor, causal self-attention (``pos_offset == 0``,
  ``Skv == S``, with or without a window) and non-causal attention with
  ``Skv == S``, ``pos_offset == 0`` and no window (the enc-dec encoder, and
  cross-attention where the decoder's length equals the source's) are
  :class:`_FlashAttention` over the whole sequence: its forward is the
  flash kernel (``kernels/flash_attention.py``, which also writes ``lse``
  when a gradient is needed), its backward the flash backward kernel;
* everything else (CPU tensors, cross-attention with ``Skv != S``,
  ``pos_offset != 0``, a window on non-causal attention) is
  :class:`_Flash`, the reference's ``_flash`` over one q chunk:
  ``blockwise_attention``'s q chunks over static kv ranges,
  ``_flash_fwd_impl``'s online softmax over kv sub-chunks, and
  ``_flash_bwd``'s backward in plain torch.

On DTensors (inside a mesh context) attention runs on each rank's local
shard (:func:`_sharded_attention`): the local tensors take the route above,
so on the card every rank launches the kernels on its own batch (or heads)
shard. Under ``seq_shard_attn`` K/V go through
``kv_replicated_constraint`` and q keeps its sequence shard, as in the
reference: each rank attends with its own queries over the gathered K/V,
one kernel call a block of keys (:class:`_SeqShardAttention`). Where a
mesh dim splits the query heads and the kv heads do not divide it, each
rank takes the kv heads its own query heads read, as the reference's
repeated K/V shard over the query heads (:func:`attention_block`).

Decode attends in plain torch; on a cache split over its sequence each
rank attends over its own rows (:func:`_sharded_decode`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels import flash_attention as _fa
from ..kernels import rope as _rp
from ..obs import profile_range
from ..sharding.rules import (kv_replicated_constraint, local_rows,
                              write_seq)
from .loop import scan
from .specs import param

NEG_INF = -1e30

# the attention and the RoPE of the kernel route, forward and backward;
# module attributes so that a check can swap in the plain versions on the
# card and compare
_flash_forward = _fa.flash_attention_kernel
_flash_backward = _fa.flash_attention_backward_kernel
_rope_kernel = _rp.rope_kernel


# ---- norms -------------------------------------------------------------------

def rmsnorm_specs(d: int):
    return {"scale": param((d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    with profile_range("model.norm"):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + eps) * p["scale"].float()
        return out.to(x.dtype)


# ---- rope ----------------------------------------------------------------------

class _Rope(torch.autograd.Function):
    """RoPE of ``x [B, S, H, D]`` in one call of ``_rope_kernel``; the
    backward is the same kernel rotating the cotangent back (``inverse``),
    so nothing of x is saved, only the positions."""

    @staticmethod
    def forward(ctx, x, positions, theta):
        ctx.save_for_backward(positions)
        ctx.theta = theta
        return _rope_kernel(x, positions, theta)

    @staticmethod
    def backward(ctx, dy):
        (positions,) = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        return _rope_kernel(dy, positions, ctx.theta, inverse=True), None, None


def _rope_local(x):
    """Whether DTensor ``x [B, S, H, D]`` rotates on its local shard: RoPE
    is elementwise over (b, s, h) and linear, so a batch, sequence or head
    shard, a replica and a partial sum or mean do; a split head dim would
    part the pairs (i, i + D/2)."""
    return x.dim() == 4 and all(
        p.is_replicate() or (type(p) is Shard and p.dim in (0, 1, 2))
        or (p.is_partial() and p.reduce_op in ("sum", "avg"))
        for p in x.placements)


def apply_rope(x, positions, theta: float = 1e4):
    """x [..., S, H, D] (D even), positions [..., S] int.

    ``[B, S, H, D]`` takes :class:`_Rope` both ways, whose wrapper launches
    the RoPE kernel on a CUDA (or fake) tensor and runs the torch ops
    (``kernels.rope.rope_plain``) on a CPU one. A DTensor does so on its
    local shard where :func:`_rope_local` allows, with its own rows of the
    positions; any other DTensor takes the torch ops on the DTensor."""
    with profile_range("model.rope"):
        if not isinstance(x, DTensor):
            return _Rope.apply(x, positions, theta)
        if isinstance(positions, DTensor) or not _rope_local(x):
            return _rp.rope_plain(x, positions, theta)
        # an empty shard's first index may lie past the end
        b0, nb = local_rows(x, 0)
        s0, ns = local_rows(x, 1)
        positions = positions.narrow(-1, min(s0, x.shape[1]), ns)
        if positions.dim() == 2:
            positions = positions.narrow(0, min(b0, x.shape[0]), nb)
        y = _Rope.apply(x.to_local(), positions, theta)
        return DTensor.from_local(
            y, x.device_mesh, x.placements, shape=x.shape,
            stride=tuple(math.prod(x.shape[i + 1:]) for i in range(4)))


# ---- linear / embedding ---------------------------------------------------------

def linear_specs(d_in: int, d_out: int, axes=("embed", "mlp"),
                 dtype=torch.bfloat16):
    return {"w": param((d_in, d_out), axes, dtype=dtype)}


def embed_specs(vocab: int, d: int, dtype=torch.bfloat16):
    return {"table": param((vocab, d), ("vocab", "embed"), dtype=dtype,
                           scale=0.02)}


def embed(p, ids):
    return F.embedding(ids, p["table"])


# ---- SwiGLU MLP ------------------------------------------------------------------

def mlp_specs(d: int, f: int, dtype=torch.bfloat16):
    return {
        "w_gate": param((d, f), ("embed", "mlp"), dtype=dtype),
        "w_up": param((d, f), ("embed", "mlp"), dtype=dtype),
        "w_down": param((f, d), ("mlp", "embed"), dtype=dtype),
    }


def mlp(p, x):
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    with profile_range("model.swiglu"):
        a = F.silu(g) * u
    return a @ p["w_down"]


# ---- attention -------------------------------------------------------------------

def attn_specs(d: int, n_heads: int, n_kv: int, d_head: int,
               dtype=torch.bfloat16):
    return {
        "wq": param((d, n_heads, d_head), ("embed", "heads", "head_dim"),
                    dtype=dtype),
        "wk": param((d, n_kv, d_head), ("embed", "kv_heads", "head_dim"),
                    dtype=dtype),
        "wv": param((d, n_kv, d_head), ("embed", "kv_heads", "head_dim"),
                    dtype=dtype),
        "wo": param((n_heads, d_head, d), ("heads", "head_dim", "embed"),
                    dtype=dtype),
    }


def _mask_scores(s, qpos, kpos, window, causal):
    mask = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool,
                      device=s.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return s.masked_fill(~mask, NEG_INF)


def _flash_fwd_impl(q, k, v, qpos0, kpos0, window, causal, k_chunk):
    """Online softmax of one q chunk ``[B, cq, H, D]`` over ``k``/``v``
    ``[B, Skv, Hkv, D]`` in kv sub-chunks, grouped by kv head. Returns
    ``(out [B, cq, H, D] in q.dtype, lse [B, Hkv, rep, cq])``."""
    b, cq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = 1.0 / (d ** 0.5)
    ck = min(k_chunk, skv)
    if skv % ck:
        ck = skv
    qg = q.reshape(b, cq, hkv, rep, d).float()
    qpos = qpos0 + torch.arange(cq, device=q.device)
    m_run = torch.full((b, hkv, rep, cq), NEG_INF, device=q.device)
    l_run = torch.zeros(b, hkv, rep, cq, device=q.device)
    acc = torch.zeros(b, hkv, rep, cq, d, device=q.device)

    def step(carry, idx):
        m_run, l_run, acc = carry
        k_blk = k[:, idx * ck:(idx + 1) * ck].float()
        v_blk = v[:, idx * ck:(idx + 1) * ck].float()
        kpos = kpos0 + idx * ck + torch.arange(ck, device=q.device)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_blk)
        s = _mask_scores(s * scale, qpos, kpos, window, causal)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p,
                                                    v_blk)
        return (m_new, l_run, acc), None

    (m_run, l_run, acc), _ = scan(step, (m_run, l_run, acc), skv // ck)
    l_safe = l_run.clamp_min(1e-30)
    out = acc / l_safe[..., None]
    lse = m_run + torch.log(l_safe)
    out_b = out.permute(0, 3, 1, 2, 4).reshape(b, cq, h, d).to(q.dtype)
    return out_b, lse


def _flash_bwd(qpos0, kpos0, window, causal, k_chunk, res, dout):
    """The reference's backward of one q chunk: recompute each kv
    sub-chunk's ``p = exp(s - lse)`` from the saved ``(q, k, v, out, lse)``
    and accumulate ``dq``; ``dk``, ``dv`` per sub-chunk. Returns ``(dq, dk,
    dv)`` in the dtypes of ``q``, ``k``, ``v``."""
    q, k, v, out, lse = res
    b, cq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = 1.0 / (d ** 0.5)
    ck = min(k_chunk, skv)
    if skv % ck:
        ck = skv
    qg = q.reshape(b, cq, hkv, rep, d).float()
    og = out.reshape(b, cq, hkv, rep, d).float()
    dog = dout.reshape(b, cq, hkv, rep, d).float()
    qpos = qpos0 + torch.arange(cq, device=q.device)
    delta = torch.einsum("bqgrd,bqgrd->bgrq", og, dog)    # rowsum(dO*O)
    dq = torch.zeros(b, cq, hkv, rep, d, device=q.device)

    def step(dq, idx):
        k_blk = k[:, idx * ck:(idx + 1) * ck].float()
        v_blk = v[:, idx * ck:(idx + 1) * ck].float()
        kpos = kpos0 + idx * ck + torch.arange(ck, device=q.device)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k_blk)
        s = _mask_scores(s * scale, qpos, kpos, window, causal)
        p = torch.exp(s - lse[..., None])                 # exact softmax
        dv_blk = torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v_blk)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bgrqk,bkgd->bqgrd", ds, k_blk)
        return dq, (torch.einsum("bgrqk,bqgrd->bkgd", ds, qg), dv_blk)

    dq, blocks = scan(step, dq, skv // ck)
    dk = torch.cat([blk[0] for blk in blocks], dim=1)
    dv = torch.cat([blk[1] for blk in blocks], dim=1)
    return (dq.reshape(b, cq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` (``jax.custom_vjp``) over one q chunk
    ``[B, cq, H, D]`` and its static kv slice: the forward is
    ``_flash_fwd_impl`` and saves ``(q, k, v, out, lse)``; the backward is
    ``_flash_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, qpos0, kpos0, window, causal, k_chunk):
        out, lse = _flash_fwd_impl(q, k, v, qpos0, kpos0, window, causal,
                                   k_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (qpos0, kpos0, window, causal, k_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        grads = _flash_bwd(*ctx.args, ctx.saved_tensors, dout)
        return grads + (None,) * 5


def _bhsd(t):
    return t.transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """Attention of ``q [B, S, H, D]`` over ``k``, ``v [B, S, Hkv, D]``
    (causal or not; GQA by the kernels' head map, no repeated heads) in one
    call of ``_flash_forward``, which writes ``lse`` when an input needs a
    gradient; the backward is one call of ``_flash_backward`` on the saved
    ``(q, k, v, out, lse)``, whose ``dk``/``dv`` sum over each kv head's
    query heads."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal=True):
        b, s, h, _ = q.shape
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = (torch.empty(b, h, s, dtype=torch.float32, device=q.device)
               if any(ctx.needs_input_grad[:3]) else None)
        _flash_forward(_bhsd(q), _bhsd(k), _bhsd(v), causal=causal,
                       window=window, out=_bhsd(out), lse=lse)
        if lse is not None:
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        grads = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in (q, k, v)]
        _flash_backward(_bhsd(q), _bhsd(k), _bhsd(v), _bhsd(out),
                        _bhsd(dout), lse, causal=ctx.causal,
                        window=ctx.window, dq=_bhsd(grads[0]),
                        dk=_bhsd(grads[1]), dv=_bhsd(grads[2]))
        return grads[0], grads[1], grads[2], None, None


def _kernel_route(q, k, pos_offset: int, causal: bool,
                  window: int | None = None) -> bool:
    """The flash kernels' case on CUDA tensors, with or without a gradient
    to take (the kernels carry the reference's custom VJP): ``Skv == S`` at
    ``pos_offset == 0``, causal with or without a window, or non-causal
    without one (then no mask depends on a position, so any such call is
    the kernel's function). Fake tensors take the same route, so that a
    dry run's trace holds the kernels."""
    return ((q.device.type == "cuda" or is_fake(q)) and pos_offset == 0
            and k.shape[1] == q.shape[1] and (causal or window is None))


def blockwise_attention(q, k, v, *, window: int | None = None,
                        q_chunk: int = 1024, k_chunk: int = 1024,
                        pos_offset: int = 0, causal: bool = True):
    """Causal (optionally sliding-window) or bidirectional attention, BSHD.

    q [B,S,H,D], k/v [B,Skv,HKV,D] with Skv == S + pos_offset (self-attention:
    pos_offset=0; cross-attention: causal=False, any Skv). On CUDA tensors,
    the kernels' case (``_kernel_route``) is one :class:`_FlashAttention`
    (one forward kernel launch, one backward call); otherwise a Python loop
    over q chunks with static kv ranges (never-visible blocks skipped), each
    a :class:`_Flash` with an online softmax over kv sub-chunks, as in the
    reference.
    """
    if isinstance(q, DTensor):
        return _sharded_attention(q, k, v, window=window, q_chunk=q_chunk,
                                  k_chunk=k_chunk, pos_offset=pos_offset,
                                  causal=causal)
    b, s, h, d = q.shape
    skv = k.shape[1]
    if _kernel_route(q, k, pos_offset, causal, window):
        return _FlashAttention.apply(q, k, v, window, causal)
    cq = min(q_chunk, s)
    if s % cq:
        cq = s                       # small/odd seq: single chunk
    outs = []
    for qi in range(s // cq):
        q_blk = q[:, qi * cq:(qi + 1) * cq]
        hi = pos_offset + (qi + 1) * cq if causal else skv
        lo = 0
        if window is not None:
            lo = max(0, pos_offset + qi * cq - window + 1)
        ck = min(k_chunk, hi - lo)
        if hi % ck and (hi - lo) % ck:
            ck = hi - lo             # non-aligned range: single sub-chunk
        # align the static slice to sub-chunk multiples
        n_sub = -(-(hi - lo) // ck)
        lo_al = max(0, hi - n_sub * ck)
        outs.append(_Flash.apply(q_blk, k[:, lo_al:hi], v[:, lo_al:hi],
                                 pos_offset + qi * cq, lo_al, window, causal,
                                 ck))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


class _SeqShardAttention(torch.autograd.Function):
    """Attention of a sequence shard ``q [B, s, H, D]``, positions ``[r*s,
    (r+1)*s)``, over the whole ``k``, ``v [B, n*s, Hkv, D]`` (no window,
    no offset). The kernels take as many keys as queries, so the keys go in
    blocks of ``s``: each visible block is one ``_flash_forward`` call
    (causal on the diagonal block ``r`` and whole before it; every block
    when not causal), and the blocks' outputs merge by their ``lse``. The
    backward runs each block's ``_flash_backward`` against the merged
    ``out`` and ``lse``, the softmax over all keys, so each block's
    ``dk``/``dv`` are its own and the blocks' ``dq`` sum."""

    @staticmethod
    def forward(ctx, q, k, v, r, causal):
        b, s, h, _ = q.shape
        n = r + 1 if causal else k.shape[1] // s
        outs, lses = [], []
        for j in range(n):
            out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
            lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
            blk = slice(j * s, (j + 1) * s)
            _flash_forward(_bhsd(q), _bhsd(k[:, blk]), _bhsd(v[:, blk]),
                           causal=causal and j == r, window=None,
                           out=_bhsd(out), lse=lse)
            outs.append(out)
            lses.append(lse)
        lse = torch.logsumexp(torch.stack(lses), dim=0)
        out = sum(torch.exp(l - lse).transpose(1, 2)[..., None] * o.float()
                  for l, o in zip(lses, outs)).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.r, ctx.causal, ctx.n = r, causal, n
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        s = q.shape[1]
        dout = dout.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
        dq_j = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        for j in range(ctx.n):
            blk = slice(j * s, (j + 1) * s)
            _flash_backward(_bhsd(q), _bhsd(k[:, blk]), _bhsd(v[:, blk]),
                            _bhsd(out), _bhsd(dout), lse,
                            causal=ctx.causal and j == ctx.r, window=None,
                            dq=_bhsd(dq_j), dk=_bhsd(dk[:, blk]),
                            dv=_bhsd(dv[:, blk]))
            dq += dq_j.float()
        return dq.to(q.dtype), dk, dv, None, None


def _seq_shard(q, k, v, kw):
    """``(r, n)``: q's sequence is shard ``r`` of ``n`` equal ones, and K/V
    are whole on every mesh dim that shards it, in the case
    :class:`_SeqShardAttention` takes (``Skv == S``, no offset, no window);
    else None."""
    s = q.shape[1]
    if (kw["window"] is not None or kw["pos_offset"] or k.shape[1] != s):
        return None
    mesh, coord = q.device_mesh, q.device_mesh.get_coordinate()
    lo, size = 0, s
    for i, p in enumerate(q.placements):
        if p == Shard(1) and mesh.size(i) > 1:
            if (k.placements[i] != Replicate()
                    or v.placements[i] != Replicate() or size % mesh.size(i)):
                return None
            size //= mesh.size(i)
            lo += coord[i] * size
    return None if size == s else (lo // size, s // size)


def _sharded_attention(q, k, v, **kw):
    """:func:`blockwise_attention` of DTensors on each rank's local shard.
    Attention is independent over batch and over heads, so the shards that
    stay local are the batch (dim 0) and, where q, k and v all shard it on
    the same mesh axis, the heads (dim 2). A sequence shard of q (dim 1)
    stays too where K/V are whole on its mesh dims (sequence parallelism,
    after ``kv_replicated_constraint``): each rank attends with its own
    queries (:class:`_SeqShardAttention`). Any other sharding (a sequence
    shard with a window, a Partial sum) is gathered first. The output has
    q's local layout."""
    mesh = q.device_mesh
    seq = _seq_shard(q, k, v, kw)

    def keep(i):
        p = q.placements[i]
        if p == Shard(0) or (p == Shard(2) and k.placements[i] == p
                             and v.placements[i] == p):
            return p
        if p == Shard(1) and seq is not None:
            return p
        return Replicate()
    pl = [keep(i) for i in range(mesh.ndim)]
    kv_pl = [Replicate() if p == Shard(1) else p for p in pl]
    # where q's queries are split, each rank's dK/dV is a partial sum
    kv_grad = [Partial() if p == Shard(1) else p for p in pl]
    ql = q.redistribute(mesh, pl).to_local()
    kl, vl = (t.redistribute(mesh, kv_pl).to_local(grad_placements=kv_grad)
              for t in (k, v))
    if seq is None:
        out = blockwise_attention(ql, kl, vl, **kw)
    else:
        out = _SeqShardAttention.apply(ql, kl, vl, seq[0], kw["causal"])
    return DTensor.from_local(out, mesh, pl)


def _sharded_decode(q, k_cache, v_cache, pos: int, window):
    """:func:`decode_attention` of DTensors on each rank's local shard: the
    batch (dim 0) and heads (dim 2) stay split where q and both caches
    split them on the same mesh axis. Where both caches split their
    sequence (dim 1), q is gathered over that axis (one token's heads)
    and each rank attends over its own rows, as the reference's masked
    read of a sequence-sharded cache does; the ranks' softmaxes merge by
    their running maxima (:func:`_merge_decode`). Anything else is
    gathered first. The output has q's local layout, whole on the
    sequence's mesh dims."""
    mesh = q.device_mesh
    seq = [i for i in range(mesh.ndim) if mesh.size(i) > 1
           and k_cache.placements[i] == v_cache.placements[i] == Shard(1)]

    def keep(i):
        p = q.placements[i]
        if p in (Shard(0), Shard(2)) and (k_cache.placements[i] == p
                                          and v_cache.placements[i] == p):
            return p
        return Replicate()
    pl = [keep(i) for i in range(mesh.ndim)]
    kv_pl = [Shard(1) if i in seq else p for i, p in enumerate(pl)]
    ql = q.redistribute(mesh, pl).to_local()
    kl, vl = (t.redistribute(mesh, kv_pl).to_local()
              for t in (k_cache, v_cache))
    if not seq:
        return DTensor.from_local(
            decode_attention(ql, kl, vl, pos, window=window), mesh, pl)
    off, _ = local_rows(k_cache, 1)
    lo = 0 if window is None else max(0, pos - window + 1)
    a, z = max(lo, off) - off, min(pos + 1, off + kl.shape[1]) - off
    acc, m = _decode_partial(ql, kl[:, a:max(a, z)], vl[:, a:max(a, z)])
    out = _merge_decode(acc, m, mesh, seq)
    return DTensor.from_local(out.reshape(ql.shape).to(q.dtype), mesh, pl)


def _decode_partial(q, k, v):
    """One rank's share of a decode step over its visible cache rows
    ``k``, ``v [B, n, Hkv, D]`` (``n`` may be 0): ``(acc [B, Hkv, rep,
    D + 1], m [B, Hkv, rep])``, the unnormalised output with the
    softmax's sum as its last column, both relative to the rank's maximum
    score ``m`` (``NEG_INF`` without rows)."""
    b, _, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k.float()) * (1.0 / d ** 0.5)
    m = s.amax(dim=-1) if k.shape[1] else torch.full(
        qg.shape[:-1], NEG_INF, device=q.device)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bgrk,bkgd->bgrd", p, v.float())
    return torch.cat([acc, p.sum(dim=-1)[..., None]], dim=-1), m


def _merge_decode(acc, m, mesh, seq):
    """The softmax over every rank's rows from each rank's
    :func:`_decode_partial`: the maxima's all-reduce (max) over the mesh
    dims ``seq``, then one all-reduce (sum) of the rescaled outputs and
    sums. Returns ``[B, H, D]``."""
    def reduced(t, op):
        return DTensor.from_local(
            t, mesh, [Partial(op) if i in seq else Replicate()
                      for i in range(mesh.ndim)]).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()
    acc = reduced(acc * torch.exp(m - reduced(m, "max"))[..., None], "sum")
    out = acc[..., :-1] / acc[..., -1:]
    return out.reshape(out.shape[0], -1, out.shape[-1])


def decode_attention(q, k_cache, v_cache, pos: int, *,
                     window: int | None = None):
    """Single-step decode: q [B,1,H,D], caches [B,Smax,HKV,D], pos int.

    Attends to cache entries ``pos - window < j <= pos`` (the caller has
    already written the current token at ``pos``). The reference masks the
    rest of the cache with -1e30, whose softmax weights are exactly 0; the
    port reads only the visible slice, which gives the same sums. On
    DTensors it runs on each rank's local shard (:func:`_sharded_decode`).
    """
    if isinstance(q, DTensor):
        return _sharded_decode(q, k_cache, v_cache, pos, window)
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    rep = h // hkv
    scale = 1.0 / (d ** 0.5)
    lo = 0 if window is None else max(0, pos - window + 1)
    k_vis = k_cache[:, lo:pos + 1].float()
    v_vis = v_cache[:, lo:pos + 1].float()
    qg = q.reshape(b, hkv, rep, d).float()
    s = torch.einsum("bgrd,bkgd->bgrk", qg, k_vis) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, v_vis)
    return out.reshape(b, 1, h, d).to(q.dtype)


def _rank_kv_heads(q, n_kv: int, x):
    """Where mesh dims split q's heads (dim 2) and ``n_kv`` kv heads do
    not divide them, so that K/V and their weights stay whole there (and
    so does ``x``): ``(dims, lo, n)``, those mesh dims and the kv heads
    ``[lo, lo + n)`` that this rank's query heads read (query head ``h``
    reads ``h // rep``, the reference's ``repeat_kv``), in equal
    consecutive groups as the flash kernels' GQA map reads them; else
    None."""
    mesh = q.device_mesh
    dims = [i for i, p in enumerate(q.placements)
            if p == Shard(2) and mesh.size(i) > 1]
    if (not dims or n_kv % math.prod(mesh.size(i) for i in dims) == 0
            or any(x.placements[i] != Replicate() for i in dims)
            or any(p not in (Shard(0), Shard(2), Replicate())
                   for p in q.placements)):
        return None
    lo, hq = local_rows(q, 2)
    rep = q.shape[2] // n_kv
    if hq % rep and rep % hq:        # a kv head's queries across ranks
        return None
    return dims, lo // rep, max(1, hq // rep)


def _partial_local(t, dims):
    """DTensor ``t``'s local tensor, whose gradient is one term of a sum
    over the mesh dims ``dims`` (``t`` is whole there; each rank uses its
    own part of it)."""
    return t.to_local(grad_placements=[Partial() if i in dims else p
                                       for i, p in enumerate(t.placements)])


def attention_block(p, x, positions, cfg, cache=None, pos=None):
    """Full GQA/SWA attention sublayer (no norm/residual: the caller owns
    those).

    Train/prefill: blockwise attention over x itself; a ``cache`` dict is
    filled at [0, S). Decode: cache given and x has S == 1 -> write the
    cache at ``pos`` and attend to it. The port writes caches in place (the
    reference donates them) and returns the same dict. Returns
    ``(out [B, S, d_model], cache or None)``.

    With ``repeat_kv`` the reference materialises K/V at the full head
    count; the kernel's GQA map reads kv head ``h // rep`` instead, which is
    the same, so only the plain route repeats. On DTensors whose query
    heads a mesh dim splits where the kv heads do not divide it, the
    reference's repeated K/V shard over the query heads: each rank takes
    the kv heads its own query heads read (:func:`_rank_kv_heads`),
    projected from its slice of ``wk``/``wv`` in training and sliced from
    the whole K/V that a prefill writes to its cache, and attends on its
    own heads.
    """
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q = apply_rope(q, positions, cfg.rope_theta)
    decode = cache is not None and s == 1
    split = None
    if (getattr(cfg, "repeat_kv", False) and isinstance(q, DTensor)
            and not decode):
        split = _rank_kv_heads(q, p["wk"].shape[1], x)
    if split is not None and cache is None:
        dims, lo, n = split
        xl = _partial_local(x, dims)
        # the weights' gradients also sum over the ranks of x's own shards:
        # each a full-size local tensor, zero outside the rank's kv heads
        wdims = dims + [i for i, pl in enumerate(x.placements)
                        if pl.is_shard()]
        kk, vv = (torch.einsum("bsd,dhk->bshk", xl, _partial_local(
            p[w], wdims).narrow(1, lo, n)) for w in ("wk", "wv"))
        kk = apply_rope(kk, positions, cfg.rope_theta)
    else:
        k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
        k = apply_rope(k, positions, cfg.rope_theta)
        if cache is not None:
            write_seq(cache["k"], pos if decode else 0, k)
            write_seq(cache["v"], pos if decode else 0, v)
        kk, vv = k, v
    if decode:
        out = decode_attention(q, cache["k"], cache["v"], pos,
                               window=cfg.window)
    elif split is not None:
        if cache is not None:
            kk, vv = (_partial_local(t, split[0]).narrow(2, *split[1:])
                      for t in (kk, vv))
        out = DTensor.from_local(
            blockwise_attention(q.to_local(), kk, vv, window=cfg.window,
                                q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk),
            q.device_mesh, q.placements)
    else:
        q_chunk = cfg.q_chunk
        if getattr(cfg, "seq_shard_attn", False):
            # gather K/V over the seq axis before any head repeat: the
            # all-gather moves n_kv_heads-sized tensors
            kk = kv_replicated_constraint(kk)
            vv = kv_replicated_constraint(vv)
            q_chunk = s                      # one seq-sharded q block
        if (getattr(cfg, "repeat_kv", False)
                and not _kernel_route(q, k, 0, True)):
            rep = q.shape[2] // k.shape[2]
            kk = kk.repeat_interleave(rep, dim=2)
            vv = vv.repeat_interleave(rep, dim=2)
        out = blockwise_attention(q, kk, vv, window=cfg.window,
                                  q_chunk=q_chunk, k_chunk=cfg.k_chunk)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, cache
