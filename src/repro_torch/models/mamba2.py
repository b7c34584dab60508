"""Mamba2 (SSD) blocks (``repro.models.mamba2``): the chunked parallel form
for training and prefill, and the O(1)-state decode step.

Chunked SSD (Mamba2 paper, §6): within a chunk the scalar-decay linear
recurrence is a masked quadratic form; across chunks a loop carries the
float32 ``[B, H, P, N]`` state (the reference's ``lax.scan``).

Layout: x ``[B, S, H, P]`` (heads x head dim = d_inner), B/C ``[B, S, G,
N]`` shared per group; head ``h`` reads group ``h // (H // G)``.

Where the reference mixes a bfloat16 and a float32 operand, jnp promotes
to float32; torch does not promote inside ``einsum``, so the port casts the
narrower operand up where the reference's promotion happens.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .layers import rmsnorm_specs
from .loop import scan
from .specs import param
from ..sharding.rules import on_local_shards, settle_grad


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64          # N
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64         # P
    n_groups: int = 1
    chunk: int = 128


def d_inner(d_model: int, cfg: SSMConfig) -> int:
    return d_model * cfg.expand


def n_heads_ssm(d_model: int, cfg: SSMConfig) -> int:
    return d_inner(d_model, cfg) // cfg.head_dim


def mamba_specs(d: int, cfg: SSMConfig, dtype=torch.bfloat16):
    di = d_inner(d, cfg)
    h = n_heads_ssm(d, cfg)
    gn = cfg.n_groups * cfg.d_state
    conv_ch = di + 2 * gn
    return {
        "w_in": param((d, 2 * di + 2 * gn + h), ("embed", "mlp"), dtype=dtype),
        "conv_w": param((cfg.d_conv, conv_ch), ("conv_k", "mlp"), dtype=dtype,
                        scale=0.5),
        "conv_b": param((conv_ch,), ("mlp",), init="zeros", dtype=dtype),
        "dt_bias": param((h,), ("heads",), init="zeros", dtype=torch.float32),
        "a_log": param((h,), ("heads",), init="ones", dtype=torch.float32),
        "d_skip": param((h,), ("heads",), init="ones", dtype=torch.float32),
        "norm": rmsnorm_specs(di),
        "w_out": param((di, d), ("mlp", "embed"), dtype=dtype),
    }


def _segsum_mask(a_cum):
    """a_cum [..., L] -> decay matrix exp(a_cum_i - a_cum_j) masked j<=i.

    The masked entries are exponentiated as ``exp(-inf) = 0`` rather than
    computed and then replaced: the values are the reference's, and the
    gradient stays finite where ``a_cum_i - a_cum_j`` (j > i) would
    overflow float32 (the reference's ``where`` after ``exp`` gives 0 x inf
    = NaN there)."""
    l = a_cum.shape[-1]
    diff = a_cum[..., :, None] - a_cum[..., None, :]
    mask = torch.ones(l, l, dtype=torch.bool, device=a_cum.device).tril()
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def ssd_chunked(x, dt, a, b, c, chunk: int, h0=None):
    """Chunked SSD scan.

    x  [B,S,H,P]   inputs (per head)
    dt [B,S,H]     discretization steps (post-softplus, >0)
    a  [H]         negative decay rates (A = -exp(a_log))
    b  [B,S,G,N]   input maps;  c [B,S,G,N] output maps; G divides H
    Returns (y [B,S,H,P] float32, h_final [B,H,P,N] float32).

    On DTensors the scan runs on each rank's local shard, the heads on the
    mesh's model axis (:func:`_sharded_ssd`).
    """
    if isinstance(x, DTensor):
        return _sharded_ssd(x, dt, a, b, c, chunk, h0)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    l = min(chunk, s)
    if s % l:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a "
                         f"multiple of the chunk {l}")
    nc = s // l

    xc = x.reshape(bsz, nc, l, h, p)
    dtc = dt.reshape(bsz, nc, l, h)
    bh = b.reshape(bsz, nc, l, g, n).repeat_interleave(rep, dim=3)
    ch = c.reshape(bsz, nc, l, g, n).repeat_interleave(rep, dim=3)

    adt = dtc * a                                          # [B,nc,L,H]
    a_cum = torch.cumsum(adt, dim=2)

    # intra-chunk quadratic part
    lmat = _segsum_mask(a_cum.permute(0, 1, 3, 2))        # [B,nc,H,L,L]
    scores = torch.einsum("bclhn,bcjhn->bchlj", ch, bh)   # C_i . B_j
    scores = scores.float() * lmat
    xdt = xc.float() * dtc[..., None]                     # dt_j x_j
    y_intra = torch.einsum("bchlj,bcjhp->bclhp", scores, xdt)

    # chunk-final states: sum_j exp(a_end - a_j) dt_j B_j x_j^T [B,nc,H,P,N]
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # [B,nc,L,H]
    states = torch.einsum("bclh,bclhn,bclhp->bchpn", decay_to_end * dtc,
                          bh.float(), xc.float())

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(a_cum[:, :, -1, :])           # [B,nc,H]
    h_prev = (torch.zeros(bsz, h, p, n, device=x.device) if h0 is None
              else h0)
    def step(h_prev, ci):
        return (h_prev * chunk_decay[:, ci, :, None, None] + states[:, ci],
                h_prev)

    h_prev, before = scan(step, h_prev, nc)
    h_before = torch.stack(before, dim=1)                 # [B,nc,H,P,N]

    # contribution of the carried state: exp(a_cum_i) C_i . H_prev
    in_decay = torch.exp(a_cum)                           # [B,nc,L,H]
    y_inter = torch.einsum("bclh,bclhn,bchpn->bclhp", in_decay,
                           ch.float(), h_before.to(ch.dtype).float())
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, h_prev


def _sharded_ssd(x, dt, a, b, c, chunk: int, h0=None):
    """:func:`ssd_chunked` of DTensors on each rank's local shards
    (``sharding.rules.on_local_shards``): the scan is independent over
    batch rows and heads, which go on the model axis where they divide
    it, as the reference pins them (its ``dim_constraint``, which would
    gather the batch here). ``b``/``c`` are repeated to one map a head
    first, as the reference does. DTensor's own einsums over the chunked
    layout merge sharded dims into strided shards, whose bookkeeping and
    reshuffles cost seconds an op at 4096 tokens."""
    h, g = x.shape[2], b.shape[2]
    b, c = (t.repeat_interleave(h // g, dim=2) for t in (b, c))
    return on_local_shards(
        lambda *t: ssd_chunked(*t[:5], chunk, t[5]),
        (x, dt, a, b, c, h0),
        ((0, 2), (0, 2), (None, 0), (0, 2), (0, 2), (0, 1)),
        ((0, 2), (0, 1)), h)


def ssd_step(h, x, dt, a, b, c):
    """Single decode step. h [B,H,P,N]; x [B,H,P]; dt [B,H]; b/c [B,G,N].
    Returns (h_new float32, y [B,H,P] float32). On DTensors it runs on each
    rank's local shards, as :func:`ssd_chunked` does."""
    if isinstance(x, DTensor):
        heads, g = x.shape[1], b.shape[1]
        b, c = (t.repeat_interleave(heads // g, dim=1) for t in (b, c))
        return on_local_shards(
            lambda x, h, *rest: ssd_step(h, x, *rest), (x, h, dt, a, b, c),
            ((0, 1), (0, 1), (0, 1), (None, 0), (0, 1), (0, 1)),
            ((0, 1), (0, 1)), heads)
    g = b.shape[1]
    rep = h.shape[1] // g
    bh = b.repeat_interleave(rep, dim=1)                  # [B,H,N]
    ch = c.repeat_interleave(rep, dim=1)
    decay = torch.exp(dt * a)                             # [B,H]
    h_new = h * decay[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt.float(), bh.float(), x.float()).to(h.dtype)
    y = torch.einsum("bhpn,bhn->bhp", h_new.float(), ch.float())
    return h_new.float(), y


def _causal_conv(x, w, b, conv_state=None, return_state=False):
    """Depthwise causal conv. x [B,S,C], w [K,C]. If conv_state [B,K-1,C] is
    given (decode, S==1) uses it and returns the next window;
    ``return_state`` also returns the trailing window during prefill."""
    if isinstance(x, DTensor):
        # depthwise over channels, causal over positions: each rank's own
        # rows and channels (DTensor's pad lays out a shard wrongly in
        # torch 2.11)
        outs = on_local_shards(
            lambda *t: tuple(o for o in _causal_conv(*t, return_state)
                             if o is not None),
            (x, w, b, conv_state), ((0, 2), (None, 1), (None, 0), (0, 2)),
            ((0, 2), (0, 2)), x.shape[2])
        return outs[0], (outs[1] if len(outs) > 1 else None)
    k = w.shape[0]
    if conv_state is not None and x.shape[1] == 1:
        window = torch.cat([conv_state, x], dim=1)        # [B,K,C]
        y = torch.einsum("bkc,kc->bc", window, w)[:, None] + b
        return y, window[:, 1:]
    s = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = pad[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + pad[:, i:i + s] * w[i]
    y = y + b
    new_state = pad[:, pad.shape[1] - (k - 1):] if return_state else None
    return y, new_state


def mamba_block(p, x, cfg, ssm_cfg: SSMConfig, cache=None):
    """Mamba2 sublayer. x [B,S,d]. cache: {"h": [B,H,P,N] float32, "conv":
    [B,K-1,C]}; decode (S == 1) reads and advances it, prefill fills it
    (from a zero state, as in the reference). The port writes the cache in
    place and returns the same dict. Returns (out [B,S,d], cache or None)."""
    bsz, s, d = x.shape
    di = d_inner(d, ssm_cfg)
    h = n_heads_ssm(d, ssm_cfg)
    g, n = ssm_cfg.n_groups, ssm_cfg.d_state
    gn = g * n

    # the slices' gradients meet laid out as the product is (as the
    # mLSTM's up-projection's)
    zxbcdt = settle_grad(x @ p["w_in"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt_raw = zxbcdt[..., di + di + 2 * gn:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])

    a = -torch.exp(p["a_log"])

    decode = cache is not None and s == 1
    conv_state = cache["conv"] if decode else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state,
                                 return_state=cache is not None)
    xbc = F.silu(xbc)
    x_ssm = xbc[..., :di].reshape(bsz, s, h, ssm_cfg.head_dim)
    b_ssm = xbc[..., di:di + gn].reshape(bsz, s, g, n)
    c_ssm = xbc[..., di + gn:].reshape(bsz, s, g, n)

    if decode:
        h_new, y = ssd_step(cache["h"], x_ssm[:, 0], dt[:, 0], a,
                            b_ssm[:, 0], c_ssm[:, 0])
        y = y[:, None]
    else:
        y, h_new = ssd_chunked(x_ssm, dt, a, b_ssm, c_ssm, ssm_cfg.chunk)
    if cache is not None:
        cache["h"].copy_(h_new)
        cache["conv"].copy_(new_conv)
    y = y + x_ssm.float() * p["d_skip"][:, None]
    y = y.reshape(bsz, s, di)

    # gated RMSNorm then out-projection
    x32 = y * F.silu(z).float()
    var = x32.square().mean(dim=-1, keepdim=True)
    gated = (x32 * torch.rsqrt(var + 1e-5)
             * p["norm"]["scale"].float()).to(x.dtype)
    return gated @ p["w_out"], cache
