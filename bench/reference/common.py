"""Plain float32 PyTorch shared by the families' references: norms, rotary
embedding, causal attention in blocks of queries, the SwiGLU MLP in blocks
of positions, the cross-entropy in blocks of positions, AdamW, and the
training loop that follows the program's first steps.

Nothing here imports the program: the weights come from the benchmark's
own generator and the batches from its token feed. Float32 products run
without TF32 (``exact_float32``). Layers and blocks run under
``torch.utils.checkpoint`` so that a cell's full size fits on the card;
that changes where values are kept, not what is computed.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def exact_float32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def rmsnorm(x, scale, eps: float = 1e-5):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """Rotary embedding of ``x [B, S, H, D]`` at positions ``0..S-1``, the
    two halves of the head dim rotated as pairs (the GPT-NeoX layout)."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
    half = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + half * sin


def _attend(q, k, v, q0: int):
    """Softmax attention of the queries at positions ``q0..`` over keys
    ``0..k.shape[1]-1``, causal; kv head ``h // rep`` serves query head
    ``h``."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k, v = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    qpos = q0 + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


def causal_attention(q, k, v, rows_a_block: int = 8192):
    """``q [B, S, H, D]`` over ``k``, ``v [B, S, Hkv, D]``, a block of
    queries at a time (at most 1024, and ``rows_a_block`` over the batch)
    against the keys up to its end, each block recomputed in the
    backward."""
    s = q.shape[1]
    block = max(1, min(1024, rows_a_block // q.shape[0]))
    outs = [ckpt(_attend, q[:, i:i + block], k[:, :i + block],
                 v[:, :i + block], i) for i in range(0, s, block)]
    return torch.cat(outs, 1)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def swiglu_blocks(x, w_gate, w_up, w_down, tokens_a_block: int = 32768):
    """:func:`swiglu` of ``x [B, S, d]``, a block of positions at a time,
    each block recomputed in the backward."""
    b, s, _ = x.shape
    c = max(1, min(s, tokens_a_block // b))
    return torch.cat([ckpt(swiglu, x[:, i:i + c], w_gate, w_up, w_down)
                      for i in range(0, s, c)], 1)


def _ce_sum(h, head, labels):
    logits = h @ head
    picked = logits.gather(-1, labels[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - picked).sum()


def mean_ce(h, head, labels, tokens_a_block: int = 4096):
    """Mean next-token cross-entropy of ``h [B, S, d] @ head`` against
    ``labels``, a block of positions at a time."""
    b, s, _ = h.shape
    c = max(1, min(s, tokens_a_block // b))
    total = sum(ckpt(_ce_sum, h[:, i:i + c], head, labels[:, i:i + c])
                for i in range(0, s, c))
    return total / (b * s)


class AdamW:
    """AdamW over a dict of float32 leaves: global-norm clipping, bias
    correction, decoupled weight decay on matrices; each updated leaf is
    stored in its type of ``store`` (the configuration's parameter type;
    float32 where none is given) and read back as float32."""

    def __init__(self, leaves: dict, hp: dict, store=None):
        self.leaves, self.hp, self.store = leaves, hp, store or {}
        self.m = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.v = {k: torch.zeros_like(p) for k, p in leaves.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        """One update; returns the clipping factor the gradients took."""
        hp = self.hp
        self.t += 1
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = (torch.clamp(hp["grad_clip"] / (gnorm + 1e-9), max=1.0)
                 if hp["grad_clip"] > 0 else torch.ones_like(gnorm))
        c1 = 1.0 - hp["b1"] ** self.t
        c2 = 1.0 - hp["b2"] ** self.t
        for k, p in self.leaves.items():
            g = grads[k] * scale
            m, v = self.m[k], self.v[k]
            m.mul_(hp["b1"]).add_(g, alpha=1.0 - hp["b1"])
            v.mul_(hp["b2"]).add_(g.square(), alpha=1.0 - hp["b2"])
            delta = (m / c1) / ((v / c2).sqrt() + hp["eps"])
            if hp["weight_decay"] and p.dim() >= 2:
                delta = delta + hp["weight_decay"] * p
            p.sub_(hp["lr"] * delta)
            if self.store.get(k) not in (None, torch.float32):
                p.copy_(p.to(self.store[k]).float())
        return scale


def follow(loss_fn, leaves: dict, batches, hp: dict, store=None):
    """Train ``leaves`` (float32, updated in place) through ``batches``
    (``[(tokens, labels)]``). Returns the losses and the first update's
    clipped gradients' norms leaf by leaf."""
    for p in leaves.values():
        p.requires_grad_(True)
    opt = AdamW(leaves, hp, store)
    keys = list(leaves)
    losses, first = [], None
    for tokens, labels in batches:
        loss = loss_fn(leaves, tokens, labels)
        grads = dict(zip(keys, torch.autograd.grad(
            loss, [leaves[k] for k in keys])))
        losses.append(float(loss.detach()))
        del loss
        scale = opt.step(grads)
        if first is None:
            first = {k: float(torch.linalg.vector_norm(g * scale))
                     for k, g in grads.items()}
        del grads
    for p in leaves.values():
        p.requires_grad_(False)
    return losses, first
