"""Plain float32 reference of the dense GQA transformer (internlm2):
pre-norm layers of causal grouped-query attention with rotary embedding
and a SwiGLU MLP, a final RMSNorm and an untied output head, trained on
the mean next-token cross-entropy.

Leaves are ``{(path, layer): tensor}``: ``layer`` is the index along a
stacked leaf's first axis, ``None`` for a leaf of its own. The sizes come
from the configuration file (published names).
"""
from __future__ import annotations

import torch

from .common import (causal_attention, ckpt, mean_ce, rmsnorm, rope,
                     swiglu_blocks)

LAYER_LEAVES = (("norm1", "scale"), ("attn", "wq"), ("attn", "wk"),
                ("attn", "wv"), ("attn", "wo"), ("norm2", "scale"),
                ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


def _layer(x, n1, wq, wk, wv, wo, n2, wg, wu, wd, theta):
    h = rmsnorm(x, n1)
    q = rope(torch.einsum("bsd,dhk->bshk", h, wq), theta)
    k = rope(torch.einsum("bsd,dhk->bshk", h, wk), theta)
    v = torch.einsum("bsd,dhk->bshk", h, wv)
    x = x + torch.einsum("bshk,hkd->bsd", causal_attention(q, k, v), wo)
    return x + swiglu_blocks(rmsnorm(x, n2), wg, wu, wd)


def loss(leaves: dict, cfg: dict, tokens, labels):
    theta = float(cfg["rope_theta"])
    x = leaves[(("embed", "table"), None)][tokens]
    for li in range(cfg["num_hidden_layers"]):
        ws = [leaves[(("seg0",) + p, li)] for p in LAYER_LEAVES]
        x = ckpt(_layer, x, *ws, theta)
    h = rmsnorm(x, leaves[(("final_norm", "scale"), None)])
    return mean_ce(h, leaves[(("head",), None)], labels)
