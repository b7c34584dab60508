"""AdamW in fp32 with the reference's update rule.

``repro.train.optim.adamw_update``: decoupled weight decay on matrices only,
bias correction, global-norm gradient clipping, and ``b2=0.95`` by default::

    m = b1 m + (1 - b1) g
    v = b2 v + (1 - b2) g²
    p -= lr ((m / c1) / (sqrt(v / c2) + eps) + wd p)     c_i = 1 - b_i^step

The bf16 and int8 moment modes of the reference are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0          # global-norm clip; 0 disables


class AdamW:
    """fp32 AdamW state for a fixed list of parameters, updated in place."""

    def __init__(self, params, cfg: AdamWConfig):
        self.params = list(params)
        self.cfg = cfg
        self.step = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads, lr_scale: float = 1.0) -> None:
        """One AdamW step with ``grads`` (one per parameter, in order)."""
        cfg = self.cfg
        self.step += 1
        grads = [g.float() for g in grads]
        if cfg.grad_clip > 0:
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = [g * scale for g in grads]
        # bias corrections in float32, as the reference computes them
        step = np.float32(self.step)
        c1 = float(np.float32(1.0) - np.float32(cfg.b1) ** step)
        c2 = float(np.float32(1.0) - np.float32(cfg.b2) ** step)
        lr = cfg.lr * lr_scale
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            if cfg.weight_decay and p.dim() >= 2:      # decay matrices only
                delta = delta + cfg.weight_decay * p
            p.copy_(p - lr * delta)
