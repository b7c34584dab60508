"""Actor / Critic networks (paper Fig 5b, 5c).

Actor: GCN(L̂, X) -> per-node embedding, concatenated with a mean-pooled global
context, through two FC layers (ReLU) to four outputs per node — (mu, log_std)
for the row dimension and for the column dimension. ``tanh`` bounds the means
inside the grid, matching the [-clip, clip] range that ``discretize`` bins
onto.

Critic: its own GCN + pooled MLP -> scalar state value.

Parameters keep the reference's names and ``[in, out]`` layout
(``gcn.{w0,b0,w1,b1}``, ``fc1_w``, ``fc1_b``, ``fc2_w``, ``fc2_b``), and its
initial distributions: fan-in normals, ``fc2_w`` at std 0.01, zero biases.
:func:`from_reference_params` loads the reference's parameter pytrees.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .gcn import GCN, fan_in_param, normal_param

LOG_STD_MIN, LOG_STD_MAX = -4.0, 1.0
LOG_STD_INIT = -1.2          # initial std ~0.3 of the [-1,1] action range
_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


class _Head(nn.Module):
    def __init__(self, d_feat: int, d_gcn: int, d_in: int, d_fc: int,
                 d_out: int, generator=None):
        super().__init__()
        self.gcn = GCN(d_feat, d_gcn, generator=generator)
        self.fc1_w = fan_in_param((d_in, d_fc), generator)
        self.fc1_b = nn.Parameter(torch.zeros(d_fc))
        self.fc2_w = normal_param((d_fc, d_out), 0.01, generator)
        self.fc2_b = nn.Parameter(torch.zeros(d_out))

    def _mlp(self, z):
        z = torch.relu(z @ self.fc1_w + self.fc1_b)
        return z @ self.fc2_w + self.fc2_b


class Actor(_Head):
    def __init__(self, d_feat: int = 5, d_gcn: int = 32, d_fc: int = 64,
                 generator=None):
        super().__init__(d_feat, d_gcn, 2 * d_gcn, d_fc, 4, generator)

    def forward(self, lap, x):
        """Returns (mu [n,2], log_std [n,2])."""
        h = self.gcn(lap, x)                                   # [n, d_gcn]
        g = h.mean(dim=0, keepdim=True).expand_as(h)
        out = self._mlp(torch.cat([h, g], dim=-1))             # [n, 4]
        mu = torch.tanh(out[:, :2])
        log_std = torch.clamp(out[:, 2:] + LOG_STD_INIT, LOG_STD_MIN,
                              LOG_STD_MAX)
        return mu, log_std


class Critic(_Head):
    def __init__(self, d_feat: int = 5, d_gcn: int = 32, d_fc: int = 64,
                 generator=None):
        super().__init__(d_feat, d_gcn, d_gcn, d_fc, 1, generator)

    def forward(self, lap, x):
        """Scalar state value."""
        return self._mlp(self.gcn(lap, x).mean(dim=0))[0]


def sample_actions(mu, log_std, n_samples: int, generator=None, eps=None):
    """Gaussian sample a batch of continuous actions: [B, n, 2] + logp [B].

    ``eps`` ([B, n, 2] standard-normal draws) replaces the draws from
    ``generator``; the tests inject the reference's draws this way."""
    std = torch.exp(log_std)
    if eps is None:
        eps = torch.randn((n_samples,) + tuple(mu.shape), generator=generator,
                          dtype=mu.dtype, device=mu.device)
    acts = mu[None] + std[None] * eps
    return acts, gaussian_logp(acts, mu, log_std)


def gaussian_logp(acts, mu, log_std):
    """Sum of diagonal-Gaussian log-densities over nodes and dims: [B]."""
    z = (acts - mu[None]) / torch.exp(log_std)[None]
    per = -0.5 * z ** 2 - log_std[None] - _HALF_LOG_2PI
    return per.sum(dim=(1, 2))


def entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))


def init_actor_critic(generator=None, d_feat: int = 5, d_gcn: int = 32,
                      d_fc: int = 64):
    """Fresh (actor, critic) on the CPU, drawn from ``generator``."""
    return (Actor(d_feat, d_gcn, d_fc, generator),
            Critic(d_feat, d_gcn, d_fc, generator))


def _load(module: nn.Module, params: dict, device):
    flat = {f"gcn.{k}": v for k, v in params["gcn"].items()}
    flat.update({k: v for k, v in params.items() if k != "gcn"})
    state = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in
             flat.items()}
    module.load_state_dict(state, strict=True)
    return module.to(device)


def from_reference_params(actor: dict, critic: dict, device="cpu"):
    """The reference's actor/critic parameter pytrees (nested dicts of numpy
    arrays: ``{"gcn": {"w0","b0","w1","b1"}, "fc1_w", "fc1_b", "fc2_w",
    "fc2_b"}``) as the port's (Actor, Critic) on ``device``."""
    d_feat, d_gcn = np.shape(actor["gcn"]["w0"])
    d_fc = np.shape(actor["fc1_w"])[1]
    return (_load(Actor(d_feat, d_gcn, d_fc), actor, device),
            _load(Critic(d_feat, d_gcn, d_fc), critic, device))
