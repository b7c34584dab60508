"""Mamba2 (SSD) blocks (``repro.models.mamba2``): only the config and its
derived widths so far.

The chunked SSD scan and the O(1)-state decode are a later slice of the port
(ROADMAP queue 1 item 10); a model that reaches a Mamba2 layer raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses


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
