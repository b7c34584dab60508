"""Mixture-of-Experts (``repro.models.moe``): only its config so far.

The sort-based capacity dispatch, the router and the expert GEMMs are a
later slice of the port (ROADMAP queue 1 item 10); a model that reaches a
MoE layer raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden dim
    n_shared: int = 0             # shared (always-on) experts
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_dtype: str = "float32"
