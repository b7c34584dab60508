"""Multi-head Latent Attention (``repro.models.mla``): only its config so far.

The MLA block (latent KV, absorbed decode) is a later slice of the port
(ROADMAP queue 1 item 10); a model that reaches it raises
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
