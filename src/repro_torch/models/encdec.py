"""Encoder-decoder transformer (``repro.models.encdec``, the seamless-m4t
backbone): only its config so far.

The encoder, the decoder with cross-attention and their caches are a later
slice of the port (ROADMAP queue 1 item 10). As in the reference, the dtype
and window attributes are class attributes, not fields.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    n_enc_layers: int
    n_dec_layers: int
    rope_theta: float = 1e4
    param_dtype = torch.bfloat16
    dtype = torch.bfloat16
    q_chunk: int = 1024
    k_chunk: int = 1024
    remat: str = "none"
    window = None
    logit_chunk: int = 0
    segments = ()          # LM-compat fields used by shared helpers
    n_layers_prop = None

    @property
    def n_layers(self):
        return self.n_enc_layers + self.n_dec_layers
