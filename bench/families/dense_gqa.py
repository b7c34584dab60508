"""The dense GQA transformer family (internlm2): the port's configuration
built from the benchmark's configuration file, the model FLOPs a token and
the flash attention calls a training step makes.

The FLOP count is the benchmark's own, from the published sizes in the
configuration file: 6 x the matrix-product parameters a token touches (the
output head in, the embedding lookup out), plus 3 x 2·S·H·D a layer and
token for causal attention (QK^T and PV over the visible half, forward and
twice that backward), without recomputation.
"""
from __future__ import annotations

from . import base_config

REFERENCE = "dense_gqa"


def port_config(cfg: dict):
    """The port's ``LMConfig`` as the cell runs it: the registry's entry
    with the file's ``port.replace`` applied, held against the published
    sizes of the file."""
    port = base_config(cfg)
    want = {"d_model": cfg["hidden_size"], "n_heads": cfg["num_attention_heads"],
            "n_kv_heads": cfg["num_key_value_heads"], "d_head": head_dim(cfg),
            "d_ff": cfg["intermediate_size"], "vocab": cfg["vocab_size"],
            "n_layers": cfg["num_hidden_layers"],
            "rope_theta": float(cfg["rope_theta"]),
            "tie_embeddings": cfg["tie_word_embeddings"]}
    got = {k: getattr(port, k) for k in want}
    if got != want:
        raise ValueError(f"{cfg['name']}: the port's config {got} is not the "
                         f"file's {want}")
    return port


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def matmul_params(cfg: dict) -> int:
    d, h, hkv = (cfg["hidden_size"], cfg["num_attention_heads"],
                 cfg["num_key_value_heads"])
    dh, f = head_dim(cfg), cfg["intermediate_size"]
    layer = d * h * dh + 2 * d * hkv * dh + h * dh * d + 3 * d * f
    return cfg["num_hidden_layers"] * layer + d * cfg["vocab_size"]


def model_flops_per_token(cfg: dict, seq: int) -> float:
    attn = 6 * seq * cfg["num_attention_heads"] * head_dim(cfg)
    return 6.0 * matmul_params(cfg) + attn * cfg["num_hidden_layers"]


def flash_calls(cfg: dict, port, batch: int, seq: int) -> list:
    """The step's attention calls: one causal call a layer forward (twice
    under ``remat="full"``, which recomputes it) and one backward."""
    n = cfg["num_hidden_layers"]
    return [{"B": batch, "H": cfg["num_attention_heads"],
             "Hkv": cfg["num_key_value_heads"], "S": seq, "D": head_dim(cfg),
             "causal": True, "fwd": n * (2 if port.remat == "full" else 1),
             "bwd": n, "elt": port.dtype.itemsize}]
