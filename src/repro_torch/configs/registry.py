"""Assigned architectures (10) as selectable configs (``repro.configs.registry``).

``get_config(arch)``       -> full-size config (exact dims from the assignment table)
``get_smoke_config(arch)`` -> reduced same-family config for CPU smoke tests
``SHAPES`` / ``cells()``   -> the 4 input-shape regimes and the 40 (arch × shape)
                              dry-run cells, with per-arch skips + reasons.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.encdec import EncDecConfig
from ..models.lm import LMConfig, Segment
from ..models import mamba2 as M
from ..models.mamba2 import SSMConfig
from ..models.mla import MLAConfig
from ..models.moe import MoEConfig
from ..models.xlstm import XLSTMConfig


# ----------------------------------------------------------------- shapes ----

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs whose long-context decode is sub-quadratic (SSM / recurrent / SWA):
LONG_OK = {"zamba2-2.7b", "xlstm-125m", "h2o-danube-1.8b"}
LONG_SKIP_REASON = ("full/quadratic attention at 512k KV is not sub-quadratic; "
                    "skipped per assignment (see DESIGN.md §4)")


# ---------------------------------------------------------------- configs ----

def qwen3_moe_30b():
    return LMConfig(
        name="qwen3-moe-30b-a3b", d_model=2048, n_heads=32, n_kv_heads=4,
        d_head=128, d_ff=768, vocab=151936,
        segments=(Segment("attn", "moe", 48),),
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=768),
        rope_theta=1e6, repeat_kv=True, remat="full", logit_chunk=512)


def deepseek_v3_671b():
    return LMConfig(
        name="deepseek-v3-671b", d_model=7168, n_heads=128, n_kv_heads=128,
        d_head=128, d_ff=18432, vocab=129280,
        segments=(Segment("mla", "dense", 3), Segment("mla", "moe", 58)),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048, n_shared=1),
        mtp=True, rope_theta=1e4, remat="full", logit_chunk=512)


def xlstm_125m():
    # xLSTM[7:1]-style: sLSTM blocks at positions 4 and 10 of 12
    return LMConfig(
        name="xlstm-125m", d_model=768, n_heads=4, n_kv_heads=4, d_head=192,
        d_ff=0, vocab=50304,
        segments=(Segment("mlstm", "none", 4), Segment("slstm", "none", 1),
                  Segment("mlstm", "none", 5), Segment("slstm", "none", 1),
                  Segment("mlstm", "none", 1)),
        xlstm=XLSTMConfig(n_heads=4), param_dtype=torch.float32,
        dtype=torch.float32, remat="none", logit_chunk=512)


def zamba2_2p7b():
    return LMConfig(
        name="zamba2-2.7b", d_model=2560, n_heads=32, n_kv_heads=32,
        d_head=160, d_ff=10240, vocab=32000,
        segments=(Segment("mamba2", "none", 54),),
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                      chunk=128),
        hybrid_period=6, hybrid_d_attn=5120, remat="full", logit_chunk=512)


def phi3_medium_14b():
    return LMConfig(
        name="phi3-medium-14b", d_model=5120, n_heads=40, n_kv_heads=10,
        d_head=128, d_ff=17920, vocab=100352,
        segments=(Segment("attn", "dense", 40),),
        seq_shard_attn=True, remat="full", logit_chunk=0)


def internlm2_1p8b():
    return LMConfig(
        name="internlm2-1.8b", d_model=2048, n_heads=16, n_kv_heads=8,
        d_head=128, d_ff=8192, vocab=92544,
        segments=(Segment("attn", "dense", 24),), repeat_kv=True,
        remat="full", logit_chunk=512)


def minicpm3_4b():
    return LMConfig(
        name="minicpm3-4b", d_model=2560, n_heads=40, n_kv_heads=40,
        d_head=64, d_ff=6400, vocab=73448,
        segments=(Segment("mla", "dense", 62),),
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                      qk_rope_dim=32, v_head_dim=64),
        seq_shard_attn=True, remat="full", logit_chunk=0)


def h2o_danube_1p8b():
    return LMConfig(
        name="h2o-danube-1.8b", d_model=2560, n_heads=32, n_kv_heads=8,
        d_head=80, d_ff=6912, vocab=32000,
        segments=(Segment("attn", "dense", 24),),
        window=4096, repeat_kv=True, remat="full", logit_chunk=512)


def llava_next_34b():
    return LMConfig(
        name="llava-next-34b", d_model=7168, n_heads=56, n_kv_heads=8,
        d_head=128, d_ff=20480, vocab=64000,
        segments=(Segment("attn", "dense", 60),),
        prefix_len=256,          # anyres patch embeddings (stub frontend)
        seq_shard_attn=True, remat="full", logit_chunk=0)


def seamless_m4t_medium():
    return EncDecConfig(
        name="seamless-m4t-medium", d_model=1024, n_heads=16, n_kv_heads=16,
        d_head=64, d_ff=4096, vocab=256206, n_enc_layers=12, n_dec_layers=12,
        remat="full", logit_chunk=512)


ARCHS = {
    "qwen3-moe-30b-a3b": qwen3_moe_30b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "xlstm-125m": xlstm_125m,
    "zamba2-2.7b": zamba2_2p7b,
    "phi3-medium-14b": phi3_medium_14b,
    "internlm2-1.8b": internlm2_1p8b,
    "minicpm3-4b": minicpm3_4b,
    "h2o-danube-1.8b": h2o_danube_1p8b,
    "llava-next-34b": llava_next_34b,
    "seamless-m4t-medium": seamless_m4t_medium,
}


def get_config(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return ARCHS[arch]()


# ----------------------------------------------------------------- smokes ----

def get_smoke_config(arch: str):
    """Reduced same-family config: small width/depth, tiny vocab."""
    full = get_config(arch)
    if isinstance(full, EncDecConfig):
        return dataclasses.replace(
            full, name=full.name + "-smoke", d_model=64, n_heads=4,
            n_kv_heads=4, d_head=16, d_ff=128, vocab=512, n_enc_layers=2,
            n_dec_layers=2, remat="none", logit_chunk=0)
    kw = dict(name=full.name + "-smoke", d_model=64, n_heads=4, n_kv_heads=2,
              d_head=16, vocab=512, remat="none", logit_chunk=0,
              param_dtype=torch.float32, dtype=torch.float32, q_chunk=64,
              k_chunk=64, seq_shard_attn=False)
    if full.moe is not None:
        # dropless capacity (cf >= E/k) so smoke decode matches forward exactly
        kw["moe"] = dataclasses.replace(full.moe, n_experts=8, top_k=2, d_ff=32,
                                        capacity_factor=4.0)
    if full.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
                              qk_rope_dim=8, v_head_dim=16)
        kw["n_kv_heads"] = 4
    if full.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk=32)
    if full.xlstm is not None:
        kw["xlstm"] = XLSTMConfig(n_heads=4, chunk=16)
    if full.window is not None:
        kw["window"] = 24
    if full.prefix_len:
        kw["prefix_len"] = 8
    kw["d_ff"] = 128 if full.d_ff else 0
    # shrink segments, preserving the family mix
    segs = []
    for s in full.segments:
        segs.append(Segment(s.kind, s.mlp, min(s.count, 2)))
    kw["segments"] = tuple(segs)
    if full.hybrid_period:
        kw["segments"] = (Segment("mamba2", "none", 4),)
        kw["hybrid_period"] = 2
        kw["hybrid_d_attn"] = 128
    return dataclasses.replace(full, **kw)


# -------------------------------------------------------- model flops (6ND) ----

def active_param_count(cfg) -> float:
    """Per-token *active* non-embedding parameter count (MoE counts top_k +
    shared experts only) — the N of MODEL_FLOPS = 6·N·D."""
    if isinstance(cfg, EncDecConfig):
        per_attn = (cfg.d_model * cfg.n_heads * cfg.d_head * 2
                    + cfg.d_model * cfg.n_kv_heads * cfg.d_head * 2)
        per_mlp = 3 * cfg.d_model * cfg.d_ff
        enc = cfg.n_enc_layers * (per_attn + per_mlp)
        dec = cfg.n_dec_layers * (2 * per_attn + per_mlp)
        return float(enc + dec)

    d = cfg.d_model
    n = 0.0
    for seg in cfg.segments:
        if seg.kind == "attn":
            per = (d * cfg.n_heads * cfg.d_head
                   + 2 * d * cfg.n_kv_heads * cfg.d_head
                   + cfg.n_heads * cfg.d_head * d)
        elif seg.kind == "mla":
            m = cfg.mla
            per = (d * m.q_lora_rank
                   + m.q_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                   + d * m.kv_lora_rank + d * m.qk_rope_dim
                   + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim
                                                     + m.v_head_dim)
                   + cfg.n_heads * m.v_head_dim * d)
        elif seg.kind == "mamba2":
            di = M.d_inner(d, cfg.ssm)
            gn = cfg.ssm.n_groups * cfg.ssm.d_state
            h = M.n_heads_ssm(d, cfg.ssm)
            per = d * (2 * di + 2 * gn + h) + di * d
        elif seg.kind == "mlstm":
            di = int(d * cfg.xlstm.up_factor)
            per = d * 2 * di + 3 * di * di + di * d
        elif seg.kind == "slstm":
            dh = d // cfg.xlstm.n_heads
            f = int(d * cfg.xlstm.slstm_ff)
            per = d * 4 * d + cfg.xlstm.n_heads * dh * 4 * dh + 3 * d * f
        else:
            per = 0.0
        if seg.mlp == "dense":
            per += 3 * d * cfg.d_ff
        elif seg.mlp == "moe":
            mo = cfg.moe
            per += d * mo.n_experts / 1e9 * 0  # router negligible
            per += 3 * d * mo.d_ff * (mo.top_k + mo.n_shared)
        n += per * seg.count
    if cfg.hybrid_period:
        n_shared_apps = sum(s.count for s in cfg.segments) // cfg.hybrid_period
        da = cfg.hybrid_d_attn or 2 * d
        dh = da // cfg.n_heads
        per = (da * cfg.n_heads * dh + 2 * da * cfg.n_kv_heads * dh
               + cfg.n_heads * dh * d + 3 * d * cfg.d_ff)
        n += per * n_shared_apps          # shared weights, but active each app
    if cfg.mtp:
        n += 2 * d * d     # proj (roughly; the extra layer adds ~1 layer more)
    return float(n)


# ------------------------------------------------------------------ cells ----

def cells():
    """All 40 (arch × shape) dry-run cells with skip annotations."""
    out = []
    for arch in ARCHS:
        for sname, shape in SHAPES.items():
            skip = None
            if sname == "long_500k" and arch not in LONG_OK:
                skip = LONG_SKIP_REASON
            out.append({"arch": arch, "shape": sname, "skip": skip})
    return out
