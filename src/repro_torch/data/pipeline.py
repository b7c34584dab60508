"""Deterministic, resumable synthetic data pipeline (``repro.data.pipeline``).

Batches are a pure function of (seed, step): restart-safe (the checkpoint
stores only the step counter). The numbers are the reference's, bit for bit:
numpy draws from a ``SeedSequence([seed, step, shard])``, and the batches stay
numpy int32, as the reference returns them; the caller moves them to the card.

Synthetic text follows a Zipfian unigram mix with a Markov-ish repetition
structure so losses move meaningfully during short training runs. Sharding
over a mesh (the reference's ``make_array_from_callback`` path) is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    pad_id: int = -1


@dataclasses.dataclass
class PipelineState:
    step: int = 0


def _rng_for(cfg: DataConfig, step: int, shard: int):
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def _sample_tokens(rng, n, vocab):
    # zipf-ish unigram: rank r prob ~ 1/(r+10)
    ranks = np.arange(vocab, dtype=np.float64)
    probs = 1.0 / (ranks + 10.0)
    probs /= probs.sum()
    toks = rng.choice(vocab, size=n, p=probs)
    # inject local repetition (learnable bigram structure)
    rep = rng.random(n) < 0.3
    toks[1:][rep[1:]] = toks[:-1][rep[1:]]
    return toks.astype(np.int32)


def global_batch(cfg: DataConfig, step: int):
    """Host-side ``[B, S+1]`` int32 tokens."""
    rng = _rng_for(cfg, step, 0)
    toks = _sample_tokens(rng, cfg.batch * (cfg.seq_len + 1), cfg.vocab)
    return toks.reshape(cfg.batch, cfg.seq_len + 1)


def batch_for_step(cfg: DataConfig, step: int, mesh=None, sharding=None):
    """``(tokens [B, S], labels [B, S])``, numpy int32; labels are the tokens
    shifted by one."""
    if mesh is not None or sharding is not None:
        raise NotImplementedError(
            "sharded batches over a mesh are not ported to repro_torch yet "
            "(ROADMAP queue 1 item 11)")
    buf = global_batch(cfg, step)
    return buf[:, :-1], buf[:, 1:]
