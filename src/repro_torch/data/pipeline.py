"""Deterministic, resumable, sharded synthetic data pipeline
(``repro.data.pipeline``).

Batches are a pure function of (seed, step): restart-safe (the checkpoint
stores only the step counter) and elastic (another mesh builds the same
global batch with its own sharding). The numbers are the reference's, bit for
bit: numpy draws from a ``SeedSequence([seed, step, shard])``. Without a mesh
the batches stay numpy int32, as the reference returns them, and the caller
moves them to the card; over a mesh each rank draws only its own rows (row
``r`` from shard ``r``, as the reference's ``make_array_from_callback``
does) and the batch is an int32 DTensor on the mesh's device.

Synthetic text follows a Zipfian unigram mix with a Markov-ish repetition
structure so losses move meaningfully during short training runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..sharding.rules import (NamedSharding, batch_partition, local_range,
                              mesh_device)


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


def rows_for_step(cfg: DataConfig, step: int, rows) -> np.ndarray:
    """Rows ``rows`` of a sharded batch, ``[len(rows), S+1]`` int32: row
    ``r`` drawn from shard ``r`` (a sharded batch differs from
    :func:`global_batch`, in the reference too)."""
    out = np.empty((len(rows), cfg.seq_len + 1), np.int32)
    for i, r in enumerate(rows):
        out[i] = _sample_tokens(_rng_for(cfg, step, r), cfg.seq_len + 1,
                                cfg.vocab)
    return out


def batch_for_step(cfg: DataConfig, step: int, mesh=None, sharding=None):
    """``(tokens [B, S], labels [B, S])``; labels are the tokens shifted by
    one. Numpy int32 without a mesh; with one, int32 DTensors laid out as
    ``sharding`` (default: ``batch_partition(mesh, 2)``), whose local
    shards are the only rows this rank draws."""
    if mesh is None and sharding is None:
        buf = global_batch(cfg, step)
        return buf[:, :-1], buf[:, 1:]
    if sharding is None:
        sharding = NamedSharding(mesh, batch_partition(mesh, 2))
    mesh, spec = sharding.mesh, sharding.spec
    out = rows_for_step(cfg, step, local_range(mesh, spec, 0, cfg.batch))
    cols = local_range(mesh, spec, 1, cfg.seq_len)
    local = torch.from_numpy(out).to(mesh_device(mesh))
    cut = slice(cols.start, cols.stop)
    return tuple(DTensor.from_local(t[:, cut].contiguous(), mesh,
                                    sharding.placements)
                 for t in (local[:, :-1], local[:, 1:]))
