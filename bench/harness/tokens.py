"""The benchmark's token generator: a frozen copy of the port's synthetic
text (``repro_torch.data.pipeline``), so that the traffic stays the same
whatever later changes the program makes to its own pipeline.

Rows follow a Zipf-like unigram mix (rank ``r`` drawn with probability
``1 / (r + offset)``) with local repetition: each token repeats the one
before it with probability ``repeat``. Step ``i`` of seed ``s`` draws from
``SeedSequence([s, i, 0])``, so every step's rows differ and the same seed
gives the same rows, in the program and in the reference alike.
"""
from __future__ import annotations

import numpy as np


def zipf_probs(vocab: int, offset: float) -> np.ndarray:
    probs = 1.0 / (np.arange(vocab, dtype=np.float64) + offset)
    return probs / probs.sum()


def sample_tokens(rng, n: int, vocab: int, offset: float = 10.0,
                  repeat: float = 0.3, probs=None) -> np.ndarray:
    if probs is None:
        probs = zipf_probs(vocab, offset)
    toks = rng.choice(vocab, size=n, p=probs)
    rep = rng.random(n) < repeat
    toks[1:][rep[1:]] = toks[:-1][rep[1:]]
    return toks.astype(np.int32)


class TokenFeed:
    """Batches of ``batch`` rows of ``seq`` tokens and their next tokens.
    ``rows(step)`` is ``[batch, seq + 1]`` int32 on the host; the tokens are
    its first ``seq`` columns, the labels its last ``seq``."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int,
                 offset: float = 10.0, repeat: float = 0.3):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = int(seed) % (1 << 64)
        self.offset, self.repeat = offset, repeat
        self.probs = zipf_probs(vocab, offset)

    def rows(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0]))
        n = self.batch * (self.seq + 1)
        toks = sample_tokens(rng, n, self.vocab, self.offset, self.repeat,
                             self.probs)
        return toks.reshape(self.batch, self.seq + 1)

    @classmethod
    def from_traffic(cls, traffic: dict, vocab: int, seed: int):
        return cls(vocab, traffic["batch"], traffic["seq"], seed,
                   traffic.get("zipf_offset", 10.0),
                   traffic.get("repeat", 0.3))
