"""Synthetic data pipeline: deterministic, seekable token streams with a
Zipfian unigram distribution plus Markov bigram structure — enough signal
that the training loss measurably drops, with no dataset downloads.

The iterator is stateless-resumable: ``TokenStream(seed).batch(step)``
always returns the same batch for a step, so checkpoint-resume is exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf: float = 1.2


class TokenStream:
    def __init__(self, dc: DataConfig):
        self.dc = dc
        rng = np.random.default_rng(dc.seed)
        v = dc.vocab_size
        probs = 1.0 / np.arange(1, v + 1) ** dc.zipf
        self.unigram = probs / probs.sum()
        # sparse bigram successor table: each token has 8 likely successors
        self.succ = rng.integers(0, v, size=(v, 8))

    def batch(self, step: int) -> dict:
        dc = self.dc
        rng = np.random.default_rng((dc.seed << 20) ^ step)
        b, s = dc.global_batch, dc.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.choice(dc.vocab_size, size=b, p=self.unigram)
        follow = rng.random((b, s)) < 0.8
        succ_pick = rng.integers(0, 8, size=(b, s))
        rand_tok = rng.choice(dc.vocab_size, size=(b, s), p=self.unigram)
        for t in range(s):
            nxt = self.succ[toks[:, t], succ_pick[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, rand_tok[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
