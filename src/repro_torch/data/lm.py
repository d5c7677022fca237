"""Synthetic LM token pipeline: a learnable Markov language and batching.

The port's copy of ``src/repro/data/lm.py``, numpy only: the same seed
draws the same table and tokens as the reference
(``data/digests.py::MARKOV_PINNED`` pins them).  A k-gram Markov source
gives non-trivial structure (the loss falls visibly within a few hundred
steps for a ~100M model) without shipping a corpus.  The one change: the
cumulative table that ``sample`` searches is computed once, not at every
call (the same array, so the same tokens).
"""
from __future__ import annotations

import functools

import numpy as np


class MarkovLM:
    def __init__(self, vocab_size: int, order: int = 2, seed: int = 0,
                 concentration: float = 0.05):
        self.vocab = vocab_size
        self.order = order
        rng = np.random.default_rng(seed)
        # hashed transition table: context hash -> categorical over vocab
        self.n_ctx = 4096
        logits = rng.gumbel(size=(self.n_ctx, vocab_size)) / concentration
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        self.probs = probs / probs.sum(axis=1, keepdims=True)
        self._mix = rng.integers(1, 2**31 - 1, order)

    @functools.cached_property
    def _cum(self) -> np.ndarray:
        return np.cumsum(self.probs, axis=1)

    def _ctx_hash(self, ctx: np.ndarray) -> np.ndarray:
        h = np.zeros(ctx.shape[0], np.int64)
        for i in range(self.order):
            h = (h * 1000003 + ctx[:, i] * self._mix[i]) % self.n_ctx
        return h

    def sample(self, rng: np.random.Generator, batch: int, seq: int):
        toks = np.zeros((batch, seq + 1), np.int64)
        toks[:, :self.order] = rng.integers(0, self.vocab,
                                            (batch, self.order))
        cum = self._cum
        for t in range(self.order, seq + 1):
            h = self._ctx_hash(toks[:, t - self.order:t])
            u = rng.random(batch)[:, None]
            toks[:, t] = (u < cum[h]).argmax(axis=1)
        return {"tokens": toks[:, :seq].astype(np.int32),
                "labels": toks[:, 1:seq + 1].astype(np.int32)}


def batches(vocab_size: int, batch: int, seq: int, n_steps: int,
            seed: int = 0, order: int = 2):
    lm = MarkovLM(vocab_size, order, seed)
    rng = np.random.default_rng(seed + 1)
    for _ in range(n_steps):
        yield lm.sample(rng, batch, seq)
