"""Synthetic CTR / sequential-recommendation data with learnable signal.

Twin of ``src/repro/data/recsys.py``: numpy draws in the reference's
order, so both packages draw the same arrays from the same seed.  Zipf
ids come from :func:`repro_torch.data.synthetic.zipf` (numpy 2.0.2's
sampler, which later numpy releases changed), never ``rng.zipf``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import zipf


class ClickLog:
    """Sparse categorical + dense features; labels from a hidden bilinear
    model so CTR training has learnable structure."""

    def __init__(self, vocab_sizes, n_dense: int = 0, seed: int = 0,
                 zipf_a: float = 1.3):
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.n_dense = n_dense
        self.zipf_a = zipf_a
        rng = np.random.default_rng(seed)
        self._field_w = [rng.normal(size=min(v, 4096)) * 0.5
                         for v in self.vocab_sizes]
        self._dense_w = rng.normal(size=n_dense) * 0.3 if n_dense else None
        self.rng = rng

    def _zipf_ids(self, n, vocab):
        z = zipf(self.rng, self.zipf_a, n)
        return np.minimum(z - 1, vocab - 1)

    def sample(self, batch: int):
        ids = np.stack([self._zipf_ids(batch, v) for v in self.vocab_sizes],
                       axis=1).astype(np.int32)
        logit = sum(w[np.minimum(ids[:, i], len(w) - 1)]
                    for i, w in enumerate(self._field_w))
        out = {"sparse_ids": ids}
        if self.n_dense:
            dense = self.rng.normal(size=(batch, self.n_dense)).astype(np.float32)
            logit = logit + dense @ self._dense_w
            out["dense"] = dense
        p = 1.0 / (1.0 + np.exp(-(logit - logit.mean())))
        out["labels"] = (self.rng.random(batch) < p).astype(np.int32)
        return out


class SessionLog:
    """Markov item sessions for BERT4Rec masked-item training.  Item 0 is
    both an item and ``[MASK]``, as in the reference."""

    def __init__(self, n_items: int, seed: int = 0, mask_frac: float = 0.15):
        self.n_items = n_items
        self.mask_frac = mask_frac
        rng = np.random.default_rng(seed)
        self._next = rng.permutation(n_items)          # item transition map
        self.rng = rng

    def sample(self, batch: int, seq: int):
        start = self.rng.integers(0, self.n_items, batch)
        items = np.zeros((batch, seq), np.int64)
        items[:, 0] = start
        for t in range(1, seq):
            jump = self.rng.random(batch) < 0.2
            items[:, t] = np.where(jump,
                                   self.rng.integers(0, self.n_items, batch),
                                   self._next[items[:, t - 1]])
        label_mask = self.rng.random((batch, seq)) < self.mask_frac
        inputs = np.where(label_mask, 0, items)        # 0 = [MASK]
        return {"items": inputs.astype(np.int32),
                "labels": items.astype(np.int32),
                "label_mask": label_mask,
                "mask": np.ones((batch, seq), bool)}
