"""Faithful host-side reference of Algorithm 1 (hash-map inverted index).

This is the paper's data structure verbatim: a Python dict J mapping
document id -> set of cached queries, FIFO deques for P and the doc store.
Used as the oracle for the fixed-shape implementation in core/has.py
(tests/test_torch_reference.py asserts trace equivalence on random query
streams).
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np


@dataclasses.dataclass
class RefHas:
    k: int
    tau: float
    h_max: int
    doc_cap: int

    def __post_init__(self):
        self.queries: collections.deque = collections.deque()   # (emb, ids)
        self.doc_ids: collections.OrderedDict = collections.OrderedDict()
        self.doc_embs: dict[int, np.ndarray] = {}
        self.inverted: dict[int, set[int]] = collections.defaultdict(set)
        self._qcounter = 0

    # -- cache channel -------------------------------------------------------

    def cache_channel(self, q_emb: np.ndarray):
        """Exact top-k over the live doc store."""
        if not self.doc_ids:
            return np.full(self.k, -1, np.int64), np.full(self.k, -np.inf)
        ids = np.fromiter(self.doc_ids.keys(), np.int64)
        embs = np.stack([self.doc_embs[i] for i in ids])
        scores = embs @ q_emb
        order = np.argsort(-scores)[:self.k]
        out_ids = np.full(self.k, -1, np.int64)
        out_s = np.full(self.k, -np.inf)
        out_ids[:len(order)] = ids[order]
        out_s[:len(order)] = scores[order]
        return out_ids, out_s

    # -- homology validation (Algorithm 1 lines 3-14) ------------------------

    def validate(self, draft_ids: np.ndarray):
        freq: collections.Counter = collections.Counter()
        for d in draft_ids:
            if d < 0:
                continue
            for qh in self.inverted.get(int(d), ()):
                freq[qh] += 1
        if not freq:
            return False, 0.0
        best = max(freq.values())
        return (best / self.k) > self.tau, best / self.k

    # -- cache update (line 16) ----------------------------------------------

    def update(self, q_emb: np.ndarray, full_ids: np.ndarray,
               full_embs: np.ndarray):
        qid = self._qcounter
        self._qcounter += 1
        self.queries.append((qid, set(int(i) for i in full_ids if i >= 0)))
        for d in full_ids:
            if d >= 0:
                self.inverted[int(d)].add(qid)
        if len(self.queries) > self.h_max:
            old_qid, old_ids = self.queries.popleft()
            for d in old_ids:
                self.inverted[d].discard(old_qid)
        for i, d in enumerate(full_ids):
            d = int(d)
            if d < 0 or d in self.doc_ids:
                continue
            self.doc_ids[d] = True
            self.doc_embs[d] = np.asarray(full_embs[i])
            if len(self.doc_ids) > self.doc_cap:
                evicted, _ = self.doc_ids.popitem(last=False)
                self.doc_embs.pop(evicted, None)
