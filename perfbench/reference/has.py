"""HaS cache semantics, plainly: the FIFO fold of a full retrieval into the
rings (Algorithm 1 line 16) and homology validation (lines 10-12).

Rings (one tenant): the query ring keeps ``h_max`` rows of (the query, its
``k`` full-retrieval ids), written at ``q_ptr % h_max``; the doc ring keeps
``doc_cap`` document ids, written at ``d_ptr % doc_cap``.  A fold writes the
query's row, then appends, in result order, each id that is not negative,
not already in the doc ring and not earlier in the same result; both
pointers count up without wrapping.

Validation: a draft's homology with a cached row is the number of its
non-negative ids found among the row's ids over ``k`` (f32), 0 for an empty
row; the draft is accepted when its best homology is above ``tau`` (f32).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Rings:
    q_ids: np.ndarray        # [H, k] int32, -1 empty
    q_valid: np.ndarray      # [H] bool
    q_src: np.ndarray        # [H] int64: stream index of the row's query
    doc_ids: np.ndarray      # [Dc] int32, -1 empty
    q_ptr: int = 0
    d_ptr: int = 0

    @classmethod
    def empty(cls, h_max: int, k: int, doc_cap: int) -> "Rings":
        return cls(q_ids=np.full((h_max, k), -1, np.int32),
                   q_valid=np.zeros(h_max, bool),
                   q_src=np.full(h_max, -1, np.int64),
                   doc_ids=np.full(doc_cap, -1, np.int32))

    def __post_init__(self):
        self._where = {int(x): i for i, x in enumerate(self.doc_ids)
                       if x >= 0}

    def fold(self, src: int, ids) -> None:
        h, dc = len(self.q_valid), len(self.doc_ids)
        slot = self.q_ptr % h
        self.q_ids[slot] = ids
        self.q_valid[slot] = True
        self.q_src[slot] = src
        new = []
        for x in (int(v) for v in ids):
            if x >= 0 and x not in self._where and x not in new:
                new.append(x)
        for j, x in enumerate(new):
            pos = (self.d_ptr + j) % dc
            old = int(self.doc_ids[pos])
            if old >= 0 and self._where.get(old) == pos:
                del self._where[old]
            self.doc_ids[pos] = x
            self._where[x] = pos
        self.d_ptr += len(new)
        self.q_ptr += 1

    def copy(self) -> "Rings":
        return Rings(q_ids=self.q_ids.copy(), q_valid=self.q_valid.copy(),
                     q_src=self.q_src.copy(), doc_ids=self.doc_ids.copy(),
                     q_ptr=self.q_ptr, d_ptr=self.d_ptr)


def best_homology(drafts: torch.Tensor, rings: Rings) -> torch.Tensor:
    """drafts [B, k] int -> each draft's best homology [B] f32 over the
    valid rows of the query ring."""
    dev = drafts.device
    k = drafts.shape[1]
    rows = torch.as_tensor(rings.q_ids, device=dev)             # [H, k]
    valid = torch.as_tensor(rings.q_valid, device=dev)
    best = torch.zeros(drafts.shape[0], dtype=torch.float32, device=dev)
    for b in range(drafts.shape[0]):
        d = drafts[b]
        hit = ((d[:, None, None] == rows[None, :, :]).any(dim=2)
               & (d >= 0)[:, None])                              # [k, H]
        count = hit.sum(dim=0).to(torch.float32)
        score = torch.where(valid, count / torch.tensor(
            float(k), device=dev), 0.0)
        best[b] = score.max() if score.numel() else 0.0
    return best


def accepts(drafts: torch.Tensor, rings: Rings, tau: float) -> torch.Tensor:
    return best_homology(drafts, rings) > torch.tensor(
        tau, dtype=torch.float32, device=drafts.device)
