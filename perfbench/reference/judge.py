"""The numbers that decide ``correct``, each a reading against a limit.

``draft_gap``   over the judged micro-batches, the widest gap by which the
                score of a draft id at position j lies below the j-th best
                score the two channels can return (the cache channel's doc
                ring and the fuzzy channel's probed buckets), in f64; an id
                that neither channel holds, a repeat or a missing id reads
                ``inf``.
``cloud_gap``   the same for the cloud stage's ids of each judged reject,
                against the stage's own reference (``stages/<kind>.py``).
``accept_miss`` judged queries whose accept bit differs from homology
                validation of the program's own draft against the rings.
``state_miss``  entries of the final cache state (ring ids, valid bits,
                pointers, query and doc embeddings) that differ from the
                rings folded from every served cloud result in order.
``unanswered``  window queries with no answer of ``k`` ids.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.has import Rings, accepts
from perfbench.reference.search import rescore

EXACT_LIMITS = ("accept_miss", "state_miss", "unanswered")


def gap(ref_vals: torch.Tensor, prog_ids: torch.Tensor,
        prog_scores: torch.Tensor) -> float:
    """Widest gap of ``prog`` below ``ref`` by position; ``inf`` for an id
    where the reference has none, a missing or unheld id, or a repeat."""
    if ref_vals.numel() == 0:
        return 0.0
    empty = ~torch.isfinite(ref_vals)
    srt = torch.sort(prog_ids, dim=1).values
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(dim=1)
    bad = ((empty & (prog_ids >= 0))
           | (~empty & ~torch.isfinite(prog_scores))).any(dim=1) | dup
    if bool(bad.any()):
        return float("inf")
    g = torch.where(empty, 0.0, ref_vals - prog_scores)
    return max(0.0, float(g.max()))


def draft_eligible(rings: Rings, buckets, probed: torch.Tensor, n: int,
                   device):
    """Mask function of the rows a query's two channels hold: the doc ring,
    and the kept rows of the probed buckets (``probed [Q, C]`` bool)."""
    member = torch.zeros(n, dtype=torch.bool, device=device)
    held = torch.as_tensor(rings.doc_ids[rings.doc_ids >= 0],
                           dtype=torch.int64, device=device)
    member[held] = True

    def mask(lo, hi):
        return member[None, lo:hi] | (buckets.kept[None, lo:hi]
                                      & probed[:, buckets.assign[lo:hi]])

    def at(rows):
        r = rows.clamp_min(0)
        return member[r] | (buckets.kept[r] & torch.gather(
            probed, 1, buckets.assign[r]))
    return mask, at


def state_misses(state, rings: Rings, stream_emb: np.ndarray,
                 corpus: torch.Tensor) -> int:
    """Entries of the program's final state that differ from ``rings``."""
    dev = state.doc_ids.device
    miss = int(int(state.q_ptr) != rings.q_ptr)
    miss += int(int(state.d_ptr) != rings.d_ptr)
    valid = torch.as_tensor(rings.q_valid, device=dev)
    miss += int((state.query_valid.cpu().numpy() != rings.q_valid).sum())
    miss += int((state.query_doc_ids.cpu().numpy() != rings.q_ids).sum())
    miss += int((state.doc_ids.cpu().numpy() != rings.doc_ids).sum())
    both = (valid & state.query_valid.bool()).cpu().numpy()
    want_q = torch.as_tensor(stream_emb[rings.q_src[both]], device=dev)
    miss += int((state.query_emb[torch.as_tensor(both, device=dev)]
                 != want_q).any(dim=1).sum())
    held = torch.as_tensor(rings.doc_ids >= 0, device=dev)
    ids = torch.as_tensor(rings.doc_ids, dtype=torch.int64, device=dev)
    miss += int((state.doc_emb[held] != corpus[ids[held]]).any(dim=1).sum())
    return miss


def accept_misses(val_ids: torch.Tensor, accept: torch.Tensor,
                  rings: Rings, tau: float) -> int:
    want = accepts(val_ids, rings, tau)
    return int((want != accept.to(want.device)).sum())


def draft_reading(ref_vals, prog_ids, score_rows, at) -> float:
    ok = at(prog_ids)
    return gap(ref_vals, prog_ids, rescore(score_rows, prog_ids, ok))
