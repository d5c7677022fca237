"""Homology score + re-identification (paper §III-C), plain PyTorch.

Definition 5: s(q1, q2) = |D1 ∩ D2| / k — the overlap ratio between the two
queries' retrieval result sets.  The paper keeps a document→query inverted
index (a hash map); here the draft's k doc-ids are compared against the
cached doc-id table [H, k] as a dense fixed-shape overlap count, O(H·k²)
integer compares.  On the card that compare is the ``homology_score``
kernel (``kernels/homology_score.py``); these functions are its plain
version and the reference semantics.

Ids below 0 in the draft never match.  Scores are ``count / k`` in f32
(IEEE division), so ``2/10 == 0.2f`` and the strict ``best > tau`` of
Algorithm 1 line 11 decides exactly as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.utils import first_argmax


def _hits(draft_ids: torch.Tensor, cache_doc_ids: torch.Tensor):
    """draft [B,k], cache [H,k] -> hit [B,H,k]: draft slot j found in row h."""
    d = draft_ids[:, None, :, None]
    eq = (d == cache_doc_ids[None, :, None, :]) & (d >= 0)     # [B,H,k,k]
    return eq.any(dim=3)


def homology_scores_batched(draft_ids: torch.Tensor,
                            cache_doc_ids: torch.Tensor,
                            cache_valid: torch.Tensor) -> torch.Tensor:
    """draft_ids [B,k], cache_doc_ids [H,k], cache_valid [H] or [B,H]
    -> scores [B,H] f32 in [0, 1]."""
    k = draft_ids.shape[1]
    overlap = _hits(draft_ids, cache_doc_ids).sum(dim=2)
    # a divisor on the device: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, and 9 * (1/10) is not 9/10 in f32
    k_dev = torch.tensor(k, dtype=torch.float32, device=overlap.device)
    s = overlap.to(torch.float32) / k_dev
    return torch.where(cache_valid.bool(), s, 0.0)


def homology_scores(draft_ids: torch.Tensor, cache_doc_ids: torch.Tensor,
                    cache_valid: torch.Tensor) -> torch.Tensor:
    """One draft [k] against every cached query -> scores [H]."""
    return homology_scores_batched(draft_ids[None], cache_doc_ids,
                                   cache_valid)[0]


def rrf_draft_weights(ids: torch.Tensor, rrf_k: float) -> torch.Tensor:
    """Per-slot normalized RRF mass of a fused draft: ids [..., k] ->
    weights [..., k] f32 summing to 1 over the valid slots (0 if none).

    Position j carries mass ``1/(rrf_k + j)``; invalid (-1) slots carry
    none.  Normalizing per draft keeps the weighted score in [0, 1], so the
    same ``tau`` applies.
    """
    k = ids.shape[-1]
    w = 1.0 / (rrf_k + torch.arange(k, dtype=torch.float32,
                                    device=ids.device))
    w = torch.where(ids >= 0, w, 0.0)
    norm = torch.clamp_min(w.sum(dim=-1, keepdim=True), 1e-30)
    return w / norm


def homology_scores_weighted_batched(draft_ids: torch.Tensor,
                                     cache_doc_ids: torch.Tensor,
                                     cache_valid: torch.Tensor,
                                     draft_weights: torch.Tensor):
    """Rank-weighted homology: draft_ids/draft_weights [B,k] -> [B,H] f32,
    the matched fraction of each draft's RRF mass."""
    hit = _hits(draft_ids, cache_doc_ids).to(torch.float32)   # [B,H,k]
    s = (hit * draft_weights.float()[:, None, :]).sum(dim=2)
    return torch.where(cache_valid.bool(), s, 0.0)


def homology_scores_weighted(draft_ids, cache_doc_ids, cache_valid,
                             draft_weights) -> torch.Tensor:
    """One fused draft [k] with weights [k] -> scores [H]."""
    return homology_scores_weighted_batched(
        draft_ids[None], cache_doc_ids, cache_valid, draft_weights[None])[0]


def reidentify(draft_ids: torch.Tensor, cache_doc_ids: torch.Tensor,
               cache_valid: torch.Tensor, tau: float):
    """Threshold re-identification -> (accept, best_score, best_slot).

    Accept iff max_h s(q, q_h) > tau (strict, Algorithm 1 line 11); the
    slot is the first maximum.
    """
    s = homology_scores(draft_ids, cache_doc_ids, cache_valid)
    slot = first_argmax(s)
    best = s[slot]
    return best > torch.tensor(tau, dtype=torch.float32), best, \
        slot.to(torch.int32)


def pairwise_homology(ids_a: torch.Tensor, ids_b: torch.Tensor):
    """s(q1,q2) for two result sets [k] -> scalar overlap ratio."""
    k = ids_a.shape[0]
    eq = (ids_a[:, None] == ids_b[None, :]) & (ids_a[:, None] >= 0)
    return eq.any(dim=1).sum().to(torch.float32) / k
