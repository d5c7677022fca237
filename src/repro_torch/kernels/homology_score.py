"""Homology-score overlap counting (HaS validation): kernel + plain.

``homology_score`` replaces the Pallas kernel
``src/repro/kernels/homology_score.py::_homology_kernel``.  On a CUDA
tensor it launches the hand-written kernel of ``csrc/homology_score.cu``
(one thread per (draft, cached row)) and raises if that fails; on a CPU
tensor it runs :func:`homology_score_plain`.

``homology_score.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.homology import (homology_scores_batched,
                                       homology_scores_weighted_batched)
from repro_torch.kernels import _build
from repro_torch.kernels.topk_search import _check_groups


def homology_score_plain(draft_ids: torch.Tensor,
                         cache_doc_ids: torch.Tensor,
                         cache_valid: torch.Tensor,
                         row_group: torch.Tensor | None = None,
                         q_group: torch.Tensor | None = None,
                         draft_weights: torch.Tensor | None = None):
    """draft [B,k] int, cache [H,k] int, valid [H] -> scores [B,H] f32.

    ``row_group [H]`` / ``q_group [B]`` (together): row h scores 0 for
    drafts of another group.  ``draft_weights [B,k]``: the sum of the
    matched slots' weights instead of ``count / k``.
    """
    valid = cache_valid.bool()[None, :]
    if _check_groups(row_group, q_group):
        valid = valid & (row_group[None, :] == q_group[:, None])
    if draft_weights is None:
        return homology_scores_batched(draft_ids, cache_doc_ids, valid)
    return homology_scores_weighted_batched(draft_ids, cache_doc_ids, valid,
                                            draft_weights)


def homology_score(draft_ids: torch.Tensor, cache_doc_ids: torch.Tensor,
                   cache_valid: torch.Tensor,
                   row_group: torch.Tensor | None = None,
                   q_group: torch.Tensor | None = None,
                   draft_weights: torch.Tensor | None = None):
    """Same contract as :func:`homology_score_plain`; the kernel on CUDA."""
    if draft_ids.device.type != "cuda":
        return homology_score_plain(draft_ids, cache_doc_ids, cache_valid,
                                    row_group, q_group, draft_weights)
    grouped = _check_groups(row_group, q_group)
    b, k = draft_ids.shape
    h = cache_doc_ids.shape[0]
    if cache_doc_ids.shape[1] != k or cache_valid.shape != (h,):
        raise ValueError(
            f"homology_score: draft {tuple(draft_ids.shape)}, cache "
            f"{tuple(cache_doc_ids.shape)}, valid {tuple(cache_valid.shape)}")
    if b > 65535:
        raise ValueError("homology_score: B <= 65535")
    draft = draft_ids.to(torch.int32).contiguous()
    cache = cache_doc_ids.to(torch.int32).contiguous()
    valid = cache_valid.bool().contiguous().view(torch.uint8)
    w = (None if draft_weights is None
         else draft_weights.float().contiguous())
    rg = row_group.to(torch.int32).contiguous() if grouped else None
    qg = q_group.to(torch.int32).contiguous() if grouped else None
    dev = _build.check_operands("homology_score", draft, cache, valid, w,
                                rg, qg)
    out = torch.zeros((b, h), dtype=torch.float32, device=dev)
    if b == 0 or h == 0:
        return out
    lib = _build.library("homology_score")
    _build.check(lib.has_homology_score(
        _build.ptr(draft), _build.ptr(cache), _build.ptr(valid),
        _build.ptr(w), _build.ptr(rg), _build.ptr(qg), _build.ptr(out), b, h,
        k, _build.stream(dev)), "homology_score")
    homology_score.launches += 1
    return out


homology_score.launches = 0
