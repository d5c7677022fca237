"""Homology-score overlap counting (HaS validation): kernel + plain.

``homology_score`` replaces the Pallas kernel
``src/repro/kernels/homology_score.py::_homology_kernel``, and
``homology_validate`` that kernel together with the reduction every caller
runs after it (``first_argmax`` of the scores and the gather of the best,
``src/repro/core/has.py:369-371``).  On a CUDA tensor both launch the
hand-written kernel of ``csrc/homology_score.cu`` once (a grid of
(h tiles x b tiles) planned by :func:`plan_tiles`; ``homology_validate``'s
best rows merged by the last CTA of each b tile in the same launch) and
raise if that fails; on a CPU tensor they run the plain versions.

``homology_score.launches`` counts the kernel's launches, one per call of
either.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.homology import (homology_scores_batched,
                                       homology_scores_weighted_batched)
from repro_torch.kernels import _build
from repro_torch.kernels.topk_search import _check_groups
from repro_torch.utils import first_argmax

MAX_TILE_B = 32        # drafts a CTA scores (the kernel's kMaxTile)
CTAS_PER_SM = 16       # CTAs per SM the grid aims for (measured)
SMEM_TILE = 48 * 1024  # a CTA's staged drafts: ids, weights, groups


@functools.lru_cache(maxsize=4096)
def plan_tiles(b: int, h: int, k: int, sms: int,
               rows: int) -> tuple[int, int, int]:
    """(tb, n_h, n_b): drafts a CTA, and the grid of n_h tiles of ``rows``
    cached rows by n_b tiles of ``tb`` drafts.  CTA (x, y) scores rows
    [x*rows, (x+1)*rows) against drafts [y*tb, (y+1)*tb), both cut at the
    end.  tb grows with B until the grid holds about CTAS_PER_SM CTAs per
    SM, within MAX_TILE_B and the shared memory a tile's drafts take."""
    n_h = -(-h // rows)
    fit = SMEM_TILE // (4 * (2 * k + 1))
    if fit < 1:
        raise ValueError(f"homology_score: k={k} drafts do not fit a CTA")
    tb = max(1, min(MAX_TILE_B, fit, b, -(-b * n_h // (CTAS_PER_SM * sms))))
    return tb, n_h, -(-b // tb)


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


def homology_validate_plain(draft_ids, cache_doc_ids, cache_valid,
                            row_group=None, q_group=None,
                            draft_weights=None):
    """-> (scores [B,H] f32, best [B] f32, slot [B] int32): the scores of
    :func:`homology_score_plain`, each draft's first maximal row and its
    score."""
    scores = homology_score_plain(draft_ids, cache_doc_ids, cache_valid,
                                  row_group, q_group, draft_weights)
    slot = first_argmax(scores)
    best = torch.gather(scores, 1, slot[:, None])[:, 0]
    return scores, best, slot.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _rows_per_cta() -> int:
    return _build.library("homology_score").has_homology_rows_per_cta()


def _launch(draft_ids, cache_doc_ids, cache_valid, row_group, q_group,
            draft_weights, validate: bool):
    grouped = _check_groups(row_group, q_group)
    b, k = draft_ids.shape
    h = cache_doc_ids.shape[0]
    if cache_doc_ids.shape[1] != k or cache_valid.shape != (h,):
        raise ValueError(
            f"homology_score: draft {tuple(draft_ids.shape)}, cache "
            f"{tuple(cache_doc_ids.shape)}, valid {tuple(cache_valid.shape)}")
    if validate and h == 0:
        raise ValueError("homology_validate: an empty cache has no best row")
    draft = draft_ids.to(torch.int32).contiguous()
    cache = cache_doc_ids.to(torch.int32).contiguous()
    valid = cache_valid.bool().contiguous().view(torch.uint8)
    w = (None if draft_weights is None
         else draft_weights.float().contiguous())
    rg = row_group.to(torch.int32).contiguous() if grouped else None
    qg = q_group.to(torch.int32).contiguous() if grouped else None
    dev = _build.check_operands("homology_score", draft, cache, valid, w,
                                rg, qg)
    out = torch.empty((b, h), dtype=torch.float32, device=dev)
    best = torch.empty((b,), dtype=torch.float32, device=dev) \
        if validate else None
    slot = torch.empty((b,), dtype=torch.int32, device=dev) \
        if validate else None
    if b == 0 or h == 0:
        return out, best, slot
    lib = _build.library("homology_score")
    tb, n_h, n_b = plan_tiles(b, h, k, _build.sm_count(dev), _rows_per_cta())
    if n_b > 65535:
        raise ValueError(f"homology_score: B={b} needs {n_b} > 65535 tiles")
    st = _build.stream(dev)
    tickets = part = None
    if validate:
        tickets, part = _build.scratch("homology_score", dev, st,
                                       -(-n_b // 32) * 32, 2 * b * n_h)
    _build.check(lib.has_homology_score(
        _build.ptr(draft), _build.ptr(cache), _build.ptr(valid),
        _build.ptr(w), _build.ptr(rg), _build.ptr(qg), _build.ptr(out),
        _build.ptr(best), _build.ptr(slot), tickets, part, b, h, k, tb, st),
        "homology_score")
    homology_score.launches += 1
    return out, best, slot


def homology_score(draft_ids: torch.Tensor, cache_doc_ids: torch.Tensor,
                   cache_valid: torch.Tensor,
                   row_group: torch.Tensor | None = None,
                   q_group: torch.Tensor | None = None,
                   draft_weights: torch.Tensor | None = None):
    """Same contract as :func:`homology_score_plain`; the kernel on CUDA."""
    if draft_ids.device.type != "cuda":
        return homology_score_plain(draft_ids, cache_doc_ids, cache_valid,
                                    row_group, q_group, draft_weights)
    return _launch(draft_ids, cache_doc_ids, cache_valid, row_group,
                   q_group, draft_weights, validate=False)[0]


homology_score.launches = 0


def homology_validate(draft_ids, cache_doc_ids, cache_valid, row_group=None,
                      q_group=None, draft_weights=None):
    """Same contract as :func:`homology_validate_plain`; on CUDA one launch
    that also finds each draft's best row."""
    if draft_ids.device.type != "cuda":
        return homology_validate_plain(draft_ids, cache_doc_ids, cache_valid,
                                       row_group, q_group, draft_weights)
    return _launch(draft_ids, cache_doc_ids, cache_valid, row_group,
                   q_group, draft_weights, validate=True)
