"""Streaming inner-product top-k (the HaS cache channel): kernel + plain.

``topk_search`` replaces the Pallas kernel
``src/repro/kernels/topk_search.py::_topk_kernel``.  On a CUDA tensor it
launches the hand-written kernel of ``csrc/topk_search.cu`` (pass 1: a
top-k per 256-row chunk; pass 2: the candidate merge) and raises if that
fails; on a CPU tensor it runs :func:`topk_search_plain`.  The two agree on
the tie rule: score descending, then the lower corpus row.

``topk_search.launches`` counts the kernel's launches (one per call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.utils import stable_topk

# widest candidate row one merge warp holds in shared memory; wider rows
# merge in rounds
MERGE_WIDTH = 4096
MAX_K = 1024


def _check_groups(row_group, q_group) -> bool:
    if (row_group is None) != (q_group is None):
        raise ValueError("row_group and q_group must be passed together")
    return row_group is not None


def topk_search_plain(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                      valid: torch.Tensor | None = None,
                      row_group: torch.Tensor | None = None,
                      q_group: torch.Tensor | None = None):
    """queries [B,d], corpus [N,d] -> (vals [B,k] desc f32, idx [B,k] i32).

    ``valid [N]`` masks corpus rows out; ``row_group [N]`` / ``q_group
    [B]`` (together) let row i win only for queries of its group.
    Positions left without a row are ``(-inf, -1)``.
    """
    grouped = _check_groups(row_group, q_group)
    scores = queries.float() @ corpus.float().T               # [B, N]
    ok = torch.ones_like(scores, dtype=torch.bool)
    if valid is not None:
        ok = ok & valid.bool()[None, :]
    if grouped:
        ok = ok & (row_group[None, :] == q_group[:, None])
    vals, pos = stable_topk(scores.masked_fill(~ok, -torch.inf), k)
    return vals, torch.where(torch.isfinite(vals), pos, -1).to(torch.int32)


def merge_candidates(fn, vals, keys, pay, k: int):
    """Pass 2 on the card: [B, m] candidates -> [B, k] (vals, keys, pay).

    ``fn`` is a C merge entry (``has_topk_merge`` / ``has_ivf_merge``).
    Order: vals descending, then keys ascending.
    """
    b, m = vals.shape
    dev = vals.device
    while True:
        g = -(-m // MERGE_WIDTH)
        width = -(-m // g)
        pad = g * width - m
        if pad:
            vals = torch.cat([vals, vals.new_full((b, pad), -torch.inf)], 1)
            keys = torch.cat([keys, keys.new_full((b, pad), -1)], 1)
            pay = torch.cat([pay, pay.new_full((b, pad), -1)], 1)
        rows = b * g
        out_v = torch.empty((rows, k), dtype=torch.float32, device=dev)
        out_k = torch.empty((rows, k), dtype=torch.int32, device=dev)
        out_p = torch.empty((rows, k), dtype=torch.int32, device=dev)
        _build.check(fn(_build.ptr(vals), _build.ptr(keys), _build.ptr(pay),
                        rows, width, k, _build.ptr(out_v), _build.ptr(out_k),
                        _build.ptr(out_p), _build.stream(dev)),
                     "top-k merge")
        if g == 1:
            return out_v, out_k, out_p
        vals, keys, pay = (t.reshape(b, g * k) for t in (out_v, out_k, out_p))
        m = g * k


def topk_search(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                valid: torch.Tensor | None = None,
                row_group: torch.Tensor | None = None,
                q_group: torch.Tensor | None = None):
    """Same contract as :func:`topk_search_plain`; the kernel on CUDA."""
    if queries.device.type != "cuda":
        return topk_search_plain(queries, corpus, k, valid, row_group,
                                 q_group)
    grouped = _check_groups(row_group, q_group)
    b, d = queries.shape
    n = corpus.shape[0]
    if corpus.shape[1] != d:
        raise ValueError(f"queries d={d} vs corpus d={corpus.shape[1]}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    q = queries.float().contiguous()
    c = corpus.float().contiguous()
    v = (torch.ones(n, dtype=torch.bool, device=q.device) if valid is None
         else valid.bool()).contiguous().view(torch.uint8)
    rg = row_group.to(torch.int32).contiguous() if grouped else None
    qg = q_group.to(torch.int32).contiguous() if grouped else None
    dev = _build.check_operands("topk_search", q, c, v, rg, qg)
    if v.shape != (n,) or (grouped and (rg.shape != (n,) or
                                        qg.shape != (b,))):
        raise ValueError("topk_search: valid/row_group must be [N], "
                         "q_group [B]")
    if b == 0 or n == 0:
        return (torch.full((b, k), -torch.inf, device=dev),
                torch.full((b, k), -1, dtype=torch.int32, device=dev))
    lib = _build.library("topk_search")
    n_chunks = -(-n // lib.has_topk_rows_per_block())
    cand_v = torch.empty((b, n_chunks * k), dtype=torch.float32, device=dev)
    cand_r = torch.empty((b, n_chunks * k), dtype=torch.int32, device=dev)
    _build.check(lib.has_topk_search(
        _build.ptr(q), _build.ptr(c), _build.ptr(v), _build.ptr(rg),
        _build.ptr(qg), _build.ptr(cand_v), _build.ptr(cand_r), b, n, d, k,
        n_chunks, _build.stream(dev)), "topk_search")
    topk_search.launches += 1
    vals, _, rows = merge_candidates(lib.has_topk_merge, cand_v, cand_r,
                                     cand_r, k)
    return vals, rows


topk_search.launches = 0
