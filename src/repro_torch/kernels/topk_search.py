"""Streaming inner-product top-k (the HaS cache channel): kernel + plain.

``topk_search`` replaces the Pallas kernel
``src/repro/kernels/topk_search.py::_topk_kernel``.  On a CUDA tensor it
launches the hand-written kernels of ``csrc/topk_search.cu`` (a persistent
scan that keeps a running top-k per query and block, then a block-wide
merge of those lists) and raises if that fails; on a CPU tensor it runs
:func:`topk_search_plain`.  The two agree on the tie rule: score
descending, then the lower corpus row.

``topk_search.launches`` counts the kernel's launches (one per call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.utils import stable_topk

MAX_K = 1024
# the scan's query tiles: (queries, rows per tile) of kernel tile 0, 1, 2
SCAN_TILES = ((1, 256), (8, 256), (64, 128))
WIDE_TILE_MAX_K = 64       # tile 2 keeps 64 lists of k in shared memory
MAX_LISTS = 256            # blocks per query tile: one merge warp per 32


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


def plan_scan(b: int, n: int, k: int, n_sm: int) -> tuple[int, int, int]:
    """(tile, grid_x, query tiles) of the scan: tile 0 for one query, 1 for
    up to 8 or for k > WIDE_TILE_MAX_K, else 2 (64 queries); about one
    block per SM in all, block j of a query tile scanning rows
    [j * n // grid_x, (j + 1) * n // grid_x)."""
    tile = 0 if b == 1 else 1 if b <= 8 or k > WIDE_TILE_MAX_K else 2
    qb, rows = SCAN_TILES[tile]
    q_tiles = -(-b // qb)
    grid_x = max(1, min(-(-n // rows), -(-n_sm // q_tiles), MAX_LISTS))
    return tile, grid_x, q_tiles


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
    if d % 4:                       # 16-byte rows for cp.async: zero-pad d
        pad = 4 - d % 4
        q = torch.nn.functional.pad(q, (0, pad))
        c = torch.nn.functional.pad(c, (0, pad))
    if q.data_ptr() % 16:
        q = q.clone()
    if c.data_ptr() % 16:
        c = c.clone()
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
    tile, grid_x, q_tiles = plan_scan(b, n, k, _build.sm_count(dev))
    if q_tiles > 65535:
        raise ValueError(f"topk_search: B={b} is too many queries")
    lib = _build.library("topk_search")
    cand_v = torch.empty((b, grid_x * k), dtype=torch.float32, device=dev)
    cand_r = torch.empty((b, grid_x * k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    rows = torch.empty((b, k), dtype=torch.int32, device=dev)
    _build.check(lib.has_topk_search(
        _build.ptr(q), _build.ptr(c), _build.ptr(v), _build.ptr(rg),
        _build.ptr(qg), _build.ptr(cand_v), _build.ptr(cand_r),
        _build.ptr(vals), _build.ptr(rows), b, n, q.shape[1], k, tile,
        grid_x, _build.stream(dev)), "topk_search")
    topk_search.launches += 1
    return vals, rows


topk_search.launches = 0
