"""Exact top-k over a row-sharded corpus: per-shard scans and a merge.

Each of ``n_shards`` row blocks runs the streaming chunked scan
(:func:`~repro_torch.retrieval.flat.chunked_flat_search`), offsets its
local ids to global ones, and pads its candidate set to exactly ``k``
columns with ``-inf`` scores and ``-1`` ids when the shard holds fewer
than ``k`` rows (:func:`_pad_candidates`).  The ``[B, n_shards * k]``
candidates then merge into the global top-k, ties to the lower
concatenated column (the reference's ``lax.top_k``), so the ids equal
``chunked_flat_search``'s over the whole corpus.  A ``-1`` id comes back
only when the whole corpus holds fewer than ``k`` rows.

:func:`distributed_flat_search` spreads the shards over the ranks of a
``torch.distributed`` process group, one row block a rank, and merges
after an all-gather of every rank's ``k`` candidates (the reference's
``shard_map`` with a tiled ``all_gather`` over its mesh axes).
:func:`sharded_topk_reference` is the form on one device, which
``retrieval/service.py::ShardedMeshBackend`` runs without a mesh.
"""
from __future__ import annotations

import torch

from repro_torch.retrieval.flat import chunked_flat_search
from repro_torch.utils import stable_topk


def _pad_candidates(s: torch.Tensor, i: torch.Tensor, k: int):
    """Pad local [B, kk<=k] candidates to [B, k] with -inf scores / -1 ids."""
    kk = s.shape[-1]
    if kk >= k:
        return s, i
    pad = k - kk
    s = torch.cat([s, s.new_full((*s.shape[:-1], pad), -torch.inf)], dim=-1)
    i = torch.cat([i, i.new_full((*i.shape[:-1], pad), -1)], dim=-1)
    return s, i


def distributed_flat_search(group=None):
    """-> ``search(corpus_shard, queries, k) -> (scores [B,k] f32, ids [B,k]
    int32)`` over the ranks of ``group`` (default the world).

    Rank ``r`` passes its own row block ``corpus_shard [N/W, d]`` (rows
    ``r * N/W`` on) and the same ``queries [B, d]``; every block has the
    same rows, so N must divide evenly over the W ranks, as the
    reference's ``shard_map`` requires.  Each rank takes a stable top-k of
    its block over ``min(k, rows)`` entries, offsets the ids by ``r *
    rows``, pads to k with ``(-inf, -1)``, and all-gathers scores and ids
    into ``[B, W*k]`` in rank-major order (the reference's tiled gather
    along axis 1).  The merge is a stable top-k, ties to the lower column,
    so to the lower rank; every rank returns the same result.  Tensors
    live where the group's backend needs them (CPU for gloo, the rank's
    card for NCCL).
    """
    import torch.distributed as dist

    def search(corpus_shard: torch.Tensor, queries: torch.Tensor, k: int):
        if not dist.is_initialized():
            raise RuntimeError("distributed_flat_search needs an "
                               "initialized process group (a one-device "
                               "mesh runs sharded_topk_reference)")
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        rows = corpus_shard.shape[0]
        s, i = stable_topk(queries @ corpus_shard.T, min(k, rows))
        i = i.int() + rank * rows                          # global ids
        s, i = _pad_candidates(s, i, k)
        b = queries.shape[0]
        s_all = s.new_empty((world * b, k))
        i_all = i.new_empty((world * b, k))
        dist.all_gather_into_tensor(s_all, s.contiguous(), group=group)
        dist.all_gather_into_tensor(i_all, i.contiguous(), group=group)
        # [W*B, k] rank blocks -> [B, W*k], rank-major along the columns
        s_all = s_all.view(world, b, k).transpose(0, 1).reshape(b, -1)
        i_all = i_all.view(world, b, k).transpose(0, 1).reshape(b, -1)
        v, pos = stable_topk(s_all, k)                     # the merge
        return v, torch.gather(i_all, 1, pos)

    return search


def sharded_topk_reference(corpus: torch.Tensor, queries: torch.Tensor,
                           k: int, n_shards: int,
                           chunk: int = 32768) -> tuple[torch.Tensor,
                                                        torch.Tensor]:
    """Per-shard chunked scans, global id offsets, -inf/-1 padding and the
    merge (module docstring) -> (scores [B,k] f32, ids [B,k] int32)."""
    n = corpus.shape[0]
    b = queries.shape[0]
    rows = max(1, -(-n // n_shards))
    kk = min(k, rows)
    cand_s, cand_i = [], []
    for sh in range(n_shards):
        live = min(rows, n - sh * rows)
        if live <= 0:                   # more shards than rows: empty shard
            lv = queries.new_full((b, k), -torch.inf)
            li = torch.full((b, k), -1, dtype=torch.int32,
                            device=queries.device)
        else:
            blk = corpus[sh * rows:sh * rows + live]
            lv, li = chunked_flat_search(blk, queries, kk,
                                         chunk=min(chunk, live))
            li = torch.where(li >= 0, li + sh * rows, -1)     # global ids
            lv, li = _pad_candidates(lv, li, k)
        cand_s.append(lv)
        cand_i.append(li)
    v, pos = stable_topk(torch.cat(cand_s, dim=1), k)          # the merge
    return v, torch.gather(torch.cat(cand_i, dim=1), 1, pos)
