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

:func:`sharded_topk_reference` is the mesh-free form, which
``retrieval/service.py::ShardedMeshBackend`` runs.  The reference's
``distributed_flat_search`` spreads the shards over a JAX device mesh with
an all-gather merge; one card has no such mesh, and a
``torch.distributed`` counterpart is still to be written, so
:func:`distributed_flat_search` raises.
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


def distributed_flat_search(mesh, corpus_axes=("data", "model")):
    """The multi-device search of the reference; not on one card."""
    raise NotImplementedError(
        "distributed_flat_search needs a multi-device mesh; one card runs "
        "sharded_topk_reference, and a torch.distributed counterpart is "
        "still to be written")


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
