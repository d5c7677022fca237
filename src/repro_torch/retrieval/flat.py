"""Exact nearest-neighbour search (ENNS) as matmul + top-k.

Flat search over an embedding store is a matrix product, scores = q @ E^T,
followed by a top-k.  The product stays ``torch.matmul`` (full f32: TF32
is never enabled), as the reference leaves it to XLA; the top-k takes ties
to the lower corpus row (:func:`~repro_torch.utils.stable_topk`).  With
``rules`` and a ``DTensor`` corpus on a mesh, the corpus and the scores
shard their rows over ``corpus`` (``src/repro/retrieval/flat.py:19-39``)
and :func:`rank_topk` takes each rank's top-k and merges the ranks'
candidates in rank order: the ids are the one-card search's.  The int8
store (``quantize_store``, ``quantized_search``) is the ScaNN substitute
of the baselines.
"""
from __future__ import annotations

import torch

from repro_torch.utils import (constrain, is_dtensor, mesh_scope, replicated,
                               run_replicated, stable_topk)


def rank_topk(scores, k: int, local_topk=stable_topk):
    """The top-k of ``scores [B, N]`` (a ``DTensor`` sharded over its N
    dim): each rank's own top-k of its rows by ``local_topk`` (ties to the
    lower row), its ids offset to global rows, the ranks' candidates
    gathered in rank order and merged by a stable top-k, so ties go to
    the lower rank -> replicated (vals [B, k], ids [B, k] int32)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = scores.device_mesh
    local = scores.to_local()
    _, offset = compute_local_shape_and_global_offset(
        scores.shape, mesh, scores.placements)
    lv, li = local_topk(local, min(k, local.shape[1]))
    li = li.int() + offset[1]
    pl = [Shard(1) if p == Shard(1) else Replicate()
          for p in scores.placements]
    lv, li = (replicated(DTensor.from_local(a, mesh, pl, run_check=False))
              for a in (lv, li))
    v, pos = stable_topk(lv, k)
    return v, run_replicated(lambda a, p: torch.gather(a, 1, p), li, pos)


def flat_search(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                rules=None) -> tuple[torch.Tensor, torch.Tensor]:
    """corpus [N, d], queries [B, d] -> (scores [B,k], ids [B,k] int32)."""
    if rules is not None and is_dtensor(corpus):
        with mesh_scope(corpus):
            corpus = constrain(corpus, ("corpus", None), rules)
            scores = constrain(queries @ corpus.T, (None, "corpus"), rules)
            return rank_topk(scores, k)
    scores, ids = stable_topk(queries @ corpus.T, k)
    return scores, ids.to(torch.int32)


def chunked_flat_search(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                        chunk: int = 65536, rules=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming exact top-k: corpus chunks with a running top-k merge.

    Bounds the transient score matrix to [B, chunk].  The running best
    comes first in each merge, so ties keep the earlier (lower) row, as the
    reference's scan does; positions never filled are ``(-inf, -1)``.
    Returns (scores [B,k] f32, ids [B,k] int32).  On a mesh (``rules``, a
    ``DTensor`` corpus) it is :func:`flat_search`'s sharded scan: each
    rank's rows are its chunk.
    """
    if rules is not None and is_dtensor(corpus):
        return flat_search(corpus, queries, k, rules)
    n = corpus.shape[0]
    b = queries.shape[0]
    dev = queries.device
    best_s = torch.full((b, k), -torch.inf, dtype=queries.dtype, device=dev)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for base in range(0, n, chunk):
        block = corpus[base:base + chunk]
        s = queries @ block.T                                  # [B, chunk]
        ids = torch.arange(base, base + block.shape[0], dtype=torch.int32,
                           device=dev).expand(b, -1)
        cs = torch.cat([best_s, s], dim=1)
        ci = torch.cat([best_i, ids], dim=1)
        best_s, pos = stable_topk(cs, k)
        best_i = torch.gather(ci, 1, pos)
    return best_s, best_i


# ---------------------------------------------------------------------------
# int8 quantized store (the baselines' ScaNN substitute)
# ---------------------------------------------------------------------------

def quantize_store(corpus: torch.Tensor) -> dict:
    """Per-vector symmetric int8 quantization: ~4x less memory.

    The reference runs this op by op (not under ``jit``), so its scale is
    a true division by 127; a divisor on the device keeps CUDA from
    multiplying by the reciprocal instead.
    """
    c127 = torch.tensor(127.0, device=corpus.device)
    scale = corpus.abs().amax(dim=-1, keepdim=True) / c127
    q = torch.clamp(torch.round(corpus / torch.clamp_min(scale, 1e-8)),
                    -127, 127)
    return {"q": q.to(torch.int8), "scale": scale[:, 0].to(torch.float32)}


def quantized_search(store: dict, queries: torch.Tensor, k: int,
                     rescore: torch.Tensor | None = None,
                     rescore_factor: int = 4) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """ADC-style scoring on the int8 store + optional exact re-rank.

    Approximate scores from the compressed store select ``rescore_factor
    * k`` candidates, which are scored exactly against the f32 corpus
    (``rescore``) if given.  Ties go to the lower row, as ``lax.top_k``.
    Returns (scores [B,k], ids [B,k] int32).
    """
    approx = (queries @ store["q"].T.to(queries.dtype)) \
        * store["scale"][None, :]
    if rescore is None:
        s, ids = stable_topk(approx, k)
        return s, ids.to(torch.int32)
    m = min(rescore_factor * k, approx.shape[1])
    _, cand = stable_topk(approx, m)                       # [B, m]
    exact = torch.einsum("bd,bmd->bm", queries, rescore[cand])
    s, local = stable_topk(exact, k)
    return s, torch.gather(cand, 1, local).to(torch.int32)
