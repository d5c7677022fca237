"""Exact nearest-neighbour search (ENNS) as matmul + top-k.

Flat search over an embedding store is a matrix product, scores = q @ E^T,
followed by a top-k.  The product stays ``torch.matmul`` (full f32: TF32
is never enabled), as the reference leaves it to XLA; the top-k takes ties
to the lower corpus row (:func:`~repro_torch.utils.stable_topk`).  The
reference's sharding rules have no role on one card, and its int8
``quantize_store`` path is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.utils import stable_topk


def flat_search(corpus: torch.Tensor, queries: torch.Tensor,
                k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """corpus [N, d], queries [B, d] -> (scores [B,k], ids [B,k] int32)."""
    scores, ids = stable_topk(queries @ corpus.T, k)
    return scores, ids.to(torch.int32)


def chunked_flat_search(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                        chunk: int = 65536) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Streaming exact top-k: corpus chunks with a running top-k merge.

    Bounds the transient score matrix to [B, chunk].  The running best
    comes first in each merge, so ties keep the earlier (lower) row, as the
    reference's scan does; positions never filled are ``(-inf, -1)``.
    Returns (scores [B,k] f32, ids [B,k] int32).
    """
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
