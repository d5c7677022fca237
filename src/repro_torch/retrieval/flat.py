"""Exact nearest-neighbour search (ENNS) as matmul + top-k.

Flat search over an embedding store is a matrix product, scores = q @ E^T,
followed by a top-k.  The product stays ``torch.matmul`` (full f32: TF32
is never enabled), as the reference leaves it to XLA; the top-k takes ties
to the lower corpus row (:func:`~repro_torch.utils.stable_topk`).  The
reference's sharding rules have no role on one card.  The int8 store
(``quantize_store``, ``quantized_search``) is the ScaNN substitute of the
baselines.
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
