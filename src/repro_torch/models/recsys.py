"""The EmbeddingBag substrate of the reference's recsys models.

Twin of ``src/repro/models/recsys.py::embedding_bag`` (gather, then a
segment sum, here ``index_add_``).  The recsys models themselves are not
ported.  The fixed-arity bag of the Pallas kernel is
``repro_torch.kernels.embedding_bag``.
"""
from __future__ import annotations

import torch


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int, mode: str = "sum",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-hot EmbeddingBag: ids [L] global row ids, segment_ids [L] the
    bag of each (sorted) -> [n_bags, D]; ``"mean"`` divides by the bag's
    size (at least 1)."""
    vecs = table[ids.long()]
    if weights is not None:
        vecs = vecs * weights[:, None]
    seg = segment_ids.long()
    out = torch.zeros((n_bags, table.shape[1]), dtype=vecs.dtype,
                      device=table.device).index_add_(0, seg, vecs)
    if mode == "mean":
        cnt = torch.zeros(n_bags, dtype=torch.float32,
                          device=table.device).index_add_(
            0, seg, torch.ones(seg.shape, dtype=torch.float32,
                               device=table.device))
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out
