"""The hybrid cloud stage: dense channel + lexical channel + fused rerank.

One call per ``[B, d]`` batch runs

    dense channel scan (flat | sharded | IVF-ANN)      -> top-kd ids
    lexical channel scan (hashed postings)             -> top-kl ids
    RRF fusion + near-dup diversification + rerank     -> top-k ids

behind the ``backend="cuda" | "torch"`` switch of ``kernels/ops.py``: the
IVF bucket scan goes to the ``ivf_scan`` kernel (int8 residual codes in
compressed mode), the lexical channel to ``lexical_score`` and the fusion
to ``fused_rerank``; the flat and sharded dense scans and the centroid
product stay plain ``torch.matmul``, as the reference leaves them to XLA.

Id contract: postings row == global doc id, so the lexical channel's rows
are already ids and the fused pool gathers rerank vectors straight from the
corpus; ``-1`` slots gather zero vectors and are never selected.

``ivf_ann_body`` is also the whole search of ``IVFBackend``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import fused_rerank_op, ivf_scan_op
from repro_torch.retrieval.distributed import sharded_topk_reference
from repro_torch.retrieval.flat import chunked_flat_search
from repro_torch.retrieval.ivf import CompressedIVFIndex, IVFIndex
from repro_torch.retrieval.lexical import lexical_topk
from repro_torch.utils import stable_topk


def ivf_ann_body(index: IVFIndex | CompressedIVFIndex, res_vecs: torch.Tensor,
                 res_ids: torch.Tensor, queries: torch.Tensor, *, nprobe: int,
                 k: int, backend: str | None = None):
    """Centroid product -> top-nprobe probe -> bucket scan -> exact scan of
    the residual buffer -> merged top-k: (scores [B,k], ids [B,k] int32).

    In compressed mode the probe's centroid scores are the scan's
    ``probe_bias`` (the product already computed them)."""
    q = queries.float()
    nprobe = min(nprobe, index.n_buckets)
    cvals, probe = stable_topk(q @ index.centroids.T, nprobe)    # [B, P]
    scaled = isinstance(index, CompressedIVFIndex)
    s, ids = ivf_scan_op(q, probe.to(torch.int32), index.bucket_vecs,
                         index.bucket_ids, k,
                         bucket_scales=index.bucket_scales if scaled else None,
                         probe_bias=cvals if scaled else None,
                         backend=backend)
    # exact scan of the residual flat buffer (live-ingested bucket spill)
    rs = (q @ res_vecs.T).masked_fill(res_ids[None, :] < 0, -torch.inf)
    r_s, r_pos = stable_topk(rs, min(k, res_vecs.shape[0]))
    s = torch.cat([s, r_s], dim=1)
    ids = torch.cat([ids, res_ids[r_pos]], dim=1)
    top_s, top_i = stable_topk(s, k)
    return top_s, torch.gather(ids, 1, top_i)


def _fuse_tail(corpus, queries, i_d, q_terms, q_weights, doc_terms,
               doc_weights, *, k: int, kl: int, rrf_k: float,
               diversify_sim: float | None, backend: str | None,
               tile_n: int):
    """Lexical scan + RRF/diversify/rerank over the two channels' lists."""
    _, i_l = lexical_topk(q_terms, q_weights, doc_terms, doc_weights, kl,
                          backend=backend, tile_n=tile_n)
    pool_ids = torch.cat([i_d.to(torch.int32), i_l], dim=1)     # [B, kd+kl]
    pool_vecs = (corpus[pool_ids.clamp_min(0).long()]
                 * (pool_ids >= 0)[..., None].to(corpus.dtype))
    return fused_rerank_op(queries, pool_ids, pool_vecs, i_d.shape[1], k,
                           rrf_k=rrf_k, diversify_sim=diversify_sim,
                           backend=backend)


def hybrid_flat_search(corpus, doc_terms, doc_weights, queries, q_terms,
                       q_weights, *, k, kd, kl, rrf_k, diversify_sim,
                       backend, tile_n, chunk):
    """Hybrid stage with the exact flat scan as its dense channel."""
    queries = queries.float()
    _, i_d = chunked_flat_search(corpus, queries, kd, chunk=chunk)
    return _fuse_tail(corpus, queries, i_d, q_terms, q_weights, doc_terms,
                      doc_weights, k=k, kl=kl, rrf_k=rrf_k,
                      diversify_sim=diversify_sim, backend=backend,
                      tile_n=tile_n)


def hybrid_sharded_search(corpus, doc_terms, doc_weights, queries, q_terms,
                          q_weights, *, k, kd, kl, rrf_k, diversify_sim,
                          backend, tile_n, n_shards, chunk):
    """Hybrid stage with the row-sharded exact scan as its dense channel."""
    queries = queries.float()
    _, i_d = sharded_topk_reference(corpus, queries, kd, n_shards=n_shards,
                                    chunk=chunk)
    return _fuse_tail(corpus, queries, i_d, q_terms, q_weights, doc_terms,
                      doc_weights, k=k, kl=kl, rrf_k=rrf_k,
                      diversify_sim=diversify_sim, backend=backend,
                      tile_n=tile_n)


def hybrid_ann_search(index, res_vecs, res_ids, corpus, doc_terms,
                      doc_weights, queries, q_terms, q_weights, *, k, kd, kl,
                      rrf_k, diversify_sim, backend, tile_n, nprobe):
    """Hybrid stage with the IVF ANN search as its dense channel."""
    queries = queries.float()
    _, i_d = ivf_ann_body(index, res_vecs, res_ids, queries, nprobe=nprobe,
                          k=kd, backend=backend)
    return _fuse_tail(corpus, queries, i_d, q_terms, q_weights, doc_terms,
                      doc_weights, k=k, kl=kl, rrf_k=rrf_k,
                      diversify_sim=diversify_sim, backend=backend,
                      tile_n=tile_n)
