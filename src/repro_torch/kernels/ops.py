"""Backend switch over the ported kernels: ``backend="cuda" | "torch"``.

The port's twin of the reference's ``backend="pallas" | "xla"``:

* ``None`` and ``"cuda"`` call the kernel wrapper.  The wrapper alone
  picks by device: on a CUDA tensor it launches the kernel or raises (it
  never falls back to the plain version); on a CPU tensor it runs the
  plain version.  So the default follows the device of the operands.
* ``"torch"`` runs the plain PyTorch version.  On the card it is taken only
  when asked for, as the oracle the kernels are held against.
"""
from __future__ import annotations

from repro_torch.kernels.cache_fold import cache_fold, cache_fold_plain
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_plain)
from repro_torch.kernels.fused_rerank import fused_rerank, fused_rerank_plain
from repro_torch.kernels.homology_score import (homology_score,
                                                homology_score_plain,
                                                homology_validate,
                                                homology_validate_plain)
from repro_torch.kernels.ivf_scan import ivf_scan, ivf_scan_plain
from repro_torch.kernels.lexical_score import (lexical_score,
                                               lexical_score_plain)
from repro_torch.kernels.topk_search import topk_search, topk_search_plain

BACKENDS = ("cuda", "torch")


def check_backend(backend: str | None) -> str | None:
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS} or None")
    return backend


def topk_search_op(queries, corpus, k, valid=None, row_group=None,
                   q_group=None, backend: str | None = None):
    fn = (topk_search_plain if check_backend(backend) == "torch"
          else topk_search)
    return fn(queries, corpus, k, valid, row_group, q_group)


def ivf_scan_op(queries, probe, bucket_vecs, bucket_ids, k,
                bucket_scales=None, probe_bias=None,
                backend: str | None = None):
    fn = ivf_scan_plain if check_backend(backend) == "torch" else ivf_scan
    return fn(queries, probe, bucket_vecs, bucket_ids, k, bucket_scales,
              probe_bias)


def homology_score_op(draft_ids, cache_doc_ids, cache_valid, row_group=None,
                      q_group=None, draft_weights=None,
                      backend: str | None = None):
    fn = (homology_score_plain if check_backend(backend) == "torch"
          else homology_score)
    return fn(draft_ids, cache_doc_ids, cache_valid, row_group, q_group,
              draft_weights)


def homology_validate_op(draft_ids, cache_doc_ids, cache_valid,
                         row_group=None, q_group=None, draft_weights=None,
                         backend: str | None = None):
    fn = (homology_validate_plain if check_backend(backend) == "torch"
          else homology_validate)
    return fn(draft_ids, cache_doc_ids, cache_valid, row_group, q_group,
              draft_weights)


def lexical_score_op(q_terms, q_weights, doc_terms, doc_weights, k,
                     tile_n: int = 512, backend: str | None = None):
    fn = (lexical_score_plain if check_backend(backend) == "torch"
          else lexical_score)
    return fn(q_terms, q_weights, doc_terms, doc_weights, k, tile_n)


def fused_rerank_op(queries, pool_ids, pool_vecs, kd, k, rrf_k: float = 60.0,
                    diversify_sim: float | None = None,
                    backend: str | None = None):
    fn = (fused_rerank_plain if check_backend(backend) == "torch"
          else fused_rerank)
    return fn(queries, pool_ids, pool_vecs, kd, k, rrf_k, diversify_sim)


def decode_attention_op(q, k_cache, v_cache, cache_len,
                        backend: str | None = None):
    fn = (decode_attention_plain if check_backend(backend) == "torch"
          else decode_attention)
    return fn(q, k_cache, v_cache, cache_len)


def embedding_bag_op(table, ids, weights=None, mode: str = "sum",
                     backend: str | None = None):
    fn = (embedding_bag_plain if check_backend(backend) == "torch"
          else embedding_bag)
    return fn(table, ids, weights, mode)


def cache_fold_op(state, q_embs, full_ids, full_vecs=None, corpus=None,
                  mask=None, tenant_ids=None, backend: str | None = None):
    fn = cache_fold_plain if check_backend(backend) == "torch" else cache_fold
    return fn(state, q_embs, full_ids, full_vecs, corpus, mask, tenant_ids)
