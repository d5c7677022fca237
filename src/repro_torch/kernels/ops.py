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

from repro_torch.kernels.homology_score import (homology_score,
                                                homology_score_plain)
from repro_torch.kernels.ivf_scan import ivf_scan, ivf_scan_plain
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
                backend: str | None = None):
    fn = ivf_scan_plain if check_backend(backend) == "torch" else ivf_scan
    return fn(queries, probe, bucket_vecs, bucket_ids, k)


def homology_score_op(draft_ids, cache_doc_ids, cache_valid, row_group=None,
                      q_group=None, draft_weights=None,
                      backend: str | None = None):
    fn = (homology_score_plain if check_backend(backend) == "torch"
          else homology_score)
    return fn(draft_ids, cache_doc_ids, cache_valid, row_group, q_group,
              draft_weights)
