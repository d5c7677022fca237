"""Cloud stage ``flat``: the exact scan of the whole corpus.

Program: ``repro_torch.retrieval.service.LocalFlatBackend``
(``chunked_flat_search`` in ``chunk``-row blocks).  Reference: the exact
top-k by inner product, in float64, in blocks of rows.
"""
from __future__ import annotations

import torch

from perfbench import roofline
from perfbench.reference import search

SCAN = "exact_scan"        # roofline key of the stage's scan
SCAN_RANGE = "pb.cloud"    # the trace range its device time is read from


def build_port(corpus, cfg: dict, seed: int, device, latency):
    from repro_torch.retrieval.service import LocalFlatBackend
    return LocalFlatBackend(corpus, int(cfg["k"]), latency,
                            chunk=int(cfg["cloud"]["chunk"]))


def reference(corpus, cfg: dict, seed: int):
    return None


def select(ref, corpus, steps, k: int, precision: str):
    """Top-k of the rejects of each judged micro-batch (``steps``: their
    [R, d] queries) -> (vals [Q, k] f64, rows [Q, k])."""
    q = torch.cat(steps)
    with search.precision_scope(precision) as dt:
        return search.blocked_topk(search.exact_block(q, corpus, dt), None,
                                   corpus.shape[0], q.shape[0], k, q.device)


def rescore(ref, corpus, steps, ids):
    q = torch.cat(steps)
    ok = ids < corpus.shape[0]
    return search.rescore(search.exact_rows(q, corpus), ids.long(), ok)


def work(ref, cfg: dict, queries) -> dict:
    """Least seconds of the stage for one micro-batch's rejects."""
    r = queries.shape[0]
    return {SCAN: roofline.exact_scan(r, int(cfg["corpus_rows"]),
                                      int(cfg["d"]), int(cfg["k"]))}
