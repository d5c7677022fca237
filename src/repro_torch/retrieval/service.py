"""Full-retrieval backend layer + the shared RetrievalService.

Every rejected draft pays for a full-database retrieval, so the cloud stage
is pluggable: :class:`FullRetrievalBackend` is what the serving layers see.

``LocalFlatBackend``
    One in-process exact scan (``chunked_flat_search``).
``IVFBackend``
    ANN cloud stage: an IVF index built chunk by chunk
    (``retrieval/ivf.py``), optionally with int8 centroid-residual codes
    (``compressed=True``), searched by ``retrieval/fusion.py::
    ivf_ann_body`` (the ``ivf_scan`` kernel on the card).  Approximate.
``HybridBackend``
    Dense channel (``"flat"`` or ``"ann"``) + hashed-term lexical channel +
    RRF fusion, near-duplicate diversification and dense rerank
    (``retrieval/fusion.py``).  Term-less searches run with inert terms
    and degrade to diversified dense retrieval.

Each ``search`` records one ``core/dispatch.py`` probe, as in the
reference.  Every backend has the reference's no-op ``on_ingest`` hook,
which the engines call after each cache ingest.  Not ported yet: live
ingest (``ingest_docs``), ``ReplicaBackend`` and ``ShardedMeshBackend``.

Latency protocol: ``latency(batch)`` returns the *modeled* service time of
one coalesced dispatch; ``n_workers`` is how many such dispatches a virtual
clock may overlap.
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.kernels.ops import check_backend
from repro_torch.retrieval.flat import chunked_flat_search
from repro_torch.retrieval.fusion import (hybrid_ann_search,
                                          hybrid_flat_search, ivf_ann_body)
from repro_torch.retrieval.ivf import _build_ivf_arrays, index_from_arrays
from repro_torch.utils import as_f32, as_i32, resolve_device, synchronize


@runtime_checkable
class FullRetrievalBackend(Protocol):
    """What a serving layer needs from the full-database retrieval stage."""

    #: concurrent dispatch slots the virtual clock may overlap
    n_workers: int

    def search(self, q_embs: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
        """Exact top-k for a query batch [B, d] -> (scores [B,k], ids [B,k])."""
        ...

    def latency(self, batch: int) -> float:
        """Modeled service time (s) of ONE coalesced dispatch of ``batch``."""
        ...

    def on_ingest(self, q_embs: np.ndarray, full_ids: np.ndarray,
                  state, tenant_ids: np.ndarray | None = None, *,
                  ingest_key=None) -> None:
        """Cache-ingest notification (rows just folded into the HaS cache).

        ``tenant_ids [N]`` (optional) tags each row with its tenant
        partition (None on the single-tenant path); ``ingest_key`` is a
        stable batch identity, for a replicating backend to drop a batch
        it has already recorded.
        """
        ...


class _BackendBase:
    """The shared no-op ingest hook; concrete backends set search,
    latency and n_workers."""

    def on_ingest(self, q_embs, full_ids, state, tenant_ids=None, *,
                  ingest_key=None) -> None:
        return None


class LocalFlatBackend(_BackendBase):
    """One in-process chunked exact scan, one worker."""

    n_workers = 1

    def __init__(self, corpus: torch.Tensor, k: int, lat,
                 chunk: int = 32768):
        self.corpus = corpus
        self.k = k
        self.lat = lat
        self.chunk = min(chunk, corpus.shape[0])

    def search(self, q_embs):
        return chunked_flat_search(self.corpus, q_embs, self.k, self.chunk)

    def latency(self, batch: int) -> float:
        # bandwidth-bound coalesced matmul: the batch streams the corpus once
        return self.lat.full_scan_time()


class IVFBackend(_BackendBase):
    """ANN cloud stage: IVF index + bucket scan + exact residual buffer.

    The index is built by streaming the corpus through k-means assignment
    in ``build_chunk``-row slices (``centroids=`` skips k-means);
    ``compressed=True`` stores int8 centroid-residual codes with two
    per-half scales, and the centroid term of every score reuses the probe
    product.  The residual buffer (``residual_cap`` rows) is where live
    ingest would spill; ingest is not ported, so it stays empty but is
    still scanned and merged as in the reference.  ``backend`` is the kernel
    switch (None: by device).  Results are approximate.
    """

    def __init__(self, corpus, k: int, lat, n_clusters: int = 1024,
                 nprobe: int = 32, capacity_factor: float = 2.0,
                 compressed: bool = False, backend: str | None = None,
                 n_workers: int = 1, seed: int = 0, residual_cap: int = 1024,
                 build_chunk: int = 65536, kmeans_iters: int = 10,
                 centroids=None, device=None):
        self.device = resolve_device(device)
        self.corpus = as_f32(corpus, self.device)
        self.k = k
        self.lat = lat
        self.n_clusters = int(n_clusters)
        self.nprobe = max(1, int(nprobe))
        self.capacity_factor = float(capacity_factor)
        self.compressed = bool(compressed)
        self.backend = check_backend(backend)
        self.n_workers = max(1, int(n_workers))
        d = self.corpus.shape[1]
        self._res_vecs = torch.zeros((max(1, int(residual_cap)), d),
                                     device=self.device)
        self._res_ids = torch.full((self._res_vecs.shape[0],), -1,
                                   dtype=torch.int32, device=self.device)
        self._res_count = 0
        self.index = index_from_arrays(*_build_ivf_arrays(
            self.corpus, self.n_clusters, self.capacity_factor,
            kmeans_iters, seed, build_chunk, self.compressed,
            centroids=centroids, device=self.device), device=self.device)

    def search(self, q_embs):
        dispatch.record("ivf_backend_search")
        return ivf_ann_body(self.index, self._res_vecs, self._res_ids,
                            as_f32(q_embs, self.device), nprobe=self.nprobe,
                            k=self.k, backend=self.backend)

    def latency(self, batch: int) -> float:
        return self.lat.full_scan_time() * self.dense_scale()

    def dense_scale(self) -> float:
        """``LatencyModel.ann_scale`` of this index."""
        return self.lat.ann_scale(
            self.index.n_buckets, self.nprobe,
            capacity_factor=self.capacity_factor,
            bytes_per_dim=1 if self.compressed else 4,
            residual_rows=self._res_count)


class HybridBackend(_BackendBase):
    """Hybrid lexical+dense cloud stage with fused reranking.

    Composes a dense channel (``dense="flat" | "ann"``; the reference's
    ``"sharded"`` waits for ``retrieval/distributed.py``) with the
    hashed-term lexical channel: channel scans -> rank-domain RRF
    (``1/(rrf_k + rank)``, cross-channel duplicate mass combined onto the
    first occurrence) -> greedy near-duplicate diversification (cosine >=
    ``diversify_sim`` against an already-kept doc drops it; ``None``
    disables) -> dense rerank.  ``ann_kwargs`` go to the inner
    :class:`IVFBackend`.  Postings row == global doc id.

    Searches without term arrays run with an all-invalid term batch of
    width ``q_term_width``: the lexical channel contributes nothing.
    """

    uses_lexical = True

    def __init__(self, corpus, k: int, lat, doc_terms, doc_term_weights,
                 dense: str = "flat", dense_k: int | None = None,
                 lexical_k: int | None = None, rrf_k: float = 60.0,
                 diversify_sim: float | None = 0.98,
                 lexical_terms: int | None = None,
                 backend: str | None = None, chunk: int = 32768,
                 n_workers: int = 1, tile_n: int = 512, q_term_width: int = 2,
                 ann_kwargs: dict | None = None, device=None):
        if dense not in ("flat", "ann"):
            raise ValueError(f"unknown hybrid dense mode: {dense!r} "
                             f"(the port has 'flat' and 'ann')")
        if rrf_k < 1:
            raise ValueError("rrf_k must be >= 1")
        if diversify_sim is not None and not 0.0 < diversify_sim <= 1.0:
            raise ValueError("diversify_sim must be in (0, 1]")
        self.device = resolve_device(device)
        self.corpus = as_f32(corpus, self.device)
        terms = np.asarray(doc_terms, np.int32)
        tw = np.asarray(doc_term_weights, np.float32)
        if terms.shape != tw.shape or terms.shape[0] != self.corpus.shape[0]:
            raise ValueError("postings arrays must be [n_docs, L] and match "
                             "the corpus row count")
        if lexical_terms is not None:
            lw = max(1, int(lexical_terms))
            terms, tw = terms[:, :lw], tw[:, :lw]
        self.k = k
        self.lat = lat
        self.dense = dense
        self.dense_k = int(dense_k) if dense_k else k
        self.lexical_k = int(lexical_k) if lexical_k else k
        self.rrf_k = float(rrf_k)
        self.diversify_sim = (None if diversify_sim is None
                              else float(diversify_sim))
        self.backend = check_backend(backend)
        self.tile_n = int(tile_n)
        self.q_term_width = max(1, int(q_term_width))
        self.n_workers = max(1, int(n_workers))
        self.chunk = min(chunk, max(1, self.corpus.shape[0]))
        self.lexical_terms = terms.shape[1]
        self._terms = as_i32(terms, self.device)
        self._tw = as_f32(tw, self.device)
        self._ivf = None
        if dense == "ann":
            kw = dict(backend=self.backend, device=self.device)
            kw.update(ann_kwargs or {})
            self._ivf = IVFBackend(self.corpus, self.dense_k, lat, **kw)

    def search(self, q_embs, q_terms=None, q_term_weights=None):
        dispatch.record("hybrid_backend_search")
        q = as_f32(q_embs, self.device)
        b = q.shape[0]
        if q_terms is None:
            # term-less callers: inert terms, lexical channel matches nothing
            q_terms = torch.full((b, self.q_term_width), -1,
                                 dtype=torch.int32, device=self.device)
            q_term_weights = torch.zeros((b, self.q_term_width),
                                         device=self.device)
        else:
            q_terms = as_i32(q_terms, self.device)
            if q_term_weights is None:
                q_term_weights = (q_terms >= 0).to(torch.float32)
            q_term_weights = as_f32(q_term_weights, self.device)
        common = dict(k=self.k, kd=self.dense_k, kl=self.lexical_k,
                      rrf_k=self.rrf_k, diversify_sim=self.diversify_sim,
                      backend=self.backend, tile_n=self.tile_n)
        if self.dense == "flat":
            return hybrid_flat_search(self.corpus, self._terms, self._tw, q,
                                      q_terms, q_term_weights,
                                      chunk=self.chunk, **common)
        return hybrid_ann_search(self._ivf.index, self._ivf._res_vecs,
                                 self._ivf._res_ids, self.corpus, self._terms,
                                 self._tw, q, q_terms, q_term_weights,
                                 nprobe=self._ivf.nprobe, **common)

    def latency(self, batch: int) -> float:
        dense = 1.0 if self._ivf is None else self._ivf.dense_scale()
        return self.lat.full_scan_time() * self.lat.hybrid_scale(
            dense, self.lexical_terms, self.dense_k + self.lexical_k)


class RetrievalService:
    """Shared substrate: corpus + latency calibration + retrieval backend.

    The world supplies the corpus, the :class:`LatencyModel` the analytic
    scan times, and the backend the full-database search (``None`` ->
    :class:`LocalFlatBackend`).  ``device`` defaults to CUDA and raises
    without a card.

    Latency accounting (serving/latency.py): edge-local compute (cache
    channel, validation, cache updates) is charged at *measured* wall-clock;
    corpus-proportional compute (full scan, fuzzy IVF scan) is charged
    analytically at the paper's 49.2M-passage scale.
    """

    def __init__(self, world, latency, k: int = 10, chunk: int = 32768,
                 calibrate: bool = False,
                 backend: FullRetrievalBackend | None = None, device=None):
        self.world = world
        self.latency = latency
        self.latency.d = world.cfg.d
        self.latency.actual_corpus = world.cfg.n_docs
        self.k = k
        self.chunk = min(chunk, world.cfg.n_docs)
        self.device = resolve_device(device)
        bc = getattr(backend, "corpus", None) if backend is not None else None
        self.corpus = bc if bc is not None else as_f32(world.doc_emb,
                                                       self.device)
        self.backend = backend if backend is not None else LocalFlatBackend(
            self.corpus, k, latency, chunk=self.chunk)
        # warmup (+ optional bandwidth calibration from a measured scan)
        z = torch.zeros((1, world.cfg.d), device=self.device)
        self.backend.search(z)
        synchronize(self.device)
        if calibrate:
            # bandwidth is defined against the unsharded reference scan
            t0 = time.perf_counter()
            for _ in range(3):
                chunked_flat_search(self.corpus, z, k, self.chunk)
            synchronize(self.device)
            self.latency.calibrate((time.perf_counter() - t0) / 3,
                                   world.cfg.n_docs)

    def _term_kw(self, q_terms, q_term_weights) -> dict:
        """Forward query terms only to backends that score them."""
        if q_terms is None or not getattr(self.backend, "uses_lexical",
                                          False):
            return {}
        return dict(q_terms=as_i32(q_terms, self.device),
                    q_term_weights=(None if q_term_weights is None
                                    else as_f32(q_term_weights,
                                                self.device)))

    def full_search(self, q_emb, q_terms=None, q_term_weights=None):
        """Full-database search -> (ids [k] np.int32, vecs [k,d] on the
        device, modeled t_comp).  Ids of -1 (a corpus smaller than k, a
        slot the hybrid fusion dropped) gather row 0; ``cache_update`` never
        inserts them.  ``q_terms`` / ``q_term_weights`` [T] reach lexical
        backends only."""
        kw = self._term_kw(
            None if q_terms is None else np.asarray(q_terms)[None],
            None if q_term_weights is None
            else np.asarray(q_term_weights)[None])
        _, ids = self.backend.search(as_f32(q_emb, self.device)[None], **kw)
        ids = ids[0]
        vecs = self.corpus[ids.clamp_min(0).long()]
        return ids.cpu().numpy().astype(np.int32), vecs, \
            self.backend.latency(1)

    def full_search_batch(self, q_embs, q_terms=None,
                          q_term_weights=None) -> tuple[np.ndarray, float]:
        """Coalesced search for [B, d] (terms [B, T]) -> (ids [B,k],
        t_comp)."""
        kw = self._term_kw(q_terms, q_term_weights)
        _, ids = self.backend.search(as_f32(q_embs, self.device), **kw)
        return ids.cpu().numpy().astype(np.int32), \
            self.backend.latency(len(q_embs))
