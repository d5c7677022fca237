"""Full-retrieval backend layer + the shared RetrievalService.

Every rejected draft pays for a full-database retrieval, so the cloud stage
is pluggable: :class:`FullRetrievalBackend` is what the serving layers see.

``LocalFlatBackend``
    One in-process exact scan (``chunked_flat_search``).
``ShardedMeshBackend``
    The corpus split into ``n_shards`` row blocks, each scanned and the
    candidate sets merged (``retrieval/distributed.py``); ``n_workers``
    concurrent dispatch slots and ``LatencyModel.shard_scale``.  A
    ``DeviceMesh`` of more than one rank (``mesh=``) spreads the blocks over
    its ranks (``distributed_flat_search``).  Ids equal
    ``LocalFlatBackend``'s.
``IVFBackend``
    ANN cloud stage: an IVF index built chunk by chunk
    (``retrieval/ivf.py``), optionally with int8 centroid-residual codes
    (``compressed=True``), searched by ``retrieval/fusion.py::
    ivf_ann_body`` (the ``ivf_scan`` kernel on the card), with live ingest.
    Approximate.
``HybridBackend``
    Dense channel (``"flat"``, ``"sharded"`` or ``"ann"``) + hashed-term
    lexical channel + RRF fusion, near-duplicate diversification and dense
    rerank (``retrieval/fusion.py``), with live ingest into both channels.
    Term-less searches run with inert terms and degrade to diversified
    dense retrieval.
``ReplicaBackend``
    An inner backend behind warm standbys: every cache ingest is recorded
    in each standby's delta log, so any of them can fail over with the
    primary's cache.

Each ``search`` records one ``core/dispatch.py`` probe, as in the
reference.  Every backend has the reference's ``on_ingest`` hook, which
the engines call after each cache ingest (a no-op but on
``ReplicaBackend``).

Live ingest keeps host numpy mirrors of the index canonical, as the
reference does: ``ingest_docs`` rewrites them in place and the next
``search`` uploads copies (``_dirty``).  The device tensors never alias
the mirrors.

Latency protocol: ``latency(batch)`` returns the *modeled* service time of
one coalesced dispatch; ``n_workers`` is how many such dispatches a virtual
clock may overlap.
"""
from __future__ import annotations

import time
from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.kernels.ops import check_backend
from repro_torch.retrieval.distributed import (distributed_flat_search,
                                              sharded_topk_reference)
from repro_torch.retrieval.flat import chunked_flat_search
from repro_torch.retrieval.fusion import (hybrid_ann_search,
                                          hybrid_flat_search,
                                          hybrid_sharded_search, ivf_ann_body)
from repro_torch.retrieval.ivf import (_assign, _build_ivf_arrays,
                                       _quant_residual_halves,
                                       index_from_arrays)
from repro_torch.serving.replication import gather_doc_vecs
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


class ShardedMeshBackend(_BackendBase):
    """Row-sharded exact scan with a concurrent-dispatch worker pool.

    ``mesh`` (a 1-D ``torch.distributed.device_mesh.DeviceMesh`` of more
    than one rank) sets ``n_shards`` to its size: each rank searches only
    its own row block of the corpus it is given, through
    ``distributed_flat_search`` over the mesh's group, and every rank gets
    the same result.  Without a mesh, or on a mesh of one rank, the same
    candidate-merge math runs on one device through
    ``sharded_topk_reference``, so the virtual clock can model an
    ``n_shards``-way deployment (``n_workers`` dispatch slots and
    ``LatencyModel.shard_scale``).  Either path returns the ids of
    ``LocalFlatBackend``.  ``corpus`` stays the whole tensor given, which
    the engines read rows of by id.
    """

    def __init__(self, corpus: torch.Tensor, k: int, lat, n_shards: int = 4,
                 n_workers: int = 1, mesh=None):
        self.corpus = corpus
        self.k = k
        self.lat = lat
        self.mesh = mesh
        self._dist = None
        if mesh is not None and mesh.size() > 1:
            # the mesh decides the physical shard count
            if mesh.ndim != 1:
                raise ValueError(f"ShardedMeshBackend: a 1-D mesh, got "
                                 f"{mesh.ndim} dimensions")
            self.n_shards = mesh.size()
            if corpus.shape[0] % self.n_shards:
                raise ValueError(
                    f"corpus rows {corpus.shape[0]} must divide evenly over "
                    f"{self.n_shards} mesh shards")
            rows = corpus.shape[0] // self.n_shards
            lo = mesh.get_local_rank() * rows
            self._shard = corpus[lo:lo + rows]
            self._dist = distributed_flat_search(mesh.get_group())
        else:
            self.n_shards = max(1, int(n_shards))
        self.n_workers = max(1, int(n_workers))

    def search(self, q_embs):
        if self._dist is not None:
            return self._dist(self._shard, q_embs, self.k)
        return sharded_topk_reference(self.corpus, q_embs, self.k,
                                      n_shards=self.n_shards)

    def latency(self, batch: int) -> float:
        # every shard streams N/n_shards rows concurrently + merge overhead
        return self.lat.full_scan_time() * self.lat.shard_scale(self.n_shards)


class IVFBackend(_BackendBase):
    """ANN cloud stage: IVF index + bucket scan + exact residual buffer,
    with live ingest.

    The index is built by streaming the corpus through k-means assignment
    in ``build_chunk``-row slices; ``compressed=True`` stores int8
    centroid-residual codes with two per-half scales, and the centroid
    term of every score reuses the probe product.  ``centroids=`` skips
    k-means, at the first build and at every rebuild.  ``backend`` is the
    kernel switch (None: by device).  Results are approximate.

    Live ingest (``ingest_docs``) assigns each new doc to its nearest
    centroid; a full bucket spills into the exact-scanned residual buffer
    (``residual_cap`` rows), and a doc that finds the residual full
    triggers a rebuild over the grown host corpus (``_rebucket``), which
    places it and every doc after it.  The host numpy arrays are
    canonical; the next ``search`` uploads copies of them.
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
        self.seed = int(seed)
        self.residual_cap = max(1, int(residual_cap))
        self.build_chunk = int(build_chunk)
        self.kmeans_iters = int(kmeans_iters)
        if isinstance(centroids, torch.Tensor):
            centroids = centroids.cpu()
        self.centroids = (None if centroids is None
                          else np.array(centroids, np.float32))
        self._corpus_np = self.corpus.cpu().numpy().copy()
        self._ids_np = np.arange(self._corpus_np.shape[0], dtype=np.int32)
        self._next_id = int(self._corpus_np.shape[0])
        self._ingest_seen: dict = {}
        self.rebuilds = 0
        self._res_vecs_np = np.zeros(
            (self.residual_cap, self._corpus_np.shape[1]), np.float32)
        self._res_ids_np = np.full(self.residual_cap, -1, np.int32)
        self._res_count = 0
        self._build()

    # -- index build / upload -------------------------------------------
    def _build(self) -> None:
        (self._cents_np, self._bvecs_np, self._bscales_np, self._bids_np,
         self._counts_np) = _build_ivf_arrays(
            self._corpus_np, self.n_clusters, self.capacity_factor,
            self.kmeans_iters, self.seed, self.build_chunk, self.compressed,
            ids=self._ids_np, centroids=self.centroids, device=self.device)
        self._dirty = True
        self._upload()

    def _upload(self) -> None:
        """Device copies of the host arrays (never views of them)."""
        self.index = index_from_arrays(
            self._cents_np, self._bvecs_np, self._bscales_np, self._bids_np,
            self._counts_np, device=self.device)
        self._res_vecs = torch.tensor(self._res_vecs_np, device=self.device)
        self._res_ids = torch.tensor(self._res_ids_np, device=self.device)
        self._dirty = False

    # -- FullRetrievalBackend protocol ----------------------------------
    def search(self, q_embs):
        dispatch.record("ivf_backend_search")
        if self._dirty:
            self._upload()
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

    # -- live-ingest reconciliation -------------------------------------
    @property
    def residual_count(self) -> int:
        return self._res_count

    def _rebucket(self) -> None:
        """Flush: rebuild the whole index (incl. residual docs, which are
        already rows of the host corpus) and empty the residual buffer."""
        self._build()
        self._res_vecs_np[:] = 0.0
        self._res_ids_np[:] = -1
        self._res_count = 0
        self.rebuilds += 1
        self._dirty = True

    def ingest_docs(self, vecs, ids=None, *, ingest_key=None) -> np.ndarray:
        """Reconcile live-ingested docs: nearest-centroid assignment with
        bounded bucket spill into the residual buffer; residual overflow
        triggers a rebuild.  Idempotent on ``ingest_key``.  Returns the
        global ids assigned to the new docs."""
        if ingest_key is not None and ingest_key in self._ingest_seen:
            return self._ingest_seen[ingest_key]
        vecs = np.asarray(vecs, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        n_new = vecs.shape[0]
        if ids is None:
            ids = self._next_id + np.arange(n_new, dtype=np.int32)
        ids = np.asarray(ids, np.int32)
        self._next_id = max(self._next_id, int(ids.max(initial=-1)) + 1)
        # the host corpus grows first: a rebuild reads it, so every doc
        # (placed or not) survives the flush
        self._corpus_np = np.concatenate([self._corpus_np, vecs])
        self._ids_np = np.concatenate([self._ids_np, ids])
        v = torch.as_tensor(vecs, device=self.device)
        cents = torch.as_tensor(self._cents_np, device=self.device)
        assign_t = _assign(v, cents)
        assign = assign_t.cpu().numpy()
        if self.compressed:
            q_all, s_all = _quant_residual_halves(v, cents[assign_t])
            q_all = q_all.cpu().numpy()
            s_all = s_all.cpu().numpy()
        cap = self._bids_np.shape[1]
        for i in range(n_new):
            b = int(assign[i])
            c = int(self._counts_np[b])
            if c < cap:
                self._bids_np[b, c] = ids[i]
                if self.compressed:
                    self._bvecs_np[b, c] = q_all[i]
                    self._bscales_np[b, c] = s_all[i]
                else:
                    self._bvecs_np[b, c] = vecs[i]
                self._counts_np[b] = c + 1
            elif self._res_count < self.residual_cap:
                self._res_vecs_np[self._res_count] = vecs[i]
                self._res_ids_np[self._res_count] = ids[i]
                self._res_count += 1
            else:
                # overflow: the rebuild already covers every remaining doc
                self._rebucket()
                break
        self._dirty = True
        if ingest_key is not None:
            self._ingest_seen[ingest_key] = ids
        return ids


class HybridBackend(_BackendBase):
    """Hybrid lexical+dense cloud stage with fused reranking.

    Composes a dense channel (``dense="flat" | "sharded" | "ann"``) with
    the hashed-term lexical channel: channel scans -> rank-domain RRF
    (``1/(rrf_k + rank)``, cross-channel duplicate mass combined onto the
    first occurrence) -> greedy near-duplicate diversification (cosine >=
    ``diversify_sim`` against an already-kept doc drops it; ``None``
    disables) -> dense rerank.  ``ann_kwargs`` go to the inner
    :class:`IVFBackend`; ``n_shards`` splits the ``"sharded"`` scan.

    Searches without term arrays run with an all-invalid term batch of
    width ``q_term_width``: the lexical channel contributes nothing.

    Id contract: postings row == global doc id, so ``ingest_docs`` rejects
    non-sequential ids; both channels grow in lockstep (dense vectors via
    the inner ``IVFBackend`` in ANN mode, a corpus append otherwise;
    postings rows always appended here, ``-1`` rows for a doc without
    terms).
    """

    uses_lexical = True

    def __init__(self, corpus, k: int, lat, doc_terms, doc_term_weights,
                 dense: str = "flat", dense_k: int | None = None,
                 lexical_k: int | None = None, rrf_k: float = 60.0,
                 diversify_sim: float | None = 0.98,
                 lexical_terms: int | None = None,
                 backend: str | None = None, chunk: int = 32768,
                 n_shards: int = 4, n_workers: int = 1, tile_n: int = 512,
                 q_term_width: int = 2, ann_kwargs: dict | None = None,
                 device=None):
        if dense not in ("flat", "sharded", "ann"):
            raise ValueError(f"unknown hybrid dense mode: {dense!r}")
        if rrf_k < 1:
            raise ValueError("rrf_k must be >= 1")
        if diversify_sim is not None and not 0.0 < diversify_sim <= 1.0:
            raise ValueError("diversify_sim must be in (0, 1]")
        self.device = resolve_device(device)
        corpus = as_f32(corpus, self.device)
        terms = np.asarray(doc_terms, np.int32)
        tw = np.asarray(doc_term_weights, np.float32)
        if terms.shape != tw.shape or terms.shape[0] != corpus.shape[0]:
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
        self.n_shards = max(1, int(n_shards))
        self.chunk = min(chunk, max(1, corpus.shape[0]))
        self.lexical_terms = terms.shape[1]
        self._terms_np = np.ascontiguousarray(terms)
        self._tw_np = np.ascontiguousarray(tw)
        self.corpus = corpus
        self._terms = torch.tensor(self._terms_np, device=self.device)
        self._tw = torch.tensor(self._tw_np, device=self.device)
        self._ivf = None
        if dense == "ann":
            kw = dict(backend=self.backend, device=self.device)
            kw.update(ann_kwargs or {})
            self._ivf = IVFBackend(self.corpus, self.dense_k, lat, **kw)
            self._corpus_np = self._ivf._corpus_np
        else:
            self._corpus_np = corpus.cpu().numpy().copy()
        self._ingest_seen: dict = {}
        self._dirty = False

    def _upload(self) -> None:
        """Device copies of the grown host arrays."""
        if self._ivf is not None and self._ivf._dirty:
            self._ivf._upload()
        self.corpus = torch.tensor(self._corpus_np, device=self.device)
        self._terms = torch.tensor(self._terms_np, device=self.device)
        self._tw = torch.tensor(self._tw_np, device=self.device)
        self._dirty = False

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
        if self._dirty or (self._ivf is not None and self._ivf._dirty):
            self._upload()
        common = dict(k=self.k, kd=self.dense_k, kl=self.lexical_k,
                      rrf_k=self.rrf_k, diversify_sim=self.diversify_sim,
                      backend=self.backend, tile_n=self.tile_n)
        if self.dense == "flat":
            return hybrid_flat_search(self.corpus, self._terms, self._tw, q,
                                      q_terms, q_term_weights,
                                      chunk=self.chunk, **common)
        if self.dense == "sharded":
            return hybrid_sharded_search(self.corpus, self._terms, self._tw,
                                         q, q_terms, q_term_weights,
                                         n_shards=self.n_shards,
                                         chunk=self.chunk, **common)
        return hybrid_ann_search(self._ivf.index, self._ivf._res_vecs,
                                 self._ivf._res_ids, self.corpus, self._terms,
                                 self._tw, q, q_terms, q_term_weights,
                                 nprobe=self._ivf.nprobe, **common)

    def _dense_scale(self) -> float:
        if self.dense == "flat":
            return 1.0
        if self.dense == "sharded":
            return self.lat.shard_scale(self.n_shards)
        return self._ivf.dense_scale()

    def latency(self, batch: int) -> float:
        return self.lat.full_scan_time() * self.lat.hybrid_scale(
            self._dense_scale(), self.lexical_terms,
            self.dense_k + self.lexical_k)

    # -- live-corpus ingest (both channels in lockstep) ------------------
    def ingest_docs(self, vecs, ids=None, *, terms=None, term_weights=None,
                    ingest_key=None) -> np.ndarray:
        if ingest_key is not None and ingest_key in self._ingest_seen:
            return self._ingest_seen[ingest_key]
        vecs = np.asarray(vecs, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        n_new = vecs.shape[0]
        start = self._corpus_np.shape[0]
        want = (start + np.arange(n_new)).astype(np.int32)
        if ids is not None and not np.array_equal(
                np.asarray(ids, np.int32), want):
            raise ValueError(
                "HybridBackend requires sequential doc ids (postings row == "
                f"global id): expected {start}..{start + n_new - 1}")
        t_rows = np.full((n_new, self.lexical_terms), -1, np.int32)
        w_rows = np.zeros((n_new, self.lexical_terms), np.float32)
        if terms is not None:
            terms = np.asarray(terms, np.int32)
            if terms.ndim == 1:
                terms = terms[None]
            if term_weights is None:
                tw = np.where(terms >= 0, 1.0, 0.0).astype(np.float32)
            else:
                tw = np.asarray(term_weights, np.float32)
                if tw.ndim == 1:
                    tw = tw[None]
            m = min(self.lexical_terms, terms.shape[1])
            t_rows[:, :m] = terms[:, :m]
            w_rows[:, :m] = np.where(terms[:, :m] >= 0, tw[:, :m], 0.0)
        if self._ivf is not None:
            got = np.asarray(
                self._ivf.ingest_docs(vecs, want, ingest_key=ingest_key),
                np.int32)
            self._corpus_np = self._ivf._corpus_np
        else:
            got = want
            self._corpus_np = np.concatenate([self._corpus_np, vecs])
        self._terms_np = np.concatenate([self._terms_np, t_rows])
        self._tw_np = np.concatenate([self._tw_np, w_rows])
        self._dirty = True
        if ingest_key is not None:
            self._ingest_seen[ingest_key] = got
        return got


class ReplicaBackend(_BackendBase):
    """Warm-standby replica routing + cache-ingest reconciliation.

    Wraps an inner backend for the scan and models one concurrent dispatch
    slot per standby.  ``on_ingest`` mirrors every row the serving loop
    folds into the authoritative cache onto each member's delta log via
    the ``record_batch`` sink protocol (``serving/replication.py``):
    members are cloud ``WarmStandby`` replicas and/or an edge
    ``EdgeReplicaPool``.  A standby failover then resumes with exactly the
    cache the primary had.

    Padded (``-1``) doc ids, which the sharded scans emit when the corpus
    holds fewer than k rows, gather zero vectors into the delta logs
    (``gather_doc_vecs``).
    """

    def __init__(self, inner: FullRetrievalBackend, standbys: Sequence,
                 corpus):
        self.inner = inner
        self.standbys = list(standbys)
        self.corpus = corpus
        self._corpus_np = np.array(torch.as_tensor(corpus).cpu(),
                                   np.float32)  # one host copy, reused
        self.n_workers = max(1, len(self.standbys))

    def search(self, q_embs, **kw):
        # kwargs pass through (a HybridBackend inner's q_terms, ...)
        return self.inner.search(q_embs, **kw)

    @property
    def uses_lexical(self) -> bool:
        return bool(getattr(self.inner, "uses_lexical", False))

    @property
    def q_term_width(self) -> int:
        return int(getattr(self.inner, "q_term_width", 0))

    def latency(self, batch: int) -> float:
        return self.inner.latency(batch)

    def on_ingest(self, q_embs, full_ids, state, tenant_ids=None, *,
                  ingest_key=None) -> None:
        q_embs = np.asarray(q_embs, np.float32)
        full_ids = np.asarray(full_ids, np.int32)
        vecs = gather_doc_vecs(self._corpus_np, full_ids)  # [N, k, d]
        for sb in self.standbys:
            sb.record_batch(q_embs, full_ids, vecs, state,
                            tenant_ids=tenant_ids, ingest_key=ingest_key)

    def ingest_docs(self, vecs, ids=None, *, ingest_key=None, **kw):
        """Live-corpus ingest passthrough (an ``IVFBackend`` or
        ``HybridBackend`` inner): the inner index reconciles, and this
        wrapper takes its grown host corpus so later ``on_ingest`` gathers
        see the new rows.  Extra kwargs (the hybrid backend's ``terms`` /
        ``term_weights``) pass through."""
        inner_ingest = getattr(self.inner, "ingest_docs", None)
        if inner_ingest is None:
            raise AttributeError(
                f"{type(self.inner).__name__} has no ingest_docs")
        out = inner_ingest(vecs, ids, ingest_key=ingest_key, **kw)
        inner_np = getattr(self.inner, "_corpus_np", None)
        if inner_np is not None:
            self._corpus_np = inner_np
        return out


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
