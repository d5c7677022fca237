"""Full-retrieval backend layer + the shared RetrievalService.

Every rejected draft pays for a full-database retrieval, so the cloud stage
is pluggable: :class:`FullRetrievalBackend` is what the serving layers see.
The port has one implementation so far, :class:`LocalFlatBackend` (one
in-process exact scan, ``chunked_flat_search``).  The sharded, IVF, replica
and hybrid backends of the reference are not ported yet, nor the
``on_ingest`` hook that only the replica backend acts on.

Latency protocol: ``latency(batch)`` returns the *modeled* service time of
one coalesced dispatch; ``n_workers`` is how many such dispatches a virtual
clock may overlap.
"""
from __future__ import annotations

import time
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.retrieval.flat import chunked_flat_search
from repro_torch.utils import as_f32, resolve_device, synchronize


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


class LocalFlatBackend:
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

    def full_search(self, q_emb):
        """Exact full-database search -> (ids [k] np.int32, vecs [k,d] on
        the device, modeled t_comp).  Ids of -1 (a corpus smaller than k)
        gather row 0; ``cache_update`` never inserts them."""
        _, ids = self.backend.search(as_f32(q_emb, self.device)[None])
        ids = ids[0]
        vecs = self.corpus[ids.clamp_min(0).long()]
        return ids.cpu().numpy().astype(np.int32), vecs, \
            self.backend.latency(1)

    def full_search_batch(self, q_embs) -> tuple[np.ndarray, float]:
        """Coalesced exact search for [B, d] -> (ids [B,k], t_comp)."""
        _, ids = self.backend.search(as_f32(q_embs, self.device))
        return ids.cpu().numpy().astype(np.int32), \
            self.backend.latency(len(q_embs))
