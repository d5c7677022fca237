"""Batched HaS serving: accept-mask compaction (throughput mode).

Algorithm 1 is sequential (each query can hit the cache updated by the
previous one).  At production load the engine instead processes micro-batches
against a cache snapshot:

  1. ``speculate_batch`` scores the whole micro-batch (the ``topk_search``,
     ``ivf_scan`` and ``homology_score`` kernels on the card);
  2. rejected queries are compacted into one batched full-database search;
  3. ``cache_update_chunked`` folds every rejected result into the cache
     (padded to the micro-batch shape, each row into its tenant), then the
     next micro-batch runs.

Semantics vs. the sequential engine: intra-batch queries cannot re-identify
each other (the cache is a snapshot), so DAR is a lower bound that converges
to the sequential engine's as batch_size/stream_length -> 0.

The engine rides the shared :class:`~repro_torch.serving.engine.ServeLoop`
substrate: it only implements ``_step_batch``; metrics recording and rng
threading live in the base class.  A step records the spans
``engine.step`` (the whole step, a new micro-batch id), ``spec``
(speculation to ``torch.cuda.synchronize``; its length is the measured
speculation time), ``spec.readback`` (the accept bits and drafts copied to
the host), ``ingest`` and ``engine.respond`` (the results) in
``core/dispatch.py``; the service adds ``cloud`` and its parts.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import dispatch
from repro_torch.core.has import (HasConfig, cache_update_chunked,
                                  init_has_state, init_tenant_states,
                                  speculate_batch)
from repro_torch.retrieval.ivf import IVFIndex, build_ivf
from repro_torch.serving.engine import (RetrievalService, ServeLoop,
                                        fuzzy_scope)
from repro_torch.utils import synchronize


class BatchedHasEngine(ServeLoop):
    """``n_tenants > 1`` partitions the snapshot cache: each micro-batch row
    speculates against and ingests into its own tenant's slice (queries
    carry a ``"tenant"`` key).  ``index`` (keyword only) is a prebuilt
    fuzzy-channel index; without it the engine builds its own."""

    def __init__(self, service: RetrievalService, cfg: HasConfig | None = None,
                 batch_size: int = 32, seed: int = 0,
                 backend: str | None = None, n_tenants: int = 1, *,
                 index: IVFIndex | None = None):
        super().__init__(service)
        self.cfg = cfg or HasConfig(k=service.k, d=service.world.cfg.d)
        self.device = service.device
        self.n_tenants = max(1, int(n_tenants))
        self.state = (
            init_has_state(self.cfg, device=self.device)
            if self.n_tenants == 1 else
            init_tenant_states(self.cfg, self.n_tenants, device=self.device))
        if index is None:
            index = build_ivf(service.corpus, self.cfg.n_buckets, seed=seed,
                              device=self.device)
        self.index = index
        self.batch_size = batch_size
        self.backend = backend
        self.fuzzy_scope = fuzzy_scope(self.cfg, self.index)
        # warm up speculation and the full search at the loop's shapes
        z = np.zeros((batch_size, self.s.world.cfg.d), np.float32)
        warm_tids = (None if self.n_tenants == 1
                     else np.zeros((batch_size,), np.int32))
        speculate_batch(self.cfg, self.state, self.index, z, backend=backend,
                        tenant_ids=warm_tids)
        service.full_search_batch(z)
        synchronize(self.device)

    def _step_batch(self, group, rng, dataset):
        with dispatch.span("engine.step", step=True):
            lat_model = self.s.latency
            bs = self.batch_size
            embs = np.stack([q["emb"] for q in group]).astype(np.float32)
            if len(group) < bs:                       # pad the tail batch
                pad = np.zeros((bs - len(group), embs.shape[1]), np.float32)
                embs = np.concatenate([embs, pad])
            tids = None
            if self.n_tenants > 1:
                tags = [int(q.get("tenant", 0)) for q in group]
                if any(not 0 <= t < self.n_tenants for t in tags):
                    raise ValueError(
                        f"tenant tags {sorted(set(tags))} out of range for "
                        f"n_tenants={self.n_tenants}")
                tids = np.zeros(bs, np.int32)         # pad rows: tenant 0
                tids[:len(group)] = tags
            synchronize(self.device)
            with dispatch.span("spec") as spec:
                out = speculate_batch(self.cfg, self.state, self.index, embs,
                                      backend=self.backend, tenant_ids=tids)
                synchronize(self.device)
            t_spec = spec.seconds / max(len(group), 1)
            # host copies before the ingest below mutates the state in place
            with dispatch.span("spec.readback"):
                accepts = out["accept"][:len(group)].cpu().numpy()
                drafts = out["draft_ids"][:len(group)].cpu().numpy()
                dispatch.count_syncs(self.device, 2)

            # compact the rejected sub-batch -> one batched full search
            rej = np.flatnonzero(~accepts)
            ids_full, t_full = None, 0.0
            if len(rej):
                ids_full, t_full = self.s.full_search_batch(embs[rej])
                rej_tids = None if tids is None else tids[rej]
                with dispatch.span("ingest"):
                    self.state = cache_update_chunked(
                        self.cfg, self.state, embs[rej], ids_full,
                        corpus=self.s.corpus, chunk=bs, tenant_ids=rej_tids,
                        backend=self.backend)
                    # replica-style backends mirror the ingest onto standby
                    # logs
                    self.s.backend.on_ingest(embs[rej], ids_full, self.state,
                                             tenant_ids=rej_tids)

            with dispatch.span("engine.respond"):
                fuzzy_t = lat_model.scan_time(
                    lat_model.target_corpus * self.fuzzy_scope * 2.0)
                results = []
                for i in range(len(group)):
                    lat = lat_model.sample_edge() + t_spec + fuzzy_t
                    if accepts[i]:
                        ids = drafts[i]
                    else:
                        j = int(np.flatnonzero(rej == i)[0])
                        ids = ids_full[j]
                        lat += lat_model.sample_cloud() + t_full
                    results.append((ids, bool(accepts[i]), lat))
            return results
