"""RAG serving engines: Full / HaS / reuse-based / CRAG / ANNS (paper §IV).

All engines run on one serve-loop substrate (:class:`ServeLoop`): the loop
owns metrics recording, record-rng threading and micro-batch iteration, and
an engine implements ``_step`` (one query -> ids/accept/latency) or
``_step_batch`` (one micro-batch -> a list of those).  Full retrieval goes
through the :class:`RetrievalService` backend, with the query's hashed
terms (``q["terms"]``, ``q["term_weights"]``), which only a lexical backend
(``HybridBackend``) scores.  ``batch_size == 1`` is Algorithm 1's
sequential semantics (the cache changes between queries);
serving/batched.py sets ``batch_size > 1`` for snapshot micro-batching.

Recorded metrics (paper §IV):

  AvgL   average end-to-end retrieval latency
  DAR    draft acceptance rate
  CAR    correct acceptance rate (accepted drafts containing a golden doc)
  DocHit golden document present in the returned set
  RA     simulated response accuracy per downstream LLM
  L@DA / L@DR   latency conditioned on acceptance / rejection

Measured edge compute is timed on the host clock after
``torch.cuda.synchronize``, so a time covers the device work and not only
its launch.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

import torch

from repro_torch.core.baselines import (CRAGEvaluator, init_reuse_state,
                                        mincache_match, minhash_signature,
                                        proximity_match, reuse_insert,
                                        saferadius_match)
from repro_torch.core.has import (HasConfig, HasState, cache_update,
                                  init_has_state, init_tenant_states,
                                  speculate_batch)
from repro_torch.data.synthetic import simulate_response_accuracy
from repro_torch.kernels.ops import check_backend, ivf_scan_op
from repro_torch.retrieval.flat import quantize_store
from repro_torch.retrieval.ivf import (IVFIndex, build_ivf, probe_buckets,
                                       subset_index)
from repro_torch.retrieval.service import RetrievalService
from repro_torch.utils import as_f32, synchronize


@dataclasses.dataclass
class ServeResult:
    latencies: np.ndarray
    accepts: np.ndarray
    doc_hits: np.ndarray
    correct_accepts: np.ndarray
    ra: dict[str, np.ndarray]

    def summary(self) -> dict[str, float]:
        # NaN-safe on an empty stream
        def _mean(a) -> float:
            a = np.asarray(a)
            return float(a.mean()) if a.size else float("nan")

        acc = self.accepts.astype(bool)
        out = {
            "avg_latency_s": _mean(self.latencies),
            "dar": _mean(acc),
            "doc_hit_rate": _mean(self.doc_hits),
            "l_at_da": _mean(self.latencies[acc]) if acc.any() else 0.0,
            "l_at_dr": _mean(self.latencies[~acc]) if (~acc).any() else 0.0,
            "car": _mean(self.correct_accepts[acc]) if acc.any() else 0.0,
            "ra_at_da": _mean(self.ra["qwen3-8b"][acc]) if acc.any() else 0.0,
        }
        for llm, arr in self.ra.items():
            out[f"ra_{llm}"] = _mean(arr)
        return out


def _metrics_init(n, llms):
    return dict(latencies=np.zeros(n), accepts=np.zeros(n, bool),
                doc_hits=np.zeros(n, bool), correct=np.zeros(n, bool),
                ra={m: np.zeros(n, bool) for m in llms})


def _finish(m) -> ServeResult:
    return ServeResult(latencies=m["latencies"], accepts=m["accepts"],
                       doc_hits=m["doc_hits"], correct_accepts=m["correct"],
                       ra=m["ra"])


LLMS = ("qwen3-8b", "llama3-8b", "mixtral-7b")


def fuzzy_scope(cfg, index) -> float:
    """Fraction of the fuzzy IVF index streamed per probed query."""
    return min(cfg.nprobe, index.n_buckets) / index.n_buckets


def _record(m, i, world, query, ids, lat, accept, dataset, llms, rng):
    golden = world.golden_mask(query["entity"], query["attr"], ids)
    hit = bool(golden.any())
    m["latencies"][i] = lat
    m["accepts"][i] = accept
    m["doc_hits"][i] = hit
    m["correct"][i] = hit and accept
    for llm in llms:
        m["ra"][llm][i] = simulate_response_accuracy(
            rng, hit, dataset, llm, n_docs=int(np.sum(np.asarray(ids) >= 0)))


class ServeLoop:
    """One serve loop for every engine.

    Engines implement ``_step(q, rng, dataset) -> (ids, accept, latency_s)``
    (sequential Algorithm 1 semantics) or ``_step_batch`` for a group.
    Latency = sampled RTTs (the latency model's own rng stream) + measured
    edge compute + analytic bandwidth-bound scan times.
    """

    batch_size: int = 1

    def __init__(self, service: RetrievalService):
        self.s = service

    def _step(self, q, rng, dataset):
        raise NotImplementedError

    def _step_batch(self, group, rng, dataset):
        return [self._step(q, rng, dataset) for q in group]

    def serve(self, queries, dataset="granola", llms=LLMS,
              seed=0) -> ServeResult:
        rng = np.random.default_rng(seed)
        m = _metrics_init(len(queries), llms)
        bs = max(int(self.batch_size), 1)
        for start in range(0, len(queries), bs):
            group = queries[start:start + bs]
            for j, (ids, accept, lat) in enumerate(
                    self._step_batch(group, rng, dataset)):
                _record(m, start + j, self.s.world, group[j], ids, lat,
                        bool(accept), dataset, llms, rng)
        return _finish(m)


class FullRetrievalEngine(ServeLoop):
    """Baseline: always full-database retrieval on the cloud."""

    def _step(self, q, rng, dataset):
        ids, _, t = self.s.full_search(q["emb"], q.get("terms"),
                                       q.get("term_weights"))
        return ids, False, self.s.latency.sample_cloud() + t


class ANNSEngine(ServeLoop):
    """IVF / ScaNN-substitute at a configurable scope (Table II ♠/♦).

    'scann' = IVF partitioning + int8 rounding baked into the bucket store
    (the reference's stand-in for ScaNN's anisotropic quantization): the
    buckets keep int8-degraded values (the accuracy cost) and are charged
    1 byte/dim on the latency model (the bandwidth win).  The bucket scan
    is the f32 ``ivf_scan`` kernel on the card (``backend``, None: by
    device).  ``index`` (keyword only) is a prebuilt index; without it the
    engine builds its own from the service's corpus.
    """

    def __init__(self, service: RetrievalService, method: str = "ivf",
                 n_buckets: int = 4096, nprobe: int = 64,
                 on_edge: bool = True, seed: int = 0, *,
                 index: IVFIndex | None = None, backend: str | None = None):
        super().__init__(service)
        self.on_edge = on_edge
        self.method = method
        self.backend = check_backend(backend)
        if index is None:
            index = build_ivf(service.corpus, n_buckets, seed=seed,
                              device=service.device)
        self.index = index
        self.nprobe = min(nprobe, self.index.n_buckets)
        self.scope = self.nprobe / self.index.n_buckets
        if method == "scann":
            # bake int8 rounding into the bucket store (score degradation):
            # the reference's per-vector rounding, run op by op, is
            # quantize_store's (a division by 127)
            bv = self.index.bucket_vecs
            st = quantize_store(bv.reshape(-1, bv.shape[-1]))
            self.index = IVFIndex(
                centroids=self.index.centroids,
                bucket_vecs=(st["q"].to(torch.float32)
                             * st["scale"][:, None]).reshape(bv.shape),
                bucket_ids=self.index.bucket_ids,
                bucket_counts=self.index.bucket_counts)
        self.search(np.zeros((service.world.cfg.d,), np.float32))  # warmup
        synchronize(service.device)

    def search(self, q_emb):
        """-> (ids [k] np.int32, modelled scan time)."""
        q = as_f32(q_emb, self.s.device)[None]
        lat = self.s.latency
        probe = probe_buckets(self.index, q, self.nprobe)
        _, ids = ivf_scan_op(q, probe, self.index.bucket_vecs,
                             self.index.bucket_ids, self.s.k,
                             backend=self.backend)
        # cost ~ probed fraction of the corpus (x2 bucket padding) at
        # 4 B/dim (ivf) or 1 B/dim (scann int8), + the centroid product
        bpd = 1 if self.method == "scann" else 4
        t = lat.scan_time(lat.target_corpus * self.scope * 2.0,
                          bytes_per_dim=bpd) + lat.scan_time(
                              self.index.n_buckets)
        return ids[0].cpu().numpy(), t

    def _step(self, q, rng, dataset):
        ids, t = self.search(q["emb"])
        rtt = (self.s.latency.sample_edge() if self.on_edge
               else self.s.latency.sample_cloud())
        return ids, False, rtt + t


class HasEngine(ServeLoop):
    """The paper's system (Algorithm 1) with optional ANNS fallback (♦).

    The parameters follow the reference's, in its order.  ``fallback`` (an
    :class:`ANNSEngine`) answers rejects in place of the full search.
    ``n_tenants > 1`` partitions the cache (``init_tenant_states``): each
    query routes through its tenant's slice (``step(..., tenant=t)``, or a
    ``"tenant"`` key on the query dict) and rejects ingest only into that
    partition; a tag out of range raises.  ``index`` (keyword only) is a
    prebuilt fuzzy-channel index, so several engines can share one build;
    without it the engine builds its own from the service's corpus.
    ``backend`` is the kernel switch of
    :func:`~repro_torch.core.has.speculate_batch` and of the ingest's
    :func:`~repro_torch.core.has.cache_update` (None: by device).
    """

    def __init__(self, service: RetrievalService, cfg: HasConfig | None = None,
                 fallback: ANNSEngine | None = None,
                 fuzzy_fraction: float = 1.0, seed: int = 0,
                 backend: str | None = None, n_tenants: int = 1, *,
                 index: IVFIndex | None = None):
        super().__init__(service)
        self.cfg = cfg or HasConfig(k=service.k, d=service.world.cfg.d)
        self.device = service.device
        self.n_tenants = max(1, int(n_tenants))
        self.state: HasState = (
            init_has_state(self.cfg, device=self.device)
            if self.n_tenants == 1 else
            init_tenant_states(self.cfg, self.n_tenants, device=self.device))
        if index is None:
            index = build_ivf(service.corpus, self.cfg.n_buckets, seed=seed,
                              device=self.device)
        self.index = subset_index(index, fuzzy_fraction)
        self.fallback = fallback
        self.backend = backend
        self.fuzzy_scope = (self.cfg.nprobe / self.cfg.n_buckets) \
            * fuzzy_fraction
        # warm up speculation at the sequential shape B=1
        z = np.zeros((1, self.s.world.cfg.d), np.float32)
        speculate_batch(self.cfg, self.state, self.index, z, backend=backend,
                        tenant_ids=self._tids(0))
        synchronize(self.device)

    def _tids(self, tenant: int):
        """tenant_ids for a B=1 speculation (None on the single-tenant
        path); a tag out of range raises, as in the reference."""
        if not 0 <= tenant < self.n_tenants:
            raise ValueError(
                f"tenant {tenant} out of range for n_tenants="
                f"{self.n_tenants}")
        return None if self.n_tenants == 1 else np.array([tenant], np.int32)

    def _fuzzy_time(self) -> float:
        """Analytic fuzzy-channel scan time at the target corpus scale."""
        lat = self.s.latency
        return lat.scan_time(lat.target_corpus * self.fuzzy_scope * 2.0
                             + self.cfg.n_buckets)

    def _speculate(self, q: torch.Tensor, tenant: int) -> tuple[dict, float]:
        """One query's speculation and its measured edge time (s)."""
        tids = self._tids(tenant)
        synchronize(self.device)
        t0 = time.perf_counter()
        out = speculate_batch(self.cfg, self.state, self.index, q[None],
                              backend=self.backend, tenant_ids=tids)
        synchronize(self.device)
        return out, time.perf_counter() - t0

    def _ingest(self, q: torch.Tensor, ids: np.ndarray, vecs,
                tenant: int) -> float:
        """Fold one reject into its tenant's cache, then tell the backend
        (replica-style backends mirror the ingest onto standby logs).
        Returns the measured time of the cache update (s)."""
        multi = self.n_tenants > 1
        t0 = time.perf_counter()
        cache_update(self.cfg, self.state, q, ids, vecs,
                     tenant_id=tenant if multi else None,
                     backend=self.backend)
        synchronize(self.device)
        t = time.perf_counter() - t0
        self.s.backend.on_ingest(
            q.cpu().numpy()[None], ids.astype(np.int32)[None], self.state,
            tenant_ids=np.array([tenant], np.int32) if multi else None)
        return t

    def step(self, q_emb: np.ndarray, tenant: int = 0, q_terms=None,
             q_term_weights=None):
        """Returns (ids, accept, latency_s, homology).  ``q_terms`` /
        ``q_term_weights`` reach a lexical cloud backend on a reject."""
        lat = self.s.latency.sample_edge()
        q = as_f32(q_emb, self.device)
        out, t_spec = self._speculate(q, tenant)
        # measured edge compute (cache channel + validation at true scale)
        # + analytic fuzzy scan extrapolated to the target corpus
        lat += t_spec + self._fuzzy_time()
        accept = bool(out["accept"][0])
        homology = float(out["homology"][0])
        if accept:
            return out["draft_ids"][0].cpu().numpy(), True, lat, homology
        # fallback: full database (cloud) or optimized ANNS (♦)
        if self.fallback is not None:
            ids, t = self.fallback.search(q)
            vecs = self.s.corpus[torch.as_tensor(ids).long().clamp_min(0)
                                 .to(self.device)]
        else:
            ids, vecs, t = self.s.full_search(q, q_terms, q_term_weights)
        lat += self.s.latency.sample_cloud() + t
        lat += self._ingest(q, ids, vecs, tenant)
        return ids, False, lat, homology

    def _step(self, q, rng, dataset):
        ids, accept, lat, _ = self.step(q["emb"],
                                        tenant=int(q.get("tenant", 0)),
                                        q_terms=q.get("terms"),
                                        q_term_weights=q.get("term_weights"))
        return ids, accept, lat


class ReuseEngine(ServeLoop):
    """Proximity / SafeRadius / MinCache reuse baselines (Table III)."""

    def __init__(self, service: RetrievalService, method: str,
                 h_max: int = 5000, theta: float = 0.9, alpha: float = 2.0,
                 t_lex: float = 0.6, t_sem: float = 0.9):
        super().__init__(service)
        self.method = method
        self.state = init_reuse_state(h_max, service.k, service.world.cfg.d,
                                      device=service.device)
        self.theta, self.alpha = theta, alpha
        self.t_lex, self.t_sem = t_lex, t_sem

    def _match(self, q):
        if self.method == "proximity":
            return proximity_match(self.state, q["emb"], self.theta)
        if self.method == "saferadius":
            return saferadius_match(self.state, q["emb"], self.alpha)
        if self.method == "mincache":
            return mincache_match(self.state, q["emb"],
                                  minhash_signature(q["tokens"]),
                                  self.t_lex, self.t_sem)
        raise ValueError(self.method)

    def _step(self, q, rng, dataset):
        lat = self.s.latency.sample_edge()
        synchronize(self.s.device)
        t0 = time.perf_counter()
        ok, slot, _ = self._match(q)
        ok = bool(ok)
        lat += time.perf_counter() - t0
        if ok:
            # a copy: a later insert may overwrite the slot in place
            ids = np.array(self.state.doc_ids[int(slot)].cpu())
        else:
            ids, vecs, t = self.s.full_search(q["emb"], q.get("terms"),
                                              q.get("term_weights"))
            lat += self.s.latency.sample_cloud() + t
            scores = vecs @ as_f32(q["emb"], self.s.device)
            reuse_insert(self.state, q["emb"], ids, vecs, scores,
                         minhash_signature(q["tokens"]))
        return ids, ok, lat


class CRAGEngine(HasEngine):
    """HaS pipeline with homology validation replaced by an LLM evaluator.

    The evaluator draws from the record rng before the draft's DocHit and
    RA, and a reject draws its cloud RTT after the edge RTT, in the
    reference's order.
    """

    def __init__(self, service: RetrievalService, cfg: HasConfig | None = None,
                 evaluator: CRAGEvaluator | None = None, seed: int = 0,
                 n_tenants: int = 1, *, index: IVFIndex | None = None):
        super().__init__(service, cfg, seed=seed, n_tenants=n_tenants,
                         index=index)
        self.evaluator = evaluator or CRAGEvaluator()

    def _step(self, q, rng, dataset):
        tenant = int(q.get("tenant", 0))
        lat = self.s.latency.sample_edge()
        qt = as_f32(q["emb"], self.device)
        out, t_spec = self._speculate(qt, tenant)
        lat += t_spec + self._fuzzy_time()
        draft = out["draft_ids"][0].cpu().numpy()
        golden = self.s.world.golden_mask(q["entity"], q["attr"], draft)
        lat += self.evaluator.latency_s              # LLM inference cost
        accept = self.evaluator.evaluate(rng, golden, dataset == "popqa")
        if accept:
            return draft, True, lat
        ids, vecs, t = self.s.full_search(qt, q.get("terms"),
                                          q.get("term_weights"))
        lat += self.s.latency.sample_cloud() + t
        self._ingest(qt, ids, vecs, tenant)
        return ids, False, lat
