"""RAG serving engines: full-database retrieval and HaS (paper §IV).

Both engines run on one serve-loop substrate (:class:`ServeLoop`): the loop
owns metrics recording, record-rng threading and micro-batch iteration, and
an engine implements ``_step`` (one query -> ids/accept/latency).  Full
retrieval goes through the :class:`RetrievalService` backend.  This is
Algorithm 1's sequential semantics: the cache changes between queries.

Recorded metrics (paper §IV):

  AvgL   average end-to-end retrieval latency
  DAR    draft acceptance rate
  CAR    correct acceptance rate (accepted drafts containing a golden doc)
  DocHit golden document present in the returned set
  RA     simulated response accuracy per downstream LLM
  L@DA / L@DR   latency conditioned on acceptance / rejection

Measured edge compute is timed on the host clock after
``torch.cuda.synchronize``, so a time covers the device work and not only
its launch.  The ANNS, reuse and CRAG engines of the reference, its ANNS
fallback and its tenant partitions are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.has import (HasConfig, HasState, cache_update,
                                  init_has_state, speculate_batch)
from repro_torch.data.synthetic import simulate_response_accuracy
from repro_torch.retrieval.ivf import IVFIndex, build_ivf, subset_index
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
        ids, _, t = self.s.full_search(q["emb"])
        return ids, False, self.s.latency.sample_cloud() + t


class HasEngine(ServeLoop):
    """The paper's system (Algorithm 1) on the service's device.

    ``index`` (optional) is a prebuilt fuzzy-channel index, so several
    engines can share one build; without it the engine builds its own from
    the service's corpus.  ``backend`` is the kernel switch of
    :func:`~repro_torch.core.has.speculate_batch` (None: by device).
    """

    def __init__(self, service: RetrievalService, cfg: HasConfig | None = None,
                 fuzzy_fraction: float = 1.0, seed: int = 0,
                 backend: str | None = None, index: IVFIndex | None = None):
        super().__init__(service)
        self.cfg = cfg or HasConfig(k=service.k, d=service.world.cfg.d)
        self.device = service.device
        self.state: HasState = init_has_state(self.cfg, device=self.device)
        if index is None:
            index = build_ivf(service.corpus, self.cfg.n_buckets, seed=seed,
                              device=self.device)
        self.index = subset_index(index, fuzzy_fraction)
        self.backend = backend
        self.fuzzy_scope = (self.cfg.nprobe / self.cfg.n_buckets) \
            * fuzzy_fraction
        # warm up speculation at the sequential shape B=1
        z = np.zeros((1, self.s.world.cfg.d), np.float32)
        speculate_batch(self.cfg, self.state, self.index, z, backend=backend)
        synchronize(self.device)

    def _fuzzy_time(self) -> float:
        """Analytic fuzzy-channel scan time at the target corpus scale."""
        lat = self.s.latency
        return lat.scan_time(lat.target_corpus * self.fuzzy_scope * 2.0
                             + self.cfg.n_buckets)

    def step(self, q_emb: np.ndarray):
        """Returns (ids, accept, latency_s, homology)."""
        lat = self.s.latency.sample_edge()
        q = as_f32(q_emb, self.device)
        synchronize(self.device)
        t0 = time.perf_counter()
        out = speculate_batch(self.cfg, self.state, self.index, q[None],
                              backend=self.backend)
        synchronize(self.device)
        # measured edge compute (cache channel + validation at true scale)
        # + analytic fuzzy scan extrapolated to the target corpus
        lat += (time.perf_counter() - t0) + self._fuzzy_time()
        accept = bool(out["accept"][0])
        homology = float(out["homology"][0])
        if accept:
            return out["draft_ids"][0].cpu().numpy(), True, lat, homology
        ids, vecs, t = self.s.full_search(q)
        lat += self.s.latency.sample_cloud() + t
        t0 = time.perf_counter()
        cache_update(self.cfg, self.state, q, ids, vecs)
        synchronize(self.device)
        lat += time.perf_counter() - t0
        return ids, False, lat, homology

    def _step(self, q, rng, dataset):
        ids, accept, lat, _ = self.step(q["emb"])
        return ids, accept, lat
