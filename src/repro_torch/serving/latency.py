"""Cloud/edge latency model (paper §IV-A deployment simulation).

The paper deploys full-database retrieval 'on the cloud' (0.1–0.2 s injected
network latency, Faiss-IndexPQ over 49.2M passages) and HaS 'on the edge'
(0.01–0.05 s).  The system runs one device with a smaller synthetic
corpus, so per-query latency is composed as:

    measured wall-clock of the device compute x corpus_scale  (for any op
    whose cost scales with corpus size: full search, fuzzy IVF scan)
  + sampled network RTT (cloud or edge)
  + measured cache/validation compute (corpus-independent, unscaled)

corpus_scale = target_corpus / actual_corpus extrapolates the measured
matmul/IVF time to the paper's 49.2M-passage scale, keeping every relative
comparison (the paper's evaluation axis) intact.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class LatencyModel:
    cloud_rtt: tuple[float, float] = (0.1, 0.2)
    edge_rtt: tuple[float, float] = (0.01, 0.05)
    target_corpus: int = 49_200_000
    actual_corpus: int = 100_000
    d: int = 64
    # Effective scan bandwidth. The default models the paper's workstation
    # (I9-13900KF): 49.2M x 64 x 4 B / 10.3 GB/s = 1.22 s full scan, matching
    # the paper's ~1.23 s ENNS compute (AvgL 1.3845 minus cloud RTT).
    # RetrievalService(calibrate=True) replaces it with THIS machine's
    # measured bandwidth instead.
    bandwidth: float = 10.3e9
    # Per-shard overhead of the distributed scan (retrieval/distributed.py):
    # every worker all-gathers and merges O(shards·k) candidate pairs, so
    # the merge cost GROWS with the shard count — modeled as this fraction
    # of the full (unsharded) scan time per extra shard.  0.2% puts the
    # over-sharding inflection (where adding shards stops helping) at
    # s ≈ sqrt(1/0.002) ≈ 22 shards.
    shard_merge_overhead: float = 0.002
    # Agent reasoning time per hop of a multi-hop (Auto-RAG) query: the LLM
    # call that turns one hop's retrieval into the next hop's sub-query (or
    # the final answer).  The paper's Fig-13 pipeline charges one such step
    # after every hop; both the sequential AutoRagPipeline baseline and the
    # scheduler's hop-graph path draw it from HERE so the two arms are
    # charged identically (serving/agentic.py).
    reason_scale: float = 0.35
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def corpus_scale(self) -> float:
        return self.target_corpus / max(self.actual_corpus, 1)

    def scan_time(self, n_vectors: float, bytes_per_dim: int = 4) -> float:
        """Analytic time to score n_vectors against one query."""
        return n_vectors * self.d * bytes_per_dim / self.bandwidth

    def full_scan_time(self) -> float:
        """Full-database ENNS at the paper's target corpus scale."""
        return self.scan_time(self.target_corpus)

    def ingest_time(self, rows: int, doc_cap: int, k: int) -> float:
        """Modeled edge time to fold ``rows`` (q, D_full) pairs into the
        HaS cache (``cache_update`` / its batched scan): per row, the doc
        dedup compares the k new ids against the whole doc ring
        (``doc_cap`` entries streamed once) and writes k doc vectors, and
        the replication fan-out appends the same k rows to the standby /
        edge-pool delta logs — ``scan_time(doc_cap + 2k)`` each.  The
        cache is edge-LOCAL state at its true size, so unlike the full
        scan this is NOT extrapolated to the target corpus.  Used for both
        the scheduler's cloud-done ingest charge and the edge replica
        pool's bounded-lag delta replay (the same fold)."""
        return rows * self.scan_time(doc_cap + 2 * k)

    def ann_scale(self, n_clusters: int, nprobe: int,
                  capacity_factor: float = 2.0, bytes_per_dim: int = 4,
                  residual_rows: int = 0) -> float:
        """Multiplier on ``full_scan_time()`` when the cloud stage is the
        IVF backend instead of a full-corpus scan: per query it streams the
        ``n_clusters`` f32 centroids (the probe matmul), then
        ``nprobe x capacity`` bucket rows at ``bytes_per_dim`` bytes each
        (1 for the int8 compressed residency, 4 for f32), plus the
        exact-scanned f32 residual buffer holding live-ingested spill.
        Capacity follows the build rule at target scale:
        ``target_corpus * capacity_factor / n_clusters`` padded rows per
        bucket — the padding is real streamed bytes, so it is charged."""
        c = max(1, int(n_clusters))
        p = max(1, min(int(nprobe), c))
        cap = self.target_corpus * capacity_factor / c
        scanned = (c + p * cap * (bytes_per_dim / 4.0)
                   + max(0, int(residual_rows)))
        return scanned / self.target_corpus

    def shard_scale(self, n_shards: int) -> float:
        """Multiplier on ``full_scan_time()`` when the scan is row-sharded
        over ``n_shards`` mesh workers (retrieval/distributed.py): every
        worker streams N/n_shards rows concurrently (the 1/s term), and the
        O(shards·k) all-gather candidate merge charges
        ``shard_merge_overhead`` of the full scan per extra shard — a
        linearly growing term, so over-sharding eventually costs more than
        it saves (minimum near s = sqrt(1/overhead))."""
        s = max(1, int(n_shards))
        return 1.0 / s + self.shard_merge_overhead * (s - 1)

    def hybrid_scale(self, dense_scale: float, lexical_terms: int,
                     pool: int) -> float:
        """Multiplier on ``full_scan_time()`` for the hybrid cloud stage
        (``HybridBackend``): the dense channel at its own multiplier
        (1.0 flat, ``shard_scale`` sharded, ``ann_scale`` ANN), PLUS the
        lexical postings stream — ``lexical_terms`` slots of (int32 term id
        + f32 weight) = 8 bytes per doc, charged relative to the 4·d-byte
        dense row the full scan streams — PLUS the fused rerank of the
        ``pool`` (= kd + kl) surviving candidates per query: a pool-sized
        pairwise-similarity pass and one pool x d rerank matmul, tiny next
        to either channel but charged so the fusion stage is never
        modeled as free."""
        lex = lexical_terms * 8.0 / (self.d * 4.0)
        p = max(1, int(pool))
        fuse = p * (p + self.d) / float(self.target_corpus)
        return float(dense_scale) + lex + fuse

    def calibrate(self, measured_s: float, n_vectors: int,
                  bytes_per_dim: int = 4) -> None:
        """Set effective bandwidth from one measured reference scan."""
        self.bandwidth = n_vectors * self.d * bytes_per_dim / max(measured_s, 1e-9)

    def reason_time(self) -> float:
        """Per-hop agent reasoning (sub-query / answer synthesis) time.

        Deterministic — no rng draw — so agentic traffic never perturbs the
        RTT sample stream shared with non-agentic requests."""
        return self.reason_scale

    def sample_cloud(self) -> float:
        return float(self._rng.uniform(*self.cloud_rtt))

    def sample_edge(self) -> float:
        return float(self._rng.uniform(*self.edge_rtt))


class Timer:
    """Wall-clock of a block of device work (block_until_ready outside)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.elapsed = time.perf_counter() - self.t0
