"""Event-driven continuous-batching HaS serving (virtual-clock simulation).

Request lifecycle:

    arrive -> admission queue -> ``speculate_batch`` on the edge (one call
              per speculation batch: the topk_search, ivf_scan and
              homology_score kernels on the card, their plain versions
              on the CPU — see core/has.py)
           -> accepted: return early (queue wait + spec compute + edge RTT)
           -> rejected:
                -> scored against every PENDING leader (queued or in-flight
                   full retrievals) and the other rejects of its speculation
                   batch via :func:`repro_torch.core.has.intra_batch_share`;
                   homologous peers become FOLLOWERS and share the leader's
                   single full retrieval (single-flight collapsing)
                -> leaders wait in the full-retrieval queue, are LATE
                   RE-VALIDATED against the current cache at cloud-dispatch
                   time (results ingested while they queued may re-identify
                   them; one ``reidentify`` on the already-computed
                   validation draft, no fuzzy scan), and the survivors are
                   coalesced into ONE batched cloud matmul
                -> full results (leaders + follower attribution) ingest into
                   the cache via ``cache_update_chunked`` (``ingest_batch``
                   rows a chunk, in place) and everyone returns

The edge (speculation) and the cloud (full retrieval) are independent
resources, so speculation of later admissions overlaps in-flight full
retrievals — the continuous-batching win that neither the sequential
``HasEngine`` (strict Algorithm 1) nor the snapshot micro-batches of
``BatchedHasEngine`` can express.  The cloud stage itself is a WORKER POOL
over the service's pluggable full-retrieval backend
(retrieval/service.py): ``backend.n_workers`` concurrent dispatch slots,
each charged ``backend.latency(batch)`` on the virtual clock — one slot
for the in-process ``LocalFlatBackend`` (the historical serialized cloud),
several for ``ShardedMeshBackend`` mesh workers or ``ReplicaBackend`` warm
standbys, whose cache ingests the loop reconciles via
``backend.on_ingest``.  CAVEAT for approximate backends (``IVFBackend``):
the cloud stage's results are what the cache ingests, so any recall loss
COMPOUNDS — a missed document is absent from later homology validations
and from every accept served off that cache entry, not just from the one
response.  Calibrate ``nprobe`` against end-to-end doc-hit
(``benchmarks/ann_recall.py``), never against kernel recall@k alone.
Four completion channels result —
``draft`` / ``reval`` / ``shared`` / ``full`` — of which the first three
count as accepted (only ``full`` pays for its own full retrieval; only
``full`` and ``shared`` wait on the cloud).

The EDGE is a replica pool too (``SchedulerConfig.edge_replicas = R``,
serving/edge_pool.py): R speculation dispatch slots, each backed by its
own warm cache replica fed from the primary's ingest stream by
bounded-lag delta replay (``edge_sync_every``).  Admission is
staleness-aware — a batch goes to the freshest free replica — and its
acceptance decisions are validated against THAT replica's own cache
version, so an accept can only reference documents the serving replica
actually holds (no phantom accepts on a stale cache).  Ingests still land
on the primary alone; late re-validation at cloud-dispatch time checks
the primary (the authoritative cache, where those ingests live).
``R == 1`` is the historical single-edge path bit-exactly: the lone slot
IS the primary (zero lag, no pool), mirroring how ``n_tenants == 1``
keeps the unstacked store.

Multi-tenancy (``SchedulerConfig.n_tenants > 1``): the cache is a
tenant-partitioned stacked store (``core/has.py::init_tenant_states``) and
every request carries a tenant tag (``serve(tenant_ids=...)`` or a
``"tenant"`` key on the query).  Admission and the full-retrieval queue
are per-tenant FIFOs drained by weighted-fair selection
(``SchedulerConfig.tenant_weights``, optional per-batch admission quota
``tenant_quota``), speculation/ingest route each row through its tenant's
partition inside the same fused programs, and the sharing election masks
cross-tenant pairs — one tenant's churn can neither evict another's
homology window nor leak retrieved documents into another's drafts.
``SchedResult.per_tenant()`` slices every metric by tenant.  T == 1 is
the historical single-tenant path, bit-exactly.

Latency accounting: every component is *modeled* — sampled RTTs from the
scheduler's own per-serve rng plus analytic bandwidth-bound scan times
(serving/latency.py) — so a run is a pure function of
(seed, arrival trace, query stream).  With equal accept bits and ids the
port's ``t_done``, spans and channels equal the reference's exactly (the
same numpy rng draws in the same order); ``tests/test_torch_scheduler.py``
holds them to it.  Batched scans are charged bandwidth-bound:
one coalesced matmul streams the operand once, so a full-retrieval batch
costs ``full_scan_time()`` regardless of batch width, and a speculation
batch streams ``min(B * scope, 1.0)`` of the fuzzy index.  EVERY stage is
on the clock: cache ingest (the ``cache_update_chunked`` fold plus the
``on_ingest`` replication fan-out) is charged on the cloud-done path to
each request returning from that batch, and edge-replica delta replay is
charged to the dispatching edge slot before its speculation batch runs
(``LatencyModel.ingest_time`` for both — they are the same fold).
``SchedulerConfig.free_ingest_replay=True`` restores the historical
free-ingest/free-replay accounting (and
``follower_score_weighted=False`` the historical leader-ordered follower
ingest).

Per-stage tracing (serving/tracing.py): every request records a span
breakdown — queue wait / replay / spec / edge RTT / reval wait / cloud
queue / cloud / ingest — summing EXACTLY to its end-to-end latency, and
``SchedResult.trace`` exposes ``stage_breakdown()`` and
``timeline(bucket_s)`` for benchmarks to assert on.

Overload control (``SchedulerConfig.{slo_deadline_s, overload_policy}``):
past saturation an uncontrolled open-loop queue grows without bound and
p99 is meaningless, so the scheduler can either ``shed`` — reject at
admission (new ``"shed"`` channel, zero latency, no resources consumed)
when the fluid-model predicted queue wait blows the deadline — or
``degrade`` — serve speculation-only under overload: rejected drafts
return immediately with ``accept=False`` (``"degraded"`` channel) instead
of queuing for the cloud.  The overload state machine has hysteresis
(enter above ``slo_deadline_s``, exit below ``overload_exit_frac`` of it)
and is evaluated only at event boundaries, so the policy is a
deterministic function of the virtual clock like everything else.

Fault injection + self-healing (``SchedulerConfig.fault_plan``,
serving/faults.py): a :class:`~repro_torch.serving.faults.FaultPlan` pins fault
events to the virtual clock — cloud-worker crashes, straggler slowdowns,
transient search failures, edge-replica crashes, dropped/duplicated
replication appends — making every chaos run a pure function of
``(seed, plan, arrivals, queries)``.  Under a non-empty plan the cloud
stage self-heals: every dispatch carries a DEADLINE derived from the
calibrated latency model (``training/fault.py::StragglerDetector`` over
observed service times, ``hedge_after`` × expected before calibration);
a blown deadline HEDGES the batch onto a free worker (first result wins,
the loser is cancelled and its head start charged to the new ``lost``
span); a failed attempt RETRIES with exponential backoff (``retry_max``,
``retry_backoff_s``, charged to ``retry_backoff``); a crashed worker's
in-flight batch is requeued at the head of the line; and a crashed edge
replica's in-flight speculation reroutes to the full channel while the
slot is rebuilt in the background from the primary (rebuild time on the
clock).  Ingest is idempotent end-to-end — every completed cloud batch
carries a monotone ``ingest_key`` that ``record_batch``/``on_ingest``
dedupe, so a duplicated replication append can never fold twice.  Span
conservation stays EXACT through every recovery path, and an empty/absent
plan leaves the fault-free schedule bit-identical to a run without the
fault machinery (no extra heap events, same rng draw order).

Agentic multi-hop serving (serving/agentic.py): a query carrying a
``hop_plan`` continuation is the hop-1 sub-query of a COMPLEX multi-hop
request.  When a hop resolves, the scheduler reasons out the bridge entity
(``LatencyModel.reason_time()`` on the clock — the new ``reason`` span) and
enqueues the next hop as a fresh tenant-tagged arrival; when a hop's DRAFT
is rejected, the next hop is PRE-SPECULATED from the drafted bridge
immediately (``SchedulerConfig.speculate_hops``), racing the hop's late
re-validation / full retrieval, so cross-hop latency pipelines instead of
serializing.  A mis-speculation (the validated bridge contradicts the
drafted one) cancels the in-flight child deterministically wherever it
lives — queued states settle at the cancel instant, dispatched cloud work
settles on its completion path — on the new ``cancelled`` channel
(sentinel ids, never ingested, spans conserved exactly), and the corrected
hop re-enqueues.  ``SchedResult.complex_records`` / ``summary()`` /
``per_tenant()`` report per-chain end-to-end latency, DAR/accuracy and
pre-speculation hit rates.  A trace with no ``hop_plan`` queries takes
none of these paths: zero extra rng draws, heap events and span charges.

The port carries the hop-graph branches over as code, but
``serving/agentic.py`` (which builds the ``hop_plan`` continuations) is not
ported yet (ROADMAP.md queue 1 item 8): ``serve`` raises
``NotImplementedError`` for a query carrying a ``hop_plan``.

Device touch points of the port: speculation (``speculate_batch``), the
sharing election (``intra_batch_share``: the ``homology_score`` kernel,
then the serial scan on the host), the late re-validation (one
``homology_validate`` call over the query cache, accept ``best > tau`` in
f32), the cloud stage's ``backend.search`` and the in-place ingest
(``cache_update_chunked``).  ``SchedulerConfig.backend`` is the kernel
switch of ``kernels/ops.py`` (None: the kernels on the card, ``"torch"``:
their plain versions).  Everything else is host code over numpy, heaps and
deques, as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
from typing import Any

import warnings

import numpy as np
import torch

from repro_torch.core.has import (HasConfig, cache_update_batched,
                                  cache_update_chunked, init_has_state,
                                  init_tenant_states, intra_batch_share,
                                  speculate_batch)
from repro_torch.kernels.ops import check_backend, homology_validate_op
from repro_torch.retrieval.ivf import build_ivf
from repro_torch.serving.edge_pool import (DEFAULT_EDGE_SYNC_EVERY,
                                           EdgeReplicaPool)
from repro_torch.serving.engine import (LLMS, RetrievalService, ServeResult,
                                        _metrics_init, _record)
from repro_torch.serving.engine import fuzzy_scope as _fuzzy_scope
from repro_torch.serving.faults import FaultInjector, FaultPlan
from repro_torch.serving.replication import gather_doc_vecs
from repro_torch.serving.tracing import Trace, build_trace, empty_spans
from repro_torch.training.fault import StragglerConfig, StragglerDetector
from repro_torch.utils import as_f32, as_i32, synchronize

# Sharing-threshold default as a multiple of the validation threshold
# cfg.tau, the reference's calibration (its sched_throughput share-tau
# sweep) on the homology-heavy granola stream at saturation: 0.5x cuts avg
# latency ~11% vs 1.0x with the follower channel's doc-hit at or above the
# full channel's (followers attach to genuinely homologous leaders), while
# 0.25x degrades follower doc-hit by 16+ points (non-homologous attachment).
DEFAULT_SHARE_TAU_MULT = 0.5


def poisson_arrivals(n: int, qps: float, seed: int = 0) -> np.ndarray:
    """Arrival times of a Poisson process at rate ``qps`` (open-loop load)."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_spec_batch: int = 32       # admission -> speculation coalescing cap
    full_batch: int = 16           # rejected leaders per cloud dispatch
    full_max_wait_s: float = 0.05  # dispatch a partial batch after this wait
    # DEPRECATED: the cloud stage is now a worker pool sized by the
    # retrieval backend (`service.backend.n_workers`); a non-None value
    # still loads (old configs keep working) and overrides the pool size,
    # with a DeprecationWarning at scheduler construction.
    max_inflight_full: int | None = None
    share: bool = True             # homology sharing across the reject queue
    share_tau: float | None = None  # sharing threshold; None ->
    #                                 DEFAULT_SHARE_TAU_MULT * cfg.tau
    max_pending_leaders: int = 256  # sharing registry capacity (fixed shape)
    revalidate: bool = True        # re-check leaders at cloud-dispatch time
    ingest_followers: bool = True  # followers' (q, shared D_full) also cached
    ingest_batch: int = 32         # fused cache-ingest chunk (compiled shape)
    backend: str | None = None     # kernel switch (kernels/ops.py): None ->
    #                                the kernels on a CUDA state, the plain
    #                                versions on the CPU; "torch" -> plain
    # -- multi-tenant partitioning (core/has.py::init_tenant_states) -------
    n_tenants: int = 1             # tenant partitions; 1 == the historical
    #                                single-tenant layout, bit-exactly
    tenant_quota: int | None = None  # admission quota: max rows one tenant
    #                                  may occupy in one speculation batch
    #                                  (None -> work-conserving fairness only)
    tenant_weights: tuple[float, ...] | None = None  # weighted-fair shares
    #                                  per tenant; None -> equal weights
    # -- edge speculation replica pool (serving/edge_pool.py) --------------
    edge_replicas: int = 1         # speculation cache replicas / dispatch
    #                                slots; 1 == the historical single-edge
    #                                path (the slot IS the primary),
    #                                bit-exactly
    edge_sync_every: int = DEFAULT_EDGE_SYNC_EVERY  # bounded-lag replay
    #                                cadence: a replica this many ingested
    #                                rows behind the primary replays its
    #                                missing delta rows
    # -- SLO-aware overload control ----------------------------------------
    slo_deadline_s: float | None = None  # end-to-end latency SLO; None ->
    #                                no deadline (goodput still unreported)
    overload_policy: str = "none"  # "none" | "shed" (reject at admission
    #                                when the predicted completion blows
    #                                the deadline) | "degrade" (serve
    #                                speculation-only under overload:
    #                                rejects return drafts, accept=False)
    overload_exit_frac: float = 0.5  # hysteresis: overload exits once the
    #                                predicted completion falls below this
    #                                fraction of the deadline
    # -- fault injection + self-healing (serving/faults.py) ----------------
    fault_plan: FaultPlan | None = None  # deterministic chaos plan pinned to
    #                                the virtual clock; None / empty plan ==
    #                                the fault-free path, BIT-EXACTLY (no
    #                                extra rng draws, no extra heap events)
    retry_max: int = 2             # transient-failure retries per cloud
    #                                batch before it fails hard ("failed"
    #                                channel)
    retry_backoff_s: float = 0.05  # exponential backoff base between a
    #                                failed cloud attempt and its retry
    #                                (doubles per attempt)
    hedge_after: float | None = 2.5  # straggler deadline factor: a cloud
    #                                dispatch outliving hedge_after x the
    #                                trailing-median attempt time (adaptive,
    #                                training/fault.py::StragglerDetector;
    #                                model-derived until warmed up) is
    #                                hedged onto a free worker — first
    #                                result wins, the loser is cancelled.
    #                                None disables hedging.  Only active
    #                                under a non-empty fault plan.
    # -- accounting / tracing ----------------------------------------------
    trace: bool = True             # per-stage span breakdown on SchedResult
    #                                (virtual-clock bookkeeping only; never
    #                                changes the schedule)
    free_ingest_replay: bool = False  # compat: the historical (pre-fix)
    #                                accounting where cache ingest and
    #                                edge-replica delta replay are FREE on
    #                                the virtual clock
    follower_score_weighted: bool = True  # followers ingest (and serve)
    #                                the shared D_full reranked by their
    #                                OWN query-doc scores; False keeps the
    #                                historical leader-ordered list
    # -- agentic hop graphs (serving/agentic.py) ---------------------------
    speculate_hops: bool = True    # cross-hop pre-speculation: launch hop
    #                                h+1 from hop h's REJECTED draft's
    #                                bridge entity, racing hop h's
    #                                validation / full retrieval; False
    #                                resolves hop graphs strictly
    #                                sequentially.  Inert on traces with
    #                                no hop_plan queries.


def _safe_mean(a) -> float:
    """``float(a.mean())`` that reports NaN instead of warning/crashing on
    an empty slice (``serve([])``, an all-shed tenant, ...)."""
    a = np.asarray(a)
    return float(a.mean()) if a.size else float("nan")


def _safe_pct(a, q: float) -> float:
    """NaN-safe ``np.percentile`` (empty slices crash it outright)."""
    a = np.asarray(a)
    return float(np.percentile(a, q)) if a.size else float("nan")


@dataclasses.dataclass
class SchedResult(ServeResult):
    """ServeResult + open-loop serving metrics."""
    t_arrive: np.ndarray
    t_done: np.ndarray
    cloud_s: np.ndarray            # cloud RTT + scan charged to each request
    channels: np.ndarray           # 'draft' | 'reval' | 'shared' | 'full'
    full_retrievals: int           # queries that PAID for a full retrieval
    spec_batches: int
    full_batches: int
    max_inflight_full_batches: int = 1  # worker-pool concurrency high-water
    tenant_ids: np.ndarray | None = None   # per-request tenant partition
    leader_idx: np.ndarray | None = None   # shared-channel leader request
    #                                        index (-1 for non-followers)
    served_ids: np.ndarray | None = None   # [n, k] doc ids actually served
    max_inflight_spec_batches: int = 1     # edge-pool concurrency high-water
    edge_replays: int = 0                  # bounded-lag delta replay events
    replica_ids: np.ndarray | None = None  # edge replica that speculated
    #                                        each request (-1: never
    #                                        speculated / R == 1 primary)
    cache_versions: np.ndarray | None = None  # serving replica's cache
    #                                        version (delta-log seq) at its
    #                                        speculation dispatch (-1: R==1)
    trace: Trace | None = None             # per-stage span breakdown
    #                                        (serving/tracing.py); None when
    #                                        SchedulerConfig.trace is False
    slo_deadline_s: float | None = None    # the SLO the stream was served
    #                                        under (goodput denominator)
    # -- fault-handling stats (serving/faults.py; all 0 fault-free) --------
    retries: int = 0               # cloud-batch re-dispatches (backoff
    #                                retries + crash requeues)
    hedges: int = 0                # straggler hedged re-dispatches
    worker_deaths: int = 0         # cloud-worker crash events handled
    replica_rebuilds: int = 0      # edge replicas rebuilt (crash recovery +
    #                                delta-gap full resyncs)
    # -- agentic hop graphs (serving/agentic.py; all None/zeros when the
    #    trace carried no hop_plan queries) -------------------------------
    hop: np.ndarray | None = None          # hop index per request (0: plain
    #                                        single-hop; spawned hop-h
    #                                        sub-queries appended after the
    #                                        input trace)
    parent_root: np.ndarray | None = None  # owning complex query's hop-1
    #                                        request index (-1: plain)
    speculative: np.ndarray | None = None  # launched from an unconfirmed
    #                                        drafted bridge AND never
    #                                        confirmed authoritative
    complex_records: list | None = None    # one record per complex query
    #                                        (root_idx, e2e_s, dar,
    #                                        accuracy, prespec[_hit],
    #                                        cancelled, hop_idx, ...)

    def per_tenant(self) -> dict[int, dict[str, float]]:
        """Per-tenant metric slices (empty when served without tenants).
        NaN-safe: an empty stream (or an all-shed tenant slice) reports
        NaN latencies instead of crashing ``np.percentile``."""
        if self.tenant_ids is None:
            return {}
        out = {}
        for t in np.unique(self.tenant_ids):
            m = self.tenant_ids == t
            lat = self.latencies[m]
            out[int(t)] = {
                "n": int(m.sum()),
                "dar": _safe_mean(self.accepts[m]),
                "doc_hit_rate": _safe_mean(self.doc_hits[m]),
                "avg_latency_s": _safe_mean(lat),
                "p95_latency_s": _safe_pct(lat, 95),
                "full_retrievals": int(np.sum((self.channels == "full") & m)),
                "shared_accepts": int(np.sum((self.channels == "shared") & m)),
            }
            if self.complex_records is not None:
                sel = [c for c in self.complex_records
                       if c["tenant"] == int(t) and c["served"]]
                out[int(t)].update({
                    "hop_requests": int(np.sum((self.hop > 0) & m)),
                    "complex_n": len(sel),
                    "complex_e2e_avg_s": _safe_mean(
                        [c["e2e_s"] for c in sel]),
                    "complex_dar": _safe_mean([c["dar"] for c in sel]),
                    "complex_accuracy": _safe_mean(
                        [c["accuracy"] for c in sel]),
                })
        return out

    def summary(self) -> dict[str, float]:
        out = super().summary()
        lat = self.latencies
        # admitted = everything the scheduler actually served (shed
        # rejections complete instantly at zero latency and would deflate
        # the percentiles the SLO verdicts assert on)
        admitted = self.channels != "shed"
        adm_lat = lat[admitted]
        makespan = (float(self.t_done.max() - self.t_arrive.min())
                    if len(lat) else float("nan"))
        out.update({
            "p50_latency_s": _safe_pct(lat, 50),
            "p95_latency_s": _safe_pct(lat, 95),
            "p99_latency_s": _safe_pct(lat, 99),
            "p99_admitted_latency_s": _safe_pct(adm_lat, 99),
            "makespan_s": makespan,
            "throughput_qps": (len(lat) / max(makespan, 1e-9)
                               if len(lat) else 0.0),
            "shared_accepts": int(np.sum(self.channels == "shared")),
            "reval_accepts": int(np.sum(self.channels == "reval")),
            "full_retrievals": int(self.full_retrievals),
            "spec_batches": int(self.spec_batches),
            "full_batches": int(self.full_batches),
            "max_inflight_full_batches": int(self.max_inflight_full_batches),
            "max_inflight_spec_batches": int(self.max_inflight_spec_batches),
            "edge_replays": int(self.edge_replays),
            "shed": int(np.sum(self.channels == "shed")),
            "degraded": int(np.sum(self.channels == "degraded")),
            "failed": int(np.sum(self.channels == "failed")),
            "retries": int(self.retries),
            "hedges": int(self.hedges),
            "worker_deaths": int(self.worker_deaths),
            "replica_rebuilds": int(self.replica_rebuilds),
        })
        if self.slo_deadline_s is not None:
            # goodput: genuinely served results (draft/reval/shared/full —
            # shed delivered nothing, degraded an unvalidated best-effort
            # draft) completing within the deadline, per second of stream
            good = (np.isin(self.channels,
                            ("draft", "reval", "shared", "full"))
                    & (lat <= self.slo_deadline_s))
            out["slo_deadline_s"] = float(self.slo_deadline_s)
            out["goodput_qps"] = (int(good.sum()) / max(makespan, 1e-9)
                                  if len(lat) else 0.0)
            out["slo_attainment"] = _safe_mean(good[admitted])
        if self.complex_records is not None:
            # per-complex-query aggregation: end-to-end latency of the hop
            # CHAIN (hop-1 arrival -> final answer, reasoning included),
            # chain-level DAR/accuracy, and cross-hop pre-speculation
            # telemetry (rate = complex queries whose next hop launched
            # from a draft bridge; hit rate = drafted bridges the
            # validated resolution confirmed)
            recs = self.complex_records
            fin = [c for c in recs if c["served"]]
            e2e = np.array([c["e2e_s"] for c in fin])
            multi = [c for c in fin if c["hops"] > 1]
            pres = [c for c in multi if c["prespec"]]
            out.update({
                "cancelled": int(np.sum(self.channels == "cancelled")),
                "complex_n": len(recs),
                "complex_served": len(fin),
                "complex_e2e_avg_s": _safe_mean(e2e),
                "complex_e2e_p95_s": _safe_pct(e2e, 95),
                "complex_retrieval_avg_s": _safe_mean(
                    e2e - np.array([c["reason_s"] for c in fin])),
                "complex_dar": _safe_mean([c["dar"] for c in fin]),
                "complex_accuracy": _safe_mean(
                    [c["accuracy"] for c in fin]),
                "hop_prespec_rate": _safe_mean(
                    [c["prespec"] for c in multi]),
                "hop_prespec_hit_rate": _safe_mean(
                    [bool(c["prespec_hit"]) for c in pres]),
                "hops_cancelled": int(sum(c["cancelled"] for c in recs)),
            })
            # per-hop aggregation over the sub-request population
            done = self.channels != "cancelled"
            for h in range(1, int(self.hop.max()) + 1):
                mh = (self.hop == h) & done
                out[f"hop{h}_n"] = int(mh.sum())
                out[f"hop{h}_avg_latency_s"] = _safe_mean(
                    self.latencies[mh])
                out[f"hop{h}_dar"] = _safe_mean(self.accepts[mh])
        return out


@dataclasses.dataclass(eq=False)      # identity semantics: requests live in
#                                       deques/registries and carry numpy
#                                       fields a field-wise __eq__ would
#                                       choke on
class _Request:
    idx: int
    q: dict
    t_arrive: float
    tenant: int = 0                        # tenant partition of this request
    edge_rtt: float = 0.0
    t_rejected: float = 0.0
    val_ids: np.ndarray | None = None
    draft_ids: np.ndarray | None = None
    ids: np.ndarray | None = None
    channel: str = "pending"
    t_done: float = -1.0
    cloud_s: float = 0.0
    slot: int = -1                         # leader-registry slot
    leader_idx: int = -1                   # leader request idx (followers)
    followers: list = dataclasses.field(default_factory=list)
    replica: int = -1                      # edge replica that speculated it
    cache_version: int = -1                # that replica's version at
    #                                        dispatch (-1: R == 1 primary)
    reroute: bool = False                  # speculation lost to a replica
    #                                        crash: straight to the full
    #                                        channel (no re-validation, no
    #                                        sharing registry — val_ids are
    #                                        the -1 sentinel)
    spans: dict = dataclasses.field(default_factory=empty_spans)
    #                                        per-stage latency breakdown
    #                                        (serving/tracing.py STAGES);
    #                                        sums to t_done - t_arrive
    # -- agentic hop graphs (serving/agentic.py) ---------------------------
    hop: int = 0                           # hop index in a complex query's
    #                                        chain (0: plain single-hop)
    cq: Any = None                         # owning _HopGraph (hop requests)
    speculative: bool = False              # launched from a DRAFT bridge,
    #                                        not yet confirmed by the
    #                                        parent hop's resolution
    cancelled: bool = False                # mis-speculation cancel landed
    t_cancel: float = -1.0                 # virtual time it landed
    stage: str = "new"                     # lifecycle position (new/admit/
    #                                        spec/cloudq/follower/cloud/
    #                                        done) — how a cancel finds the
    #                                        container holding the request
    lead: Any = None                       # leader _Request (followers)
    t_sdone: float = -1.0                  # in-flight speculation batch's
    #                                        completion time (mid-spec
    #                                        cancel claws back the tail)


class _HopGraph:
    """Serve-time state of ONE complex query's hop chain (the scheduler
    side of a ``HopPlan`` continuation of the reference's
    ``serving/agentic.py``; not ported yet).

    Tracks the authoritative per-hop results (accepts/hits), the one
    in-flight speculative next-hop child (if cross-hop pre-speculation
    launched it), and the chain's completion."""

    __slots__ = ("plan", "root_idx", "tenant", "t_start", "hits", "accepts",
                 "hop_idx", "spec_child", "prespec", "prespec_hit",
                 "cancelled", "done", "t_done", "served")

    def __init__(self, plan, root_idx: int, tenant: int, t_start: float):
        self.plan = plan
        self.root_idx = root_idx
        self.tenant = tenant
        self.t_start = t_start
        self.hits: list[bool] = []
        self.accepts: list[bool] = []
        self.hop_idx: list[int] = []
        self.spec_child = None          # in-flight speculative _Request
        self.prespec = False            # a hop was launched pre-validation
        self.prespec_hit: bool | None = None
        self.cancelled = 0              # hops cancelled on mis-speculation
        self.done = False
        self.t_done = -1.0
        self.served = False             # final hop delivered a result


# event-kind priorities at equal timestamps: full results ingest before a
# speculation batch dispatched at the same instant (cache freshness), and
# both before new arrivals join the queue.  Fault events (kind -1) fire
# FIRST at their instant — a completion scheduled for the same moment a
# crash lands is already lost work.  Kinds 4..7 exist only under a
# non-empty fault plan (the fault-free heap never sees them).
_FAULT = -1
_FULL_DONE, _SPEC_DONE, _ARRIVE, _FULL_TIMER = 0, 1, 2, 3
_DEADLINE, _RETRY, _WORKER_UP, _REBUILT = 4, 5, 6, 7


class ContinuousBatchingScheduler:
    """Continuous-batching HaS engine over an open-loop arrival process.

    Each ``serve`` call is an independent stream: the cache is re-initialised
    so that (seed, arrivals, queries) fully determine the result.  The
    cache, the replicas and the speculation run on ``service.device``
    (CUDA unless the service was built with ``device="cpu"``); ``index``
    is a prebuilt fuzzy-channel index, without which the scheduler builds
    its own.
    """

    def __init__(self, service: RetrievalService, cfg: HasConfig | None = None,
                 sched: SchedulerConfig | None = None, seed: int = 0,
                 index=None):
        self.s = service
        self.device = service.device
        self.cfg = cfg or HasConfig(k=service.k, d=service.world.cfg.d)
        self.sched = sched or SchedulerConfig()
        sc = self.sched
        check_backend(sc.backend)
        # batching knobs: a direct SchedulerConfig(...) used to accept
        # nonsense silently (launch/serve.py validated its own flags, this
        # path did not) — a 0-wide batch livelocks the loop, a negative
        # timer fires in the past
        if sc.max_spec_batch < 1:
            raise ValueError(
                f"max_spec_batch must be >= 1, got {sc.max_spec_batch}")
        if sc.full_batch < 1:
            raise ValueError(f"full_batch must be >= 1, got {sc.full_batch}")
        if sc.full_max_wait_s < 0:
            raise ValueError(
                f"full_max_wait_s must be >= 0, got {sc.full_max_wait_s}")
        if sc.ingest_batch < 1:
            raise ValueError(
                f"ingest_batch must be >= 1, got {sc.ingest_batch}")
        # overload-control knobs
        if sc.overload_policy not in ("none", "shed", "degrade"):
            raise ValueError(
                f"overload_policy must be 'none', 'shed' or 'degrade', got "
                f"{sc.overload_policy!r}")
        if sc.slo_deadline_s is not None and sc.slo_deadline_s <= 0:
            raise ValueError(
                f"slo_deadline_s must be > 0 (or None), got "
                f"{sc.slo_deadline_s}")
        if sc.overload_policy != "none" and sc.slo_deadline_s is None:
            raise ValueError(
                f"overload_policy={sc.overload_policy!r} needs "
                "slo_deadline_s — the policy triggers on the predicted "
                "completion time blowing the deadline")
        if not (0 < sc.overload_exit_frac <= 1):
            raise ValueError(
                f"overload_exit_frac must be in (0, 1], got "
                f"{sc.overload_exit_frac}")
        # fault-handling knobs
        if sc.retry_max < 0:
            raise ValueError(f"retry_max must be >= 0, got {sc.retry_max}")
        if sc.retry_backoff_s < 0:
            raise ValueError(
                f"retry_backoff_s must be >= 0, got {sc.retry_backoff_s}")
        if sc.hedge_after is not None and not sc.hedge_after > 1:
            raise ValueError(
                f"hedge_after must be > 1 (or None to disable hedging), "
                f"got {sc.hedge_after}")
        if sc.fault_plan is not None and not isinstance(sc.fault_plan,
                                                        FaultPlan):
            raise TypeError(
                f"fault_plan must be a FaultPlan (or None), got "
                f"{type(sc.fault_plan).__name__} — parse CLI specs with "
                "FaultPlan.parse()")
        # tenant-partitioned cache: T == 1 keeps the historical unstacked
        # layout (bit-exact legacy path); T > 1 stacks [T, ...] partitions
        # with per-tenant capacity cfg.h_max / cfg.doc_cap EACH
        self.n_tenants = max(1, int(self.sched.n_tenants))
        if self.sched.tenant_weights is not None:
            if len(self.sched.tenant_weights) != self.n_tenants:
                raise ValueError(
                    f"tenant_weights needs {self.n_tenants} entries, got "
                    f"{len(self.sched.tenant_weights)}")
            if any(w <= 0 for w in self.sched.tenant_weights):
                raise ValueError("tenant_weights must be positive")
            self.tenant_weights = tuple(
                float(w) for w in self.sched.tenant_weights)
        else:
            self.tenant_weights = (1.0,) * self.n_tenants
        if self.sched.tenant_quota is not None and self.sched.tenant_quota < 1:
            # quota 0 would livelock the loop: fair_pick could never drain
            # the admission queues, yet they would keep the edge dispatching
            raise ValueError(
                f"tenant_quota must be >= 1 (or None), got "
                f"{self.sched.tenant_quota}")
        self.state = self._init_state()
        self.index = index if index is not None else build_ivf(
            service.corpus, self.cfg.n_buckets, seed=seed,
            device=self.device)
        self.fuzzy_scope = _fuzzy_scope(self.cfg, self.index)
        self._share_tau = (self.sched.share_tau if self.sched.share_tau
                           is not None
                           else DEFAULT_SHARE_TAU_MULT * self.cfg.tau)
        # cloud-stage worker pool: one slot per backend worker (mesh shard
        # group / warm-standby replica); the deprecated scalar still wins
        # when an old config sets it
        if self.sched.max_inflight_full is not None:
            warnings.warn(
                "SchedulerConfig.max_inflight_full is deprecated; the "
                "full-retrieval stage is a worker pool sized by "
                "service.backend.n_workers (see retrieval/service.py)",
                DeprecationWarning, stacklevel=2)
            self.n_full_workers = max(1, int(self.sched.max_inflight_full))
        else:
            self.n_full_workers = max(1, int(service.backend.n_workers))
        # edge speculation replica pool: R dispatch slots, each a warm cache
        # replica fed by bounded-lag delta replay (serving/edge_pool.py);
        # R == 1 keeps the historical single-edge path (the slot IS the
        # primary state — zero lag, no pool object) bit-exactly
        if self.sched.edge_replicas < 1:
            raise ValueError(
                f"edge_replicas must be >= 1, got {self.sched.edge_replicas}")
        if self.sched.edge_sync_every < 1:
            raise ValueError(
                f"edge_sync_every must be >= 1, got "
                f"{self.sched.edge_sync_every}")
        self.n_edge_replicas = int(self.sched.edge_replicas)
        self.edge_pool: EdgeReplicaPool | None = None   # built per serve()
        self._keep_edge_log = False    # audits/tests: retain the delta log
        self._inj: FaultInjector | None = None          # built per serve()
        # fault-plan topology validation: every targeted worker/replica must
        # exist, and the plan must not permanently kill the whole cloud
        # pool (queued leaders would then never complete — a silent
        # deadlock, not a chaos result)
        self._fault_mode = (self.sched.fault_plan is not None
                            and len(self.sched.fault_plan) > 0)
        if self._fault_mode:
            perm_dead = set()
            for i, ev in enumerate(self.sched.fault_plan.events):
                if ev.kind in ("worker_crash", "straggler", "search_fail"):
                    if ev.target >= self.n_full_workers:
                        raise ValueError(
                            f"fault_plan events[{i}] ({ev.kind}) targets "
                            f"worker {ev.target} but the backend has only "
                            f"{self.n_full_workers} worker(s)")
                    if ev.kind == "worker_crash" and ev.down_s == 0.0:
                        perm_dead.add(ev.target)
                elif ev.kind == "replica_crash":
                    if self.n_edge_replicas < 2:
                        raise ValueError(
                            f"fault_plan events[{i}] (replica_crash) needs "
                            "edge_replicas >= 2 — with R == 1 the lone "
                            "slot IS the primary and there is no pool to "
                            "fail over to")
                    if ev.target >= self.n_edge_replicas:
                        raise ValueError(
                            f"fault_plan events[{i}] (replica_crash) "
                            f"targets replica {ev.target} but "
                            f"edge_replicas={self.n_edge_replicas}")
                else:                          # delta_drop / delta_dup
                    if self.n_edge_replicas < 2:
                        raise ValueError(
                            f"fault_plan events[{i}] ({ev.kind}) needs "
                            "edge_replicas >= 2 — the replication delta "
                            "log only exists with an edge pool")
                    if (ev.kind == "delta_drop"
                            and self.sched.free_ingest_replay):
                        raise ValueError(
                            f"fault_plan events[{i}] (delta_drop) is "
                            "incompatible with free_ingest_replay=True — "
                            "gap detection fires at dispatch-time replay, "
                            "which the compat accounting bypasses")
            if len(perm_dead) >= self.n_full_workers:
                raise ValueError(
                    "fault_plan permanently crashes all "
                    f"{self.n_full_workers} cloud worker(s) (down_s=0) — "
                    "queued full retrievals could never complete")
        # host corpus copy: pool delta vectors (R > 1) and the
        # score-weighted follower rerank both need numpy gathers, and keep
        # computing on the host as the reference does (a device version
        # would round differently and could reorder a follower's ids)
        self._corpus_np = service.corpus.cpu().numpy()
        # warmup: call every device program once at the shape the loop
        # uses — speculation at max_spec_batch, the chunked ingest, the
        # full search at full_batch, re-validation and the sharing
        # election — so the first kernel build is paid here, not in the
        # first served batch
        sc, d, k = self.sched, service.world.cfg.d, self.cfg.k
        spec_tids = (None if self.n_tenants == 1
                     else np.zeros((sc.max_spec_batch,), np.int32))
        speculate_batch(self.cfg, self.state, self.index,
                        np.zeros((sc.max_spec_batch, d), np.float32),
                        backend=sc.backend, tenant_ids=spec_tids)
        scratch = self._init_state()            # updated, then discarded
        cache_update_batched(
            self.cfg, scratch, np.zeros((sc.ingest_batch, d), np.float32),
            np.zeros((sc.ingest_batch, k), np.int32),
            np.zeros((sc.ingest_batch, k, d), np.float32),
            np.zeros((sc.ingest_batch,), bool),
            tenant_ids=(None if self.n_tenants == 1
                        else np.zeros((sc.ingest_batch,), np.int32)))
        service.backend.search(torch.zeros((sc.full_batch, d),
                                           device=self.device))
        self._revalidate(np.full((sc.full_batch, k), -1, np.int32),
                         np.zeros((sc.full_batch,), np.int32))
        nrows = sc.max_pending_leaders + sc.max_spec_batch
        intra_batch_share(
            torch.full((nrows, k), -1, dtype=torch.int32, device=self.device),
            np.zeros((nrows,), bool), np.float32(self._share_tau),
            np.zeros((nrows,), bool),
            None if self.n_tenants == 1 else np.zeros((nrows,), np.int32),
            backend=sc.backend)
        synchronize(self.device)

    def _init_state(self):
        return (init_has_state(self.cfg, device=self.device)
                if self.n_tenants == 1 else
                init_tenant_states(self.cfg, self.n_tenants,
                                   device=self.device))

    def _revalidate(self, vids: np.ndarray, vtids: np.ndarray) -> np.ndarray:
        """Late re-validation of queued validation drafts ``vids [B, k]``
        (tenants ``vtids [B]``) against the current query cache: one
        ``homology_validate`` call, accept iff the best score > tau (f32,
        strict).  As in the reference the scores are the UNWEIGHTED
        overlap even under ``fusion="rrf"``, and only the accept bit is
        read.  Tenant mode scores the flat ``[T*H]`` rows through the
        kernel's row and query groups, so a draft meets only its own
        tenant's rows.  Rows of -1 (padding) never match."""
        st = self.state
        cache_ids, cache_valid = st.query_doc_ids, st.query_valid
        groups = {}
        if self.n_tenants > 1:
            t, h = cache_valid.shape
            cache_ids = cache_ids.reshape(t * h, -1)
            cache_valid = cache_valid.reshape(-1)
            groups = dict(
                row_group=torch.arange(
                    t, dtype=torch.int32,
                    device=self.device).repeat_interleave(h),
                q_group=as_i32(vtids, self.device))
        _, best, _ = homology_validate_op(as_i32(vids, self.device),
                                          cache_ids, cache_valid,
                                          backend=self.sched.backend,
                                          **groups)
        return (best > torch.tensor(self.cfg.tau, dtype=torch.float32,
                                    device=best.device)).cpu().numpy()

    # -- modeled service times (bandwidth-bound coalesced scans) -----------

    def _spec_time(self, b: int) -> float:
        """Edge time for one speculation batch of b queries: the cache
        channel streams the doc store once (all T tenant partitions — the
        partitioned scan is one fused program over the stacked store); the
        fuzzy channel streams the union of probed buckets (capped at the
        whole index)."""
        lat = self.s.latency
        fuzzy = lat.scan_time(min(b * self.fuzzy_scope, 1.0)
                              * lat.target_corpus * 2.0 + self.cfg.n_buckets)
        return fuzzy + lat.scan_time(self.cfg.doc_cap * self.n_tenants)

    def _full_time(self, b: int) -> float:
        """Modeled cloud compute of one coalesced backend dispatch."""
        return self.s.backend.latency(b)

    # -- fused cache ingest ------------------------------------------------

    def _ingest(self, batch, ingest_key=None):
        """Fold a completed full-retrieval batch (leaders followed by their
        followers, i.e. the attribution computed by ``intra_batch_share``)
        into the cache via ``cache_update_chunked`` — one device dispatch
        per ``ingest_batch`` chunk instead of one per request.  Row order
        matches the old per-request loop, so the final state is identical.
        The backend is then notified (``on_ingest``) so replica-style
        backends can reconcile standby caches, and the same rows are
        appended to the edge pool's delta log (bounded-lag replay keeps
        the speculation replicas within ``edge_sync_every`` rows of this
        primary).

        ``ingest_key`` stamps the batch with a stable identity so every
        replication sink (standbys, edge pool) is IDEMPOTENT on it.  Under
        a fault plan, the replication channel itself can misbehave here: a
        ``delta_dup`` event re-sends the batch (absorbed bit-exactly by
        the key), a ``delta_drop`` loses it to the edge pool (the primary
        and cloud standbys folded it; the pool's sequence numbers advance
        with no rows, so the next replica replay fails loudly on the gap
        instead of silently diverging — see ``serving/faults.py``)."""
        rows = []
        for r in batch:
            if not r.cancelled:            # a cancelled hop's row (sentinel
                rows.append(r)             # ids) never folds into the cache
            if self.sched.ingest_followers:
                rows.extend(f for f in r.followers if not f.cancelled)
        if not rows:
            return
        q_embs = np.stack([r.q["emb"] for r in rows])
        full_ids = np.stack([r.ids for r in rows])
        tids = (None if self.n_tenants == 1
                else np.array([r.tenant for r in rows], np.int32))
        self.state = cache_update_chunked(
            self.cfg, self.state, q_embs, full_ids,
            corpus=self.s.corpus, chunk=self.sched.ingest_batch,
            tenant_ids=tids)
        fault = self._inj.delta_fault() if self._inj is not None else None
        self.s.backend.on_ingest(q_embs, full_ids, self.state,
                                 tenant_ids=tids, ingest_key=ingest_key)
        if fault == "dup":
            # duplicated fan-out send — the standbys' ingest keys drop it
            self.s.backend.on_ingest(q_embs, full_ids, self.state,
                                     tenant_ids=tids, ingest_key=ingest_key)
        if self.edge_pool is not None:
            if fault == "drop":
                self.edge_pool.mark_lost(len(rows))
                return
            vecs = gather_doc_vecs(self._corpus_np, full_ids)
            self.edge_pool.record_batch(q_embs, full_ids, vecs, self.state,
                                        tenant_ids=tids,
                                        ingest_key=ingest_key)
            if fault == "dup":
                self.edge_pool.record_batch(q_embs, full_ids, vecs,
                                            self.state, tenant_ids=tids,
                                            ingest_key=ingest_key)

    # -- event loop --------------------------------------------------------

    def serve(self, queries, arrivals: np.ndarray | None = None,
              dataset: str = "granola", llms=LLMS, seed: int = 0,
              tenant_ids: np.ndarray | None = None) -> SchedResult:
        sc = self.sched
        cap = sc.max_pending_leaders
        T = self.n_tenants
        n = len(queries)
        if arrivals is None:                     # fully saturated admission
            arrivals = np.zeros(n)
        arrivals = np.asarray(arrivals, np.float64)
        assert arrivals.shape == (n,)
        if any(q.get("hop_plan") is not None for q in queries):
            raise NotImplementedError(
                "hop_plan queries (agentic multi-hop serving) need the "
                "port of serving/agentic.py, ROADMAP.md queue 1 item 8; "
                "the hop-graph branches below stay unreached until then")
        # tenant resolution: explicit array wins, else the queries' own
        # "tenant" tags, else everyone in partition 0
        if tenant_ids is None:
            tids = np.array([int(q.get("tenant", 0)) for q in queries],
                            np.int32)
        else:
            tids = np.asarray(tenant_ids, np.int32)
            assert tids.shape == (n,)
        if n and (tids.min() < 0 or tids.max() >= T):
            raise ValueError(
                f"tenant ids must be in [0, {T}); got range "
                f"[{tids.min()}, {tids.max()}] — raise "
                f"SchedulerConfig.n_tenants")

        self.state = self._init_state()          # independent stream
        # edge replica pool: fresh replicas + delta log per stream (R == 1
        # keeps the historical single-slot path — the slot IS the primary)
        R = self.n_edge_replicas
        # fixed accounting replays at speculation-dispatch time (charged to
        # the slot); the compat flag restores the free record_batch cadence
        self.edge_pool = None if R == 1 else EdgeReplicaPool(
            self.cfg, R, sync_every=sc.edge_sync_every, n_tenants=T,
            replay_batch=sc.ingest_batch,       # reuse the warmed-up shape
            compact=not self._keep_edge_log,
            sync_on_record=sc.free_ingest_replay, device=self.device)
        pool = self.edge_pool
        rtt_rng = np.random.default_rng(seed)    # scheduler-owned RTT stream
        lat = self.s.latency

        reqs = [_Request(idx=i, q=q, t_arrive=float(arrivals[i]),
                         tenant=int(tids[i]))
                for i, q in enumerate(queries)]
        heap: list[tuple[float, int, int, Any]] = []
        seq = 0
        for r in reqs:
            heapq.heappush(heap, (r.t_arrive, _ARRIVE, seq, r))
            seq += 1

        # -- agentic hop graphs (serving/agentic.py) -----------------------
        # A query carrying a HopPlan continuation ("hop_plan") is the hop-1
        # sub-query of a complex multi-hop request: when a hop resolves, the
        # graph reasons out the bridge entity (reason_s on the clock, the
        # "reason" span) and enqueues the next hop; rejected drafts
        # PRE-SPECULATE the next hop ahead of validation (speculate_hops),
        # and mis-speculations cancel deterministically ("cancelled"
        # channel).  Everything below is gated so a trace with no hop_plan
        # queries adds zero rng draws, heap events and span charges — bit-
        # identical to the pre-hop-graph goldens.
        reason_s = lat.reason_time()
        graphs: list[_HopGraph] = []
        for r in reqs:
            plan = r.q.get("hop_plan")
            if plan is not None:
                r.hop = 1
                r.cq = _HopGraph(plan, r.idx, r.tenant, r.t_arrive)
                graphs.append(r.cq)
        agentic = bool(graphs)

        # -- fault injection + self-healing (serving/faults.py) ------------
        # Everything below is gated on fault_mode: an empty/absent plan
        # adds NO heap events, NO rng draws and NO bookkeeping, so the
        # fault-free schedule is bit-identical to pre-fault builds (the
        # golden-trace tests pin this).
        fault_mode = self._fault_mode
        inj = self._inj = FaultInjector(sc.fault_plan) if fault_mode else None
        detector = None
        cloud_free: list[int] = []     # free cloud worker ids (fault mode)
        busy: dict[int, dict] = {}     # worker id -> live dispatch/backoff
        dead_workers: set[int] = set()
        dead_replicas: set[int] = set()
        spec_epoch = [0] * R           # bumped on replica crash: stale
        #                                _SPEC_DONE events are ignored
        spec_inflight: dict[int, tuple] = {}   # replica -> in-flight batch
        ingest_seq = 0                 # stable ingest_key counter
        retries = hedges = worker_deaths = replica_rebuilds = 0
        if fault_mode:
            cloud_free = list(range(self.n_full_workers))
            detector = StragglerDetector(StragglerConfig(
                deadline_factor=(sc.hedge_after if sc.hedge_after is not None
                                 else 3.0)))
            for ev in sc.fault_plan.sorted_events():
                heapq.heappush(heap, (ev.t, _FAULT, seq, ev))
                seq += 1

        # per-tenant FIFO queues; batches are assembled by weighted-fair
        # selection across them (lowest served/weight first), so one
        # tenant's burst cannot monopolize the edge or the cloud stage.
        # T == 1 degenerates to the historical single FIFO, bit-exactly.
        admission = [collections.deque() for _ in range(T)]
        leaders = [collections.deque() for _ in range(T)]    # queued leaders
        spec_served = [0.0] * T        # weighted-fair virtual service
        full_served = [0.0] * T
        edge_free = list(range(R))     # free speculation dispatch slots
        max_inflight_spec = 0          # edge-pool concurrency high-water
        inflight_full = 0              # busy cloud-pool workers
        max_inflight = 0               # pool-concurrency high-water mark
        timer_armed = False
        spec_batches = full_batches = full_retrievals = 0

        # -- SLO-aware overload control (fluid-model predictor) ------------
        # Steady-state drain rates of the two stages from the modeled
        # service times; the predictor is the QUEUE WAIT a reject-path
        # request admitted NOW would see — everything queued or in flight
        # ahead of it at both stages, over each stage's drain rate.
        # Service time itself is load-independent (the part no admission
        # decision can avoid), so the trigger is on the waiting alone.
        # Hysteresis (enter above the deadline, exit at
        # overload_exit_frac of it) keeps the policy a deterministic step
        # function of the virtual clock.
        policy = sc.overload_policy
        overloaded = False
        if policy != "none":
            mean_cloud_rtt = 0.5 * (lat.cloud_rtt[0] + lat.cloud_rtt[1])
            spec_rate = (R * sc.max_spec_batch
                         / self._spec_time(sc.max_spec_batch))
            cloud_rate = (self.n_full_workers * sc.full_batch
                          / (self._full_time(sc.full_batch)
                             + mean_cloud_rtt))

        def predicted_wait() -> float:
            n_adm = sum(len(q) for q in admission)
            n_lead = sum(len(q) for q in leaders)
            busy_spec = R - len(edge_free)
            # pessimistic: by the time this request is rejected at the
            # edge, everything admitted ahead of it may have been rejected
            # too — the admission backlog feeds BOTH stage queues on the
            # reject path the SLO must cover
            return ((n_adm + busy_spec * sc.max_spec_batch) / spec_rate
                    + (n_adm + n_lead + inflight_full * sc.full_batch)
                    / cloud_rate)

        def update_overload():
            nonlocal overloaded
            p = predicted_wait()
            if overloaded:
                overloaded = p > sc.overload_exit_frac * sc.slo_deadline_s
            else:
                overloaded = p > sc.slo_deadline_s

        def fair_pick(queues, served, limit, quota=None):
            """Pop up to ``limit`` requests across per-tenant FIFO queues:
            repeatedly take from the non-empty tenant with the lowest
            weighted virtual service (ties -> lowest tenant id), bumping
            its counter by 1/weight.  ``quota`` caps one tenant's rows per
            call (admission quota — strict isolation knob)."""
            picked, taken = [], [0] * T
            while len(picked) < limit:
                best, best_key = -1, None
                for u in range(T):
                    if not queues[u] or (quota is not None
                                         and taken[u] >= quota):
                        continue
                    key = served[u]
                    if best_key is None or key < best_key:
                        best, best_key = u, key
                if best < 0:
                    break
                picked.append(queues[best].popleft())
                served[best] += 1.0 / self.tenant_weights[best]
                taken[best] += 1
            return picked

        # fixed-shape sharing registry over ALL pending (queued + in-flight)
        # leaders; new rejects are scored against it in one device call
        reg_vals = np.full((cap, self.cfg.k), -1, np.int32)
        reg_valid = np.zeros(cap, bool)
        reg_tenant = np.zeros(cap, np.int32)
        reg_req: list[_Request | None] = [None] * cap
        # min-heap of free slot ids: pop -> lowest, O(log cap) per
        # completion (identical lowest-slot-first allocation as the old
        # descending-sorted list, without its O(cap log cap) re-sort —
        # the golden-trace tests pin the equivalence)
        free_slots = list(range(cap))

        def registry_add(r: _Request):
            if not free_slots:
                return                      # registry full: r stays a leader
            slot = heapq.heappop(free_slots)
            reg_vals[slot] = r.val_ids
            reg_valid[slot] = True
            reg_tenant[slot] = r.tenant
            reg_req[slot] = r
            r.slot = slot

        def registry_remove(r: _Request):
            if r.slot >= 0:
                reg_valid[r.slot] = False
                reg_req[r.slot] = None
                heapq.heappush(free_slots, r.slot)
                r.slot = -1

        def _admit_chunk(group: list[_Request]):
            g = len(group)
            vals = np.concatenate([
                reg_vals,
                np.stack([r.val_ids for r in group]),
                np.full((sc.max_spec_batch - g, self.cfg.k), -1, np.int32)])
            rejected = np.zeros(cap + sc.max_spec_batch, bool)
            rejected[cap:cap + g] = True
            pending = np.concatenate(
                [reg_valid, np.zeros(sc.max_spec_batch, bool)])
            if T == 1:
                share_tids = None
            else:
                # tenant tags for registry rows + the group + inert padding:
                # the election masks cross-tenant pairs, so a follower can
                # only attach to a leader of its own partition
                share_tids = np.concatenate([
                    reg_tenant,
                    np.array([r.tenant for r in group], np.int32),
                    np.zeros(sc.max_spec_batch - g, np.int32)])
            out = intra_batch_share(as_i32(vals, self.device), rejected,
                                    np.float32(self._share_tau), pending,
                                    share_tids, backend=sc.backend)
            leader_of = out["leader"].cpu().numpy()
            is_leader = out["is_leader"].cpu().numpy()
            for j, r in enumerate(group):
                row = cap + j
                if is_leader[row]:
                    leaders[r.tenant].append(r)
                    registry_add(r)
                    r.stage = "cloudq"
                else:
                    li = leader_of[row]
                    lead = reg_req[li] if li < cap else group[li - cap]
                    lead.followers.append(r)
                    r.lead, r.stage = lead, "follower"

        def admit_rejects(group: list[_Request]):
            """Share-or-lead election for newly rejected requests against the
            pending-leader registry + each other (admission order)."""
            if not sc.share:
                for r in group:
                    leaders[r.tenant].append(r)
                    registry_add(r)
                    r.stage = "cloudq"
                return
            for i in range(0, len(group), sc.max_spec_batch):
                _admit_chunk(group[i:i + sc.max_spec_batch])

        def dispatch_spec(t: float):
            nonlocal seq, spec_batches, max_inflight_spec, replica_rebuilds
            # staleness-aware admission: the batch goes to the freshest
            # free replica (highest cache version); R == 1 — the lone slot
            # is the primary itself (zero lag, the historical path)
            r_id = edge_free[0] if pool is None else pool.freshest(edge_free)
            edge_free.remove(r_id)
            # bounded-lag replay ON the clock: a replica edge_sync_every or
            # more rows behind catches up before its batch runs, and the
            # replay occupies the dispatching slot (compat mode keeps the
            # historical free record_batch-time cadence instead)
            replay_s = 0.0
            if (pool is not None and not sc.free_ingest_replay
                    and pool.lag(r_id) >= sc.edge_sync_every):
                try:
                    rows = pool.sync(r_id)
                    replay_s = lat.ingest_time(rows, self.cfg.doc_cap,
                                               self.cfg.k)
                except (ValueError, LookupError):
                    # delta rows lost in transit (fault plan delta_drop):
                    # replay hit a sequence gap, or the cursor fell behind
                    # the log base entirely — full resync from the primary
                    # instead of serving a diverged cache, charged to the
                    # dispatching slot like any replay
                    pool.resync_from(r_id, self.state, pool.log.head)
                    replay_s = lat.ingest_time(
                        min(pool.log.head, self.cfg.h_max),
                        self.cfg.doc_cap, self.cfg.k)
                    replica_rebuilds += 1
            spec_state = self.state if pool is None else pool.states[r_id]
            version = -1 if pool is None else pool.version(r_id)
            batch = fair_pick(admission, spec_served, sc.max_spec_batch,
                              sc.tenant_quota)
            embs = np.zeros((sc.max_spec_batch, self.s.world.cfg.d),
                            np.float32)
            for j, r in enumerate(batch):
                embs[j] = r.q["emb"]
                r.edge_rtt = rtt_rng.uniform(*lat.edge_rtt)
            if T == 1:
                spec_tids = None
            else:
                batch_tids = np.zeros(sc.max_spec_batch, np.int32)
                for j, r in enumerate(batch):
                    batch_tids[j] = r.tenant
                spec_tids = batch_tids
            # acceptance is decided against the SERVING replica's own cache
            # version — a stale replica can only accept drafts its cache
            # actually supports (no phantom accepts); only the first
            # len(batch) rows are read (the zero padding moves no pointer)
            out = speculate_batch(self.cfg, spec_state, self.index, embs,
                                  backend=sc.backend, tenant_ids=spec_tids)
            accepts = out["accept"].cpu().numpy()
            drafts = out["draft_ids"].cpu().numpy()
            val_ids = out["val_ids"].cpu().numpy()
            spec_s = self._spec_time(len(batch))
            t_done = t + replay_s + spec_s
            for j, r in enumerate(batch):
                r.replica, r.cache_version = r_id, version
                # hop sub-queries pre-charge their synthesis reasoning to
                # the reason span; the wait starts when it ends (exact
                # no-op for plain requests: x - 0.0 == x)
                r.spans["queue_wait"] += t - r.t_arrive - r.spans["reason"]
                r.spans["replay"] += replay_s
                r.spans["spec"] += spec_s
                r.stage, r.t_sdone = "spec", t_done
                if accepts[j]:
                    r.ids, r.channel = drafts[j], "draft"
                else:
                    r.val_ids, r.draft_ids = val_ids[j], drafts[j]
            heapq.heappush(heap, (t_done, _SPEC_DONE, seq,
                                  (batch, r_id, spec_epoch[r_id])))
            seq += 1
            if fault_mode:
                spec_inflight[r_id] = (batch, t, replay_s, spec_s)
            max_inflight_spec = max(max_inflight_spec, R - len(edge_free))
            spec_batches += 1

        def try_spec(t: float):
            # speculation batches of later admissions overlap on DIFFERENT
            # replicas, the way full retrievals overlap on cloud workers
            while edge_free and any(admission):
                dispatch_spec(t)

        # -- fault-mode cloud dispatch machinery ---------------------------
        # A cloud "group" is one logical batch (leaders + ids) that may be
        # executed by SEVERAL dispatches over its lifetime: the original
        # attempt, backoff retries after transient failures, and hedged
        # re-dispatches racing a straggler.  The first live completion
        # wins; span attribution keeps conservation exact (cloud = the
        # winner's service, retry_backoff = accumulated backoff waits,
        # lost = everything else thrown away between first dispatch and
        # completion).  None of this exists fault-free.

        def cloud_dispatch(g, w, t):
            """Push one cloud attempt of group g on worker w."""
            nonlocal seq
            b = len(g["batch"])
            mult = inj.latency_multiplier(w, t)
            cloud = rtt_rng.uniform(*lat.cloud_rtt) + self._full_time(b) * mult
            disp = {"g": g, "w": w, "t_disp": t,
                    "fails": inj.search_fails(w, t), "live": True}
            g["dispatches"].append(disp)
            busy[w] = disp
            heapq.heappush(heap, (t + cloud, _FULL_DONE, seq, disp))
            seq += 1
            if sc.hedge_after is not None:
                # per-dispatch deadline: adaptive (trailing median of
                # completed attempts) once warmed up, model-derived before
                dl = detector.deadline
                if dl is None:
                    dl = sc.hedge_after * (self._full_time(b)
                                           + lat.cloud_rtt[1])
                disp["dl"] = dl
                heapq.heappush(heap, (t + dl, _DEADLINE, seq, disp))
                seq += 1

        def free_worker(w):
            nonlocal inflight_full
            busy.pop(w, None)
            inflight_full -= 1
            if w not in dead_workers:
                cloud_free.append(w)

        def requeue_group(g, t):
            """Worker crashed under the group's only live dispatch: charge
            the wasted attempt and put the batch back at the FRONT of the
            full-retrieval queue (it has waited longest)."""
            nonlocal retries
            g["done"] = True
            retries += 1
            for r in reversed(g["batch"]):
                if r.cancelled and r.t_done < 0:
                    # cancelled while the attempt was in flight: the crash
                    # settles it now — nothing requeues, the whole attempt
                    # was waste; live followers re-enter the election
                    r.spans["lost"] += max(0.0, r.t_cancel - g["t_first"])
                    fin_cancel(r, r.t_cancel)
                    registry_remove(r)
                    readmit, r.followers = r.followers, []
                    live = []
                    for f in readmit:
                        cq = max(0.0, g["t_first"] - f.t_rejected)
                        f.spans["cloud_queue"] += cq
                        if f.cancelled and f.t_done < 0:
                            f.spans["lost"] += max(
                                0.0, (f.t_cancel - f.t_rejected) - cq)
                            fin_cancel(f, f.t_cancel)
                            continue
                        f.spans["lost"] += max(0.0, (t - f.t_rejected) - cq)
                        f.t_rejected = t
                        live.append(f)
                    admit_rejects(live)
                    continue
                r.spans["retry_backoff"] += g["backoff_s"]
                r.spans["lost"] += max(0.0,
                                       (t - g["t_first"]) - g["backoff_s"])
                kept = []
                for f in r.followers:
                    cq = max(0.0, g["t_first"] - f.t_rejected)
                    f.spans["cloud_queue"] += cq
                    if f.cancelled and f.t_done < 0:
                        f.spans["lost"] += max(
                            0.0, (f.t_cancel - f.t_rejected) - cq)
                        fin_cancel(f, f.t_cancel)
                        continue
                    f.spans["lost"] += max(0.0, (t - f.t_rejected) - cq)
                    f.t_rejected = t
                    kept.append(f)
                r.followers = kept
                r.t_rejected = t
                r.stage = "cloudq"
                leaders[r.tenant].appendleft(r)

        def fail_group(g, t):
            """Retry budget exhausted: the batch fails hard — ``failed``
            channel, sentinel ids, accept False.  Orphaned followers
            re-enter the sharing election (their leader delivered
            nothing; they still need results)."""
            g["done"] = True
            for r in g["batch"]:
                if r.cancelled and r.t_done < 0:
                    # cancelled mid-flight: it finalizes as cancelled, not
                    # failed — the chain already moved on without it
                    r.spans["lost"] += max(0.0, r.t_cancel - g["t_first"])
                    fin_cancel(r, r.t_cancel)
                    registry_remove(r)
                else:
                    r.spans["retry_backoff"] += g["backoff_s"]
                    r.spans["lost"] += max(0.0,
                                           (t - g["t_first"])
                                           - g["backoff_s"])
                    r.ids = np.full(self.cfg.k, -1, np.int32)
                    r.channel = "failed"
                    r.t_done = t
                    r.stage = "done"
                    registry_remove(r)
                readmit, r.followers = r.followers, []
                live = []
                for f in readmit:
                    cq = max(0.0, g["t_first"] - f.t_rejected)
                    f.spans["cloud_queue"] += cq
                    if f.cancelled and f.t_done < 0:
                        f.spans["lost"] += max(
                            0.0, (f.t_cancel - f.t_rejected) - cq)
                        fin_cancel(f, f.t_cancel)
                        continue
                    f.spans["lost"] += max(0.0, (t - f.t_rejected) - cq)
                    f.t_rejected = t
                    live.append(f)
                admit_rejects(live)
                # a failed hop still resolves: the chain proceeds on the
                # guessed bridge (hit False) instead of hanging forever
                if agentic and r.cq is not None and not r.cancelled:
                    resolve(r, r.t_done)

        def complete_group(t, winner):
            """First live completion wins the group: racing dispatches are
            cancelled (their workers free NOW — the winner's result serves
            everyone) and the batch completes with fault-aware span
            attribution summing exactly to each request's latency."""
            nonlocal ingest_seq
            g = winner["g"]
            g["done"] = True
            for d in g["dispatches"]:
                if d["live"]:
                    d["live"] = False
                    free_worker(d["w"])
            detector.observe(full_batches, t - winner["t_disp"])
            batch, ids_full = g["batch"], g["ids_full"]
            n_rows = sum(not r.cancelled for r in batch)
            if sc.ingest_followers:
                n_rows += sum(sum(not f.cancelled for f in r.followers)
                              for r in batch)
            ingest_s = (0.0 if sc.free_ingest_replay else
                        lat.ingest_time(n_rows, self.cfg.doc_cap,
                                        self.cfg.k))
            winner_cloud = t - winner["t_disp"]
            for j, r in enumerate(batch):
                lead_ids = ids_full[j].astype(np.int32)
                if r.cancelled:
                    # cancelled while the group raced faults: everything
                    # it paid for past its first dispatch was waste
                    r.spans["lost"] += max(0.0, r.t_cancel - g["t_first"])
                    fin_cancel(r, r.t_cancel)
                    registry_remove(r)
                else:
                    r.ids = lead_ids
                    r.channel = "full"
                    r.cloud_s = winner_cloud
                    r.spans["cloud"] += winner_cloud
                    r.spans["retry_backoff"] += g["backoff_s"]
                    r.spans["lost"] += max(0.0,
                                           (t - g["t_first"]) - winner_cloud
                                           - g["backoff_s"])
                    r.spans["ingest"] += ingest_s
                    r.spans["edge_rtt"] += r.edge_rtt
                    r.t_done = t + ingest_s + r.edge_rtt
                    r.stage = "done"
                    registry_remove(r)
                for f in r.followers:
                    if f.cancelled:
                        cq = max(0.0, min(g["t_first"], f.t_cancel)
                                 - f.t_rejected)
                        f.spans["cloud_queue"] += cq
                        f.spans["lost"] += max(
                            0.0, (f.t_cancel - f.t_rejected) - cq)
                        fin_cancel(f, f.t_cancel)
                        f.leader_idx = r.idx
                        continue
                    f.ids = (follower_rerank(f, lead_ids)
                             if sc.follower_score_weighted else lead_ids)
                    f.channel = "shared"
                    f.cloud_s = winner_cloud
                    # the follower waited through whatever mix of queue /
                    # service / backoff / waste its leader's group saw
                    # after it attached — split its wait the same way
                    cq = max(0.0, g["t_first"] - f.t_rejected)
                    rem = (t - f.t_rejected) - cq
                    cloud_part = min(rem, winner_cloud)
                    backoff_part = min(rem - cloud_part, g["backoff_s"])
                    f.spans["cloud_queue"] += cq
                    f.spans["cloud"] += cloud_part
                    f.spans["retry_backoff"] += backoff_part
                    f.spans["lost"] += max(0.0,
                                           rem - cloud_part - backoff_part)
                    f.spans["ingest"] += ingest_s
                    f.spans["edge_rtt"] += f.edge_rtt
                    f.t_done = t + ingest_s + f.edge_rtt
                    f.stage = "done"
                    f.leader_idx = r.idx
                if agentic:
                    if r.cq is not None and not r.cancelled:
                        resolve(r, r.t_done)
                    for f in r.followers:
                        if f.cq is not None and not f.cancelled:
                            resolve(f, f.t_done)
            self._ingest(batch, ingest_key=ingest_seq)
            ingest_seq += 1

        def dispatch_full(t: float):
            nonlocal inflight_full, max_inflight, seq, full_batches, \
                full_retrievals
            batch = fair_pick(leaders, full_served, sc.full_batch)
            if agentic:
                # popped from the queues: a resolve-triggered cancel fired
                # by the re-validation below must DEFER (stage "cloud"),
                # not search the deques these rows just left
                for r in batch:
                    r.stage = "cloud"
            # late re-validation: results ingested while these leaders
            # queued may re-identify them now — no cloud work needed
            if sc.revalidate:
                vids = np.full((sc.full_batch, self.cfg.k), -1, np.int32)
                vtids = np.zeros(sc.full_batch, np.int32)
                for j, r in enumerate(batch):
                    vids[j] = r.val_ids
                    vtids[j] = r.tenant
                acc = self._revalidate(vids, vtids)
                survivors = []
                for j, r in enumerate(batch):
                    # rerouted-after-replica-crash rows carry sentinel
                    # val_ids — they always need the real retrieval
                    if acc[j] and not r.reroute:
                        r.ids, r.channel = r.draft_ids, "reval"
                        r.spans["reval_wait"] += t - r.t_rejected
                        r.spans["edge_rtt"] += r.edge_rtt
                        r.t_done = t + r.edge_rtt
                        r.stage = "done"
                        registry_remove(r)
                        # orphaned followers re-enter the election
                        readmit_followers(r)
                        if agentic and r.cq is not None:
                            resolve(r, r.t_done)
                    else:
                        survivors.append(r)
                batch = survivors
            if agentic:
                # settle members the re-validation resolves cancelled:
                # they were never dispatched — their wait ends at the
                # cancel instant, their followers re-enter the election
                live = []
                for r in batch:
                    if r.cancelled and r.t_done < 0:
                        r.spans["cloud_queue"] += r.t_cancel - r.t_rejected
                        fin_cancel(r, r.t_cancel)
                        registry_remove(r)
                        readmit_followers(r)
                    else:
                        live.append(r)
                batch = live
            b = len(batch)
            if not b:
                return
            embs = np.zeros((sc.full_batch, self.s.world.cfg.d), np.float32)
            for j, r in enumerate(batch):
                embs[j] = r.q["emb"]
                r.spans["cloud_queue"] += t - r.t_rejected
            # one coalesced backend dispatch retrieves every leader; the
            # pool slot stays busy for the modeled service time
            term_kw = {}
            if getattr(self.s.backend, "uses_lexical", False):
                # hybrid cloud stage: thread each leader's query terms into
                # the same dispatch (fixed width keeps the jit cache warm;
                # empty slots stay -1/0 and the lexical channel ignores them)
                tw_w = self.s.backend.q_term_width
                terms = np.full((sc.full_batch, tw_w), -1, np.int32)
                tws = np.zeros((sc.full_batch, tw_w), np.float32)
                for j, r in enumerate(batch):
                    qt = np.asarray(r.q.get("terms", ()), np.int32)[:tw_w]
                    qw = np.asarray(
                        r.q.get("term_weights", ()), np.float32)[:tw_w]
                    terms[j, :qt.shape[0]] = qt
                    tws[j, :qw.shape[0]] = qw
                term_kw = dict(q_terms=as_i32(terms, self.device),
                               q_term_weights=as_f32(tws, self.device))
            _, ids_full = self.s.backend.search(as_f32(embs, self.device),
                                                **term_kw)
            ids_full = ids_full.cpu().numpy()
            if not fault_mode:
                cloud = rtt_rng.uniform(*lat.cloud_rtt) + self._full_time(b)
                heapq.heappush(heap, (t + cloud, _FULL_DONE, seq,
                                      (batch, ids_full, cloud)))
                seq += 1
                inflight_full += 1
                max_inflight = max(max_inflight, inflight_full)
            else:
                w = min(cloud_free)
                cloud_free.remove(w)
                inflight_full += 1
                max_inflight = max(max_inflight, inflight_full)
                g = {"batch": batch, "ids_full": ids_full, "t_first": t,
                     "backoff_s": 0.0, "fails": 0, "done": False,
                     "dispatches": []}
                cloud_dispatch(g, w, t)
            full_batches += 1
            full_retrievals += b

        def try_full(t: float):
            nonlocal timer_armed, seq
            # fault mode tracks worker IDENTITY (crashes / stragglers are
            # per-worker); the free-list gate degenerates to the historical
            # counter gate when nobody ever dies
            while ((len(cloud_free) > 0 if fault_mode
                    else inflight_full < self.n_full_workers)
                   and any(leaders)):
                n_lead = sum(len(q) for q in leaders)
                oldest = min(q[0].t_rejected for q in leaders if q)
                deadline = oldest + sc.full_max_wait_s
                if n_lead < sc.full_batch and t < deadline:
                    if not timer_armed:
                        heapq.heappush(heap, (deadline, _FULL_TIMER, seq,
                                              None))
                        seq += 1
                        timer_armed = True
                    return
                dispatch_full(t)

        def follower_rerank(f: _Request, ids: np.ndarray) -> np.ndarray:
            """Rerank the leader's shared D_full by the FOLLOWER's own
            query-doc scores (stable descending; padded ids last) — the
            homology overlap that elected the pair is order-insensitive,
            so this changes which docs the follower serves first and its
            cache row, never the election itself."""
            scores = np.where(ids >= 0,
                              self._corpus_np[np.maximum(ids, 0)]
                              @ np.asarray(f.q["emb"], np.float32),
                              -np.inf)
            return ids[np.argsort(-scores, kind="stable")]

        # -- agentic hop-graph machinery (inert on plain traces) -----------
        # The continuation protocol: every site that finalizes a request
        # (sets t_done + channel) calls resolve(); resolution reasons out
        # the next hop's bridge entity and spawns it, confirms or cancels
        # the pre-speculated child, and closes the chain on the final hop.
        # All rng the graph consumes lives in per-(query, hop) HopPlan
        # substreams — never the scheduler's rtt_rng — so agentic traffic
        # cannot perturb the plain requests sharing the stream.

        def spawn_hop(cx, h: int, entity: int, t: float,
                      speculative: bool) -> _Request:
            """Synthesize hop ``h``'s sub-query from the (resolved or
            drafted) bridge entity: the reasoning step runs t -> t +
            reason_s on the clock (pre-charged to the new request's
            ``reason`` span), then the sub-query enters admission like any
            arrival, tenant-tagged with its chain's tenant."""
            nonlocal seq
            r = _Request(idx=len(reqs), q=cx.plan.query(h, entity),
                         t_arrive=t, tenant=cx.tenant, hop=h, cq=cx,
                         speculative=speculative, stage="reason")
            r.spans["reason"] = reason_s
            reqs.append(r)
            heapq.heappush(heap, (t + reason_s, _ARRIVE, seq, r))
            seq += 1
            return r

        def fin_cancel(r: _Request, t: float):
            """Finalize a cancelled hop: ``cancelled`` channel, sentinel
            ids (its row NEVER ingests), t_done at the settle instant —
            the caller has already balanced the spans to that instant."""
            r.channel = "cancelled"
            r.ids = np.full(self.cfg.k, -1, np.int32)
            r.t_done = t
            r.stage = "done"
            r.cq.cancelled += 1

        def cancel(r: _Request, t: float) -> bool:
            """Deterministically cancel a mis-speculated hop wherever it
            currently lives.  Queued states settle NOW (spans charged to
            ``t`` exactly — conservation stays bit-exact); in-flight cloud
            work cannot be unsent, so those flag and settle on their
            completion path at this cancel instant.  Returns False when
            the request already finalized (superseded wasted work)."""
            if r.t_done >= 0 or r.cancelled:
                return False
            r.cancelled = True
            r.t_cancel = t
            if r.stage == "reason":        # still synthesizing its query
                r.spans["reason"] = t - r.t_arrive
                fin_cancel(r, t)
            elif r.stage == "admit":
                admission[r.tenant].remove(r)
                r.spans["queue_wait"] += t - r.t_arrive - r.spans["reason"]
                fin_cancel(r, t)
            elif r.stage == "spec":        # mid-speculation: claw back the
                over = r.t_sdone - t       # not-yet-run tail of the batch
                cut = min(over, r.spans["spec"])
                r.spans["spec"] -= cut
                r.spans["replay"] -= over - cut
                fin_cancel(r, t)
            elif r.stage == "cloudq":      # queued leader
                leaders[r.tenant].remove(r)
                registry_remove(r)
                r.spans["cloud_queue"] += t - r.t_rejected
                fin_cancel(r, t)
                readmit_followers(r)       # orphans re-enter the election
            elif r.stage == "follower":
                if r.lead.stage == "cloud":
                    pass                   # leader's batch is in flight:
                    #                        its completion settles the
                    #                        follower at t_cancel
                else:
                    r.lead.followers.remove(r)
                    r.spans["cloud_queue"] += t - r.t_rejected
                    fin_cancel(r, t)
            elif r.stage == "cloud":
                # dispatched: drop the result on completion; deregister
                # NOW so no new follower attaches to a doomed leader
                registry_remove(r)
            return True

        def readmit_followers(r: _Request):
            """Detach ``r``'s followers for re-election, settling any that
            were cancelled while attached (their wait ends at t_cancel)."""
            readmit, r.followers = r.followers, []
            if agentic:
                live = []
                for f in readmit:
                    if f.cancelled and f.t_done < 0:
                        f.spans["cloud_queue"] += f.t_cancel - f.t_rejected
                        fin_cancel(f, f.t_cancel)
                    else:
                        live.append(f)
                readmit = live
            admit_rejects(readmit)

        def finish(cx, r: _Request, t: float):
            """Final hop resolved: the trailing answer-synthesis reasoning
            closes the chain.  Charged on the closing request's own clock
            when its completion IS the chain's last event; a pre-speculated
            final hop that landed before its bridge confirmed charges the
            complex query alone (the request's interval already ended)."""
            if t <= r.t_done:
                r.spans["reason"] += reason_s
                r.t_done += reason_s
                cx.t_done = r.t_done
            else:
                cx.t_done = t + reason_s
            cx.done = True
            cx.served = r.channel in ("draft", "reval", "shared", "full",
                                      "degraded")

        def resolve(r: _Request, t: float):
            """A hop request finalized at virtual time ``t`` (when its
            result reaches the agent): advance the owning hop graph."""
            cx = r.cq
            if cx is None or cx.done or r.cancelled:
                return
            if r.speculative:
                return      # parked: the parent hop's resolution decides
            h = r.hop
            if r.channel == "shed":
                # the chain lost a hop at admission: no bridge, no
                # downstream — the complex query aborts
                cx.done, cx.t_done, cx.served = True, t, False
                if cx.spec_child is not None:
                    cancel(cx.spec_child, t)
                    cx.spec_child = None
                return
            cx.accepts.append(r.channel in ("draft", "reval", "shared"))
            cx.hits.append(False if r.channel == "failed"
                           else cx.plan.hit(h, r.ids))
            cx.hop_idx.append(r.idx)
            if h == cx.plan.hops:
                finish(cx, r, t)
                return
            nxt = cx.plan.bridge(h, cx.hits[-1])
            child, cx.spec_child = cx.spec_child, None
            if child is not None:
                if not child.cancelled and child.q["entity"] == nxt:
                    # pre-speculation CONFIRMED: the drafted bridge matches
                    # the validated one — the in-flight (or finished)
                    # speculative hop becomes the authoritative
                    # continuation, keeping its head start
                    cx.prespec_hit = True
                    child.speculative = False
                    if child.t_done >= 0:
                        resolve(child, max(t, child.t_done))
                    return
                # MIS-SPECULATION: the validated bridge contradicts the
                # drafted one — cancel whatever is still cancellable and
                # re-enqueue the corrected hop (sequential timing from
                # here; a finished child is just superseded wasted work)
                cx.prespec_hit = False
                cancel(child, t)
            spawn_hop(cx, h + 1, nxt, t, speculative=False)

        while heap:
            t, kind, _, payload = heapq.heappop(heap)
            if kind == _ARRIVE:
                if payload.cancelled:
                    continue       # hop cancelled mid-reason: settled there
                if policy == "shed":
                    # admission control: reject NOW when the fluid model
                    # predicts a queue wait past the deadline — zero
                    # latency, zero resources, no rng draws
                    update_overload()
                    if overloaded:
                        payload.channel = "shed"
                        payload.ids = np.full(self.cfg.k, -1, np.int32)
                        # a shed hop still paid its synthesis reasoning
                        # (exact no-op for plain requests: x + 0.0 == x)
                        payload.t_done = (payload.t_arrive
                                          + payload.spans["reason"])
                        payload.stage = "done"
                        if agentic and payload.cq is not None:
                            resolve(payload, payload.t_done)
                            try_full(t)   # an abort-cancel may have drained
                            #               a queued leader and readmitted
                            #               its followers
                        continue
                payload.stage = "admit"
                admission[payload.tenant].append(payload)
                try_spec(t)
            elif kind == _SPEC_DONE:
                payload, r_id, epoch = payload
                if fault_mode:
                    if epoch != spec_epoch[r_id]:
                        # the replica died mid-speculation: the batch was
                        # already rerouted to the full channel and the slot
                        # is rebuilding — this completion is from a ghost
                        continue
                    spec_inflight.pop(r_id, None)
                edge_free.append(r_id)
                if policy == "degrade":
                    update_overload()
                rejected = []
                for r in payload:
                    if r.cancelled:
                        continue   # cancelled mid-spec: settled at cancel
                    if r.channel == "draft":
                        r.spans["edge_rtt"] += r.edge_rtt
                        r.t_done = t + r.edge_rtt
                        r.stage = "done"
                        if agentic and r.cq is not None:
                            resolve(r, r.t_done)
                    elif policy == "degrade" and overloaded:
                        # speculation-only under overload: the reject's
                        # draft returns immediately, unvalidated
                        # (accept=False), instead of queuing for the cloud
                        r.ids, r.channel = r.draft_ids, "degraded"
                        r.spans["edge_rtt"] += r.edge_rtt
                        r.t_done = t + r.edge_rtt
                        r.stage = "done"
                        if agentic and r.cq is not None:
                            resolve(r, r.t_done)
                    else:
                        r.t_rejected = t
                        rejected.append(r)
                        # cross-hop pre-speculation: this hop's DRAFT was
                        # rejected, but its drafted bridge entity is
                        # available NOW — launch the next hop from it,
                        # racing this hop's late re-validation / full
                        # retrieval; the authoritative resolution later
                        # confirms the child or cancels it (the plan's
                        # per-hop bridge draws are frozen, so agreeing
                        # hits imply agreeing bridges)
                        if (agentic and sc.speculate_hops
                                and r.cq is not None and not r.speculative
                                and not r.cq.done
                                and 0 < r.hop < r.cq.plan.hops
                                and r.cq.spec_child is None):
                            cx = r.cq
                            ent = cx.plan.bridge(
                                r.hop, cx.plan.hit(r.hop, r.draft_ids))
                            cx.spec_child = spawn_hop(
                                cx, r.hop + 1, ent, t, speculative=True)
                            cx.prespec = True
                admit_rejects(rejected)
                try_full(t)
                try_spec(t)
            elif kind == _FULL_DONE:
                if fault_mode:
                    disp = payload
                    g = disp["g"]
                    if not disp["live"] or g["done"]:
                        continue    # cancelled hedge loser / crashed worker
                    if disp["fails"]:
                        # transient search failure surfacing after the full
                        # service time: retry with exponential backoff on
                        # the same worker (held through the backoff), give
                        # up past the budget — unless a hedge is still
                        # racing (it IS the retry)
                        disp["live"] = False
                        g["fails"] += 1
                        if any(d["live"] for d in g["dispatches"]):
                            free_worker(disp["w"])
                        elif g["fails"] <= sc.retry_max:
                            delta = sc.retry_backoff_s * 2 ** (g["fails"] - 1)
                            g["backoff_s"] += delta
                            retries += 1
                            rec = {"g": g, "w": disp["w"], "live": True,
                                   "backoff": True}
                            busy[disp["w"]] = rec
                            heapq.heappush(heap, (t + delta, _RETRY, seq,
                                                  (g, disp["w"], rec)))
                            seq += 1
                        else:
                            free_worker(disp["w"])
                            fail_group(g, t)
                    else:
                        complete_group(t, disp)
                    try_full(t)
                    continue
                inflight_full -= 1               # ingest is EDGE work: the
                #                                  cloud worker frees at t
                batch, ids_full, cloud = payload
                n_rows = sum(not r.cancelled for r in batch)
                if sc.ingest_followers:
                    n_rows += sum(sum(not f.cancelled for f in r.followers)
                                  for r in batch)
                # the cache fold + replication fan-out of the whole batch,
                # charged to every request returning from it (the state
                # update itself lands at t: results are visible to the next
                # speculation the instant the cloud round trip ends)
                ingest_s = (0.0 if sc.free_ingest_replay else
                            lat.ingest_time(n_rows, self.cfg.doc_cap,
                                            self.cfg.k))
                t_d = t - cloud                  # this batch's dispatch time
                for j, r in enumerate(batch):
                    lead_ids = ids_full[j].astype(np.int32)
                    if r.cancelled:
                        # cancelled while in flight: the dispatch could not
                        # be unsent — service runs to the cancel instant,
                        # the result is dropped (never served, never
                        # ingested)
                        r.spans["cloud"] += max(0.0, r.t_cancel - t_d)
                        fin_cancel(r, r.t_cancel)
                        registry_remove(r)
                    else:
                        r.ids = lead_ids
                        r.channel = "full"
                        r.cloud_s = cloud
                        r.spans["cloud"] += cloud
                        r.spans["ingest"] += ingest_s
                        r.spans["edge_rtt"] += r.edge_rtt
                        r.t_done = t + ingest_s + r.edge_rtt
                        r.stage = "done"
                        registry_remove(r)
                    for f in r.followers:
                        if f.cancelled:
                            # its wait ends at ITS cancel instant
                            cq = max(0.0, min(t_d, f.t_cancel)
                                     - f.t_rejected)
                            f.spans["cloud_queue"] += cq
                            f.spans["cloud"] += max(
                                0.0, (f.t_cancel - f.t_rejected) - cq)
                            fin_cancel(f, f.t_cancel)
                            f.leader_idx = r.idx
                            continue
                        f.ids = (follower_rerank(f, lead_ids)
                                 if sc.follower_score_weighted else lead_ids)
                        f.channel = "shared"
                        f.cloud_s = cloud
                        # a follower may have attached AFTER its leader
                        # dispatched (in-flight leaders stay shareable):
                        # its cloud wait then starts at its own rejection
                        cq = max(0.0, t_d - f.t_rejected)
                        f.spans["cloud_queue"] += cq
                        f.spans["cloud"] += (t - f.t_rejected) - cq
                        f.spans["ingest"] += ingest_s
                        f.spans["edge_rtt"] += f.edge_rtt
                        f.t_done = t + ingest_s + f.edge_rtt
                        f.stage = "done"
                        f.leader_idx = r.idx
                    if agentic:
                        if r.cq is not None and not r.cancelled:
                            resolve(r, r.t_done)
                        for f in r.followers:
                            if f.cq is not None and not f.cancelled:
                                resolve(f, f.t_done)
                self._ingest(batch, ingest_key=ingest_seq)
                ingest_seq += 1
                try_full(t)
            elif kind == _FULL_TIMER:
                timer_armed = False
                try_full(t)
            elif kind == _FAULT:
                ev = payload
                if ev.kind == "worker_crash":
                    w = ev.target
                    if w in dead_workers:
                        continue                   # already down: coalesce
                    worker_deaths += 1
                    dead_workers.add(w)
                    if w in cloud_free:
                        cloud_free.remove(w)
                    rec = busy.pop(w, None)
                    if rec is not None:
                        # the crash takes the in-flight (or backing-off)
                        # dispatch with it; if that was the group's only
                        # live attempt, its queries requeue at the front
                        inflight_full -= 1
                        rec["live"] = False
                        g = rec["g"]
                        if (not g["done"]
                                and not any(d["live"]
                                            for d in g["dispatches"])):
                            requeue_group(g, t)
                    if ev.down_s > 0:
                        heapq.heappush(heap, (t + ev.down_s, _WORKER_UP,
                                              seq, w))
                        seq += 1
                    try_full(t)
                elif ev.kind == "replica_crash":
                    rho = ev.target
                    if rho in dead_replicas:
                        continue                   # already rebuilding
                    dead_replicas.add(rho)
                    spec_epoch[rho] += 1
                    if rho in edge_free:
                        edge_free.remove(rho)
                    else:
                        info = spec_inflight.pop(rho, None)
                        if info is not None:
                            # mid-speculation loss: undo the dispatch-time
                            # charges (the work never finished), reroute
                            # the batch to the full-retrieval channel —
                            # degraded latency, correct results
                            sbatch, t_disp, replay_s, spec_s = info
                            for r in sbatch:
                                if r.cancelled:
                                    continue   # settled at its cancel
                                r.spans["replay"] -= replay_s
                                r.spans["spec"] -= spec_s
                                r.spans["lost"] += t - t_disp
                                r.ids = None
                                r.channel = "pending"
                                r.val_ids = np.full(self.cfg.k, -1,
                                                    np.int32)
                                r.draft_ids = np.full(self.cfg.k, -1,
                                                      np.int32)
                                r.reroute = True
                                r.t_rejected = t
                                r.stage = "cloudq"
                            for r in reversed(sbatch):
                                if not r.cancelled:
                                    leaders[r.tenant].appendleft(r)
                    # background rebuild: install a primary snapshot (a
                    # full cache fold on the clock), then rejoin the pool
                    rb_s = lat.ingest_time(
                        min(pool.log.head, self.cfg.h_max),
                        self.cfg.doc_cap, self.cfg.k)
                    heapq.heappush(heap, (t + rb_s, _REBUILT, seq, rho))
                    seq += 1
                    try_full(t)
                else:
                    # straggler / search_fail windows, delta-channel
                    # faults: armed in the injector, consulted at
                    # dispatch / ingest time
                    inj.activate(ev)
            elif kind == _DEADLINE:
                disp = payload
                if not disp["live"] or disp["g"]["done"]:
                    continue                       # attempt already settled
                if cloud_free:
                    # hedged re-dispatch: race a fresh attempt on a free
                    # worker; first result wins, the loser is cancelled
                    w2 = min(cloud_free)
                    cloud_free.remove(w2)
                    inflight_full += 1
                    max_inflight = max(max_inflight, inflight_full)
                    hedges += 1
                    cloud_dispatch(disp["g"], w2, t)
                else:
                    heapq.heappush(heap, (t + disp["dl"], _DEADLINE, seq,
                                          disp))
                    seq += 1
            elif kind == _RETRY:
                g, w, rec = payload
                if busy.get(w) is not rec or g["done"]:
                    continue       # the worker crashed during the backoff
                # rotate AWAY from the failing worker when another is free
                # (a transient failure window is usually per-node, so a
                # same-worker retry tends to land back inside it); the held
                # slot is released to the pool either way
                if cloud_free:
                    w2 = min(cloud_free)
                    cloud_free.remove(w2)
                    del busy[w]
                    cloud_free.append(w)
                    cloud_dispatch(g, w2, t)
                    try_full(t)
                else:
                    cloud_dispatch(g, w, t)
            elif kind == _WORKER_UP:
                w = payload
                dead_workers.discard(w)
                cloud_free.append(w)
                try_full(t)
            else:                                  # _REBUILT
                rho = payload
                pool.resync_from(rho, self.state, pool.log.head)
                dead_replicas.discard(rho)
                edge_free.append(rho)
                replica_rebuilds += 1
                try_spec(t)

        # -- metrics (request-index order, shared substrate; spawned hop
        #    sub-queries appended after the input trace) -------------------
        rng = np.random.default_rng(seed)
        m = _metrics_init(len(reqs), llms)
        for r in reqs:
            accept = r.channel in ("draft", "reval", "shared")
            _record(m, r.idx, self.s.world, r.q, r.ids,
                    r.t_done - r.t_arrive, accept, dataset, llms, rng)
        t_arrive = np.array([r.t_arrive for r in reqs])
        t_done = np.array([r.t_done for r in reqs])
        channels = np.array([r.channel for r in reqs], dtype="U16")
        # -- complex-query (hop chain) records -----------------------------
        complex_records = hop_arr = parent_arr = spec_arr = None
        if agentic:
            complex_records = []
            for cx in graphs:
                H = cx.plan.hops
                full_chain = cx.done and len(cx.hits) == H
                complex_records.append({
                    "root_idx": cx.root_idx,
                    "tenant": cx.tenant,
                    "hops": H,
                    "t_start": cx.t_start,
                    "t_done": cx.t_done,
                    "e2e_s": (cx.t_done - cx.t_start if cx.done
                              else float("nan")),
                    # one reasoning step per hop: H-1 sub-query syntheses
                    # + the trailing answer synthesis
                    "reason_s": H * reason_s,
                    "served": bool(cx.served and full_chain),
                    "dar": (float(np.mean(cx.accepts)) if cx.accepts
                            else 0.0),
                    "accuracy": cx.plan.accuracy(
                        full_chain and all(cx.hits), dataset),
                    "prespec": cx.prespec,
                    "prespec_hit": cx.prespec_hit,
                    "cancelled": cx.cancelled,
                    "hop_idx": list(cx.hop_idx),
                })
            hop_arr = np.array([r.hop for r in reqs], np.int32)
            parent_arr = np.array(
                [r.cq.root_idx if r.cq is not None else -1 for r in reqs],
                np.int32)
            spec_arr = np.array([r.speculative for r in reqs], bool)
            if len(reqs) != n:
                tids = np.array([r.tenant for r in reqs], np.int32)
        return SchedResult(
            latencies=m["latencies"], accepts=m["accepts"],
            doc_hits=m["doc_hits"], correct_accepts=m["correct"], ra=m["ra"],
            t_arrive=t_arrive,
            t_done=t_done,
            cloud_s=np.array([r.cloud_s for r in reqs]),
            channels=channels,
            trace=(build_trace(reqs, t_arrive, t_done, channels)
                   if sc.trace else None),
            slo_deadline_s=sc.slo_deadline_s,
            full_retrievals=full_retrievals,
            spec_batches=spec_batches, full_batches=full_batches,
            retries=retries, hedges=hedges, worker_deaths=worker_deaths,
            replica_rebuilds=replica_rebuilds,
            max_inflight_full_batches=max_inflight,
            max_inflight_spec_batches=max(1, max_inflight_spec),
            edge_replays=0 if pool is None else pool.replays,
            replica_ids=np.array([r.replica for r in reqs], np.int32),
            cache_versions=np.array([r.cache_version for r in reqs],
                                    np.int64),
            tenant_ids=tids,
            leader_idx=np.array([r.leader_idx for r in reqs], np.int32),
            served_ids=np.stack([np.asarray(r.ids, np.int32)
                                 for r in reqs]) if reqs else None,
            hop=hop_arr, parent_root=parent_arr, speculative=spec_arr,
            complex_records=complex_records)


# canonical name for the continuous-batching HaS scheduler
HasScheduler = ContinuousBatchingScheduler
