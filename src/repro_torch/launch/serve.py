"""Serving entry point: HaS speculative retrieval over a synthetic query
stream, on the PyTorch/CUDA port.

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 2000 --dataset granola --tau 0.2
  PYTHONPATH=src python -m repro_torch.launch.serve --engine sched --agentic-frac 0.25 --device cpu

The twin of ``repro/launch/serve.py``: the same flags, the same exit-2
validation and the same printout, plus ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path).  ``--retrieval-backend sharded``
runs the no-mesh sharded scan (one card has no device mesh), and the
fuzzy index comes from the port's k-means, so numbers agree with the
reference's ``serve`` only where both use one index.

Full-database retrieval is pluggable (``--retrieval-backend``, see
retrieval/service.py): ``flat`` is the in-process exact scan, ``sharded``
row-shards the corpus over ``--shards`` mesh workers
(``LatencyModel.shard_scale`` speedup + ``--workers`` concurrent cloud
dispatch slots for the scheduler's worker pool), ``replica`` routes through
``--workers`` warm standbys whose delta logs are reconciled on every cache
ingest.

Multi-tenant serving: ``--tenants N`` partitions the HaS cache into N
tenant slices (core/has.py::init_tenant_states; per-tenant capacity
``--h-max`` EACH) and assigns each query a tenant drawn from a Zipf
popularity law over tenants (``--tenant-zipf A``; 0 = uniform) — the
mixed-traffic shape the partitioning isolates.  Supported by the ``has``,
``crag`` and ``sched`` engines (the baselines have no per-tenant cache
state).

``--engine sched`` runs the continuous-batching scheduler
(serving/scheduler.py) over an open-loop Poisson arrival stream
(``--qps``; omit for fully saturated admission).  Its edge speculation
stage is a REPLICA POOL (serving/edge_pool.py): ``--edge-replicas R``
cache replicas each take speculation batches concurrently, kept within
``--edge-sync-every`` ingested rows of the primary by bounded-lag delta
replay.  R == 1 is the historical single-edge scheduler bit-exactly.

SLO-aware overload control (``--engine sched`` only): ``--slo-deadline S``
reports goodput against an end-to-end latency SLO, and
``--overload-policy shed|degrade`` keeps admitted-request p99 bounded past
saturation — shed rejects at admission, degrade serves speculation-only
drafts.  The result's per-stage virtual-clock breakdown (queue wait /
replay / spec / edge RTT / reval / cloud queue / cloud / ingest / lost /
retry backoff) is printed after the summary.

Agentic multi-hop serving (``--engine sched`` only): ``--agentic-frac F``
replaces a deterministic fraction F of the stream with COMPLEX multi-hop
queries (``--hops H`` chain length, serving/agentic.py) that enter
admission as their hop-1 sub-query; the scheduler resolves the hop graph
on the virtual clock — reasoning charged to the ``reason`` span, the next
hop pre-speculated from rejected drafts, mis-speculations cancelled
deterministically — and the summary grows per-complex-query aggregates
(chain e2e latency, DAR/accuracy, pre-speculation hit rates).
``--agentic-frac 0`` leaves the stream bit-identical to a build without
the hop-graph machinery.

Chaos serving (``--engine sched`` only): ``--fault-plan SPEC`` injects a
deterministic fault schedule on the virtual clock (serving/faults.py) —
``kind@t[,key=val]*`` events separated by ``;``, e.g.
``worker_crash@2.0,target=0,down=3.0;straggler@1.0,duration=5,factor=4``.
``--retry-max N`` bounds per-batch cloud retries (exponential backoff) and
``--hedge-after FACTOR`` sets the deadline multiple after which an
unfinished cloud dispatch is hedged onto a free worker.
"""
from __future__ import annotations

import argparse
import tempfile


def main(argv=None):
    """Parse ``argv``, serve, print the summary; returns the result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--dataset", default="granola",
                    choices=["granola", "popqa", "triviaqa", "squad"])
    ap.add_argument("--engine", default="has",
                    choices=["has", "full", "proximity", "saferadius",
                             "mincache", "crag", "ivf", "scann", "sched"])
    ap.add_argument("--retrieval-backend", default="flat",
                    choices=["flat", "sharded", "replica", "ann", "hybrid"],
                    help="full-retrieval backend (retrieval/service.py): "
                         "in-process flat scan, mesh-sharded concurrent "
                         "scan, warm-standby replicas, the IVF ANN "
                         "index (approximate; nprobe-calibrated), or the "
                         "hybrid lexical+dense channel pair with fused "
                         "RRF reranking (retrieval/fusion.py)")
    ap.add_argument("--hybrid-dense", default="flat",
                    choices=["flat", "sharded", "ann"],
                    help="dense channel of --retrieval-backend hybrid")
    ap.add_argument("--rrf-k", type=float, default=None,
                    help="reciprocal-rank-fusion constant for "
                         "--retrieval-backend hybrid: per-channel mass of "
                         "rank r is 1/(rrf_k + r) (default 60)")
    ap.add_argument("--diversify-sim", type=float, default=None,
                    help="near-duplicate suppression threshold for "
                         "--retrieval-backend hybrid: a fused candidate is "
                         "dropped when its cosine similarity to an already-"
                         "selected result is >= this (default 0.98; 1.0 "
                         "disables in practice)")
    ap.add_argument("--lexical-terms", type=int, default=None,
                    help="postings-row width cap (terms kept per doc) for "
                         "--retrieval-backend hybrid (default: the world's "
                         "full term width)")
    ap.add_argument("--shards", type=int, default=4,
                    help="corpus shards for --retrieval-backend sharded")
    ap.add_argument("--workers", type=int, default=None,
                    help="concurrent cloud dispatch slots (sharded/ann) / "
                         "standby replicas (replica); default 2.  Only "
                         "meaningful with a non-flat --retrieval-backend")
    ap.add_argument("--nprobe", type=int, default=32,
                    help="IVF buckets probed per query for "
                         "--retrieval-backend ann; calibrate with "
                         "benchmarks/ann_recall.py (recall feeds the HaS "
                         "cache, so too-low nprobe compounds end-to-end)")
    ap.add_argument("--ann-clusters", type=int, default=1024,
                    help="IVF centroid count for --retrieval-backend ann "
                         "(clamped to corpus_docs/8 for tiny corpora)")
    ap.add_argument("--compressed-corpus", action="store_true",
                    help="int8 centroid-residual compressed bucket residency "
                         "for --retrieval-backend ann (~3.6x smaller scan "
                         "operand; dequant fused into the kernel)")
    ap.add_argument("--tenants", type=int, default=1,
                    help="tenant partitions of the HaS cache (--h-max "
                         "capacity EACH); queries are tagged per tenant")
    ap.add_argument("--tenant-zipf", type=float, default=1.1,
                    help="Zipf exponent of the tenant popularity law "
                         "(0 = uniform traffic across tenants)")
    ap.add_argument("--edge-replicas", type=int, default=1,
                    help="edge speculation cache replicas for --engine "
                         "sched (serving/edge_pool.py); 1 == the "
                         "historical single-edge scheduler")
    ap.add_argument("--edge-sync-every", type=int, default=None,
                    help="bounded-lag replay cadence: an edge replica this "
                         "many ingested rows behind the primary replays "
                         "its missing delta rows (default 32)")
    ap.add_argument("--qps", type=float, default=None,
                    help="open-loop Poisson arrival rate for --engine "
                         "sched (omit for fully saturated admission)")
    ap.add_argument("--agentic-frac", type=float, default=0.0,
                    help="fraction of the stream served as complex "
                         "multi-hop (Auto-RAG) queries for --engine sched "
                         "(serving/agentic.py hop graphs inside the "
                         "scheduler); 0 disables agentic traffic entirely")
    ap.add_argument("--hops", type=int, default=2,
                    help="chain length of the complex queries injected by "
                         "--agentic-frac (2 == the paper's Fig-13 shape)")
    ap.add_argument("--slo-deadline", type=float, default=None,
                    help="end-to-end latency SLO in seconds for --engine "
                         "sched (reports goodput; required by "
                         "--overload-policy)")
    ap.add_argument("--overload-policy", default="none",
                    choices=["none", "shed", "degrade"],
                    help="overload control for --engine sched: shed "
                         "rejects at admission when the predicted "
                         "completion blows --slo-deadline; degrade serves "
                         "speculation-only drafts (accept=False) under "
                         "overload")
    ap.add_argument("--fault-plan", default=None,
                    help="deterministic fault schedule for --engine sched "
                         "(serving/faults.py grammar): ';'-separated "
                         "'kind@t[,key=val]*' events, kinds "
                         "worker_crash|straggler|search_fail|replica_crash"
                         "|delta_drop|delta_dup")
    ap.add_argument("--retry-max", type=int, default=None,
                    help="max cloud retries per batch after transient "
                         "failures (exponential backoff); --engine sched "
                         "with --fault-plan only (default 2)")
    ap.add_argument("--hedge-after", type=float, default=None,
                    help="hedge an unfinished cloud dispatch after this "
                         "multiple of its expected service time; must be "
                         "> 1; --engine sched with --fault-plan only "
                         "(default 2.5)")
    ap.add_argument("--tau", type=float, default=0.2)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--h-max", type=int, default=5000)
    ap.add_argument("--entities", type=int, default=20000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)

    # fail fast on invalid combinations instead of a downstream shape error
    if args.shards < 1:
        ap.error(f"--shards must be >= 1 (got {args.shards})")
    if args.workers is not None and args.workers < 1:
        ap.error(f"--workers must be >= 1 (got {args.workers})")
    if args.workers is not None and args.retrieval_backend == "flat":
        ap.error("--workers only applies to --retrieval-backend "
                 "sharded|replica|ann (the flat backend is one in-process "
                 "worker by definition)")
    if args.nprobe < 1:
        ap.error(f"--nprobe must be >= 1 (got {args.nprobe})")
    if args.ann_clusters < 1:
        ap.error(f"--ann-clusters must be >= 1 (got {args.ann_clusters})")
    if args.nprobe > args.ann_clusters:
        ap.error(f"--nprobe ({args.nprobe}) must be <= --ann-clusters "
                 f"({args.ann_clusters}): a query cannot probe more "
                 "buckets than the index has")
    if args.compressed_corpus and not (
            args.retrieval_backend == "ann"
            or (args.retrieval_backend == "hybrid"
                and args.hybrid_dense == "ann")):
        ap.error("--compressed-corpus only applies to an ANN dense stage "
                 "(--retrieval-backend ann, or hybrid with --hybrid-dense "
                 "ann); the exact backends scan the f32 corpus")
    if (args.hybrid_dense != "flat"
            and args.retrieval_backend != "hybrid"):
        ap.error("--hybrid-dense only applies to --retrieval-backend "
                 "hybrid (it selects hybrid's dense channel)")
    hybrid_flags = (("--rrf-k", args.rrf_k),
                    ("--diversify-sim", args.diversify_sim),
                    ("--lexical-terms", args.lexical_terms))
    if args.retrieval_backend != "hybrid":
        for name, val in hybrid_flags:
            if val is not None:
                ap.error(f"{name} only applies to --retrieval-backend "
                         "hybrid (the single-channel backends have no "
                         "fusion stage)")
    if args.rrf_k is not None and args.rrf_k < 1:
        ap.error(f"--rrf-k must be >= 1 (got {args.rrf_k}; rank 0 mass "
                 "1/rrf_k must stay bounded)")
    if args.diversify_sim is not None and not 0 < args.diversify_sim <= 1:
        ap.error(f"--diversify-sim must be in (0, 1] "
                 f"(got {args.diversify_sim}; cosine similarity range)")
    if args.lexical_terms is not None and args.lexical_terms < 1:
        ap.error(f"--lexical-terms must be >= 1 (got {args.lexical_terms})")
    if args.tenants < 1:
        ap.error(f"--tenants must be >= 1 (got {args.tenants})")
    if args.tenant_zipf < 0:
        ap.error(f"--tenant-zipf must be >= 0 (got {args.tenant_zipf})")
    if args.tenants > 1 and args.engine not in ("has", "crag", "sched"):
        ap.error(f"--tenants requires --engine has|crag|sched (the "
                 f"'{args.engine}' engine has no per-tenant cache state)")
    if args.edge_replicas < 1:
        ap.error(f"--edge-replicas must be >= 1 (got {args.edge_replicas})")
    if args.edge_sync_every is not None and args.edge_sync_every < 1:
        ap.error(f"--edge-sync-every must be >= 1 "
                 f"(got {args.edge_sync_every})")
    if args.edge_replicas > 1 and args.engine != "sched":
        ap.error("--edge-replicas only applies to --engine sched (the "
                 "sequential engines speculate against one cache by "
                 "definition)")
    if args.edge_sync_every is not None and args.engine != "sched":
        ap.error("--edge-sync-every only applies to --engine sched "
                 "(it paces the scheduler's edge replica pool)")
    if args.qps is not None and args.qps <= 0:
        ap.error(f"--qps must be > 0 (got {args.qps})")
    if args.qps is not None and args.engine != "sched":
        ap.error("--qps only applies to --engine sched (the other engines "
                 "serve a closed loop)")
    if not 0.0 <= args.agentic_frac <= 1.0:
        ap.error(f"--agentic-frac must be in [0, 1] "
                 f"(got {args.agentic_frac})")
    if args.hops < 1:
        ap.error(f"--hops must be >= 1 (got {args.hops}; a complex query "
                 "is a chain of at least one hop)")
    if args.agentic_frac > 0 and args.engine != "sched":
        ap.error("--agentic-frac only applies to --engine sched (the "
                 "hop-graph executor lives in the continuous-batching "
                 "scheduler; use benchmarks/fig13_agentic.py for the "
                 "sequential Auto-RAG pipeline)")
    if args.slo_deadline is not None and args.slo_deadline <= 0:
        ap.error(f"--slo-deadline must be > 0 (got {args.slo_deadline})")
    if ((args.slo_deadline is not None or args.overload_policy != "none")
            and args.engine != "sched"):
        ap.error("--slo-deadline/--overload-policy only apply to --engine "
                 "sched (the sequential engines have no admission queue "
                 "to control)")
    if args.overload_policy != "none" and args.slo_deadline is None:
        ap.error(f"--overload-policy {args.overload_policy} requires "
                 "--slo-deadline (the policy triggers on the predicted "
                 "completion blowing the deadline)")
    if args.fault_plan is not None and args.engine != "sched":
        ap.error("--fault-plan only applies to --engine sched (faults are "
                 "scheduled on the scheduler's virtual clock)")
    if args.retry_max is not None and args.retry_max < 0:
        ap.error(f"--retry-max must be >= 0 (got {args.retry_max})")
    if args.hedge_after is not None and args.hedge_after <= 1.0:
        ap.error(f"--hedge-after must be > 1 (got {args.hedge_after}; it "
                 "multiplies the expected service time, so <= 1 would "
                 "hedge every dispatch immediately)")
    if ((args.retry_max is not None or args.hedge_after is not None)
            and args.fault_plan is None):
        ap.error("--retry-max/--hedge-after require --fault-plan (the "
                 "self-healing machinery only engages under a non-empty "
                 "fault plan; a fault-free run is bit-identical without "
                 "it)")
    fault_plan = None
    if args.fault_plan is not None:
        from repro_torch.serving.faults import FaultPlan
        try:
            fault_plan = FaultPlan.parse(args.fault_plan)
        except ValueError as e:
            ap.error(f"--fault-plan: {e}")
    workers = 2 if args.workers is None else args.workers

    import numpy as np

    from repro_torch.core.has import HasConfig
    from repro_torch.data.synthetic import (DATASETS, SyntheticWorld,
                                            WorldConfig)
    from repro_torch.retrieval.service import (LocalFlatBackend,
                                               ReplicaBackend,
                                               ShardedMeshBackend)
    from repro_torch.serving.engine import (ANNSEngine, CRAGEngine,
                                            FullRetrievalEngine, HasEngine,
                                            ReuseEngine, RetrievalService)
    from repro_torch.serving.latency import LatencyModel
    from repro_torch.utils import as_f32, resolve_device

    device = resolve_device(args.device)
    world = SyntheticWorld(WorldConfig(n_entities=args.entities,
                                       seed=args.seed))
    latency = LatencyModel()
    corpus = as_f32(world.doc_emb, device)
    if args.retrieval_backend == "sharded":
        backend = ShardedMeshBackend(corpus, args.k, latency,
                                     n_shards=args.shards,
                                     n_workers=workers)
    elif args.retrieval_backend == "replica":
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.serving.replication import WarmStandby
        cfg0 = HasConfig(k=args.k, tau=args.tau, h_max=args.h_max,
                         nprobe=16, n_buckets=2048, d=world.cfg.d)
        standbys = [
            WarmStandby(cfg0, CheckpointManager(tempfile.mkdtemp(
                prefix=f"has-standby{i}-")), snapshot_every=10_000,
                max_lag=50_000, n_tenants=args.tenants, device=device)
            for i in range(workers)]
        backend = ReplicaBackend(
            LocalFlatBackend(corpus, args.k, latency), standbys, corpus)
    elif args.retrieval_backend == "ann":
        from repro_torch.retrieval.service import IVFBackend
        backend = IVFBackend(corpus, args.k, latency,
                             n_clusters=args.ann_clusters,
                             nprobe=args.nprobe,
                             compressed=args.compressed_corpus,
                             n_workers=workers, seed=args.seed,
                             device=device)
    elif args.retrieval_backend == "hybrid":
        from repro_torch.retrieval.service import HybridBackend
        backend = HybridBackend(
            corpus, args.k, latency,
            world.doc_terms, world.doc_term_weights,
            dense=args.hybrid_dense,
            rrf_k=60.0 if args.rrf_k is None else args.rrf_k,
            diversify_sim=(0.98 if args.diversify_sim is None
                           else args.diversify_sim),
            lexical_terms=args.lexical_terms,
            n_shards=args.shards, n_workers=workers,
            ann_kwargs=(dict(n_clusters=args.ann_clusters,
                             nprobe=args.nprobe,
                             compressed=args.compressed_corpus,
                             seed=args.seed)
                        if args.hybrid_dense == "ann" else None),
            device=device)
    else:
        backend = None                       # RetrievalService default: flat
    svc = RetrievalService(world, latency, k=args.k, backend=backend,
                           device=device)
    ds = DATASETS[args.dataset]
    queries = world.sample_queries(
        args.queries, pattern=ds["pattern"], zipf_a=ds["zipf_a"],
        p_uncovered=ds["p_uncovered"], seed=args.seed + 1)

    if args.tenants > 1:
        # tenant popularity ~ Zipf over tenant ranks (0 -> uniform traffic)
        ranks = np.arange(1, args.tenants + 1, dtype=np.float64)
        p = ranks ** -args.tenant_zipf
        p /= p.sum()
        trng = np.random.default_rng(args.seed + 2)
        tenant_of = trng.choice(args.tenants, size=len(queries), p=p)
        for q, t in zip(queries, tenant_of):
            q["tenant"] = int(t)

    n_agentic = 0
    if args.engine == "sched" and args.agentic_frac > 0:
        # deterministic mixed trace: a seeded draw picks which arrival
        # slots become complex queries; each keeps its slot's tenant tag
        # and enters admission as its hop-1 sub-query carrying the
        # HopPlan continuation
        from repro_torch.serving.agentic import (TwoHopDataset,
                                                 build_hop_trace)
        n_agentic = int(round(args.agentic_frac * len(queries)))
        if n_agentic:
            ag_ds = TwoHopDataset(world, seed=args.seed)
            cqs = ag_ds.sample(n_agentic, seed=args.seed + 4,
                               hops=args.hops)
            arng = np.random.default_rng(args.seed + 5)
            slots = np.sort(arng.choice(len(queries), n_agentic,
                                        replace=False))
            hop1 = build_hop_trace(
                ag_ds, cqs, seed=args.seed,
                tenants=[int(queries[i].get("tenant", 0)) for i in slots])
            for i, q in zip(slots, hop1):
                queries[int(i)] = q

    if args.engine == "has":
        engine = HasEngine(svc, HasConfig(
            k=args.k, tau=args.tau, h_max=args.h_max,
            nprobe=16, n_buckets=2048, d=world.cfg.d),
            n_tenants=args.tenants)
    elif args.engine == "full":
        engine = FullRetrievalEngine(svc)
    elif args.engine in ("proximity", "saferadius", "mincache"):
        engine = ReuseEngine(svc, args.engine, h_max=args.h_max)
    elif args.engine == "crag":
        engine = CRAGEngine(svc, HasConfig(
            k=args.k, tau=args.tau, h_max=args.h_max,
            nprobe=16, n_buckets=2048, d=world.cfg.d),
            n_tenants=args.tenants)
    elif args.engine == "sched":
        from repro_torch.serving.edge_pool import DEFAULT_EDGE_SYNC_EVERY
        from repro_torch.serving.scheduler import (
            ContinuousBatchingScheduler, SchedulerConfig, poisson_arrivals)
        mk = lambda: ContinuousBatchingScheduler(
            svc, HasConfig(k=args.k, tau=args.tau, h_max=args.h_max,
                           nprobe=16, n_buckets=2048, d=world.cfg.d),
            SchedulerConfig(
                n_tenants=args.tenants, edge_replicas=args.edge_replicas,
                edge_sync_every=(DEFAULT_EDGE_SYNC_EVERY
                                 if args.edge_sync_every is None
                                 else args.edge_sync_every),
                slo_deadline_s=args.slo_deadline,
                overload_policy=args.overload_policy,
                fault_plan=fault_plan,
                **({} if args.retry_max is None
                   else {"retry_max": args.retry_max}),
                **({} if args.hedge_after is None
                   else {"hedge_after": args.hedge_after})))
        try:
            engine = mk()
        except ValueError as e:
            # fault-plan vs topology mismatch (bad worker/replica target,
            # every worker crashed permanently, ...) — surface as a CLI
            # error, not a traceback
            ap.error(f"--fault-plan: {e}")
    else:
        engine = ANNSEngine(svc, method=args.engine)

    if args.engine == "sched":
        arrivals = (None if args.qps is None else poisson_arrivals(
            len(queries), qps=args.qps, seed=args.seed + 3))
        result = engine.serve(queries, arrivals, dataset=args.dataset,
                              seed=args.seed)
    else:
        result = engine.serve(queries, dataset=args.dataset, seed=args.seed)
    print(f"[serve] engine={args.engine} dataset={args.dataset} "
          f"retrieval-backend={args.retrieval_backend} "
          f"(n_workers={svc.backend.n_workers}) tenants={args.tenants}"
          + (f" edge-replicas={args.edge_replicas}"
             f" sync-every={engine.sched.edge_sync_every}"
             if args.engine == "sched" else "")
          + (f" agentic={n_agentic}/{args.queries} hops={args.hops}"
             if n_agentic else ""))
    for k, v in result.summary().items():
        print(f"  {k:20s} {v:.4f}")
    trace = getattr(result, "trace", None)
    if trace is not None and trace.n:
        print("  per-stage breakdown (virtual-clock seconds):")
        for stage, row in trace.stage_breakdown().items():
            print(f"    {stage:12s} total={row['total_s']:10.3f}  "
                  f"mean={row['mean_s']:8.4f}  frac={row['frac']:6.1%}")
    if args.tenants > 1:
        tids = np.array([q["tenant"] for q in queries])
        print(f"  tenant histogram     "
              f"{np.bincount(tids, minlength=args.tenants).tolist()}")
        # per-request slices must cover spawned hop sub-queries too (the
        # sched result's population can exceed the input trace)
        rtids = getattr(result, "tenant_ids", None)
        if rtids is not None and len(rtids) == len(result.accepts):
            tids = rtids
        for t in range(args.tenants):
            m = tids == t
            if m.any():
                print(f"  tenant[{t}] n={int(m.sum()):5d} "
                      f"dar={float(result.accepts[m].mean()):.4f} "
                      f"doc_hit={float(result.doc_hits[m].mean()):.4f}")
    return result


if __name__ == "__main__":
    main()
