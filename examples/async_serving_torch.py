"""Continuous-batching async serving on the PyTorch/CUDA port: open-loop
load on the scheduler.

    PYTHONPATH=src python examples/async_serving_torch.py [n_requests] [qps] [backend]
    PYTHONPATH=src python examples/async_serving_torch.py 300 25 flat --device cpu

The twin of ``examples/async_serving.py``: requests arrive as a Poisson
process; the event-driven scheduler (``repro_torch/serving/scheduler.py``)
coalesces admissions into speculation batches on the edge, returns
accepted drafts at once, collapses homologous rejects into shared full
retrievals, late-revalidates queued rejects against the freshly ingested
cache, and overlaps the cloud full-retrieval pipeline with ongoing edge
speculation.  The same positional arguments and printout; it runs on the
card unless ``--device cpu`` is given.

The cloud stage is ``flat`` (one in-process exact-scan worker).  The
reference's ``sharded`` backend (4 mesh-sharded workers) waits for the port
of ``ShardedMeshBackend`` (ROADMAP.md queue 1 item 7).  The fuzzy index
comes from the port's k-means, so numbers agree with the reference's
example only when both use one index (the parity test hands the
reference's across).
"""
import argparse

import numpy as np

from repro_torch.core.has import HasConfig
from repro_torch.data.synthetic import DATASETS, SyntheticWorld, WorldConfig
from repro_torch.serving.engine import HasEngine, RetrievalService
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           SchedulerConfig, poisson_arrivals)

N_ENTITIES = 5000
SEQ_QUERIES = 200
HAS_CFG = dict(k=10, tau=0.2, h_max=4000, nprobe=8, n_buckets=512, d=64)
SCHED_CFG = dict(max_spec_batch=32, full_batch=16, full_max_wait_s=0.05)
CHANNELS = ("draft", "reval", "shared", "full")


def run(n: int, qps: float, backend_name: str = "flat", device=None,
        n_entities: int = N_ENTITIES, index=None) -> dict:
    """The scheduler's result on a Poisson stream, beside the sequential
    ``HasEngine`` on its first ``SEQ_QUERIES`` queries: {"sched" (the
    ``SchedResult``), "summary", "seq", "n_full_workers"}.  ``index`` is a
    prebuilt fuzzy-channel index (None: the scheduler builds one, and the
    sequential engine shares it)."""
    if backend_name == "sharded":
        raise SystemExit("the sharded backend waits for the port of "
                         "ShardedMeshBackend (ROADMAP.md queue 1 item 7); "
                         "use flat")
    if backend_name != "flat":
        raise SystemExit(f"unknown backend {backend_name!r} "
                         "(choices: flat, sharded)")
    world = SyntheticWorld(WorldConfig(n_entities=n_entities, seed=0))
    service = RetrievalService(world, LatencyModel(), k=10, device=device)
    cfg = HasConfig(**HAS_CFG)
    ds = DATASETS["granola"]
    queries = world.sample_queries(n, pattern=ds["pattern"],
                                   zipf_a=ds["zipf_a"],
                                   p_uncovered=ds["p_uncovered"], seed=1)
    sched = ContinuousBatchingScheduler(
        service, cfg, SchedulerConfig(**SCHED_CFG), index=index)
    res = sched.serve(queries, poisson_arrivals(n, qps=qps, seed=7), seed=0)
    seq = HasEngine(service, cfg, index=sched.index).serve(
        queries[:SEQ_QUERIES]).summary()
    return {"sched": res, "summary": res.summary(), "seq": seq,
            "n_full_workers": sched.n_full_workers}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=600)
    ap.add_argument("qps", nargs="?", type=float, default=25.0)
    ap.add_argument("backend", nargs="?", default="flat")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = run(args.n, args.qps, args.backend, device=args.device)
    res, s, seq = out["sched"], out["summary"], out["seq"]

    print(f"open-loop load          {args.qps:.1f} qps Poisson, {args.n} "
          f"requests")
    print(f"cloud worker pool       {args.backend} backend, "
          f"{out['n_full_workers']} worker(s), peak concurrency "
          f"{s['max_inflight_full_batches']:.0f}")
    print(f"completed throughput    {s['throughput_qps']:.2f} qps "
          f"(makespan {s['makespan_s']:.1f} s)")
    print(f"latency p50/p95/p99     {s['p50_latency_s'] * 1e3:.0f} / "
          f"{s['p95_latency_s'] * 1e3:.0f} / "
          f"{s['p99_latency_s'] * 1e3:.0f} ms")
    print(f"draft acceptance (DAR)  {s['dar']:.1%}   doc-hit "
          f"{s['doc_hit_rate']:.1%}")
    for ch in CHANNELS:
        cnt = int(np.sum(res.channels == ch))
        lat_ch = res.latencies[res.channels == ch]
        med = np.median(lat_ch) * 1e3 if cnt else 0.0
        print(f"  channel {ch:<7} {cnt:>5} requests   median latency "
              f"{med:7.1f} ms")
    print(f"full retrievals paid    {s['full_retrievals']} "
          f"({s['shared_accepts']} homologous rejects shared one)")

    # closed-loop sequential reference on a prefix of the same stream
    print(f"\nsequential HasEngine    {1.0 / seq['avg_latency_s']:.2f} qps "
          f"(AvgL {seq['avg_latency_s']:.3f} s) — the scheduler overlaps "
          "cloud retrieval with edge speculation instead of serializing")


if __name__ == "__main__":
    main()
