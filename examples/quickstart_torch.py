"""Quickstart on the PyTorch/CUDA port: HaS speculative retrieval vs
full-database retrieval.

    PYTHONPATH=src python examples/quickstart_torch.py [n_queries]
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of ``examples/quickstart.py``: builds the synthetic
entity-attribute world (the paper's Granola-EQ* analogue), serves a Zipf
query stream through HaS and through plain full-database retrieval, and
prints the paper's headline metrics side by side.  It runs on the card
unless ``--device cpu`` is given.  The fuzzy index comes from the port's
k-means, which cannot repeat the reference's ``jax.random`` draws, so
DAR, CAR and DocHit agree with ``examples/quickstart.py`` only when both
use one index (the parity test hands the reference's across).
"""
import argparse

from repro_torch.core.has import HasConfig
from repro_torch.data.synthetic import DATASETS, SyntheticWorld, WorldConfig
from repro_torch.serving.engine import (FullRetrievalEngine, HasEngine,
                                        RetrievalService)
from repro_torch.serving.latency import LatencyModel

N_ENTITIES = 8000
FULL_QUERIES = 400
HAS_CFG = dict(k=10, tau=0.2, h_max=5000, nprobe=8, n_buckets=1024, d=64)


def stream_kw() -> dict:
    ds = DATASETS["granola"]
    return dict(pattern=ds["pattern"], zipf_a=ds["zipf_a"],
                p_uncovered=ds["p_uncovered"])


def run(n_queries: int, device=None, n_entities: int = N_ENTITIES,
        index=None) -> dict:
    """Both engines' summaries on one world and stream: {"full", "has"}.
    ``index`` is a prebuilt fuzzy-channel index (None: HaS builds one)."""
    world = SyntheticWorld(WorldConfig(n_entities=n_entities, seed=0))
    service = RetrievalService(world, LatencyModel(), k=10, device=device)
    queries = world.sample_queries(n_queries, **stream_kw(), seed=1)
    full = FullRetrievalEngine(service).serve(queries[:FULL_QUERIES])
    has = HasEngine(service, HasConfig(**HAS_CFG), index=index)
    return {"full": full.summary(), "has": has.serve(queries).summary(),
            "n_docs": world.cfg.n_docs, "device": str(service.device)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_queries", nargs="?", type=int, default=1500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print(f"== world ({N_ENTITIES // 1000}k entities) on {args.device}, "
          f"{args.n_queries} queries ==")
    out = run(args.n_queries, device=args.device)
    print(f"   {out['n_docs']} passages")
    full, s = out["full"], out["has"]
    print("== full-database retrieval (cloud ENNS, 49.2M-passage scale) ==")
    for k in ("avg_latency_s", "doc_hit_rate", "ra_qwen3-8b"):
        print(f"  {k:16s} {full[k]:.4f}")
    print("== HaS (two-channel speculation + homology validation) ==")
    for k in ("avg_latency_s", "dar", "car", "l_at_da", "l_at_dr",
              "doc_hit_rate", "ra_qwen3-8b"):
        print(f"  {k:16s} {s[k]:.4f}")
    cut = (s["avg_latency_s"] - full["avg_latency_s"]) / full["avg_latency_s"]
    print(f"\n  retrieval latency change vs full DB: {cut:+.2%} "
          f"(paper: -23.74% Granola / -36.99% PopQA)")


if __name__ == "__main__":
    main()
