"""HaS inside an Auto-RAG-style agentic pipeline (paper §IV-E II, Fig 13/14),
on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/agentic_multihop_torch.py [n_complex_queries]
    PYTHONPATH=src python examples/agentic_multihop_torch.py 200 --device cpu

The twin of ``examples/agentic_multihop.py``: complex 2-hop queries are
decomposed into sub-queries, and every sub-query is intercepted by HaS
with no change to the pipeline.  It runs on the card unless ``--device
cpu`` is given.  The fuzzy index comes from the port's k-means, so DAR and
accuracy agree with the reference's example only when both use one index
(``index=``; the parity test hands the reference's across).
"""
import argparse

from repro_torch.core.has import HasConfig
from repro_torch.data.synthetic import SyntheticWorld, WorldConfig
from repro_torch.serving.agentic import AutoRagPipeline, TwoHopDataset
from repro_torch.serving.engine import HasEngine, RetrievalService
from repro_torch.serving.latency import LatencyModel

N_ENTITIES = 8000
HAS_CFG = dict(k=10, tau=0.2, h_max=5000, nprobe=8, n_buckets=1024, d=64)


def run(n: int, device=None, n_entities: int = N_ENTITIES,
        index=None) -> dict:
    """Both pipelines' summaries on one world and sample: {"full", "has"}.
    ``index`` is a prebuilt fuzzy-channel index (None: HaS builds one)."""
    world = SyntheticWorld(WorldConfig(n_entities=n_entities, seed=0))
    service = RetrievalService(world, LatencyModel(), k=10, device=device)
    ds = TwoHopDataset(world, seed=0)
    complex_qs = ds.sample(n, seed=2)
    base = AutoRagPipeline(ds, None, service).run(complex_qs)
    engine = HasEngine(service, HasConfig(**HAS_CFG), index=index)
    plug = AutoRagPipeline(ds, engine, service).run(complex_qs)
    return {"full": base, "has": plug}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = run(args.n, device=args.device)
    base, plug = out["full"], out["has"]
    print("== Auto-RAG with full-database retrieval ==")
    for k, v in base.items():
        print(f"  {k:20s} {v:.4f}")
    print("== Auto-RAG + HaS (plug-in, no pipeline changes) ==")
    for k, v in plug.items():
        print(f"  {k:20s} {v:.4f}")
    cut = (plug["retrieval_latency"] - base["retrieval_latency"]) \
        / base["retrieval_latency"]
    dacc = plug["accuracy"] - base["accuracy"]
    print(f"\nretrieval latency: {cut:+.1%} (paper: -69.4%), "
          f"accuracy delta: {dacc:+.4f} (paper: -3.72%)")


if __name__ == "__main__":
    main()
