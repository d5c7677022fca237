"""End-to-end RAG serving on the PyTorch/CUDA port: HaS retrieval + an LM
decoding answers.

    PYTHONPATH=src python examples/rag_serving_torch.py [n_requests]
    PYTHONPATH=src python examples/rag_serving_torch.py 16 --device cpu

The twin of ``examples/rag_serving.py``: the same ``rag-lm`` generator
(4 layers, d 256, 8/4 heads, d_ff 1024, vocab 4096, d_head 32, bf16), the
same world (5000 entities), ``HasConfig``, prompt (64 tokens), generation
(16 greedy steps), batch (8) and printed lines, served through
``repro_torch.serving.rag.serve_rag``:

  1. each query hits HaS (two-channel speculation + homology validation);
  2. its retrieved doc ids become context tokens for the generator;
  3. prefill gives the first token (TTFT), then greedy ``decode_step``s
     from a fresh KV cache (``decode_attention`` on the card).

It runs on the card unless ``--device cpu`` is given.  Its weights come
from the port's ``init_params`` (a ``torch.Generator``), not the
reference's ``jax.random.key(0)`` draws, and its fuzzy index from the
port's k-means, so its tokens and DAR equal the reference's only when both
are handed over (``run(params=..., index=...)``, as the parity test does).
"""
import argparse

import numpy as np

from repro_torch.core.has import HasConfig
from repro_torch.data.synthetic import DATASETS, SyntheticWorld, WorldConfig
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import HasEngine, RetrievalService
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.rag import serve_rag

N_ENTITIES = 5000
BATCH, PROMPT_LEN, GEN_LEN = 8, 64, 16
GEN_CFG = tf.TransformerConfig(
    name="rag-lm", n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
    d_ff=1024, vocab_size=4096, d_head=32)
HAS_CFG = dict(k=10, tau=0.2, h_max=4000, nprobe=8, n_buckets=512, d=64)


def run(n_requests: int, device=None, params=None, index=None) -> dict:
    """Serve ``n_requests`` granola queries; ``params`` (the generator's)
    and ``index`` (the fuzzy channel's) are drawn and built when None.
    Returns the ``RagResult``, the modelled full-scan time and the
    device."""
    world = SyntheticWorld(WorldConfig(n_entities=N_ENTITIES, seed=0))
    service = RetrievalService(world, LatencyModel(), k=10, device=device)
    if params is None:
        params = tf.init_params(GEN_CFG, seed=0, device=service.device)
    engine = HasEngine(service, HasConfig(**HAS_CFG), index=index)
    ds = DATASETS["granola"]
    queries = world.sample_queries(n_requests, pattern=ds["pattern"],
                                   zipf_a=ds["zipf_a"],
                                   p_uncovered=ds["p_uncovered"], seed=1)
    res = serve_rag(engine, queries, params, GEN_CFG, batch=BATCH,
                    prompt_len=PROMPT_LEN, gen_len=GEN_LEN,
                    device=service.device)
    return {"result": res, "full_scan_s": service.latency.full_scan_time(),
            "device": str(service.device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_requests", nargs="?", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"generator: {GEN_CFG.param_count() / 1e6:.1f}M params")
    out = run(args.n_requests, device=args.device)
    res = out["result"]
    print(f"requests served        {len(res.retrieval_s)}")
    print(f"retrieval avg latency  {np.mean(res.retrieval_s):.4f} s "
          f"(draft acceptance {np.mean(res.accepts):.1%})")
    print(f"prefill TTFT (batch)   {np.mean(res.ttft_s) * 1e3:.1f} ms")
    print(f"decode throughput      {np.mean(res.decode_tps):.1f} tok/s")
    print("\nFig-1 takeaway: full-DB retrieval would add "
          f"{out['full_scan_s']:.2f} s/query on top of a "
          f"{np.mean(res.ttft_s) * 1e3:.0f} ms TTFT; HaS cuts the "
          "retrieval term for every accepted draft.")
    return out


if __name__ == "__main__":
    main()
