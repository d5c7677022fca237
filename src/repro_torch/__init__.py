"""PyTorch/CUDA port of HaS (homology-aware speculative retrieval).

Mirrors the layout of the JAX package ``repro``, which stays the reference:
``core/`` (speculation state and validation), ``kernels/`` (hand-written
CUDA kernels for Hopper beside their plain PyTorch versions),
``retrieval/`` (flat, sharded, IVF and hybrid search, the retrieval
service and its backends), ``serving/`` (engines, the scheduler, agentic
hop graphs, replication, latency model), ``launch/`` (the serving
entry point), ``training/`` (int8 quantization) and ``data/`` (the synthetic
world).  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""
