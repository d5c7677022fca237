"""PyTorch/CUDA port of HaS (homology-aware speculative retrieval).

Mirrors the layout of the JAX package ``repro``, which stays the reference:
``core/`` (speculation state and validation), ``kernels/`` (hand-written
CUDA kernels for Hopper beside their plain PyTorch versions),
``retrieval/`` (flat, IVF and hybrid search, the retrieval service and its
backends), ``serving/`` (engines, latency model), ``training/`` (int8
quantization) and ``data/`` (the synthetic world).  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
