"""PyTorch/CUDA port of HaS (homology-aware speculative retrieval).

Mirrors the layout of the JAX package ``repro``, which stays the reference:
``core/`` (speculation state and validation), ``kernels/`` (hand-written
CUDA kernels for Hopper beside their plain PyTorch versions),
``retrieval/`` (flat and IVF search, the retrieval service), ``serving/``
(engines, latency model) and ``data/`` (the synthetic world).  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
