"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Each wrapper launches its kernel on CUDA tensors and runs the plain version
on CPU tensors; ``ops.py`` adds the ``backend="cuda" | "torch"`` switch.
Kernels are built with nvcc at first use (``_build.py``), never at import.
"""
