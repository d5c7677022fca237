"""Fixed-arity EmbeddingBag (the recsys lookup hot path): kernel + plain.

``embedding_bag`` replaces the Pallas kernel
``src/repro/kernels/embedding_bag.py::_bag_kernel``.  It takes
``table [V,d]`` (f32 or bf16), ``ids [B,n]`` (integers in ``[0, V)``), an
optional ``weights [B,n]`` and ``mode`` ``"sum"`` or ``"mean"``, and returns
``[B,d]`` in the table's dtype: slot by slot, ``j = 0..n-1``, the term
``(row * w) * scale`` (in f32; ``scale`` is ``1/n`` for ``"mean"``) is
rounded to the table's dtype and added to the bag's sum in that dtype, as
the TPU kernel accumulates into its output block.  Both versions follow that
order, so they are bit-equal.

On a CUDA tensor it launches the kernel of ``csrc/embedding_bag.cu`` (one
warp per bag, every row gather of the bag in flight at once; int32 or
int64 ids as given) and raises if that fails; on a CPU tensor it runs
:func:`embedding_bag_plain`.  ``embedding_bag.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

MODES = ("sum", "mean")


def _scale(ids: torch.Tensor, mode: str) -> float:
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode {mode!r} not in {MODES}")
    return 1.0 / max(ids.shape[1], 1) if mode == "mean" else 1.0


def embedding_bag_plain(table: torch.Tensor, ids: torch.Tensor,
                        weights: torch.Tensor | None = None,
                        mode: str = "sum") -> torch.Tensor:
    """table [V,d], ids [B,n], weights [B,n] | None -> [B,d] (table dtype),
    summed slot by slot in the table's dtype (module docstring)."""
    scale = _scale(ids, mode)
    b, n = ids.shape
    out = torch.zeros((b, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for j in range(n):
        row = table[ids[:, j].long()].float()
        if weights is not None:
            row = row * weights[:, j:j + 1].float()
        out = out + (row * scale).to(table.dtype)
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mode: str = "sum") -> torch.Tensor:
    """Same contract as :func:`embedding_bag_plain`; the kernel on CUDA."""
    if table.device.type != "cuda":
        return embedding_bag_plain(table, ids, weights, mode)
    scale = _scale(ids, mode)
    dt = table.dtype
    if dt is not torch.float32 and dt is not torch.bfloat16:
        raise ValueError(f"embedding_bag: table dtype {dt} is not f32 or "
                         f"bf16")
    if table.dim() != 2 or ids.dim() != 2 or \
            (weights is not None and weights.shape != ids.shape):
        raise ValueError(f"embedding_bag: table {tuple(table.shape)}, ids "
                         f"{tuple(ids.shape)}, weights "
                         f"{None if weights is None else tuple(weights.shape)}")
    if ids.dtype is not torch.int32 and ids.dtype is not torch.int64:
        ids = ids.to(torch.int32)
    ids = ids.contiguous()
    if weights is not None:
        weights = weights.float().contiguous()
    dev = table.device
    if ids.device != dev or (weights is not None and weights.device != dev):
        raise ValueError(f"embedding_bag: tensors on {ids.device} and {dev}")
    if not table.is_contiguous():
        raise ValueError("embedding_bag: operands must be contiguous")
    b, n = ids.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=dt, device=dev)
    if b == 0 or d == 0:
        return out
    _build.check(_build.entry("embedding_bag", "has_embedding_bag")(
        table.data_ptr(), ids.data_ptr(),
        None if weights is None else weights.data_ptr(), out.data_ptr(), b,
        n, d, scale, dt is torch.bfloat16, ids.dtype is torch.int64,
        _build.stream(dev)), "embedding_bag")
    embedding_bag.launches += 1
    return out


embedding_bag.launches = 0
