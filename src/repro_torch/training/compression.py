"""Symmetric int8 quantization (the compressed IVF residency uses it).

Only ``quantize_int8`` / ``dequantize_int8`` are ported: the compressed
all-reduce of the reference's training path has no caller in the port.

The scale is ``max|x| / 127`` floored at 1e-12 (an all-zero slice, such as
an IVF pad slot, would otherwise divide 0 by 0), and ``torch.round`` rounds
half to even as ``jnp.round`` does.  The reference runs this under ``jit``
(its compressed IVF build), where XLA turns the division by the constant
127 into a multiplication by its f32 reciprocal; the port multiplies the
same way, so codes and scales equal the jitted reference's bit for bit.
(Run op by op, the reference divides, and some scales differ in the last
bit.)
"""
from __future__ import annotations

import numpy as np
import torch

_INV_127 = float(np.float32(1.0) / np.float32(127.0))   # exact in f32


def quantize_int8(x: torch.Tensor, axis: int | None = None):
    """Symmetric int8 quantization -> (codes int8, scale f32).

    ``axis=None`` uses one scale for the whole tensor; an integer axis
    keeps one scale per slice along it (``keepdim``, so
    :func:`dequantize_int8` broadcasts).
    """
    x = x.float()
    if axis is None:
        scale = x.abs().max() * _INV_127
    else:
        scale = x.abs().amax(dim=axis, keepdim=True) * _INV_127
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
