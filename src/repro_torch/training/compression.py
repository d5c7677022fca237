"""Symmetric int8 quantization (the compressed IVF residency uses it) and
the int8 error-feedback all-reduce of cross-pod data parallelism.

:func:`compressed_psum` (twin of ``src/repro/training/compression.py:
48-79``): each rank quantizes ``x + error`` to int8 with one scale, keeps
``corrected - dequant`` as its next error, and the ranks' codes and scales
cross the wire as int8 and f32 (all-gathers over the data-parallel
group); each rank then sums the dequantized tensors in rank order.  The
reference's psum reduces the dequantized f32 tensors in an order of its
own, so the sums agree to f32 reassociation.

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
import torch.distributed as dist
from torch.distributed.tensor import DTensor

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


def compressed_psum(x: torch.Tensor, group, error: torch.Tensor):
    """Error-feedback int8 all-reduce of each rank's ``x`` over ``group``
    (None: no other rank) -> (the sum, the new error), f32."""
    corrected = x.float() + error
    q, scale = quantize_int8(corrected)
    deq = dequantize_int8(q, scale)
    new_error = corrected - deq
    if group is None:
        return deq, new_error
    world = dist.get_world_size(group)
    codes = q.new_empty(world * q.numel())
    dist.all_gather_into_tensor(codes, q.reshape(-1), group=group)
    codes = codes.view((world,) + tuple(q.shape))
    scales = scale.new_empty(world)
    dist.all_gather_into_tensor(scales, scale.reshape(1), group=group)
    total = dequantize_int8(codes[0], scales[0])
    for r in range(1, world):
        total = total + dequantize_int8(codes[r], scales[r])
    return total, new_error


def dp_group(mesh, dp_axes=("pod",)):
    """The process group over the mesh axes ``dp_axes`` that the mesh has
    (several flattened into one, in mesh order), or None when it has
    none."""
    names = tuple(mesh.mesh_dim_names or ())
    axes = tuple(a for a in names if a in dp_axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def make_compressed_allreduce(mesh, dp_axes=("pod",)):
    """-> ``fn(grads, errors) -> (reduced, new_errors)``: trees (dicts and
    lists) of each rank's own gradients and persistent errors, reduced
    leaf by leaf with :func:`compressed_psum` over the ``dp_axes`` of
    ``mesh``.  A ``DTensor`` leaf contributes its local shard; the results
    are plain f32 tensors."""
    group = dp_group(mesh, dp_axes)

    def walk(g, e):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], e[k]) for k in g}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if isinstance(g, (list, tuple)):
            pairs = [walk(a, b) for a, b in zip(g, e)]
            return [p[0] for p in pairs], [p[1] for p in pairs]
        local = g.to_local() if isinstance(g, DTensor) else g
        err = e.to_local() if isinstance(e, DTensor) else e
        return compressed_psum(local, group, err)

    return walk
