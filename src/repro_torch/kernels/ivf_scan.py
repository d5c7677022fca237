"""IVF probed-bucket scan, f32 buckets (the HaS fuzzy channel).

``ivf_scan`` replaces the f32 mode of the Pallas kernel
``src/repro/kernels/ivf_scan.py::_ivf_kernel``.  On a CUDA tensor it
launches the hand-written kernel of ``csrc/ivf_scan.cu`` (pass 1: a top-k
per (query, probed bucket); pass 2: the candidate merge) and raises if that
fails; on a CPU tensor it runs :func:`ivf_scan_plain`.  Both order by score
descending, then by the flat probe position ``p * cap + slot``, as
``lax.top_k`` over the reference's flattened pool does.  The int8
centroid-residual mode (``_ivf_kernel_scaled``) is not ported yet.

``ivf_scan.launches`` counts the kernel's launches (one per call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_search import MAX_K, merge_candidates
from repro_torch.utils import stable_topk


def ivf_scan_plain(queries: torch.Tensor, probe: torch.Tensor,
                   bucket_vecs: torch.Tensor, bucket_ids: torch.Tensor,
                   k: int):
    """queries [B,d], probe [B,P], bucket_vecs [C,cap,d], bucket_ids
    [C,cap] (-1 = pad) -> (vals [B,k] desc f32, global ids [B,k] i32).

    Gathers the probed buckets ([B,P,cap,d]) and takes an exact top-k of
    the flattened pool; a pool smaller than k pads with ``(-inf, -1)``.
    """
    probe = probe.long()
    vecs = bucket_vecs[probe].float()                       # [B,P,cap,d]
    ids = bucket_ids[probe]                                 # [B,P,cap]
    s = torch.einsum("bd,bpcd->bpc", queries.float(), vecs)
    s = s.masked_fill(ids < 0, -torch.inf)
    b = queries.shape[0]
    s, ids = s.reshape(b, -1), ids.reshape(b, -1)
    vals, pos = stable_topk(s, k)
    out = torch.gather(ids, 1, pos.clamp_min(0))
    return vals, torch.where(torch.isfinite(vals), out, -1).to(torch.int32)


def ivf_scan(queries: torch.Tensor, probe: torch.Tensor,
             bucket_vecs: torch.Tensor, bucket_ids: torch.Tensor, k: int):
    """Same contract as :func:`ivf_scan_plain`; the kernel on CUDA."""
    if queries.device.type != "cuda":
        return ivf_scan_plain(queries, probe, bucket_vecs, bucket_ids, k)
    b, d = queries.shape
    c, cap, d2 = bucket_vecs.shape
    p = probe.shape[1]
    if d2 != d or bucket_ids.shape != (c, cap) or probe.shape[0] != b:
        raise ValueError(
            f"ivf_scan: queries {tuple(queries.shape)}, probe "
            f"{tuple(probe.shape)}, bucket_vecs {tuple(bucket_vecs.shape)}, "
            f"bucket_ids {tuple(bucket_ids.shape)}")
    if bucket_vecs.dtype != torch.float32:
        raise ValueError("ivf_scan: only f32 buckets (the int8 residual "
                         "mode is not ported)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if b > 65535 or c == 0 or cap == 0:
        raise ValueError("ivf_scan: B <= 65535 and a non-empty index")
    q = queries.float().contiguous()
    pr = probe.to(torch.int32).contiguous()
    ids = bucket_ids.to(torch.int32).contiguous()
    dev = _build.check_operands("ivf_scan", q, pr, bucket_vecs, ids)
    if b == 0 or p == 0:
        return (torch.full((b, k), -torch.inf, device=dev),
                torch.full((b, k), -1, dtype=torch.int32, device=dev))
    lib = _build.library("ivf_scan")
    cand_v = torch.empty((b, p * k), dtype=torch.float32, device=dev)
    cand_k = torch.empty((b, p * k), dtype=torch.int32, device=dev)
    cand_i = torch.empty((b, p * k), dtype=torch.int32, device=dev)
    _build.check(lib.has_ivf_scan(
        _build.ptr(q), _build.ptr(pr), _build.ptr(bucket_vecs),
        _build.ptr(ids), _build.ptr(cand_v), _build.ptr(cand_k),
        _build.ptr(cand_i), b, p, c, cap, d, k, _build.stream(dev)),
        "ivf_scan")
    ivf_scan.launches += 1
    vals, _, gids = merge_candidates(lib.has_ivf_merge, cand_v, cand_k,
                                     cand_i, k)
    return vals, gids


ivf_scan.launches = 0
