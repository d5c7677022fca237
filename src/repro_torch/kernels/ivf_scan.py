"""IVF probed-bucket scan: f32 buckets (the HaS fuzzy channel) and int8
centroid-residual codes (the compressed ANN cloud stage).

``ivf_scan`` replaces the Pallas kernel
``src/repro/kernels/ivf_scan.py::_ivf_kernel`` (f32) and its scaled mode
``_ivf_kernel_scaled`` (int8).  On a CUDA tensor it launches the
hand-written kernel of ``csrc/ivf_scan.cu`` once (each query's probed pool
cut into row ranges by :func:`plan_ranges`, a top-k per range, and the
ranges' lists merged by the last CTA of the query in the same launch) and
raises if that fails; on a CPU tensor it runs :func:`ivf_scan_plain`.  Both
order by score descending, then by the flat probe position
``p * cap + slot``, as ``lax.top_k`` over the reference's flattened pool
does.

Scaled mode (``bucket_scales`` and ``probe_bias`` together):
``bucket_vecs`` holds int8 codes of the residual ``v - centroid`` with one
scale per d/2 half, and a slot scores
``(q_lo . v8_lo) * s_lo + (q_hi . v8_hi) * s_hi + bias[b, p]``, summed in
that order; ``d`` must be even.

``ivf_scan.launches`` counts the f32 kernel's launches and
``ivf_scan.launches_int8`` the int8 kernel's (one per call).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_search import MAX_K
from repro_torch.utils import stable_topk

MAX_RANGES = 256       # lists one query's merge takes: 8 warps of 32
MIN_RANGE_ROWS = 32    # a CTA scores at least this many rows
CTAS_PER_SM = 16       # CTAs per SM the batch aims for (measured)


@functools.lru_cache(maxsize=4096)
def plan_ranges(b: int, p: int, cap: int, k: int, sms: int) -> int:
    """Row ranges L per query (one CTA each) for B queries of P probed
    buckets of ``cap`` slots on ``sms`` SMs.

    Range z of a query's pool of n = P*cap flat positions is
    ``[z*n // L, (z+1)*n // L)``.  L aims at CTAS_PER_SM CTAs per SM over
    the batch, with ranges of at least MIN_RANGE_ROWS rows (one range for a
    smaller pool) and at most MAX_RANGES lists for the in-launch merge.
    Measured on an H100 by ``ivf_scan_probe.py``: at B=64 (int8, P=32,
    cap=977) 8, 16, 32 and 64 CTAs per SM took 334, 296, 299 and 324 us
    (f32, P=64, cap=123: 277, 276, 274, 339 us); B=1 is capped by the 256
    lists and 32-row ranges either way.  ``k`` does not change the cut."""
    n = p * cap
    return max(1, min(MAX_RANGES, n // MIN_RANGE_ROWS,
                      -(-CTAS_PER_SM * sms // b)))


def _check_scaled(bucket_scales, probe_bias) -> bool:
    if (bucket_scales is None) != (probe_bias is None):
        raise ValueError("bucket_scales (residual codes) and probe_bias "
                         "must be passed together")
    return bucket_scales is not None


def ivf_scan_plain(queries: torch.Tensor, probe: torch.Tensor,
                   bucket_vecs: torch.Tensor, bucket_ids: torch.Tensor,
                   k: int, bucket_scales: torch.Tensor | None = None,
                   probe_bias: torch.Tensor | None = None):
    """queries [B,d], probe [B,P], bucket_vecs [C,cap,d], bucket_ids
    [C,cap] (-1 = pad) -> (vals [B,k] desc f32, global ids [B,k] i32).

    ``bucket_scales [C,cap,2]`` + ``probe_bias [B,P]`` score residual codes
    (module docstring).  Gathers the probed buckets ([B,P,cap,d]) and takes
    an exact top-k of the flattened pool; a pool smaller than k pads with
    ``(-inf, -1)``.
    """
    scaled = _check_scaled(bucket_scales, probe_bias)
    probe = probe.long()
    q = queries.float()
    vecs = bucket_vecs[probe].float()                       # [B,P,cap,d]
    ids = bucket_ids[probe]                                 # [B,P,cap]
    if scaled:
        h = q.shape[1] // 2
        sc = bucket_scales[probe].float()                   # [B,P,cap,2]
        s = (torch.einsum("bd,bpcd->bpc", q[:, :h], vecs[..., :h])
             * sc[..., 0]
             + torch.einsum("bd,bpcd->bpc", q[:, h:], vecs[..., h:])
             * sc[..., 1]
             + probe_bias.float()[:, :, None])
    else:
        s = torch.einsum("bd,bpcd->bpc", q, vecs)
    s = s.masked_fill(ids < 0, -torch.inf)
    b = queries.shape[0]
    s, ids = s.reshape(b, -1), ids.reshape(b, -1)
    vals, pos = stable_topk(s, k)
    out = torch.gather(ids, 1, pos.clamp_min(0))
    return vals, torch.where(torch.isfinite(vals), out, -1).to(torch.int32)


def ivf_scan(queries: torch.Tensor, probe: torch.Tensor,
             bucket_vecs: torch.Tensor, bucket_ids: torch.Tensor, k: int,
             bucket_scales: torch.Tensor | None = None,
             probe_bias: torch.Tensor | None = None):
    """Same contract as :func:`ivf_scan_plain`; the kernel on CUDA."""
    if queries.device.type != "cuda":
        return ivf_scan_plain(queries, probe, bucket_vecs, bucket_ids, k,
                              bucket_scales, probe_bias)
    scaled = _check_scaled(bucket_scales, probe_bias)
    b, d = queries.shape
    c, cap, d2 = bucket_vecs.shape
    p = probe.shape[1]
    if d2 != d or bucket_ids.shape != (c, cap) or probe.shape[0] != b:
        raise ValueError(
            f"ivf_scan: queries {tuple(queries.shape)}, probe "
            f"{tuple(probe.shape)}, bucket_vecs {tuple(bucket_vecs.shape)}, "
            f"bucket_ids {tuple(bucket_ids.shape)}")
    want = torch.int8 if scaled else torch.float32
    if bucket_vecs.dtype != want:
        raise ValueError(f"ivf_scan: {'scaled' if scaled else 'f32'} mode "
                         f"takes {want} buckets, got {bucket_vecs.dtype}")
    if scaled and (d % 2 or bucket_scales.shape != (c, cap, 2)
                   or probe_bias.shape != (b, p)):
        raise ValueError(
            f"ivf_scan: scaled mode needs even d (got {d}), bucket_scales "
            f"[C,cap,2] and probe_bias [B,P]; got "
            f"{tuple(bucket_scales.shape)}, {tuple(probe_bias.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if b > 65535 or c == 0 or cap == 0:
        raise ValueError("ivf_scan: B <= 65535 and a non-empty index")
    q = queries.float().contiguous()
    pr = probe.to(torch.int32).contiguous()
    ids = bucket_ids.to(torch.int32).contiguous()
    sc = bucket_scales.float().contiguous() if scaled else None
    bias = probe_bias.float().contiguous() if scaled else None
    dev = _build.check_operands("ivf_scan", q, pr, bucket_vecs, ids, sc,
                                bias)
    if b == 0 or p == 0:
        return (torch.full((b, k), -torch.inf, device=dev),
                torch.full((b, k), -1, dtype=torch.int32, device=dev))
    if max(p, c) * cap >= 2 ** 31 - 1:
        raise ValueError(f"ivf_scan: P*cap = {p * cap} pool slots and C*cap "
                         f"= {c * cap} bucket rows must fit 32-bit ints")
    lib = _build.library("ivf_scan")
    n_ranges = plan_ranges(b, p, cap, k, _build.sm_count(dev))
    stride = -(-n_ranges * k // 32) * 32        # whole 128-byte lines
    st = _build.stream(dev)
    tickets, lists = _build.scratch("ivf_scan", dev, st, -(-b // 32) * 32,
                                    2 * b * stride)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    gids = torch.empty((b, k), dtype=torch.int32, device=dev)
    _build.check(lib.has_ivf_scan(
        _build.ptr(q), _build.ptr(pr), _build.ptr(bucket_vecs),
        _build.ptr(sc), _build.ptr(bias), _build.ptr(ids), tickets, lists,
        lists + 4 * b * stride, _build.ptr(vals), _build.ptr(gids), b, p, c,
        cap, d, k, n_ranges, stride, st),
        "ivf_scan (int8)" if scaled else "ivf_scan")
    if scaled:
        ivf_scan.launches_int8 += 1
    else:
        ivf_scan.launches += 1
    return vals, gids


ivf_scan.launches = 0
ivf_scan.launches_int8 = 0
