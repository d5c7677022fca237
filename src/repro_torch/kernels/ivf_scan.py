"""IVF probed-bucket scan: f32 buckets (the HaS fuzzy channel) and int8
centroid-residual codes (the compressed ANN cloud stage).

``ivf_scan`` replaces the Pallas kernel
``src/repro/kernels/ivf_scan.py::_ivf_kernel`` (f32) and its scaled mode
``_ivf_kernel_scaled`` (int8).  On a CUDA tensor it launches the
hand-written kernels of ``csrc/ivf_scan.cu`` (pass 1: a top-k per (query,
probed bucket, row range); pass 2: the candidate merge) and raises if that
fails; on a CPU tensor it runs :func:`ivf_scan_plain`.  Both order by score
descending, then by the flat probe position ``p * cap + slot``, as
``lax.top_k`` over the reference's flattened pool does.

Scaled mode (``bucket_scales`` and ``probe_bias`` together):
``bucket_vecs`` holds int8 codes of the residual ``v - centroid`` with one
scale per d/2 half, and a slot scores
``(q_lo . v8_lo) * s_lo + (q_hi . v8_hi) * s_hi + bias[b, p]``, summed in
that order; ``d`` must be even.

``ivf_scan.launches`` counts the f32 kernel's launches and
``ivf_scan.launches_int8`` the int8 kernel's (one per call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_search import MAX_K
from repro_torch.utils import stable_topk

# widest candidate row one merge warp holds in shared memory; wider rows
# merge in rounds
MERGE_WIDTH = 4096


def _row_splits(dev, b: int, p: int, cap: int, k: int) -> int:
    """Row ranges per probed bucket, one block each: about four blocks per
    SM for the batch, ranges of at least 32 rows, and each query's P*S*k
    candidates within one merge row."""
    sms = _build.sm_count(dev)
    want = -(-4 * sms // (b * p))
    return max(1, min(want, -(-cap // 32), MERGE_WIDTH // (p * k)))


def merge_candidates(fn, vals, keys, pay, k: int):
    """Pass 2 on the card: [B, m] candidates -> [B, k] (vals, keys, pay).

    ``fn`` is the C merge entry ``has_ivf_merge``.
    Order: vals descending, then keys ascending.
    """
    b, m = vals.shape
    dev = vals.device
    while True:
        g = -(-m // MERGE_WIDTH)
        width = -(-m // g)
        pad = g * width - m
        if pad:
            vals = torch.cat([vals, vals.new_full((b, pad), -torch.inf)], 1)
            keys = torch.cat([keys, keys.new_full((b, pad), -1)], 1)
            pay = torch.cat([pay, pay.new_full((b, pad), -1)], 1)
        rows = b * g
        out_v = torch.empty((rows, k), dtype=torch.float32, device=dev)
        out_k = torch.empty((rows, k), dtype=torch.int32, device=dev)
        out_p = torch.empty((rows, k), dtype=torch.int32, device=dev)
        _build.check(fn(_build.ptr(vals), _build.ptr(keys), _build.ptr(pay),
                        rows, width, k, _build.ptr(out_v), _build.ptr(out_k),
                        _build.ptr(out_p), _build.stream(dev)),
                     "top-k merge")
        if g == 1:
            return out_v, out_k, out_p
        vals, keys, pay = (t.reshape(b, g * k) for t in (out_v, out_k, out_p))
        m = g * k


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
    lib = _build.library("ivf_scan")
    splits = _row_splits(dev, b, p, cap, k)
    cand_v = torch.empty((b, p * splits * k), dtype=torch.float32,
                         device=dev)
    cand_k = torch.empty((b, p * splits * k), dtype=torch.int32, device=dev)
    cand_i = torch.empty((b, p * splits * k), dtype=torch.int32, device=dev)
    outs = (_build.ptr(cand_v), _build.ptr(cand_k), _build.ptr(cand_i))
    if scaled:
        _build.check(lib.has_ivf_scan_int8(
            _build.ptr(q), _build.ptr(pr), _build.ptr(bucket_vecs),
            _build.ptr(sc), _build.ptr(bias), _build.ptr(ids), *outs, b, p,
            c, cap, d, k, splits, _build.stream(dev)), "ivf_scan (int8)")
        ivf_scan.launches_int8 += 1
    else:
        _build.check(lib.has_ivf_scan(
            _build.ptr(q), _build.ptr(pr), _build.ptr(bucket_vecs),
            _build.ptr(ids), *outs, b, p, c, cap, d, k, splits,
            _build.stream(dev)), "ivf_scan")
        ivf_scan.launches += 1
    vals, _, gids = merge_candidates(lib.has_ivf_merge, cand_v, cand_k,
                                     cand_i, k)
    return vals, gids


ivf_scan.launches = 0
ivf_scan.launches_int8 = 0
