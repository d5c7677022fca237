"""IVF (inverted-file) approximate search in PyTorch.

Build: k-means over the corpus -> centroids; vectors re-ordered into
fixed-capacity buckets (power-law bucket sizes are padded/truncated so every
shape is static; truncation loss is the deliberate 'fuzzy' accuracy trade of
HaS).

Search: centroid matmul -> top-nprobe buckets -> bucket scan -> local top-k.
The bucket scan is :func:`~repro_torch.kernels.ivf_scan.ivf_scan_plain`
here; ``core/has.py`` and ``retrieval/fusion.py`` send it to the
``ivf_scan`` kernel on the card.

Compressed residency (:class:`CompressedIVFIndex`, the ANN cloud stage):
buckets hold int8 codes of the residual ``v - centroid`` with one scale per
d/2 half, and a slot scores ``q.c + (q_lo.v8_lo)s_lo + (q_hi.v8_hi)s_hi``.
:func:`build_ivf_streaming` builds either kind chunk by chunk; its bucket
contents equal the reference's for the same centroids.

k-means draws its sample and its first centroids from a ``torch.Generator``,
which cannot reproduce the reference's ``jax.random`` draws, so the two
packages build different (equally valid) indexes from one corpus.  Parity
checks hand the reference's index across (``repro_torch.convert``).  On the
card the k-means sums use ``index_add_``, whose float order is not
deterministic: build an index once and share it where runs are compared.
The streaming build takes ``centroids=`` to skip k-means.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.ivf_scan import ivf_scan_plain
from repro_torch.training.compression import quantize_int8
from repro_torch.utils import as_f32, resolve_device, stable_topk

# rows per assignment product: [ASSIGN_CHUNK, C] f32 scores stay ~1 GB at
# C = 8192
ASSIGN_CHUNK = 32768


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor      # [C, d] f32
    bucket_vecs: torch.Tensor    # [C, cap, d] f32
    bucket_ids: torch.Tensor     # [C, cap] int32 global ids (-1 = pad)
    bucket_counts: torch.Tensor  # [C] int32

    @property
    def n_buckets(self) -> int:
        return self.centroids.shape[0]

    @property
    def capacity(self) -> int:
        return self.bucket_ids.shape[1]


@dataclasses.dataclass
class CompressedIVFIndex:
    """IVF index with int8 centroid-residual bucket codes (module
    docstring): about 3.6x smaller than f32 buckets at d=768."""
    centroids: torch.Tensor      # [C, d] f32
    bucket_vecs: torch.Tensor    # [C, cap, d] int8 residual codes
    bucket_scales: torch.Tensor  # [C, cap, 2] f32 per-half scales
    bucket_ids: torch.Tensor     # [C, cap] int32 global ids (-1 = pad)
    bucket_counts: torch.Tensor  # [C] int32

    @property
    def n_buckets(self) -> int:
        return self.centroids.shape[0]

    @property
    def capacity(self) -> int:
        return self.bucket_ids.shape[1]


def _assign(vecs: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest centroid by inner product, chunked (the [N, C] scores never
    exist whole).  k-means cannot match the reference's draws anyway, so
    the plain ``argmax`` serves here."""
    return torch.cat([torch.argmax(vecs[lo:lo + ASSIGN_CHUNK] @ cents.T, 1)
                      for lo in range(0, vecs.shape[0], ASSIGN_CHUNK)])


def _kmeans_step(train: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    c = cents.shape[0]
    assign = _assign(train, cents)
    sums = torch.zeros_like(cents).index_add_(0, assign, train)
    cnts = torch.bincount(assign, minlength=c).to(train.dtype)
    new = sums / torch.clamp_min(cnts, 1.0)[:, None]
    # re-seed empty clusters from the previous centroids
    new = torch.where((cnts > 0)[:, None], new, cents)
    return new / torch.clamp_min(new.norm(dim=-1, keepdim=True), 1e-8)


def kmeans(vecs: torch.Tensor, n_clusters: int, iters: int = 10,
           seed: int = 0, sample: int = 131072) -> torch.Tensor:
    """Lloyd's k-means on (a sample of) the corpus, on ``vecs.device``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = vecs.shape[0]
    if n > sample:
        idx = torch.randperm(n, generator=g)[:sample].to(vecs.device)
        train = vecs[idx]
    else:
        train = vecs
    init = torch.randperm(train.shape[0], generator=g)[:n_clusters]
    cents = train[init.to(vecs.device)]
    for _ in range(iters):
        cents = _kmeans_step(train, cents)
    return cents


def build_ivf(corpus, n_buckets: int, capacity_factor: float = 2.0,
              kmeans_iters: int = 10, seed: int = 0,
              device=None) -> IVFIndex:
    """Assign every corpus vector to its nearest centroid bucket.

    ``device`` defaults to CUDA (raising without a card); the buckets keep
    the reference's fill order: corpus order within a bucket, rows past the
    capacity dropped.
    """
    dev = resolve_device(device)
    corpus = as_f32(corpus, dev)
    n, d = corpus.shape
    n_buckets = max(1, min(n_buckets, n // 8))   # clamp for tiny corpora
    cents = kmeans(corpus, n_buckets, kmeans_iters, seed)
    assign = _assign(corpus, cents).cpu().numpy()
    cap = int(np.ceil(n / n_buckets * capacity_factor))
    # vectorized bucket fill: sort by bucket, position-in-bucket via offsets
    order = np.argsort(assign, kind="stable")
    sorted_b = assign[order]
    starts = np.searchsorted(sorted_b, np.arange(n_buckets))
    pos = np.arange(n) - starts[sorted_b]
    keep = pos < cap
    bucket_ids = np.full((n_buckets, cap), -1, np.int32)
    bucket_ids[sorted_b[keep], pos[keep]] = order[keep]
    counts = np.bincount(sorted_b[keep], minlength=n_buckets).astype(np.int32)
    ids_t = torch.as_tensor(bucket_ids, device=dev)
    bucket_vecs = corpus[ids_t.clamp_min(0).long()]           # [C, cap, d]
    bucket_vecs[ids_t < 0] = 0.0
    return IVFIndex(centroids=cents.contiguous(), bucket_vecs=bucket_vecs,
                    bucket_ids=ids_t,
                    bucket_counts=torch.as_tensor(counts, device=dev))


def _quant_residual_halves(rows: torch.Tensor, cents_rows: torch.Tensor):
    """int8-code the residual ``rows - centroid`` with one symmetric scale
    per d/2 half -> (codes [n, d] int8, scales [n, 2] f32)."""
    r = rows - cents_rows
    h = r.shape[1] // 2
    q0, s0 = quantize_int8(r[:, :h], axis=-1)
    q1, s1 = quantize_int8(r[:, h:], axis=-1)
    return torch.cat([q0, q1], dim=1), torch.cat([s0, s1], dim=1)


def _build_ivf_arrays(corpus, n_buckets: int, capacity_factor: float = 2.0,
                      kmeans_iters: int = 10, seed: int = 0,
                      chunk: int = 65536, compressed: bool = False,
                      ids=None, centroids=None, device=None):
    """Streaming bucket build into HOST (numpy) arrays.

    k-means (or the given ``centroids``), assignment and quantization run on
    ``device``, ``chunk`` corpus rows at a time; per-bucket fill cursors keep
    :func:`build_ivf`'s bucket order, and f32 buckets are never made in
    compressed mode.  Returns ``(centroids, bucket_vecs, bucket_scales |
    None, bucket_ids, counts)`` as numpy arrays.
    """
    dev = resolve_device(device)
    corpus = as_f32(corpus, dev)
    n, d = corpus.shape
    if centroids is None:
        n_buckets = max(1, min(n_buckets, n // 8))   # clamp for tiny corpora
        cents = kmeans(corpus, n_buckets, kmeans_iters, seed)
    else:
        cents = as_f32(centroids, dev)
        n_buckets = cents.shape[0]
    cap = int(np.ceil(n / n_buckets * capacity_factor))
    gids = (np.arange(n, dtype=np.int32) if ids is None
            else np.asarray(ids, np.int32))
    bucket_ids = np.full((n_buckets, cap), -1, np.int32)
    counts = np.zeros(n_buckets, np.int64)
    bucket_vecs = np.zeros((n_buckets, cap, d),
                           np.int8 if compressed else np.float32)
    bucket_scales = (np.zeros((n_buckets, cap, 2), np.float32)
                     if compressed else None)
    for lo in range(0, n, chunk):
        rows = corpus[lo:lo + chunk]
        assign = _assign(rows, cents).cpu().numpy()
        order = np.argsort(assign, kind="stable")
        sb = assign[order]
        starts = np.searchsorted(sb, np.arange(n_buckets))
        pos = counts[sb] + (np.arange(len(sb)) - starts[sb])
        keep = pos < cap
        rb, rp, ro = sb[keep], pos[keep], order[keep]
        bucket_ids[rb, rp] = gids[lo + ro]
        kept = rows[torch.as_tensor(ro, device=dev)]
        if compressed:
            q, scale = _quant_residual_halves(
                kept, cents[torch.as_tensor(rb, device=dev)])
            bucket_vecs[rb, rp] = q.cpu().numpy()
            bucket_scales[rb, rp] = scale.cpu().numpy()
        else:
            bucket_vecs[rb, rp] = kept.cpu().numpy()
        counts = np.minimum(counts + np.bincount(sb, minlength=n_buckets),
                            cap)
    return (cents.cpu().numpy(), bucket_vecs, bucket_scales, bucket_ids,
            counts.astype(np.int32))


def index_from_arrays(cents, bucket_vecs, bucket_scales, bucket_ids, counts,
                      device) -> IVFIndex | CompressedIVFIndex:
    """The index of :func:`_build_ivf_arrays`' arrays on ``device``: copies,
    never views of the arrays (live ingest rewrites them in place)."""
    t = {"centroids": torch.tensor(cents, device=device),
         "bucket_vecs": torch.tensor(bucket_vecs, device=device),
         "bucket_ids": torch.tensor(bucket_ids, device=device),
         "bucket_counts": torch.tensor(counts, device=device)}
    if bucket_scales is None:
        return IVFIndex(**t)
    return CompressedIVFIndex(
        bucket_scales=torch.tensor(bucket_scales, device=device), **t)


def build_ivf_streaming(corpus, n_buckets: int, capacity_factor: float = 2.0,
                        kmeans_iters: int = 10, seed: int = 0,
                        chunk: int = 65536, compressed: bool = False,
                        ids=None, centroids=None,
                        device=None) -> IVFIndex | CompressedIVFIndex:
    """Chunked-assignment build; bucket contents equal to
    :func:`build_ivf`'s for the same centroids.  ``compressed=True`` returns
    a :class:`CompressedIVFIndex`."""
    dev = resolve_device(device)
    return index_from_arrays(
        *_build_ivf_arrays(corpus, n_buckets, capacity_factor, kmeans_iters,
                           seed, chunk, compressed, ids, centroids, dev),
        device=dev)


def subset_index(index: IVFIndex, fraction: float, seed: int = 0) -> IVFIndex:
    """Keep only a fraction of each bucket (Table VII compression mode)."""
    if fraction >= 1.0:
        return index
    new_cap = max(1, int(index.capacity * fraction))
    return IVFIndex(centroids=index.centroids,
                    bucket_vecs=index.bucket_vecs[:, :new_cap].contiguous(),
                    bucket_ids=index.bucket_ids[:, :new_cap].contiguous(),
                    bucket_counts=torch.clamp_max(index.bucket_counts,
                                                  new_cap))


def ivf_probe_scan(index: IVFIndex | CompressedIVFIndex,
                   queries: torch.Tensor, probe: torch.Tensor, k: int):
    """Gather + score the probed buckets (the plain bucket scan).  For a
    :class:`CompressedIVFIndex` the centroid term is ``q . c`` of each
    probed bucket; a pool smaller than k pads with ``(-inf, -1)``."""
    if isinstance(index, CompressedIVFIndex):
        bias = torch.einsum("bd,bpd->bp", queries,
                            index.centroids[probe.long()])
        return ivf_scan_plain(queries, probe, index.bucket_vecs,
                              index.bucket_ids, k, index.bucket_scales, bias)
    return ivf_scan_plain(queries, probe, index.bucket_vecs,
                          index.bucket_ids, k)


def probe_buckets(index: IVFIndex | CompressedIVFIndex, queries: torch.Tensor,
                  nprobe: int) -> torch.Tensor:
    """Top-``nprobe`` centroids per query -> probe [B, nprobe] int32."""
    nprobe = min(nprobe, index.n_buckets)
    _, probe = stable_topk(queries @ index.centroids.T, nprobe)
    return probe.to(torch.int32)


def ivf_search(index: IVFIndex | CompressedIVFIndex, queries: torch.Tensor,
               *, nprobe: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [B, d] -> (scores [B, k], global ids [B, k] int32)."""
    return ivf_probe_scan(index, queries, probe_buckets(index, queries,
                                                        nprobe), k)
