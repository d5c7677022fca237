"""IVF (inverted-file) approximate search in PyTorch.

Build: k-means over the corpus -> centroids; vectors re-ordered into
fixed-capacity buckets (power-law bucket sizes are padded/truncated so every
shape is static; truncation loss is the deliberate 'fuzzy' accuracy trade of
HaS).

Search: centroid matmul -> top-nprobe buckets -> bucket scan -> local top-k.
The bucket scan is :func:`~repro_torch.kernels.ivf_scan.ivf_scan_plain`
here; ``core/has.py`` sends it to the ``ivf_scan`` kernel on the card.

k-means draws its sample and its first centroids from a ``torch.Generator``,
which cannot reproduce the reference's ``jax.random`` draws, so the two
packages build different (equally valid) indexes from one corpus.  Parity
checks hand the reference's index across (``repro_torch.convert``).  On the
card the k-means sums use ``index_add_``, whose float order is not
deterministic: build an index once and share it where runs are compared.
The int8 ``CompressedIVFIndex`` and the streaming build are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.ivf_scan import ivf_scan_plain
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


def ivf_probe_scan(index: IVFIndex, queries: torch.Tensor,
                   probe: torch.Tensor, k: int):
    """Gather + score the probed buckets (the plain bucket scan)."""
    return ivf_scan_plain(queries, probe, index.bucket_vecs,
                          index.bucket_ids, k)


def probe_buckets(index: IVFIndex, queries: torch.Tensor,
                  nprobe: int) -> torch.Tensor:
    """Top-``nprobe`` centroids per query -> probe [B, nprobe] int32."""
    nprobe = min(nprobe, index.n_buckets)
    _, probe = stable_topk(queries @ index.centroids.T, nprobe)
    return probe.to(torch.int32)


def ivf_search(index: IVFIndex, queries: torch.Tensor, *, nprobe: int,
               k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """queries [B, d] -> (scores [B, k], global ids [B, k] int32)."""
    return ivf_probe_scan(index, queries, probe_buckets(index, queries,
                                                        nprobe), k)
