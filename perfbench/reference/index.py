"""Inverted-file membership, worked out again from the corpus: which bucket
each row lies in and whether it was kept.

An IVF build trains its centroids by Lloyd's k-means on a seeded sample of
the rows: ``randperm(N)[:sample]`` of a CPU ``torch.Generator`` seeded with
the build's seed (all rows when ``N <= sample``), then the first centroids
``randperm(sample)[:C]`` of those, in that order.  A Lloyd step assigns
each sample row to its centroid, and a new centroid is the unit-norm mean
of its rows (an empty cluster keeps its old centroid).  A row lies in the
bucket of its largest inner product with a centroid (the first on a tie),
scored in blocks of ``ASSIGN_BLOCK`` rows.  A bucket holds its rows in
corpus order up to ``cap = ceil(N / C * capacity_factor)``; the rest are
dropped.

Membership hangs on the last bit of each centroid, so the float order of a
cluster's sum is fixed: both builds run under :func:`deterministic`, in
which ``index_add_`` adds a cluster's rows in row order on the card as on
the CPU.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings

import torch

ASSIGN_BLOCK = 32768
PROBE_TIE = 1e-5     # a bucket scoring this close to the last one probed may
                     # be probed by either side of a comparison


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms on for the block, as they were after it.
    Ops without a deterministic kernel (an integer ``bincount``, cuBLAS
    without a fixed workspace) only warn, and are silenced."""
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])


@dataclasses.dataclass
class Buckets:
    centroids: torch.Tensor     # [C, d] f32
    assign: torch.Tensor        # [N] int64 bucket of each row
    kept: torch.Tensor          # [N] bool: the row is in its bucket
    counts: torch.Tensor        # [C] int64 rows kept in each bucket
    cap: int

    @property
    def n_buckets(self) -> int:
        return self.centroids.shape[0]


def nearest(rows: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """The centroid of each row, scored in blocks of ``ASSIGN_BLOCK``."""
    return torch.cat([
        torch.argmax(rows[lo:lo + ASSIGN_BLOCK] @ cents.T, dim=1)
        for lo in range(0, rows.shape[0], ASSIGN_BLOCK)])


def lloyd_centroids(corpus: torch.Tensor, n_clusters: int, seed: int,
                    sample: int, iters: int) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(int(seed))
    n = corpus.shape[0]
    if n > sample:
        idx = torch.randperm(n, generator=g)[:sample]
        train = corpus[idx.to(corpus.device)]
    else:
        train = corpus
    init = torch.randperm(train.shape[0], generator=g)[:n_clusters]
    cents = train[init.to(corpus.device)]
    for _ in range(int(iters)):
        assign = nearest(train, cents)
        sums = torch.zeros_like(cents).index_add_(0, assign, train)
        cnts = torch.bincount(assign, minlength=n_clusters).to(train.dtype)
        new = sums / torch.clamp_min(cnts, 1.0)[:, None]
        new = torch.where((cnts > 0)[:, None], new, cents)
        cents = new / torch.clamp_min(new.norm(dim=-1, keepdim=True), 1e-8)
    return cents.contiguous()


def build(corpus: torch.Tensor, n_buckets: int, capacity_factor: float,
          seed: int, sample: int, iters: int) -> Buckets:
    n = corpus.shape[0]
    c = max(1, min(int(n_buckets), n // 8))
    with deterministic():
        cents = lloyd_centroids(corpus, c, seed, sample, iters)
        assign = nearest(corpus, cents)
    cap = int(math.ceil(n / c * capacity_factor))
    order = torch.argsort(assign, stable=True)
    counts_all = torch.bincount(assign, minlength=c)
    starts = torch.cumsum(counts_all, 0) - counts_all
    pos = torch.empty_like(assign)
    pos[order] = (torch.arange(n, device=corpus.device)
                  - starts[assign[order]])
    kept = pos < cap
    return Buckets(centroids=cents, assign=assign, kept=kept,
                   counts=torch.clamp_max(counts_all, cap), cap=cap)


def probe(buckets: Buckets, queries: torch.Tensor, nprobe: int):
    """Top-``nprobe`` buckets of each query by ``q . centroid`` (f32; ties
    to the lower bucket) -> (probe [B, P] int64, scores [B, P] f32)."""
    s = queries @ buckets.centroids.T
    p = min(int(nprobe), buckets.n_buckets)
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return idx[:, :p], vals[:, :p]


def probe_masks(buckets: Buckets, queries: torch.Tensor, nprobe: int):
    """-> (strict, lenient) [B, C] bool: the top ``nprobe`` buckets, and
    every bucket within PROBE_TIE of the last of them."""
    p, vals = probe(buckets, queries, nprobe)
    strict = torch.zeros(queries.shape[0], buckets.n_buckets,
                         dtype=torch.bool, device=queries.device)
    strict.scatter_(1, p, True)
    lenient = (queries @ buckets.centroids.T) >= vals[:, -1:] - PROBE_TIE
    return strict, lenient
