"""Hashed-term lexical scoring with the reference's streamed top-k.

``lexical_score`` replaces the Pallas kernel
``src/repro/kernels/lexical_score.py::_lexical_kernel``.  A doc scores

    s[b, doc] = sum_t qw[b,t] * sum_l dw[doc,l] * [dt[doc,l] == qt[b,t]]

with ``-1`` term ids inert on both sides; a doc with no positive mass is
``-inf`` / id ``-1``.  The matched weights are summed over ``l`` in order,
then the terms over ``t`` in order, so the scores are bit-equal to the
reference's.

The answer is NOT the exact top-k by (score desc, row asc).  The reference
streams ``tile_n``-row tiles and merges each into a running [k] buffer by
K rounds of "the tile's best replaces the buffer's argmin when strictly
greater"; the argmin is the lowest buffer slot among equal minima, and the
final stable sort leaves ties in buffer-slot order.  Lexical scores tie all
the time (1.0, 1.49, ...), so both versions here replay that exchange over
the same tiles (pad rows past N never match).  The candidate stream is
each tile's top-k by (score desc, column asc), tiles in order; a candidate
that is not greater than the buffer's minimum changes nothing, so only the
finite candidates need replaying.

On a CUDA tensor the wrapper launches the kernel of
``csrc/lexical_score.cu`` once per chunk of at most MAX_QUERIES queries
and MAX_ENTRIES (query, term) pairs (:func:`plan_chunks`; one chunk up to
B=128 at T=2): a persistent grid (:func:`plan_grid`) streams the tiles'
terms into registers and probes them against a filter and hash table of
the batch's terms; the matches go to a list that the last CTA to arrive
scores, orders and replays the exchange over (a round with too many
matches keeps each tile's top-k per query itself); it raises if that
fails.  On a CPU tensor it runs :func:`lexical_score_plain`.
``lexical_score.launches`` counts the kernel's launches (one per chunk).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.utils import first_argmax

MAX_K = 32           # the replay keeps the buffer in one warp's lanes
SMEM_LIMIT = 227 * 1024
TABLE = 1024         # hash slots of the query terms
FILTER_BITS = 1 << 16   # their hashes' filter
MAX_ENTRIES = 256    # (query, term) pairs one launch holds
MAX_QUERIES = 128    # queries one launch holds
MAX_HITS = 512       # a round's list of matches
LIST = 2048          # matches handed to the last CTA
ROUND = 4            # tiles a CTA takes at once
CTAS_PER_SM = 2      # the persistent grid
# csrc/lexical_score.cu's shared memory: the filter, the table, a round's
# matches, per-query counts and the flags; then the last CTA's list
FIXED_SMEM = 4 * (FILTER_BITS // 32 + 2 * TABLE + 3 * MAX_ENTRIES
                  + 2 * MAX_HITS + 3 * MAX_QUERIES + 4
                  + ROUND * MAX_QUERIES // 32 + 4)
LIST_SMEM = 6 * 4 * LIST


def smem_bytes(tile_n: int) -> int:
    """A CTA's dynamic shared memory: the fixed part, the overflow path's
    tile_n scores and the last CTA's list."""
    return FIXED_SMEM + 4 * (-(-tile_n // 4) * 4) + LIST_SMEM


def plan_chunks(b: int, t_q: int) -> list[tuple[int, int]]:
    """[start, stop) of the queries of each launch: at most MAX_QUERIES
    queries and MAX_ENTRIES (query, term) pairs a launch."""
    per = MAX_QUERIES if t_q == 0 else min(MAX_QUERIES, MAX_ENTRIES // t_q)
    if per == 0:
        raise ValueError(f"lexical_score: {t_q} terms a query exceed the "
                         f"kernel's {MAX_ENTRIES}-entry table")
    return [(q, min(q + per, b)) for q in range(0, b, per)]


def plan_grid(n_tiles: int, tile_n: int, sms: int) -> int:
    """CTAs of the persistent grid: CTAS_PER_SM a SM (one if their shared
    memory does not fit twice), at most one a tile; CTA c takes the rounds
    :func:`cta_tiles` gives it."""
    per_sm = CTAS_PER_SM if CTAS_PER_SM * smem_bytes(tile_n) <= SMEM_LIMIT \
        else 1
    return max(1, min(n_tiles, per_sm * sms))


def cta_tiles(cta: int, ctas: int, n_tiles: int) -> list[list[int]]:
    """The rounds of tiles CTA ``cta`` of ``ctas`` scores, in its order:
    tiles cta, cta + ctas, ..., ROUND at a time."""
    tiles = list(range(cta, n_tiles, ctas))
    return [tiles[i:i + ROUND] for i in range(0, len(tiles), ROUND)]


def _stream_candidates(scores: torch.Tensor, k: int, tile_n: int):
    """[B, N] scores -> each tile's top-k (score desc, column asc), tiles in
    order, compacted to the finite ones: (vals [B,M], rows [B,M]), with
    ``-inf`` where a row has fewer than M."""
    b, n = scores.shape
    n_tiles = -(-n // tile_n)
    pad = n_tiles * tile_n - n
    if pad:
        scores = torch.cat([scores, scores.new_full((b, pad), -torch.inf)],
                           dim=1)
    tiles = scores.reshape(b, n_tiles, tile_n)
    kk = min(k, tile_n)
    tv, tc = torch.sort(tiles, dim=2, descending=True, stable=True)
    tv, tc = tv[..., :kk], tc[..., :kk]
    base = torch.arange(n_tiles, device=scores.device)[:, None] * tile_n
    vals, rows = tv.reshape(b, -1), (tc + base).reshape(b, -1)
    finite = torch.isfinite(vals)
    order = torch.sort((~finite).to(torch.uint8), dim=1, stable=True).indices
    m = int(finite.sum(dim=1).max()) if b else 0
    order = order[:, :m]
    return torch.gather(vals, 1, order), torch.gather(rows, 1, order)


def lexical_score_plain(q_terms: torch.Tensor, q_weights: torch.Tensor,
                        doc_terms: torch.Tensor, doc_weights: torch.Tensor,
                        k: int, tile_n: int = 512):
    """q_terms/q_weights [B,T], doc_terms/doc_weights [N,L] -> (vals [B,k]
    desc f32, postings-row ids [B,k] int32), as the reference streams it
    (module docstring)."""
    b, t_q = q_terms.shape
    n, l_w = doc_terms.shape
    dev = q_terms.device
    qt, qw = q_terms.to(torch.int32), q_weights.float()
    dt, dw = doc_terms.to(torch.int32), doc_weights.float()
    s = torch.zeros((b, n), dtype=torch.float32, device=dev)
    for t in range(t_q):
        qt_t = qt[:, t:t + 1]                                   # [B, 1]
        m = torch.zeros((b, n), dtype=torch.float32, device=dev)
        for l in range(l_w):
            hit = (dt[None, :, l] == qt_t) & (dt[None, :, l] >= 0) \
                & (qt_t >= 0)
            m = m + torch.where(hit, dw[None, :, l], 0.0)
        s = s + qw[:, t:t + 1] * m
    s = torch.where(s > 0.0, s, -torch.inf)

    vals = torch.full((b, k), -torch.inf, dtype=torch.float32, device=dev)
    idx = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    if n:
        cand_v, cand_r = _stream_candidates(s, k, tile_n)
        slots = torch.arange(k, device=dev)
        for j in range(cand_v.shape[1]):
            v = cand_v[:, j:j + 1]
            slot = first_argmax(-vals)                   # first argmin
            hit = (slots[None, :] == slot[:, None]) \
                & (v > vals.min(dim=1, keepdim=True).values)
            vals = torch.where(hit, v, vals)
            idx = torch.where(hit, cand_r[:, j:j + 1].to(torch.int32), idx)
    vals, order = torch.sort(vals, dim=1, descending=True, stable=True)
    idx = torch.gather(idx, 1, order)
    return vals, torch.where(torch.isfinite(vals), idx, -1)


def lexical_score(q_terms: torch.Tensor, q_weights: torch.Tensor,
                  doc_terms: torch.Tensor, doc_weights: torch.Tensor,
                  k: int, tile_n: int = 512):
    """Same contract as :func:`lexical_score_plain`; the kernel on CUDA."""
    if q_terms.device.type != "cuda":
        return lexical_score_plain(q_terms, q_weights, doc_terms,
                                   doc_weights, k, tile_n)
    b, t_q = q_terms.shape
    n, l_w = doc_terms.shape
    if q_weights.shape != (b, t_q) or doc_weights.shape != (n, l_w):
        raise ValueError(
            f"lexical_score: q_terms {tuple(q_terms.shape)}, q_weights "
            f"{tuple(q_weights.shape)}, doc_terms {tuple(doc_terms.shape)}, "
            f"doc_weights {tuple(doc_weights.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"lexical_score: k must be in [1, {MAX_K}], got {k}")
    if not 1 <= tile_n <= 0xffff or tile_n * l_w >= 1 << 22 or \
            smem_bytes(tile_n) > SMEM_LIMIT:
        raise ValueError(f"lexical_score: a {tile_n}-row tile of {l_w} "
                         f"terms does not fit one block's shared memory")
    chunks = plan_chunks(b, t_q)
    qt = q_terms.to(torch.int32).contiguous()
    qw = q_weights.float().contiguous()
    dt = doc_terms.to(torch.int32).contiguous()
    dw = doc_weights.float().contiguous()
    dev = _build.check_operands("lexical_score", qt, qw, dt, dw)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0 or n == 0:
        return vals.fill_(-torch.inf), ids.fill_(-1)
    n_tiles = -(-n // tile_n)
    ctas = plan_grid(n_tiles, tile_n, _build.sm_count(dev))
    bc = chunks[0][1] - chunks[0][0]
    st = _build.stream(dev)
    # the ticket, the list's counts and each query's bitmap of tiles; the
    # list of matches, then the slow path's candidates
    tickets, words = _build.scratch(
        "lexical_score", dev, st, -(-(4 + bc * -(-n_tiles // 32)) // 32) * 32,
        2 * LIST + 2 * bc * n_tiles * k)
    fn = _build.entry("lexical_score", "has_lexical_score")
    for q0, q1 in chunks:
        _build.check(fn(
            qt.data_ptr() + 4 * q0 * t_q, qw.data_ptr() + 4 * q0 * t_q,
            dt.data_ptr(), dw.data_ptr(), tickets, words,
            vals.data_ptr() + 4 * q0 * k, ids.data_ptr() + 4 * q0 * k,
            q1 - q0, t_q, n, l_w, tile_n, k, ctas, st), "lexical_score")
        lexical_score.launches += 1
    return vals, ids


lexical_score.launches = 0
