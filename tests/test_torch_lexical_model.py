"""A model of the CUDA ``lexical_score`` kernel's algorithm, on the CPU,
against the port's plain version and the JAX reference.

The kernel (``csrc/lexical_score.cu``) does not score every (row, query).
Its persistent grid takes the reference's tiles in rounds (``plan_grid``,
``cta_tiles``); each round lists its matches: (posting, (query, t)) pairs
found by probing a hash table of the batch's terms.  The query's first
(l, t) hit in a row scores the row, in full and in the reference's order.
A round whose list fits (MAX_HITS) and finds room in the global list
(LIST) hands its matches to the last CTA, which offers each query all of
them in (tile asc, score desc, row asc) order; any other round keeps each
(tile, query)'s top-k by (score desc, column asc) itself (a (tile, query)
that lost a match to the full list scores the whole tile).  The last CTA
replays the reference's exchange over each query's candidates in tile
order, then sorts stably.  The model below does the same steps with f32
arithmetic in the kernel's order, rounds in either order; its answer must
be bit-equal to ``lexical_score_plain`` and to the reference's
``lexical_score_ref`` on sparse world postings and on tie-heavy ones, on
the fast path, the slow path, both mixed, and with the lists shrunk to
force the overflow branch.  On the CPU, XLA contracts the reference's
``s + qw * m`` into a fused multiply-add, so the random cases use weights
whose products are exact in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import lexical_score_ref
from repro_torch.kernels.lexical_score import (LIST, MAX_HITS, MAX_K,
                                               cta_tiles, lexical_score,
                                               lexical_score_plain,
                                               plan_grid)
from repro_torch.retrieval.lexical import build_doc_terms, query_terms

F32 = np.float32


def _first_hit(qtb, rt, l, t):
    """(l, t) is the query's first hit in row rt, in (l, t) order."""
    for l2 in range(l + 1):
        for t2 in range(len(qtb) if l2 < l else t):
            if qtb[t2] >= 0 and qtb[t2] == rt[l2]:
                return False
    return True


def _score(qtb, qwb, rt, dwr):
    """One row's score for one query: over t, then l, rounded f32 ops."""
    acc = F32(0)
    for t in range(len(qtb)):
        m = F32(0)
        for l in range(len(rt)):
            hit = rt[l] == qtb[t] and rt[l] >= 0 and qtb[t] >= 0
            m = F32(m + (dwr[l] if hit else F32(0)))
        acc = F32(acc + F32(qwb[t] * m))
    return acc


def _top_k(sc, k):
    """A tile's top-k of finite scores by (score desc, column asc): the
    reference's argmax rounds; [(score, column)]."""
    sc = list(sc)
    picks = []
    for _ in range(k):
        j = int(np.argmax(sc))
        if not sc[j] > -np.inf:
            break
        picks.append((sc[j], j))
        sc[j] = -np.inf
    return picks


def kernel_model(qt, qw, dt, dw, k, tile_n, max_hits=MAX_HITS, list_cap=LIST,
                 reverse=False, sms=4):
    """(vals [B,k], ids [B,k], rounds on the fast path, rounds on the slow
    path, (tile, query)s scored in full)."""
    b, t_q = qt.shape
    n = dt.shape[0]
    vals = np.full((b, k), -np.inf, F32)
    ids = np.full((b, k), -1, np.int32)
    if n == 0:
        return vals, ids, 0, 0, 0
    table = {}                                   # term -> [(query, t)]
    for q in range(b):
        for t in range(t_q):
            if qt[q, t] >= 0:
                table.setdefault(int(qt[q, t]), []).append((q, t))
    n_tiles = -(-n // tile_n)
    ctas = plan_grid(n_tiles, tile_n, sms)
    rounds = [tiles for c in range(ctas)
              for tiles in cta_tiles(c, ctas, n_tiles)]
    if reverse:                                  # CTAs finish in any order
        rounds = rounds[::-1]
    fast = {}                                    # query -> [(tile, v, row)]
    slow = {}                                    # (query, tile) -> [(v, row)]
    n_fast = n_slow = n_full = used = 0
    for tiles in rounds:
        matches = []                             # (tile, query, t, col, l)
        for tile in tiles:
            row0 = tile * tile_n
            for col in range(min(tile_n, n - row0)):
                for l, term in enumerate(dt[row0 + col]):
                    for q, t in table.get(int(term), ()) if term >= 0 else ():
                        matches.append((tile, q, t, col, l))
        if not matches:
            continue
        scored = []                              # (tile, query, col, v)
        for tile, q, t, col, l in matches[:max_hits]:
            row = tile * tile_n + col
            if _first_hit(qt[q], dt[row], l, t):
                v = _score(qt[q], qw[q], dt[row], dw[row])
                if v > 0:
                    scored.append((tile, q, col, v))
        if len(matches) <= max_hits and used + len(matches) <= list_cap:
            used += len(matches)                 # the fast path
            n_fast += 1
            for tile, q, col, v in scored:
                fast.setdefault(q, []).append((tile, v, tile * tile_n + col))
            continue
        n_slow += 1                              # the slow path
        lost = {(tile, q) for tile, q, _, _, _ in matches[max_hits:]}
        groups = {}
        for tile, q, col, v in scored:
            if (tile, q) not in lost:
                groups.setdefault((q, tile), []).append((v, col))
        for (q, tile), hits in groups.items():
            hits.sort(key=lambda h: (-h[0], h[1]))
            slow[(q, tile)] = [(v, tile * tile_n + col)
                               for v, col in hits[:k]]
        for tile, q in sorted(lost):             # the tile in full
            n_full += 1
            row0 = tile * tile_n
            sc = [_score(qt[q], qw[q], dt[r], dw[r])
                  for r in range(row0, min(row0 + tile_n, n))]
            picks = _top_k([s if s > 0 else -np.inf for s in sc], k)
            if picks:
                slow[(q, tile)] = [(v, row0 + c) for v, c in picks]
    for q in range(b):
        offered = [(tile, 0, -v, row, v) for tile, v, row in fast.get(q, [])]
        offered += [(tile, 1, j, row, v)
                    for (q2, tile), cands in slow.items() if q2 == q
                    for j, (v, row) in enumerate(cands)]
        for *_, row, v in sorted(offered):
            slot = int(np.argmin(vals[q]))       # the lowest slot of the min
            if v > vals[q, slot]:
                vals[q, slot], ids[q, slot] = v, row
        order = np.argsort(-vals[q], kind="stable")
        vals[q], ids[q] = vals[q, order], ids[q, order]
    ids[~np.isfinite(vals)] = -1
    return vals, ids, n_fast, n_slow, n_full


def _world(rng, n_ent, b):
    """World postings (entity term 1.0, pair terms 0.7, 5 a row) for
    n_ent entities of 5 passages, and b world queries (T=2)."""
    doc_entity = np.repeat(np.arange(n_ent), 5)
    mask = np.zeros((5 * n_ent, 12), bool)
    for _ in range(4):
        mask[np.arange(5 * n_ent), rng.integers(0, 12, 5 * n_ent)] = True
    dt, dw = build_doc_terms(doc_entity, mask, width=5)
    qs = [query_terms(int(e), int(a)) for e, a in
          zip(rng.integers(0, n_ent, b), rng.integers(0, 12, b))]
    return (np.stack([t for t, _ in qs]), np.stack([w for _, w in qs]), dt,
            dw)


def _ties(rng, n, b, vocab=6):
    """Tie-heavy postings: a vocabulary of 6, most rows match."""
    dt = rng.integers(-1, vocab, (n, 5)).astype(np.int32)
    dw = rng.choice([0.25, 0.375, 0.5, 0.75, 1.0], (n, 5)).astype(F32)
    dw[dt < 0] = 0.0
    qt = rng.integers(0, vocab, (b, 2)).astype(np.int32)
    qw = rng.choice([0.5, 0.75, 1.0], (b, 2)).astype(F32)
    return qt, qw, dt, dw


def _edge_queries(qt, qw):
    """A term shared by several queries, one repeated within a query, a
    zero weight, a -1 term and a term-less query."""
    qt, qw = qt.copy(), qw.copy()
    qt[1:4, 0] = qt[0, 0]
    qt[4, 1] = qt[4, 0]
    qw[5, 0] = 0.0
    qt[6, 1] = -1
    qt[7] = -1
    return qt, qw


def _data(kind, n):
    rng = np.random.default_rng(n)
    if kind == "world":
        qt, qw, dt, dw = _world(rng, -(-n // 5), 8)
        dt, dw = dt[:n], dw[:n]
        qt[:4] = dt[rng.integers(0, n, 4), :2]   # queries that surely hit
    else:
        qt, qw, dt, dw = _ties(rng, n, 8)
    qt, qw = _edge_queries(qt, qw)
    return qt, qw, dt, dw


def _check(qt, qw, dt, dw, k, tile_n, **kw):
    mv, mi, *counts = kernel_model(qt, qw, dt, dw, k, tile_n, **kw)
    pv, pi = lexical_score_plain(*map(torch.from_numpy, (qt, qw, dt, dw)),
                                 k, tile_n)
    rv, ri = lexical_score_ref(*map(jnp.asarray, (qt, qw, dt, dw)), k,
                               tile_n=tile_n)
    np.testing.assert_array_equal(mv, pv.numpy())
    np.testing.assert_array_equal(mi, pi.numpy())
    np.testing.assert_array_equal(mv, np.asarray(rv))
    np.testing.assert_array_equal(mi, np.asarray(ri))
    return mv, mi, counts


PATHS = {
    "fast": {},                                  # the kernel's lists
    "mixed": dict(list_cap=40),                  # the global list fills
    "mixed, rounds reversed": dict(list_cap=40, reverse=True),
    "slow": dict(list_cap=0),
    "overflow": dict(max_hits=3),                # lost matches: full tiles
}


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("tile_n", [99, 256, 512])
@pytest.mark.parametrize("kind", ["world", "ties"])
def test_kernel_model_matches_plain_and_reference(kind, tile_n, path):
    qt, qw, dt, dw = _data(kind, 1200)
    mv, mi, (n_fast, n_slow, n_full) = _check(qt, qw, dt, dw, 10, tile_n,
                                              **PATHS[path])
    assert np.isfinite(mv[:4]).all(axis=1).any()   # real matches
    assert (mi[7] == -1).all()                      # the term-less query
    if path == "slow":
        assert n_fast == 0 and n_slow > 0
    if path.startswith("mixed") and kind == "world":
        assert n_fast > 0 and n_slow > 0
    if path == "overflow":
        assert n_full > 0
    if path == "fast" and kind == "world":
        assert n_slow == 0


@pytest.mark.parametrize("k", [1, 10, MAX_K])
def test_kernel_model_k(k):
    qt, qw, dt, dw = _data("ties", 700)
    _check(qt, qw, dt, dw, k, 256)
    _check(qt, qw, dt, dw, k, 256, list_cap=40)


@pytest.mark.parametrize("n", [1, 90, 511])
def test_kernel_model_fewer_rows_than_a_tile(n):
    qt, qw, dt, dw = _data("ties", n)
    _check(qt, qw, dt, dw, 10, 512)


def test_kernel_model_no_rows():
    qt, qw, dt, dw = _data("ties", 5)
    dt, dw = dt[:0], dw[:0]
    mv, mi, *_ = kernel_model(qt, qw, dt, dw, 10, 512)
    assert np.isneginf(mv).all() and (mi == -1).all()
    pv, pi = lexical_score(*map(torch.from_numpy, (qt, qw, dt, dw)), 10)
    np.testing.assert_array_equal(mv, pv.numpy())
    np.testing.assert_array_equal(mi, pi.numpy())
