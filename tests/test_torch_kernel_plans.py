"""Host-side planning of the redesigned CUDA kernels, on the CPU.

The kernels themselves run only on the card (``test_torch_cuda_kernels.py``);
how their wrappers cut the work is plain Python and is checked here:
decode_attention's chunks of the cache and its kernel route,
topk_search's query tiles and even row ranges, ivf_scan's row ranges
over each query's probed pool, homology_score's tiles of cached rows
by drafts, and lexical_score's persistent grid over the postings tiles and
its chunks of queries.  Every position, row, tile and query must be
covered exactly once.
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import homology_score as HS
from repro_torch.kernels import ivf_scan as IS
from repro_torch.kernels import lexical_score as LS
from repro_torch.kernels import topk_search as TS

N_SM = 132                                  # an H100 SXM


def _decode_chunks(covered, chunk, nc):
    """[start, end) of each chunk that holds a valid position."""
    return [(c * chunk, min((c + 1) * chunk, covered)) for c in range(nc)
            if c * chunk < covered]


@pytest.mark.parametrize("b,hkv,covered", [
    (8, 2, 2112),                 # chatglm3-6b at the RAG shape
    (8, 4, 2049), (8, 10, 2111),  # starcoder2-7b, phi3-medium-14b groups
    (1, 2, 524_288), (128, 2, 32_768), (3, 2, 4099), (1, 1, 1),
    (5, 3, 63), (2, 7, 65), (1, 1, 1_000_003)])
def test_decode_chunks_cover_positions_once(b, hkv, covered):
    for mma in (True, False):
        slots = N_SM * (1 if mma else DA.SIMT_CTAS_PER_SM)
        chunk, nc, group = DA.plan_chunks(b * hkv, covered, slots)
        assert chunk % DA.CHUNK_ALIGN == 0 and 1 <= nc <= DA.MAX_CHUNKS
        spans = _decode_chunks(covered, chunk, nc)
        assert len(spans) == nc                 # no chunk is wholly empty
        seen = torch.zeros(covered, dtype=torch.int32)
        for lo, hi in spans:
            seen[lo:hi] += 1
        assert bool((seen == 1).all())
        # the merge: groups of `group` chunks, at most 32 partials at once
        n_groups = -(-nc // group)
        assert group <= 32 and n_groups <= 32
        assert (nc <= DA.SINGLE_LEVEL) == (n_groups == 1)
        members = [min(group, nc - j * group) for j in range(n_groups)]
        assert sum(members) == nc and min(members) >= 1


@pytest.mark.parametrize("cache_len", [0, 1, 700, 2047, 2111])
def test_decode_chunks_cut_by_cache_len(cache_len):
    """A device-tensor cache_len plans for all of S: the chunks that hold
    positions <= cache_len are a prefix, and cover them once."""
    s = 2112
    chunk, nc, _ = DA.plan_chunks(16, s, N_SM)
    used = -(-(cache_len + 1) // chunk)
    spans = _decode_chunks(cache_len + 1, chunk, nc)
    assert len(spans) == used and spans[-1][1] == cache_len + 1


def test_decode_rag_shape_fills_the_card_once():
    """16 (b, kvh) rows x 2112 positions: one wave of CTAs with a few
    64-position tiles each, not 528 blocks of two tiles."""
    chunk, nc, group = DA.plan_chunks(16, 2112, N_SM)
    assert 16 * nc <= N_SM and chunk <= 8 * DA.TILE and group == nc
    _, nc32, _ = DA.plan_chunks(256, 32_768, N_SM)
    assert nc32 == 1                            # no merge at decode_32k


@pytest.mark.parametrize("g", [1, 3, 4, 9, 16, 17, 32])
def test_decode_mma_route(g):
    """Which (dtype, D, G) the tensor-core kernel takes; the rest go to the
    SIMT kernel."""
    assert DA.uses_mma(torch.bfloat16, 128, g)
    assert DA.uses_mma(torch.bfloat16, 256, g) == (g <= 16)
    assert not DA.uses_mma(torch.float32, 128, g)
    assert not DA.uses_mma(torch.bfloat16, 96, g)


@pytest.mark.parametrize("b", [1, 7, 9, 64, 65, 200])
@pytest.mark.parametrize("n", [1, 300, 50_000, 50_001])
@pytest.mark.parametrize("k", [1, 10, 100, 1024])
def test_topk_scan_covers_rows_and_queries_once(b, n, k):
    tile, grid_x, q_tiles = TS.plan_scan(b, n, k, N_SM)
    qb, rows = TS.SCAN_TILES[tile]
    assert (q_tiles - 1) * qb < b <= q_tiles * qb
    if k > TS.WIDE_TILE_MAX_K:
        assert qb <= 8
    if b == 1:
        assert qb == 1
    n_tiles = -(-n // rows)
    assert 1 <= grid_x <= min(n_tiles, TS.MAX_LISTS)
    # block j scans rows [j * n // grid_x, (j + 1) * n // grid_x), in
    # tiles of `rows`: each corpus row once, shares within one row
    spans = [(j * n // grid_x, (j + 1) * n // grid_x) for j in range(grid_x)]
    seen = torch.zeros(n, dtype=torch.int32)
    for lo, hi in spans:
        seen[lo:hi] += 1
    assert bool((seen == 1).all())
    sizes = [hi - lo for lo, hi in spans]
    assert max(sizes) - min(sizes) <= 1
    # about one block per SM in all, so each query keeps grid_x * k
    # candidates for the merge (~1,300 at B=1, k=10)
    assert grid_x * q_tiles <= N_SM + q_tiles


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("k", [10, 1024])
@pytest.mark.parametrize("cap", [1, 5, 123, 977])
@pytest.mark.parametrize("p", [1, 64, 300, 512])
@pytest.mark.parametrize("b", [1, 64, 65])
def test_ivf_ranges_cover_the_pool_once(b, p, cap, k, sms):
    """ivf_scan's L ranges of a query's P*cap flat positions (range z is
    [z*n // L, (z+1)*n // L), as the kernel cuts it): each position once,
    at most 256 lists for the merge, ranges of at least 32 rows unless the
    pool is smaller, and at B=1 a CTA or more per SM wherever the pool has
    32 rows per SM."""
    n_ranges = IS.plan_ranges(b, p, cap, k, sms)
    n = p * cap
    assert 1 <= n_ranges <= IS.MAX_RANGES
    z = torch.arange(n_ranges + 1, dtype=torch.int64)
    bounds = z * n // n_ranges
    sizes = bounds[1:] - bounds[:-1]
    assert int(bounds[0]) == 0 and int(bounds[-1]) == n
    assert bool((sizes >= 1).all())          # ordered, none empty: a cover
    assert int(sizes.min()) >= min(n, IS.MIN_RANGE_ROWS)
    assert int(sizes.max() - sizes.min()) <= 1
    if b == 1 and n >= IS.MIN_RANGE_ROWS * sms:
        assert n_ranges >= min(sms, IS.MAX_RANGES)
    assert b * n_ranges <= IS.CTAS_PER_SM * sms + b   # ~4 CTAs per SM


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("k", [1, 10, 32, 1000])
@pytest.mark.parametrize("h", [1, 127, 5000, 5001])
@pytest.mark.parametrize("b", [1, 7, 64, 200])
def test_homology_tiles_cover_drafts_and_rows_once(b, h, k, sms):
    """CTA (x, y) scores rows [x*rows, (x+1)*rows) against drafts
    [y*tb, (y+1)*tb), both cut at the end: every (draft, row) once, the
    drafts' shared memory within its budget, and about CTAS_PER_SM CTAs
    per SM once B is large enough to fill them."""
    rows = 128
    tb, n_h, n_b = HS.plan_tiles(b, h, k, sms, rows)
    assert 1 <= tb <= min(HS.MAX_TILE_B, b)
    assert 4 * tb * (2 * k + 1) <= HS.SMEM_TILE
    seen = torch.zeros(b, h, dtype=torch.int32)
    for y in range(n_b):
        for x in range(n_h):
            seen[y * tb:(y + 1) * tb, x * rows:(x + 1) * rows] += 1
    assert bool((seen == 1).all())
    assert (n_h - 1) * rows < h <= n_h * rows
    assert (n_b - 1) * tb < b <= n_b * tb
    if tb < min(HS.MAX_TILE_B, HS.SMEM_TILE // (4 * (2 * k + 1))):
        # the tile was not held down by a cap: the grid is near its aim
        aim = HS.CTAS_PER_SM * sms
        assert 2 * n_h * n_b >= min(aim, b * n_h)
        assert n_h * n_b <= aim + n_h


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("n,tile_n", [
    (500_000, 512),               # the hybrid path: 977 tiles
    (100_003, 99), (100_003, 256), (1, 512), (511, 512), (512, 512),
    (513, 512), (20_011, 1), (70_000, 2048), (5_000_000, 512)])
def test_lexical_tiles_cover_rows_once(n, tile_n, sms):
    """CTA c of the persistent grid takes tiles c, c + G, ..., ROUND at a
    time: every tile once, each tile the reference's rows [t*tile_n,
    min((t+1)*tile_n, N)) (its pad rows past N are never read), at most
    CTAS_PER_SM CTAs a SM and one a tile, and their shared memory within
    what the CTAs of a SM share."""
    n_tiles = -(-n // tile_n)
    ctas = LS.plan_grid(n_tiles, tile_n, sms)
    fits = LS.CTAS_PER_SM * LS.smem_bytes(tile_n) <= LS.SMEM_LIMIT
    assert ctas == min(n_tiles, (LS.CTAS_PER_SM if fits else 1) * sms)
    seen = torch.zeros(n, dtype=torch.int32)
    tiles = torch.zeros(n_tiles, dtype=torch.int32)
    for c in range(ctas):
        rounds = LS.cta_tiles(c, ctas, n_tiles)
        walk = [t for r in rounds for t in r]
        assert walk == list(range(c, n_tiles, ctas))
        assert all(1 <= len(r) <= LS.ROUND for r in rounds)
        for t in walk:
            tiles[t] += 1
            seen[t * tile_n:min((t + 1) * tile_n, n)] += 1
    assert bool((tiles == 1).all()) and bool((seen == 1).all())
    if n == 500_000 and sms == 132:
        # one round a CTA: every tile of a CTA in flight at once
        assert ctas == 264 and all(len(LS.cta_tiles(c, ctas, n_tiles)) == 1
                                   for c in range(ctas))


@pytest.mark.parametrize("t_q", [0, 1, 2, 3, 256])
@pytest.mark.parametrize("b", [0, 1, 64, 65, 128, 129, 200, 1000])
def test_lexical_chunks_cover_queries_once(b, t_q):
    """Each launch holds at most MAX_QUERIES queries and MAX_ENTRIES
    (query, term) pairs; the chunks cover the batch once, in order, all
    full but the last (B=200 at T=2: two launches)."""
    chunks = LS.plan_chunks(b, t_q)
    seen = torch.zeros(b, dtype=torch.int32)
    for q0, q1 in chunks:
        assert q0 < q1 and q1 - q0 <= LS.MAX_QUERIES
        assert (q1 - q0) * t_q <= LS.MAX_ENTRIES
        seen[q0:q1] += 1
    assert bool((seen == 1).all())
    per = chunks[0][1] - chunks[0][0] if chunks else 0
    assert all(q1 - q0 == per for q0, q1 in chunks[:-1])
    if t_q == 2:
        assert len(chunks) == -(-b // 128)


def test_lexical_chunks_refuse_too_many_terms():
    with pytest.raises(ValueError):
        LS.plan_chunks(1, LS.MAX_ENTRIES + 1)
