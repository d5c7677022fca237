"""Each CUDA kernel of the port against its plain version, on the card.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip
without one.  They import nothing of JAX, so they run on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Scores must agree to 1e-5 (f32 sums of 768 products taken in another
order); ids must be equal except swaps between candidates whose scores lie
within that tolerance; unweighted homology scores, and each draft's best
score and row, must be bit-equal.
Decode attention agrees to 2e-5 (f32 softmax sums in another order, the
reference's own f32 tolerance); the EmbeddingBag is bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_plain)
from repro_torch.kernels.fused_rerank import (fused_rerank,
                                              fused_rerank_plain,
                                              fused_scores,
                                              fused_scores_plain)
from repro_torch.kernels.homology_score import (homology_score,
                                                homology_validate,
                                                homology_validate_plain)
from repro_torch.kernels import _build
from repro_torch.kernels.ivf_scan import ivf_scan, ivf_scan_plain
from repro_torch.kernels import lexical_score as LS
from repro_torch.kernels.lexical_score import (lexical_score,
                                               lexical_score_plain)
from repro_torch.kernels.topk_search import (MAX_K, topk_search,
                                             topk_search_plain)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _topk_inputs(rng, b, n, d, valid_p, groups):
    q = rng.normal(size=(b, d)).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    valid = rng.random(n) < valid_p
    rg = rng.integers(0, 3, n).astype(np.int32) if groups else None
    qg = rng.integers(0, 3, b).astype(np.int32) if groups else None
    return q, c, valid, rg, qg


def _ivf_inputs(rng, b, c, cap, d, p):
    vecs = rng.normal(size=(c, cap, d)).astype(np.float32)
    ids = rng.permutation(c * cap).reshape(c, cap).astype(np.int32)
    ids[rng.random((c, cap)) < 0.3] = -1         # pad slots
    vecs[ids < 0] = 0.0
    q = rng.normal(size=(b, d)).astype(np.float32)
    probe = np.stack([rng.permutation(c)[:p] for _ in range(b)]) \
        .astype(np.int32)
    return q, probe, vecs, ids


# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _near_tie_ok(vals_plain, idx_a, idx_b, tol=1e-5):
    """Ids equal, except swaps between candidates whose scores lie within
    ``tol`` of each other (f32 sums taken in another order)."""
    va = vals_plain.cpu().numpy()
    for row in range(idx_a.shape[0]):
        for j in np.flatnonzero(idx_a[row].cpu() != idx_b[row].cpu()):
            close = np.abs(va[row] - va[row, j]) <= tol
            if close.sum() < 2:
                return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,groups,k", [
    (1, 50_000, False, 10), (64, 5000, True, 10), (3, 300, False, 10),
    (65, 50_000, False, 10),                     # a ragged query tile
    (7, 20_000, True, 100), (64, 50_000, False, 100), (1, 50_000, False, 1)])
def test_cuda_topk_search_vs_plain(cuda_dev, b, n, groups, k):
    rng = np.random.default_rng(b)
    q, c, valid, rg, qg = _topk_inputs(rng, b, n, 768, 0.9, groups)
    args = [_t(x).to(cuda_dev) for x in (q, c, valid)]
    kw = {} if rg is None else dict(row_group=_t(rg).to(cuda_dev),
                                    q_group=_t(qg).to(cuda_dev))
    v0, i0 = topk_search_plain(*args[:2], k, valid=args[2], **kw)
    v1, i1 = topk_search(*args[:2], k, valid=args[2], **kw)
    torch.testing.assert_close(v1, v0, rtol=1e-5, atol=1e-5)
    assert _near_tie_ok(v0, i0, i1)


def _homology_inputs(rng, b, h, k, weights, groups, dev):
    """Drafts [B,k] and a cache [H,k] of ids from a small range (real
    overlaps, -1 slots in both), 90% valid rows; weights None, "dyadic"
    (multiples of 1/64: sums exact in any order) or "random"."""
    draft = rng.integers(-1, 60, (b, k)).astype(np.int32)
    cache = rng.integers(-1, 60, (h, k)).astype(np.int32)
    valid = rng.random(h) < 0.9
    w = None
    if weights == "dyadic":
        w = rng.integers(0, 9, (b, k)).astype(np.float32) / 64
    elif weights == "random":
        w = rng.random((b, k)).astype(np.float32)
    kw = {}
    if groups:
        kw = dict(row_group=_t(rng.integers(0, 3, h).astype(np.int32)),
                  q_group=_t(rng.integers(0, 3, b).astype(np.int32)))
    args = [_t(x).to(dev) for x in (draft, cache, valid)]
    kw = {n: x.to(dev) for n, x in kw.items()}
    if w is not None:
        kw["draft_weights"] = _t(w).to(dev)
    return args, kw


def _check_validate(got, want, exact):
    """homology_validate (scores, best, slot) against the plain version:
    scores bit-equal (within 1e-6 when not exact), best and slot equal
    (when not exact: the kernel's slot holds a score within 1e-6 of the
    plain best)."""
    (s1, b1, t1), (s0, b0, t0) = got, want
    assert t1.dtype == torch.int32 and b1.dtype == torch.float32
    if exact:
        assert torch.equal(s1, s0) and torch.equal(b1, b0)
        assert torch.equal(t1, t0)
        return
    torch.testing.assert_close(s1, s0, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(b1, b0, rtol=1e-6, atol=1e-6)
    at = torch.gather(s0, 1, t1.long()[:, None])[:, 0]
    assert bool(((at - b0).abs() <= 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("weights,groups", [(None, False), ("dyadic", True),
                                            ("random", False)])
@pytest.mark.parametrize("k", [1, 10, 32, 7])
@pytest.mark.parametrize("b", [1, 64, 200])
def test_cuda_homology_score_vs_plain(cuda_dev, b, k, weights, groups):
    """homology_score and homology_validate against their plain versions
    at B 1, 64 and 200, the templated widths k = 1, 10, 32 and the generic
    route (k = 7), weighted and grouped: one launch a call each."""
    rng = np.random.default_rng(b * 100 + k)
    args, kw = _homology_inputs(rng, b, 5000, k, weights, groups, cuda_dev)
    exact = weights != "random"
    n0 = homology_score.launches
    s1 = homology_score(*args, **kw)
    got = homology_validate(*args, **kw)
    assert homology_score.launches == n0 + 2
    want = homology_validate_plain(*args, **kw)
    if exact:
        assert torch.equal(s1, want[0])
    _check_validate(got, want, exact)


@pytest.mark.cuda
def test_cuda_homology_validate_ties_and_empty(cuda_dev):
    """Equal best scores in rows far apart (other CTAs, other warps) go to
    the lowest row; a table of invalid rows gives slot 0 and best 0."""
    b, h, k = 5, 5000, 10
    cache = torch.full((h, k), -1, dtype=torch.int32, device=cuda_dev)
    draft = torch.arange(b * k, dtype=torch.int32,
                         device=cuda_dev).reshape(b, k)
    for row, (rows, hits) in enumerate([((4999, 130, 3001), 3),
                                        ((128, 127), 5), ((4000, 4999), 10),
                                        ((), 0), ((0, 2500), 1)]):
        for r in rows:
            cache[r, :hits] = draft[row, :hits]
    valid = torch.ones(h, dtype=torch.bool, device=cuda_dev)
    got = homology_validate(draft, cache, valid)
    _check_validate(got, homology_validate_plain(draft, cache, valid), True)
    assert got[2].tolist() == [130, 127, 4000, 0, 0]
    none = torch.zeros(h, dtype=torch.bool, device=cuda_dev)
    s, best, slot = homology_validate(draft, cache, none)
    assert not s.any() and not best.any() and not slot.any()


@pytest.mark.cuda
def test_cuda_homology_validate_back_to_back_and_two_streams(cuda_dev):
    """200 calls on one stream repeat the first and leave every ticket at
    zero; calls on two streams at once each match the plain version."""
    rng = np.random.default_rng(17)
    args, kw = _homology_inputs(rng, 64, 5000, 10, None, False, cuda_dev)
    first = homology_validate(*args, **kw)
    for _ in range(199):
        last = homology_validate(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, last))
    for (name, _, _), (buf, n_tickets, _) in _build.scratch_cache.items():
        if name == "homology_score":
            assert not buf[:n_tickets].view(torch.int32).any()
    cases = [_homology_inputs(rng, b, 5000, 10, None, False, cuda_dev)
             for b in (1, 65)]
    streams = [torch.cuda.Stream() for _ in cases]
    outs = []
    for st, (a, kw_) in zip(streams, cases):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(homology_validate(*a, **kw_))
    torch.cuda.synchronize()
    for (a, kw_), got in zip(cases, outs):
        _check_validate(got, homology_validate_plain(*a, **kw_), True)


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,k", [(1, 64, 10), (64, 64, 10), (2, 1, 10),
                                   (32, 64, 10)])
def test_cuda_ivf_scan_vs_plain(cuda_dev, b, p, k):
    rng = np.random.default_rng(p)
    q, probe, vecs, ids = _ivf_inputs(rng, b, 256, 123 if p > 1 else 5,
                                      768, p)
    args = [_t(x).to(cuda_dev) for x in (q, probe, vecs, ids)]
    v0, i0 = ivf_scan_plain(*args, k)
    v1, i1 = ivf_scan(*args, k)
    torch.testing.assert_close(v1, v0, rtol=1e-5, atol=1e-5)
    assert _near_tie_ok(v0, i0, i1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,cap", [(1, 32, 977), (64, 32, 977), (2, 1, 5)])
def test_cuda_ivf_scan_int8_vs_plain(cuda_dev, b, p, cap):
    rng = np.random.default_rng(cap + b)
    c, d, k = 96, 768, 10
    codes = rng.integers(-127, 128, size=(c, cap, d)).astype(np.int8)
    scales = rng.uniform(1e-4, 1e-3, size=(c, cap, 2)).astype(np.float32)
    ids = rng.permutation(c * cap).reshape(c, cap).astype(np.int32)
    ids[rng.random((c, cap)) < 0.3] = -1
    ids[3] = -1                                  # an all-pad bucket
    scales[4] = np.float32(1e-12)                # zero residuals
    codes[4] = 0
    q = rng.normal(size=(b, d)).astype(np.float32)
    probe = np.stack([rng.permutation(c)[:p] for _ in range(b)]) \
        .astype(np.int32)
    probe[0, 0] = 3
    bias = rng.normal(size=(b, p)).astype(np.float32)
    args = [_t(x).to(cuda_dev) for x in (q, probe, codes, ids)]
    kw = dict(bucket_scales=_t(scales).to(cuda_dev),
              probe_bias=_t(bias).to(cuda_dev))
    v0, i0 = ivf_scan_plain(*args, k, **kw)
    v1, i1 = ivf_scan(*args, k, **kw)
    torch.testing.assert_close(v1, v0, rtol=1e-5, atol=1e-5)
    assert _near_tie_ok(v0, i0, i1)


def _ivf_world(rng, scaled, c, cap, d):
    """(vecs, ids, scales) of an index of c buckets: f32 vectors, or int8
    codes with their two scales; ~30% pad slots."""
    ids = rng.permutation(c * cap).reshape(c, cap).astype(np.int32)
    ids[rng.random((c, cap)) < 0.3] = -1
    if not scaled:
        return rng.normal(size=(c, cap, d)).astype(np.float32), ids, None
    codes = rng.integers(-127, 128, size=(c, cap, d)).astype(np.int8)
    return codes, ids, rng.uniform(1e-4, 1e-3, (c, cap, 2)).astype(
        np.float32)


def _ivf_call(dev, q, probe, vecs, ids, scales, k, bias=None):
    """Kernel and plain results of one call; the plain version gets the
    probe clamped into range, as the kernel clamps it."""
    t = [_t(x).to(dev) for x in (q, probe, vecs, ids)]
    kw = {}
    if scales is not None:
        if bias is None:
            bias = np.random.default_rng(1).normal(
                size=probe.shape).astype(np.float32)
        kw = dict(bucket_scales=_t(scales).to(dev),
                  probe_bias=_t(bias).to(dev))
    counter = "launches_int8" if kw else "launches"
    n0 = getattr(ivf_scan, counter)
    got = ivf_scan(*t, k, **kw)
    assert getattr(ivf_scan, counter) == n0 + 1          # one launch
    t[1] = t[1].clamp(0, vecs.shape[0] - 1)
    return got, ivf_scan_plain(*t, k, **kw)


# (B, P, cap, k, d) of the one-launch cases
IVF_CASES = {"B=1": (1, 64, 61, 10, 768), "B=7": (7, 64, 61, 10, 768),
             "B=64": (64, 64, 61, 10, 768), "B=65": (65, 64, 61, 10, 768),
             "k=1": (7, 64, 61, 1, 768), "k=MAX_K": (7, 64, 61, MAX_K, 768),
             "P=1": (7, 1, 61, 10, 768), "P=512": (7, 512, 61, 10, 768),
             "pool < k": (3, 3, 3, 10, 768), "d=770": (7, 16, 37, 10, 770)}


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("case", list(IVF_CASES))
def test_cuda_ivf_scan_one_launch_vs_plain(cuda_dev, case, scaled):
    """Both modes in one launch, with an out-of-range probe (clamped)."""
    b, p, cap, k, d = IVF_CASES[case]
    rng = np.random.default_rng(p * cap + b)
    c = p + 2
    vecs, ids, scales = _ivf_world(rng, scaled, c, cap, d)
    probe = np.stack([rng.permutation(c - 1)[:p] for _ in range(b)]) \
        .astype(np.int32)
    probe[:, -1] = c + 5                        # clamped to bucket c - 1
    q = rng.normal(size=(b, d)).astype(np.float32)
    (v1, i1), (v0, i0) = _ivf_call(cuda_dev, q, probe, vecs, ids, scales, k)
    torch.testing.assert_close(v1, v0, rtol=1e-5, atol=1e-5)
    assert _near_tie_ok(v0, i0, i1)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
def test_cuda_ivf_scan_pads_and_ties(cuda_dev, scaled):
    """Every probed slot a pad gives (-inf, -1); equal vectors in two
    probed buckets tie, and the earlier probe wins."""
    rng = np.random.default_rng(11)
    vecs, ids, scales = _ivf_world(rng, scaled, 40, 61, 768)
    pads = ids.copy()
    pads[:20] = -1
    probe = np.stack([rng.permutation(20) for _ in range(3)]).astype(np.int32)
    q = rng.normal(size=(3, 768)).astype(np.float32)
    (v1, i1), _ = _ivf_call(cuda_dev, q, probe, vecs, pads, scales, 10)
    assert torch.isneginf(v1).all() and (i1 == -1).all()
    probe = np.stack([rng.permutation(40)[:16] for _ in range(2)]) \
        .astype(np.int32)
    early, late = probe[0, 2], probe[0, 11]
    vecs[late, 7] = vecs[early, 30]
    ids[early, 30], ids[late, 7] = 10 ** 8, 10 ** 8 + 1
    if scaled:
        scales[early, 30] = scales[late, 7] = 1.1e-3
    q = np.repeat(vecs[early, 30].astype(np.float32)[None], 2, 0)
    (v1, i1), (v0, i0) = _ivf_call(cuda_dev, q, probe, vecs, ids, scales, 10,
                                   bias=np.full((2, 16), 0.5, np.float32))
    assert float(v1[0, 0]) == float(v1[0, 1])
    assert i1[0, :2].tolist() == [10 ** 8, 10 ** 8 + 1]
    torch.testing.assert_close(v1, v0, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
def test_cuda_ivf_scan_back_to_back_and_two_streams(cuda_dev, scaled):
    """200 calls on one stream repeat the first and leave every ticket at
    zero; calls on two streams at once each match the plain version."""
    rng = np.random.default_rng(12)
    vecs, ids, scales = _ivf_world(rng, scaled, 300, 61, 768)
    t = dict(vecs=_t(vecs).to(cuda_dev), ids=_t(ids).to(cuda_dev))
    kw = {}
    if scaled:
        kw = dict(bucket_scales=_t(scales).to(cuda_dev))

    def inputs(b):
        q = _t(rng.normal(size=(b, 768)).astype(np.float32)).to(cuda_dev)
        pr = _t(np.stack([rng.permutation(300)[:64] for _ in range(b)])
                .astype(np.int32)).to(cuda_dev)
        bias = dict(probe_bias=_t(rng.normal(size=(b, 64)).astype(
            np.float32)).to(cuda_dev)) if scaled else {}
        return q, pr, bias

    q, pr, bias = inputs(7)
    first = ivf_scan(q, pr, t["vecs"], t["ids"], 10, **kw, **bias)
    for _ in range(199):
        last = ivf_scan(q, pr, t["vecs"], t["ids"], 10, **kw, **bias)
    torch.cuda.synchronize()
    assert torch.equal(first[0], last[0]) and torch.equal(first[1], last[1])
    for (name, _, _), (buf, n_tickets, _) in _build.scratch_cache.items():
        if name == "ivf_scan":
            assert not buf[:n_tickets].view(torch.int32).any()
    args = [inputs(b) for b in (3, 65)]
    streams = [torch.cuda.Stream() for _ in args]
    outs = []
    for st, (q, pr, bias) in zip(streams, args):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(ivf_scan(q, pr, t["vecs"], t["ids"], 10, **kw,
                                 **bias))
    torch.cuda.synchronize()
    for (q, pr, bias), (v1, i1) in zip(args, outs):
        v0, i0 = ivf_scan_plain(q, pr, t["vecs"], t["ids"], 10, **kw,
                                **bias)
        torch.testing.assert_close(v1, v0, rtol=1e-5, atol=1e-5)
        assert _near_tie_ok(v0, i0, i1)


def _lexical_inputs(rng, b, n, vocab, dev, t_q=2):
    dt = rng.integers(-1, vocab, (n, 5)).astype(np.int32)
    dw = rng.choice([0.7, 1.0, 0.45], (n, 5)).astype(np.float32)
    dw[dt < 0] = 0.0
    qt = rng.integers(-1, vocab, (b, t_q)).astype(np.int32)
    qw = rng.choice([1.0, 0.7, 0.0], (b, t_q)).astype(np.float32)
    return [_t(x).to(dev) for x in (qt, qw, dt, dw)]


def _lexical_check(args, k, tile_n=512):
    """Kernel and plain bit-equal; the launches are the planned chunks."""
    n0 = lexical_score.launches
    v1, i1 = lexical_score(*args, k, tile_n=tile_n)
    assert lexical_score.launches - n0 == len(
        LS.plan_chunks(*args[0].shape))
    v0, i0 = lexical_score_plain(*args, k, tile_n=tile_n)
    assert torch.equal(v1, v0) and torch.equal(i1, i0)
    return v1, i1


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,vocab,tile_n", [(1, 500_000, 4000, 512),
                                              (64, 50_000, 6, 512),
                                              (3, 2000, 6, 256)])
def test_cuda_lexical_score_vs_plain(cuda_dev, b, n, vocab, tile_n):
    rng = np.random.default_rng(n)
    _lexical_check(_lexical_inputs(rng, b, n, vocab, cuda_dev), 10, tile_n)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, LS.MAX_K])
@pytest.mark.parametrize("b", [1, 64, 65, 200])
def test_cuda_lexical_score_batches_and_k(cuda_dev, b, k):
    """Sparse matches over 500,000 rows (about 5 a term); B=200 takes two
    launches (MAX_ENTRIES)."""
    rng = np.random.default_rng(b + k)
    args = _lexical_inputs(rng, b, 500_000, 200_000, cuda_dev)
    v, _ = _lexical_check(args, k)
    assert bool(torch.isfinite(v).any())


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [1, 3, 99, 256, 512, 4096])
def test_cuda_lexical_score_overflow_and_unaligned_tiles(cuda_dev, tile_n):
    """Term 7 sits in every row and query 0 asks for it: its hits overflow
    each tile's list (the tile is scored in full for it) while the other
    queries' sparse hits stay in the list; tile_n 1, 3 and 99 give tiles
    that start off a 16-byte boundary; 20,011 rows end in a tail tile."""
    rng = np.random.default_rng(tile_n)
    qt, qw, dt, dw = _lexical_inputs(rng, 9, 20_011, 3000, cuda_dev)
    dt[:, 2], dw[:, 2] = 7, 0.45
    qt[0, 0], qt[1] = 7, qt[2]                   # a shared pair of terms
    qt[3, 1] = qt[3, 0]                          # a term repeated
    qw[4, 0] = 0.0
    _lexical_check((qt, qw, dt, dw), 10, tile_n)


@pytest.mark.cuda
@pytest.mark.parametrize("b,vocab", [(64, 2000), (8, 300)])
def test_cuda_lexical_score_fast_and_slow_rounds(cuda_dev, b, vocab):
    """Matches dense enough that the global list of LIST fills: the first
    rounds hand their matches to the last CTA, the later ones keep their
    tiles' top-k, and the replay merges both in tile order."""
    rng = np.random.default_rng(vocab)
    _lexical_check(_lexical_inputs(rng, b, 200_000, vocab, cuda_dev), 10)


@pytest.mark.cuda
def test_cuda_lexical_score_back_to_back_and_two_streams(cuda_dev):
    """200 calls on one stream repeat the first and leave the ticket and
    every bitmap word at zero; calls on two streams at once each match the
    plain version."""
    rng = np.random.default_rng(21)
    args = _lexical_inputs(rng, 64, 100_000, 6, cuda_dev)
    first = lexical_score(*args, 10)
    for _ in range(199):
        last = lexical_score(*args, 10)
    torch.cuda.synchronize()
    assert torch.equal(first[0], last[0]) and torch.equal(first[1], last[1])
    cases = [_lexical_inputs(rng, b, 30_000, v, cuda_dev)
             for b, v in ((1, 50), (130, 6))]
    streams = [torch.cuda.Stream() for _ in cases]
    outs = []
    for st, a in zip(streams, cases):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(lexical_score(*a, 10, tile_n=99))
    torch.cuda.synchronize()
    for a, (v1, i1) in zip(cases, outs):
        v0, i0 = lexical_score_plain(*a, 10, tile_n=99)
        assert torch.equal(v1, v0) and torch.equal(i1, i0)
    for (name, _, _), (buf, n_tickets, _) in _build.scratch_cache.items():
        if name == "lexical_score":
            assert not buf[:n_tickets].view(torch.int32).any()


@pytest.mark.cuda
def test_cuda_lexical_score_one_launch_a_call(cuda_dev):
    """A call launches the kernel once (B=200: twice, once a chunk) and
    nothing else: the launch count, and the profiler over 10 calls sees no
    other kernel (it may miss a few launches at the edge of its window);
    the dynamic shared memory is the planned."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(5)
    for b, want in ((1, 1), (64, 1), (200, 2)):
        args = _lexical_inputs(rng, b, 100_000, 50_000, cuda_dev)
        n0 = lexical_score.launches
        lexical_score(*args, 10)
        assert lexical_score.launches - n0 == want
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                lexical_score(*args, 10)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(kernels) == 1 and "lexical_kernel" in kernels[0].key
        assert 1 <= kernels[0].count <= 10 * want
    lib = _build.library("lexical_score")
    assert lib.has_lexical_smem(512) == LS.smem_bytes(512)
    assert lib.has_lexical_smem(99) == LS.smem_bytes(99)


def _fused_pool(rng, b, p, d=768):
    """A pool of p slots (kd = p // 2): ids from a small range (repeats
    within and across channels), row 0 empty, row 1's lexical list the
    dense one, near-duplicate pairs (slots 2, 3 and 2, kd + 2), zero
    vectors on invalid slots."""
    kd = p // 2
    q = rng.normal(size=(b, d)).astype(np.float32)
    ids = rng.integers(0, 2 * p, size=(b, p)).astype(np.int32)
    ids[rng.random((b, p)) < 0.1] = -1
    ids[0] = -1
    if b > 1 and p > 1:
        ids[1, kd:kd + kd] = ids[1, :kd]
    vecs = rng.normal(size=(b, p, d)).astype(np.float32)
    if p > 3:
        vecs[:, 3] = vecs[:, 2] + 0.05 * rng.normal(size=(b, d))
    if 2 < kd < p - 2:      # equal masses, near-duplicates: the tie decides
        vecs[:, kd + 2] = vecs[:, 2] + 0.05 * rng.normal(size=(b, d))
    vecs[ids < 0] = 0.0
    return q, ids, vecs, kd


def _near_threshold_rows(vecs, dsim, tol=1e-5):
    """Rows with a cosine within tol of dsim (f64): their keep decisions
    may differ between f32 sums taken in another order."""
    if dsim is None:
        return torch.zeros(vecs.shape[0], dtype=torch.bool)
    v = vecs.double().cpu()
    vn = v / v.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    return ((vn @ vn.transpose(1, 2) - dsim).abs() <= tol).flatten(1) \
        .any(dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dsim", [None, 0.5, 0.98])
@pytest.mark.parametrize("b,p,k", [(1, 20, 10), (64, 20, 10), (65, 20, 10),
                                   (64, 1, 10), (7, 64, 10), (64, 64, 1),
                                   (3, 20, 25), (2, 64, 100), (1, 1, 1)])
def test_cuda_fused_rerank_vs_plain(cuda_dev, b, p, k, dsim):
    """fused_scores and fused_rerank (one launch each, the final top-k in
    it) against the plain versions: masses bit-equal, rscores within 1e-4
    of f32 sums of 768 products, vals equal, ids equal except between
    equal masses whose rscores lie within 1e-4 (and rows with a cosine
    within 1e-5 of dsim, whose keep decisions may differ)."""
    rng = np.random.default_rng(b * 1000 + p * 10 + k)
    q, ids, vecs, kd = _fused_pool(rng, b, p)
    args = [_t(x).to(cuda_dev) for x in (q, ids, vecs)]
    exempt = _near_threshold_rows(args[2], dsim)
    n0 = fused_scores.launches
    m1, r1 = fused_scores(*args, kd, 60.0, dsim)
    v1, i1 = fused_rerank(*args, kd, k, 60.0, dsim)
    assert fused_scores.launches == n0 + 2
    m0, r0 = fused_scores_plain(*args, kd, 60.0, dsim)
    v0, i0 = fused_rerank_plain(*args, kd, k, 60.0, dsim)
    assert v1.shape == v0.shape == (b, min(k, p)) and i1.dtype == torch.int32
    torch.testing.assert_close(r1, r0, rtol=1e-5, atol=1e-4)
    keep = ~exempt.to(cuda_dev)
    assert torch.equal(m1[keep], m0[keep]) and torch.equal(v1[keep], v0[keep])
    # ids may differ only between equal masses whose rscores nearly tie
    for row, j in (i1 != i0).nonzero().tolist():
        if exempt[row]:
            continue
        same = (v0[row] == v0[row, j]).nonzero()[:, 0]
        rs = r0[row][torch.isin(args[1][row], i0[row, same])]
        assert float(rs.max() - rs.min()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d,dt,clen", [
    (8, 2112, 32, 2, 128, torch.bfloat16, 2100),     # the RAG shape
    (8, 2112, 40, 10, 128, torch.bfloat16, 2111),    # G=4 (phi3-medium-14b)
    (8, 2112, 36, 4, 128, torch.bfloat16, 2048),     # G=9 (starcoder2-7b)
    (2, 3000, 64, 2, 128, torch.bfloat16, 2999),     # G=32: two MMA tiles
    (1, 4099, 32, 2, 128, torch.bfloat16, 4098),     # S % chunk != 0
    (2, 1000, 8, 8, 64, torch.float32, 999),         # Hkv == H
    (3, 777, 6, 2, 16, torch.float32, 500),          # group of 3
    (4, 300, 32, 2, 128, torch.bfloat16, 0),         # one valid position
])
def test_cuda_decode_attention_vs_plain(cuda_dev, b, s, h, hkv, d, dt, clen):
    g = torch.Generator(device=cuda_dev).manual_seed(s)
    q = torch.randn(b, h, d, device=cuda_dev, generator=g).to(dt)
    k = torch.randn(b, s, hkv, d, device=cuda_dev, generator=g).to(dt)
    v = torch.randn(b, s, hkv, d, device=cuda_dev, generator=g).to(dt)
    want = decode_attention_plain(q, k, v, clen)
    n0 = decode_attention.launches
    for length in (clen, torch.tensor(clen, device=cuda_dev)):
        got = decode_attention(q, k, v, length)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert decode_attention.launches == n0 + 2
    empty = decode_attention(q, k, v, -1)        # nothing valid: zeros
    assert not empty.any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode,weighted,dt,d,ids_dtype", [
    ("sum", False, torch.float32, 64, torch.int32),
    ("mean", False, torch.float32, 64, torch.int64),
    ("sum", True, torch.float32, 10, torch.int64),
    ("mean", True, torch.bfloat16, 64, torch.int32),
    ("sum", False, torch.bfloat16, 64, torch.int64),
    ("sum", True, torch.bfloat16, 63, torch.int64),   # odd d: 2-byte loads
    ("mean", False, torch.bfloat16, 3, torch.int32),
    ("sum", False, torch.float32, 300, torch.int32)])  # three column blocks
def test_cuda_embedding_bag_vs_plain(cuda_dev, mode, weighted, dt, d,
                                     ids_dtype):
    g = torch.Generator(device=cuda_dev).manual_seed(3)
    v, b, n = 100_000, 512, 26
    table = torch.randn(v, d, device=cuda_dev, generator=g).to(dt)
    ids = torch.randint(0, v, (b, n), device=cuda_dev, generator=g,
                        dtype=ids_dtype)
    w = (torch.randn(b, n, device=cuda_dev, generator=g) if weighted
         else None)
    want = embedding_bag_plain(table, ids, w, mode)
    n0 = embedding_bag.launches
    got = embedding_bag(table, ids, w, mode)
    assert embedding_bag.launches == n0 + 1
    assert got.dtype == dt and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 512, 1000])
@pytest.mark.parametrize("n", [1, 26, 39, 100])
@pytest.mark.parametrize("d", [1, 3, 10, 32, 33, 64, 100])
def test_cuda_embedding_bag_shapes(cuda_dev, d, n, b):
    """Every width (4-, 8- and 16-byte gathers; 32 | 33 and 64 | 100 on
    each side of a lane's accumulator counts) and bag length (100 slots at
    d=64 take several passes of a warp's shared memory), weighted."""
    g = torch.Generator(device=cuda_dev).manual_seed(d * n + b)
    table = torch.randn(50_000, d, device=cuda_dev, generator=g)
    ids = torch.randint(0, 50_000, (b, n), device=cuda_dev, generator=g,
                        dtype=torch.int32)
    w = torch.rand(b, n, device=cuda_dev, generator=g)
    for weights in (None, w):
        got = embedding_bag(table, ids, weights)
        assert torch.equal(got, embedding_bag_plain(table, ids, weights))


@pytest.mark.cuda
def test_cuda_embedding_bag_one_launch_int64_ids(cuda_dev):
    """int64 ids cost no cast launch: a call launches the kernel once, and
    the profiler over 10 calls sees no other kernel (it may miss a few
    launches at the edge of its window)."""
    from torch.profiler import ProfilerActivity, profile
    table = torch.randn(10_000, 10, device=cuda_dev)
    ids = torch.randint(0, 10_000, (512, 39), device=cuda_dev)
    n0 = embedding_bag.launches
    embedding_bag(table, ids)
    assert embedding_bag.launches == n0 + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            embedding_bag(table, ids)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "bag_kernel" in kernels[0].key
    assert 1 <= kernels[0].count <= 10


# -- the tenant path's B=32 shapes -----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("empty_tenant", [False, True])
def test_cuda_topk_search_grouped_tenant_rings(cuda_dev, empty_tenant):
    """The batched tenant path's cache channel: B=32 queries over 4
    tenants' rings of 50,000 rows flattened to 200,000 (contiguous
    groups), optionally one tenant's ring empty (its queries get -1)."""
    t, dc, b, d = 4, 50_000, 32, 768
    rng = np.random.default_rng(32)
    q, c, valid, _, _ = _topk_inputs(rng, b, t * dc, d, 0.9, False)
    rg = np.repeat(np.arange(t, dtype=np.int32), dc)
    qg = (np.arange(b) % t).astype(np.int32)
    if empty_tenant:
        valid[rg == 3] = False
    args = [_t(x).to(cuda_dev) for x in (q, c, valid, rg, qg)]
    kw = dict(valid=args[2], row_group=args[3], q_group=args[4])
    v0, i0 = topk_search_plain(args[0], args[1], 10, **kw)
    v1, i1 = topk_search(args[0], args[1], 10, **kw)
    torch.testing.assert_close(v1, v0, rtol=1e-5, atol=1e-5)
    assert _near_tie_ok(v0, i0, i1)
    own = torch.div(i1.long().clamp_min(0), dc, rounding_mode="floor")
    assert bool(((own == args[4][:, None].long()) | (i1 < 0)).all())
    if empty_tenant:
        assert bool((i1[args[4] == 3] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("empty_tenant", [False, True])
def test_cuda_homology_validate_grouped_tenant_caches(cuda_dev,
                                                      empty_tenant):
    """The batched tenant path's validation: B=32 drafts over 4 tenants'
    query caches of 5000 rows flattened to 20,000; a tenant with an empty
    cache scores 0 everywhere and takes row 0 (another tenant's), as the
    reference's flat argmax does.  Scores, best and slot bit-equal."""
    t, h, b, k = 4, 5000, 32, 10
    rng = np.random.default_rng(20)
    draft = rng.integers(-1, 500, (b, k)).astype(np.int32)
    cache = rng.integers(-1, 500, (t * h, k)).astype(np.int32)
    valid = rng.random(t * h) < 0.9
    rg = np.repeat(np.arange(t, dtype=np.int32), h)
    qg = (np.arange(b) % t).astype(np.int32)
    if empty_tenant:
        valid[rg == 3] = False
    args = [_t(x).to(cuda_dev) for x in (draft, cache, valid)]
    kw = dict(row_group=_t(rg).to(cuda_dev), q_group=_t(qg).to(cuda_dev))
    got = homology_validate(*args, **kw)
    _check_validate(got, homology_validate_plain(*args, **kw), True)
    if empty_tenant:
        assert bool((got[2][kw["q_group"] == 3] == 0).all())
        assert not got[1][kw["q_group"] == 3].any()


@pytest.mark.cuda
def test_cuda_batched_tenant_engine_vs_torch(cuda_dev):
    """BatchedHasEngine with 4 tenants at a small world: the kernels
    (backend "cuda") serve the plain path's accept bits and ids (up to
    near-tied candidates), from one shared index."""
    from repro_torch.core.has import HasConfig
    from repro_torch.data.synthetic import SyntheticWorld, WorldConfig
    from repro_torch.retrieval.ivf import build_ivf
    from repro_torch.retrieval.service import RetrievalService
    from repro_torch.serving.batched import BatchedHasEngine
    from repro_torch.serving.latency import LatencyModel

    world = SyntheticWorld(WorldConfig(n_entities=2000, d=64))
    service = RetrievalService(world, LatencyModel(), k=10, device=cuda_dev)
    cfg = HasConfig(k=10, tau=0.2, h_max=200, doc_capacity=1000, nprobe=8,
                    n_buckets=128, d=64)
    index = build_ivf(service.corpus, cfg.n_buckets, seed=0)
    queries = [dict(q, tenant=int(q["entity"]) % 4)
               for q in world.sample_queries(400, seed=1)]
    served = {}
    for backend in ("cuda", "torch"):
        eng = BatchedHasEngine(service, cfg, batch_size=32, backend=backend,
                               n_tenants=4, index=index)
        log, step = [], eng._step_batch

        def rec(group, rng, dataset, step=step, log=log):
            out = step(group, rng, dataset)
            log.extend((np.asarray(i), a) for i, a, _ in out)
            return out

        eng._step_batch = rec
        eng.serve(queries)
        served[backend] = log
    accepts = [a for _, a in served["cuda"]]
    assert accepts == [a for _, a in served["torch"]]
    assert any(accepts) and not all(accepts)
    for (a, _), (b_, _), q in zip(served["cuda"], served["torch"], queries):
        diff = np.flatnonzero(a != b_)
        if len(diff):
            qe = torch.as_tensor(q["emb"], device=cuda_dev)
            sa = service.corpus[torch.as_tensor(a[diff]).long()
                                .to(cuda_dev)] @ qe
            sb = service.corpus[torch.as_tensor(b_[diff]).long()
                                .to(cuda_dev)] @ qe
            assert float((sa - sb).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(edge_replicas=3, n_tenants=2)],
                         ids=["T1", "R3-T2"])
def test_cuda_scheduler_vs_torch(cuda_dev, kw):
    """The continuous-batching scheduler at a small world: the kernels
    (backend None) and the plain versions (backend "torch") on the card
    serve the same channels, ids, leaders, spans and t_done."""
    from repro_torch.core.has import HasConfig
    from repro_torch.data.synthetic import SyntheticWorld, WorldConfig
    from repro_torch.retrieval.ivf import build_ivf
    from repro_torch.retrieval.service import RetrievalService
    from repro_torch.serving.latency import LatencyModel
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               SchedulerConfig,
                                               poisson_arrivals)

    world = SyntheticWorld(WorldConfig(n_entities=2000, d=64))
    service = RetrievalService(world, LatencyModel(), k=10, device=cuda_dev)
    cfg = HasConfig(k=10, tau=0.2, h_max=300, doc_capacity=2000, nprobe=8,
                    n_buckets=128, d=64)
    index = build_ivf(service.corpus, cfg.n_buckets, seed=0)
    queries = world.sample_queries(400, seed=1)
    tids = np.arange(400, dtype=np.int32) % kw.get("n_tenants", 1)
    arr = poisson_arrivals(400, qps=40.0, seed=7)
    out = {}
    for backend in (None, "torch"):
        sched = ContinuousBatchingScheduler(
            service, cfg, SchedulerConfig(max_spec_batch=32, full_batch=16,
                                          full_max_wait_s=0.05,
                                          backend=backend, **kw),
            index=index)
        out[backend] = sched.serve(queries, arr, seed=0, tenant_ids=tids)
    a, b = out[None], out["torch"]
    for f in ("channels", "served_ids", "leader_idx", "t_done",
              "replica_ids", "cache_versions"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for s in a.trace.spans:
        np.testing.assert_array_equal(a.trace.spans[s], b.trace.spans[s])
    assert 0 < a.summary()["dar"] < 1
