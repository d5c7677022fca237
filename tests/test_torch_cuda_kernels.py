"""Each CUDA kernel of the port against its plain version, on the card.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip
without one.  They import nothing of JAX, so they run on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Scores must agree to 1e-5 (f32 sums of 768 products taken in another
order); ids must be equal except swaps between candidates whose scores lie
within that tolerance; unweighted homology scores must be bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.homology_score import (homology_score,
                                                homology_score_plain)
from repro_torch.kernels.ivf_scan import ivf_scan, ivf_scan_plain
from repro_torch.kernels.topk_search import topk_search, topk_search_plain


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
@pytest.mark.parametrize("b,n,groups", [(1, 50_000, False), (64, 5000, True),
                                        (3, 300, False)])
def test_cuda_topk_search_vs_plain(cuda_dev, b, n, groups):
    rng = np.random.default_rng(b)
    q, c, valid, rg, qg = _topk_inputs(rng, b, n, 768, 0.9, groups)
    args = [_t(x).to(cuda_dev) for x in (q, c, valid)]
    kw = {} if rg is None else dict(row_group=_t(rg).to(cuda_dev),
                                    q_group=_t(qg).to(cuda_dev))
    v0, i0 = topk_search_plain(*args[:2], 10, valid=args[2], **kw)
    v1, i1 = topk_search(*args[:2], 10, valid=args[2], **kw)
    torch.testing.assert_close(v1, v0, rtol=1e-5, atol=1e-5)
    assert _near_tie_ok(v0, i0, i1)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted,groups", [(False, False), (True, True)])
def test_cuda_homology_score_vs_plain(cuda_dev, weighted, groups):
    rng = np.random.default_rng(7)
    b, h, k = 64, 5000, 10
    draft = _t(rng.integers(-1, 500, (b, k)).astype(np.int32)).to(cuda_dev)
    cache = _t(rng.integers(-1, 500, (h, k)).astype(np.int32)).to(cuda_dev)
    valid = _t(rng.random(h) < 0.9).to(cuda_dev)
    w = _t(rng.random((b, k)).astype(np.float32)).to(cuda_dev) \
        if weighted else None
    kw = {} if not groups else dict(
        row_group=_t(rng.integers(0, 2, h).astype(np.int32)).to(cuda_dev),
        q_group=_t(rng.integers(0, 2, b).astype(np.int32)).to(cuda_dev))
    s0 = homology_score_plain(draft, cache, valid, draft_weights=w, **kw)
    s1 = homology_score(draft, cache, valid, draft_weights=w, **kw)
    if weighted:
        torch.testing.assert_close(s1, s0, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(s1, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,k", [(1, 64, 10), (64, 64, 10), (2, 1, 10)])
def test_cuda_ivf_scan_vs_plain(cuda_dev, b, p, k):
    rng = np.random.default_rng(p)
    q, probe, vecs, ids = _ivf_inputs(rng, b, 256, 123 if p > 1 else 5,
                                      768, p)
    args = [_t(x).to(cuda_dev) for x in (q, probe, vecs, ids)]
    v0, i0 = ivf_scan_plain(*args, k)
    v1, i1 = ivf_scan(*args, k)
    torch.testing.assert_close(v1, v0, rtol=1e-5, atol=1e-5)
    assert _near_tie_ok(v0, i0, i1)
