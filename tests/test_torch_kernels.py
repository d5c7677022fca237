"""Port parity for the three ported kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the reference's Pallas kernels run in interpret mode, on the same
numpy inputs.  Integer outputs must match exactly; float scores to
rtol = atol = 1e-5 (XLA-CPU and torch-CPU sum f32 products in different
orders).  The CUDA kernels are held against these plain versions on the
card by ``test_torch_cuda_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.homology_score import homology_score as ref_homology
from repro.kernels.ivf_scan import ivf_scan as ref_ivf
from repro.kernels.topk_search import topk_search as ref_topk
from repro_torch.kernels import ops
from repro_torch.kernels.homology_score import (homology_score,
                                                homology_score_plain)
from repro_torch.kernels.ivf_scan import ivf_scan, ivf_scan_plain
from repro_torch.kernels.topk_search import topk_search, topk_search_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _topk_inputs(rng, b, n, d, valid_p, groups):
    q = rng.normal(size=(b, d)).astype(np.float32)
    c = rng.normal(size=(n, d)).astype(np.float32)
    valid = rng.random(n) < valid_p
    rg = rng.integers(0, 3, n).astype(np.int32) if groups else None
    qg = rng.integers(0, 3, b).astype(np.int32) if groups else None
    return q, c, valid, rg, qg


@pytest.mark.parametrize("b,n,d,k,tile,valid_p,groups", [
    (1, 200, 16, 5, 64, 0.7, False),      # tail tile, partial ring
    (4, 130, 32, 10, 64, 1.0, True),      # group masks
    (3, 40, 8, 12, 64, 0.2, False),       # fewer valid rows than k
])
def test_topk_search_matches_pallas(b, n, d, k, tile, valid_p, groups):
    rng = np.random.default_rng(n + k)
    q, c, valid, rg, qg = _topk_inputs(rng, b, n, d, valid_p, groups)
    kw = {} if rg is None else dict(row_group=jnp.asarray(rg),
                                    q_group=jnp.asarray(qg))
    rv, ri = ref_topk(jnp.asarray(q), jnp.asarray(c), k, tile_c=tile,
                      valid=jnp.asarray(valid), interpret=True, **kw)
    tkw = {} if rg is None else dict(row_group=_t(rg), q_group=_t(qg))
    pv, pi = topk_search(_t(q), _t(c), k, valid=_t(valid), **tkw)
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_allclose(np.asarray(rv), pv.numpy(), **TOL)


def test_topk_search_empty_ring():
    rng = np.random.default_rng(1)
    q, c, _, _, _ = _topk_inputs(rng, 2, 64, 8, 1.0, False)
    pv, pi = topk_search(_t(q), _t(c), 4, valid=torch.zeros(64, dtype=bool))
    assert torch.isneginf(pv).all() and (pi == -1).all()


def test_topk_search_ties_go_to_lower_row():
    c = torch.ones((10, 4))
    c[7] = 2.0
    pv, pi = topk_search(torch.ones((1, 4)), c, 4)
    assert pi.tolist() == [[7, 0, 1, 2]]


@pytest.mark.parametrize("b,h,k,weighted,groups", [
    (3, 40, 5, False, False),
    (2, 70, 10, True, True),
])
def test_homology_score_matches_pallas(b, h, k, weighted, groups):
    rng = np.random.default_rng(h)
    draft = rng.integers(-1, 30, (b, k)).astype(np.int32)
    cache = rng.integers(-1, 30, (h, k)).astype(np.int32)
    cache[::4] = draft[0]                       # some high-overlap rows
    valid = rng.random(h) < 0.8
    w = rng.random((b, k)).astype(np.float32) if weighted else None
    rg = rng.integers(0, 2, h).astype(np.int32) if groups else None
    qg = rng.integers(0, 2, b).astype(np.int32) if groups else None
    kw = {} if rg is None else dict(row_group=jnp.asarray(rg),
                                    q_group=jnp.asarray(qg))
    ref = ref_homology(jnp.asarray(draft), jnp.asarray(cache),
                       jnp.asarray(valid), tile_h=32, interpret=True,
                       draft_weights=None if w is None else jnp.asarray(w),
                       **kw)
    tkw = {} if rg is None else dict(row_group=_t(rg), q_group=_t(qg))
    out = homology_score(_t(draft), _t(cache), _t(valid),
                         draft_weights=None if w is None else _t(w), **tkw)
    np.testing.assert_allclose(np.asarray(ref), out.numpy(), **TOL)
    if not weighted:       # count / k: bit-equal, so accept bits agree
        np.testing.assert_array_equal(np.asarray(ref), out.numpy())


def test_homology_score_two_of_ten_is_tau():
    draft = torch.tensor([[1, 2, -1, -1, -1, -1, -1, -1, -1, -1]],
                         dtype=torch.int32)
    cache = torch.tensor([[2, 1, 5, 6, 7, 8, 9, 10, 11, 12]],
                         dtype=torch.int32)
    s = homology_score(draft, cache, torch.ones(1, dtype=bool))
    assert s.item() == np.float32(0.2)


def _ivf_inputs(rng, b, c, cap, d, p):
    vecs = rng.normal(size=(c, cap, d)).astype(np.float32)
    ids = rng.permutation(c * cap).reshape(c, cap).astype(np.int32)
    ids[rng.random((c, cap)) < 0.3] = -1         # pad slots
    vecs[ids < 0] = 0.0
    q = rng.normal(size=(b, d)).astype(np.float32)
    probe = np.stack([rng.permutation(c)[:p] for _ in range(b)]) \
        .astype(np.int32)
    return q, probe, vecs, ids


@pytest.mark.parametrize("b,c,cap,d,p,k", [
    (2, 8, 12, 16, 3, 5),
    (3, 6, 2, 8, 2, 10),        # probed pool (<= 4 slots) smaller than k
])
def test_ivf_scan_matches_pallas(b, c, cap, d, p, k):
    rng = np.random.default_rng(cap)
    q, probe, vecs, ids = _ivf_inputs(rng, b, c, cap, d, p)
    rv, ri = ref_ivf(jnp.asarray(q), jnp.asarray(probe), jnp.asarray(vecs),
                     jnp.asarray(ids), k, interpret=True)
    pv, pi = ivf_scan(_t(q), _t(probe), _t(vecs), _t(ids), k)
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_allclose(np.asarray(rv), pv.numpy(), **TOL)


def test_backend_switch():
    for backend in (None, "cuda", "torch"):
        assert ops.check_backend(backend) == backend
    with pytest.raises(ValueError):
        ops.check_backend("pallas")
    rng = np.random.default_rng(0)
    q, c, valid, _, _ = _topk_inputs(rng, 2, 50, 8, 0.5, False)
    before = topk_search.launches
    for backend in ("cuda", "torch", None):   # CPU tensors: plain either way
        v, i = ops.topk_search_op(_t(q), _t(c), 3, valid=_t(valid),
                                  backend=backend)
        v2, i2 = topk_search_plain(_t(q), _t(c), 3, valid=_t(valid))
        assert torch.equal(i, i2) and torch.equal(v, v2)
    assert topk_search.launches == before     # no kernel ran on the CPU


@pytest.mark.parametrize("backend", ["cuda", "torch", None])
def test_ivf_and_homology_ops_on_cpu_are_plain(backend):
    rng = np.random.default_rng(3)
    q, probe, vecs, ids = _ivf_inputs(rng, 2, 6, 5, 8, 3)
    args = (_t(q), _t(probe), _t(vecs), _t(ids), 4)
    n_ivf, n_hom = ivf_scan.launches, homology_score.launches
    v, i = ops.ivf_scan_op(*args, backend=backend)
    v2, i2 = ivf_scan_plain(*args)
    assert torch.equal(i, i2) and torch.equal(v, v2)
    draft, cache = _t(ids[:2, :4]), _t(ids[:, :4])
    valid = torch.ones(6, dtype=torch.bool)
    s = ops.homology_score_op(draft, cache, valid, backend=backend)
    assert torch.equal(s, homology_score_plain(draft, cache, valid))
    assert (ivf_scan.launches, homology_score.launches) == (n_ivf, n_hom)
    with pytest.raises(ValueError):
        ops.ivf_scan_op(*args, backend="xla")
