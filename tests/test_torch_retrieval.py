"""Port parity: flat search, IVF search and build, state conversion.

The reference's IVF index is handed to the port through
``repro_torch.convert`` (k-means draws cannot be reproduced across the two
packages).  Ids must match exactly; scores to rtol = atol = 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.retrieval.flat import chunked_flat_search as ref_chunked
from repro.retrieval.flat import flat_search as ref_flat
from repro.retrieval.ivf import build_ivf as ref_build_ivf
from repro.retrieval.ivf import ivf_search as ref_ivf_search
from repro.retrieval.ivf import subset_index as ref_subset
from repro_torch import convert
from repro_torch.retrieval.flat import chunked_flat_search, flat_search
from repro_torch.retrieval.ivf import build_ivf, ivf_search, subset_index

TOL = dict(rtol=1e-5, atol=1e-5)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,b,k,chunk", [(300, 3, 10, 64), (37, 2, 5, 16),
                                         (6, 1, 10, 4)])
def test_flat_searches_match_reference(n, b, k, chunk):
    rng = np.random.default_rng(n)
    corpus, q = _unit(rng, n, 24), _unit(rng, b, 24)
    rv, ri = ref_chunked(jnp.asarray(corpus), jnp.asarray(q), k, chunk=chunk)
    pv, pi = chunked_flat_search(torch.from_numpy(corpus),
                                 torch.from_numpy(q), k, chunk=chunk)
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_allclose(np.asarray(rv), pv.numpy(), **TOL)
    if n >= k:
        rv, ri = ref_flat(jnp.asarray(corpus), jnp.asarray(q), k)
        pv, pi = flat_search(torch.from_numpy(corpus), torch.from_numpy(q), k)
        np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
        np.testing.assert_allclose(np.asarray(rv), pv.numpy(), **TOL)


def _ref_index(n=400, d=16, n_buckets=16):
    rng = np.random.default_rng(0)
    corpus = _unit(rng, n, d)
    index = ref_build_ivf(jnp.asarray(corpus), n_buckets, seed=0)
    arrays = {f: np.asarray(getattr(index, f)) for f in convert.IVF_FIELDS}
    return corpus, index, arrays


@pytest.mark.parametrize("nprobe,k,fraction", [(3, 10, 1.0), (2, 5, 0.5),
                                               (40, 10, 0.1)])
def test_ivf_search_on_reference_index(nprobe, k, fraction):
    corpus, index, arrays = _ref_index()
    pidx = convert.ivf_index_from_numpy(arrays, device="cpu")
    index, pidx = ref_subset(index, fraction), subset_index(pidx, fraction)
    q = _unit(np.random.default_rng(1), 5, corpus.shape[1])
    rv, ri = ref_ivf_search(index, jnp.asarray(q), nprobe=nprobe, k=k)
    pv, pi = ivf_search(pidx, torch.from_numpy(q), nprobe=nprobe, k=k)
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_allclose(np.asarray(rv), pv.numpy(), **TOL)


def test_build_ivf_bucket_invariants():
    rng = np.random.default_rng(3)
    corpus = _unit(rng, 500, 16)
    idx = build_ivf(torch.from_numpy(corpus), 32, device="cpu")
    ids = idx.bucket_ids.numpy()
    counts = idx.bucket_counts.numpy()
    assert idx.n_buckets == 32 and idx.capacity == int(np.ceil(500 / 32 * 2))
    real = ids[ids >= 0]
    assert len(real) == len(np.unique(real)) == counts.sum()
    for c in range(idx.n_buckets):       # corpus order within each bucket
        row = ids[c][ids[c] >= 0]
        assert (np.diff(row) > 0).all() and len(row) == counts[c]
        assert (ids[c][counts[c]:] == -1).all()
    vecs = idx.bucket_vecs.numpy()
    np.testing.assert_array_equal(vecs[ids >= 0], corpus[real])
    assert (vecs[ids < 0] == 0).all()
    norms = np.linalg.norm(idx.centroids.numpy(), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-5)


def test_convert_round_trip():
    _, _, arrays = _ref_index()
    back = convert.ivf_index_to_numpy(
        convert.ivf_index_from_numpy(arrays, device="cpu"))
    for f in convert.IVF_FIELDS:
        assert back[f].dtype == arrays[f].dtype
        np.testing.assert_array_equal(back[f], arrays[f])
