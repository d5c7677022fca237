"""Port parity of the compressed ANN path: int8 quantization, the
compressed IVF build, the int8 mode of ``ivf_scan`` and ``IVFBackend``.

The port's k-means cannot reproduce the reference's ``jax.random`` draws,
so every build here starts from the reference's centroids.  The reference
quantizes under ``jit`` (XLA multiplies by the f32 reciprocal of 127), and
that is what the port's codes and scales must equal bit for bit.  Float
scores of the int8 scan may differ by f32 summation order (rtol = atol =
1e-5); ids must be equal except swaps between candidates whose reference
scores lie within that tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import ivf_scan_ref
from repro.retrieval.ivf import _build_ivf_arrays as ref_build_arrays
from repro.retrieval.ivf import _quant_residual_halves as ref_quant_halves
from repro.retrieval.ivf import build_ivf_streaming as ref_build_streaming
from repro.retrieval.ivf import ivf_search as ref_ivf_search
from repro.retrieval.service import IVFBackend as RefIVFBackend
from repro.serving.latency import LatencyModel as RefLatency
from repro.training.compression import quantize_int8 as ref_quantize
from repro_torch import convert
from repro_torch.core import dispatch
from repro_torch.kernels import ops
from repro_torch.kernels.ivf_scan import ivf_scan, ivf_scan_plain
from repro_torch.retrieval.ivf import (CompressedIVFIndex, _build_ivf_arrays,
                                       _quant_residual_halves,
                                       build_ivf_streaming, ivf_search)
from repro_torch.retrieval.service import FullRetrievalBackend, IVFBackend
from repro_torch.serving.latency import LatencyModel
from repro_torch.training.compression import dequantize_int8, quantize_int8

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n, d, n_protos=32, spread=0.2):
    protos = _unit(rng, n_protos, d)
    x = protos[rng.integers(0, n_protos, n)] + spread * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _assert_ids_near_ties(ref_vals, ref_ids, ids, tol=1e-5):
    """Ids equal, except swaps between positions whose reference scores lie
    within ``tol`` of each other."""
    rv, ri, pi = (np.asarray(x) for x in (ref_vals, ref_ids, ids))
    for row, j in np.argwhere(ri != pi):
        close = np.abs(rv[row] - rv[row, j]) <= tol
        assert close.sum() >= 2, f"ids differ at [{row},{j}], not a tie"


# -- quantize_int8 ----------------------------------------------------------

@pytest.mark.parametrize("axis", [-1, None])
def test_quantize_int8_bit_equal_to_jitted_reference(axis):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(600, 48))
         * rng.uniform(0, 1, (600, 1))).astype(np.float32)
    x[3] = 0.0                                   # all-zero row: floored scale
    x[7] = 1e-30
    rq, rs = jax.jit(functools.partial(ref_quantize, axis=axis))(
        jnp.asarray(x))
    pq, ps = quantize_int8(_t(x), axis=axis)
    np.testing.assert_array_equal(np.asarray(rq), pq.numpy())
    np.testing.assert_array_equal(np.asarray(rs), ps.numpy())
    assert torch.isfinite(dequantize_int8(pq, ps)).all()
    if axis == -1:
        assert ps[3].item() == np.float32(1e-12) and (pq[3] == 0).all()


def test_quant_residual_halves_bit_equal():
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(300, 32)).astype(np.float32)
    cents = rng.normal(size=(300, 32)).astype(np.float32)
    cents[:4] = rows[:4]                        # zero residual: scale floor
    rq, rs = ref_quant_halves(jnp.asarray(rows), jnp.asarray(cents))
    pq, ps = _quant_residual_halves(_t(rows), _t(cents))
    np.testing.assert_array_equal(np.asarray(rq), pq.numpy())
    np.testing.assert_array_equal(np.asarray(rs), ps.numpy())
    assert (ps[:4] == np.float32(1e-12)).all()


# -- the compressed build on the reference's centroids ----------------------

def _doc_slots(bucket_ids):
    """doc id -> (bucket, slot) of a [C, cap] id table."""
    c, s = np.nonzero(bucket_ids >= 0)
    return {int(bucket_ids[a, b]): (int(a), int(b)) for a, b in zip(c, s)}


@pytest.mark.parametrize("compressed,chunk", [(True, 128), (True, 10**6),
                                              (False, 300)])
def test_build_on_reference_centroids_matches(compressed, chunk):
    rng = np.random.default_rng(2)
    corpus = _clustered(rng, 1000, 32)
    ref = ref_build_arrays(corpus, 24, seed=3, chunk=chunk,
                           compressed=compressed)
    cents = ref[0]
    pt = _build_ivf_arrays(corpus, 24, chunk=chunk, compressed=compressed,
                           centroids=cents, device="cpu")
    np.testing.assert_array_equal(ref[0], pt[0])
    assert ref[3].shape == pt[3].shape
    if not np.array_equal(ref[3], pt[3]):
        # a doc may land elsewhere only on a near-tie of its two centroids
        rs, ps = _doc_slots(ref[3]), _doc_slots(pt[3])
        for doc in set(rs) | set(ps):
            if doc in rs and doc in ps and rs[doc][0] == ps[doc][0]:
                continue
            s = corpus[doc] @ cents.T
            a = rs[doc][0] if doc in rs else int(np.argmax(s))
            b = ps[doc][0] if doc in ps else int(np.argmax(s))
            assert abs(s[a] - s[b]) <= 1e-6, f"doc {doc}: {a} vs {b}"
    rs, ps = _doc_slots(ref[3]), _doc_slots(pt[3])
    for doc, (c, s) in ps.items():
        if rs.get(doc, (None,))[0] != c:
            continue
        rc, rsl = rs[doc]
        np.testing.assert_array_equal(ref[1][rc, rsl], pt[1][c, s])
        if compressed:
            np.testing.assert_array_equal(ref[2][rc, rsl], pt[2][c, s])
    np.testing.assert_array_equal(ref[4], pt[4])
    assert pt[1].dtype == (np.int8 if compressed else np.float32)
    assert (pt[2] is None) == (not compressed)


def test_build_ivf_streaming_and_convert_round_trip():
    rng = np.random.default_rng(3)
    corpus = _clustered(rng, 800, 32)
    ref = ref_build_streaming(corpus, 16, seed=1, compressed=True)
    arrays = {f: np.asarray(getattr(ref, f))
              for f in convert.COMPRESSED_IVF_FIELDS}
    idx = convert.compressed_ivf_index_from_numpy(arrays, device="cpu")
    assert isinstance(idx, CompressedIVFIndex)
    assert idx.bucket_vecs.dtype == torch.int8 and idx.capacity == \
        ref.capacity and idx.n_buckets == ref.n_buckets
    back = convert.compressed_ivf_index_to_numpy(idx)
    for f in convert.COMPRESSED_IVF_FIELDS:
        np.testing.assert_array_equal(arrays[f], back[f], err_msg=f)
    built = build_ivf_streaming(corpus, 16, compressed=True,
                                centroids=arrays["centroids"], device="cpu")
    for f in convert.COMPRESSED_IVF_FIELDS:
        np.testing.assert_array_equal(arrays[f],
                                      getattr(built, f).numpy(), err_msg=f)


# -- int8 ivf_scan: plain version vs the Pallas kernel and its oracle ------

def _int8_case(rng, name):
    b, c, cap, d, p, k = 3, 12, 9, 32, 4, 10
    codes = rng.integers(-127, 128, size=(c, cap, d)).astype(np.int8)
    scales = rng.uniform(1e-3, 2e-2, size=(c, cap, 2)).astype(np.float32)
    ids = rng.permutation(c * cap).reshape(c, cap).astype(np.int32)
    ids[rng.random((c, cap)) < 0.3] = -1
    q = _unit(rng, b, d)
    probe = np.stack([rng.permutation(c)[:p] for _ in range(b)]) \
        .astype(np.int32)
    bias = rng.normal(size=(b, p)).astype(np.float32)
    if name == "all-pad bucket":
        ids[probe[0, 0]] = -1
    elif name == "zero residual":
        codes[:, :3] = 0
        scales[:, :3] = np.float32(1e-12)
    elif name == "pool < k":
        codes, scales, ids = codes[:, :2], scales[:, :2], ids[:, :2]
        probe = probe[:, :2]
        bias = bias[:, :2]
    return q, probe, codes, ids, scales, bias, k


@pytest.mark.parametrize("name", ["random", "all-pad bucket",
                                  "zero residual", "pool < k"])
def test_int8_ivf_scan_plain_matches_pallas_and_oracle(name):
    rng = np.random.default_rng(len(name))
    q, probe, codes, ids, scales, bias, k = _int8_case(rng, name)
    args = tuple(jnp.asarray(x) for x in (q, probe, codes, ids))
    rk_v, rk_i = ref_ops.ivf_scan(*args, k, interpret=True,
                                  bucket_scales=jnp.asarray(scales),
                                  probe_bias=jnp.asarray(bias))
    ro_v, ro_i = ivf_scan_ref(*args, k, bucket_scales=jnp.asarray(scales),
                              probe_bias=jnp.asarray(bias))
    pv, pi = ivf_scan(_t(q), _t(probe), _t(codes), _t(ids), k,
                      bucket_scales=_t(scales), probe_bias=_t(bias))
    for rv, ri in ((rk_v, rk_i), (ro_v, ro_i)):
        np.testing.assert_allclose(np.asarray(rv), pv.numpy(), **TOL)
        _assert_ids_near_ties(rv, ri, pi)
    if name == "pool < k":                 # 2 probes x 2 slots < k = 10
        assert (pi[:, 4:] == -1).all() and torch.isneginf(pv[:, 4:]).all()
    if name == "all-pad bucket":
        pad = set(ids[probe[0, 0]].tolist()) - {-1}
        assert not pad & set(pi[0].tolist())


def test_ivf_scan_scaled_operands_go_together():
    rng = np.random.default_rng(4)
    q, probe, codes, ids, scales, bias, k = _int8_case(rng, "random")
    with pytest.raises(ValueError, match="together"):
        ivf_scan_plain(_t(q), _t(probe), _t(codes), _t(ids), k,
                       bucket_scales=_t(scales))
    n = ivf_scan.launches_int8
    v, i = ops.ivf_scan_op(_t(q), _t(probe), _t(codes), _t(ids), k,
                           bucket_scales=_t(scales), probe_bias=_t(bias),
                           backend="cuda")          # CPU tensors: plain
    v2, i2 = ivf_scan_plain(_t(q), _t(probe), _t(codes), _t(ids), k,
                            _t(scales), _t(bias))
    assert torch.equal(v, v2) and torch.equal(i, i2)
    assert ivf_scan.launches_int8 == n


def test_ivf_search_compressed_matches_reference():
    rng = np.random.default_rng(5)
    corpus = _clustered(rng, 900, 32)
    ref = ref_build_streaming(corpus, 16, seed=1, compressed=True)
    idx = convert.compressed_ivf_index_from_numpy(
        {f: np.asarray(getattr(ref, f))
         for f in convert.COMPRESSED_IVF_FIELDS}, device="cpu")
    q = _unit(rng, 6, 32)
    rv, ri = ref_ivf_search(ref, jnp.asarray(q), nprobe=5, k=10)
    pv, pi = ivf_search(idx, _t(q), nprobe=5, k=10)
    np.testing.assert_allclose(np.asarray(rv), pv.numpy(), **TOL)
    _assert_ids_near_ties(rv, ri, pi)


# -- IVFBackend --------------------------------------------------------------

@pytest.mark.parametrize("compressed,scan", [(True, "pallas"), (True, "xla"),
                                             (False, "xla")])
def test_ivf_backend_matches_reference(compressed, scan):
    rng = np.random.default_rng(6)
    corpus = _clustered(rng, 1100, 32)
    kw = dict(n_clusters=16, nprobe=4, compressed=compressed)
    ref = RefIVFBackend(jnp.asarray(corpus), 10, RefLatency(), backend=scan,
                        interpret=True, **kw)
    pt = IVFBackend(corpus, 10, LatencyModel(), device="cpu",
                    centroids=np.asarray(ref.index.centroids), **kw)
    assert isinstance(pt, FullRetrievalBackend)
    fields = (convert.COMPRESSED_IVF_FIELDS if compressed
              else convert.IVF_FIELDS)
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(ref.index, f)),
                                      getattr(pt.index, f).numpy(),
                                      err_msg=f)
    q = _unit(rng, 8, 32)
    rv, ri = ref.search(jnp.asarray(q))
    with dispatch.capture() as probe:
        pv, pi = pt.search(_t(q))
    assert probe.counts() == {"ivf_backend_search": 1}
    np.testing.assert_allclose(np.asarray(rv), pv.numpy(), **TOL)
    _assert_ids_near_ties(rv, ri, pi)
    assert pt.latency(1) == ref.latency(1)


def test_ivf_backend_pool_smaller_than_k():
    rng = np.random.default_rng(7)
    corpus = _clustered(rng, 64, 16)
    be = IVFBackend(corpus, 40, LatencyModel(), n_clusters=8, nprobe=1,
                    compressed=True, device="cpu")
    v, i = be.search(_t(_unit(rng, 2, 16)))
    assert v.shape == (2, 40) and (i[torch.isneginf(v)] == -1).all()
    assert torch.isneginf(v[:, -1]).all()      # one bucket < 40 docs
