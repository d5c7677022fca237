"""Port parity of the row-sharded exact scan (``retrieval/distributed.py``),
``ShardedMeshBackend`` and the hybrid stage's ``"sharded"`` dense channel.

The merge must give ties to the lower concatenated column, as the
reference's ``lax.top_k`` does.  Ids are held exactly to the reference's
and to ``chunked_flat_search``; scores with ``allclose`` (the reference's
own sharded and chunked scans differ by up to ~1e-7 on the CPU, products
of other widths).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticWorld as RefWorld
from repro.data.synthetic import WorldConfig as RefWorldCfg
from repro.retrieval.distributed import \
    sharded_topk_reference as ref_sharded
from repro.retrieval.service import HybridBackend as RefHybrid
from repro.retrieval.service import ShardedMeshBackend as RefSharded
from repro.serving.latency import LatencyModel as RefLatency
from repro_torch.core import dispatch
from repro_torch.data.synthetic import SyntheticWorld as PtWorld
from repro_torch.data.synthetic import WorldConfig as PtWorldCfg
from repro_torch.retrieval import distributed
from repro_torch.retrieval.flat import chunked_flat_search
from repro_torch.retrieval.service import (FullRetrievalBackend,
                                           HybridBackend, LocalFlatBackend,
                                           ShardedMeshBackend)
from repro_torch.serving.latency import LatencyModel

TOL = dict(rtol=1e-6, atol=1e-6)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_topk(ref_s, ref_i, s, i):
    np.testing.assert_array_equal(np.asarray(ref_i), i.numpy())
    live = np.asarray(ref_i) >= 0
    np.testing.assert_allclose(np.asarray(ref_s)[live], s.numpy()[live],
                               **TOL)
    assert torch.isneginf(s[~torch.from_numpy(live)]).all()


@pytest.mark.parametrize("n,k,shards", [
    (1024, 10, 8),        # plain multi-shard
    (32, 10, 8),          # shard rows (4) < k (10)
    (5, 7, 2),            # whole corpus < k -> -1 padded tail
    (257, 10, 4),         # ragged tail block
    (12, 10, 3),          # one shard (4 rows) smaller than k, others too
    (3, 10, 8),           # more shards than rows: empty shards
    (6, 4, 16),           # more shards than rows, corpus >= k
])
def test_sharded_reference_matches_reference_and_chunked(n, k, shards):
    rng = np.random.default_rng(0)
    c, q = _unit(rng, n, 16), _unit(rng, 5, 16)
    rs, ri = ref_sharded(jnp.asarray(c), jnp.asarray(q), k, n_shards=shards)
    s, i = distributed.sharded_topk_reference(_t(c), _t(q), k,
                                              n_shards=shards)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    _same_topk(rs, ri, s, i)
    cs, ci = chunked_flat_search(_t(c), _t(q), k, chunk=64)
    assert torch.equal(ci, i)
    assert ((i == -1).sum(1) == max(0, k - n)).all()


def test_merge_gives_ties_to_the_lower_column():
    """Duplicate rows in different shards score equal: the merge keeps
    the lower global id first, as ``lax.top_k`` over the concatenated
    candidates does."""
    rng = np.random.default_rng(1)
    base = _unit(rng, 8, 16)
    c = np.concatenate([base, base, base])            # 24 rows, 3 copies
    q = _unit(rng, 4, 16)
    for shards in (2, 3, 5):
        rs, ri = ref_sharded(jnp.asarray(c), jnp.asarray(q), 9,
                             n_shards=shards)
        s, i = distributed.sharded_topk_reference(_t(c), _t(q), 9,
                                                  n_shards=shards)
        np.testing.assert_array_equal(np.asarray(ri), i.numpy())
        # each tied triple appears in ascending id order
        ids = i.numpy()
        for row in ids:
            for a, b in zip(row[:-1], row[1:]):
                if a % 8 == b % 8:
                    assert a < b


def test_pad_candidates_and_mesh_raise():
    s = torch.tensor([[0.5, 0.2]])
    i = torch.tensor([[3, 1]], dtype=torch.int32)
    ps, pi = distributed._pad_candidates(s, i, 4)
    assert pi.tolist() == [[3, 1, -1, -1]] and pi.dtype == torch.int32
    assert torch.isneginf(ps[0, 2:]).all()
    assert distributed._pad_candidates(s, i, 2)[1] is i
    with pytest.raises(NotImplementedError, match="mesh"):
        distributed.distributed_flat_search(object())


def test_sharded_backend_matches_local_flat_and_reference():
    rng = np.random.default_rng(2)
    c, q = _unit(rng, 512, 16), _unit(rng, 6, 16)
    lat = LatencyModel()
    flat = LocalFlatBackend(_t(c), 10, lat, chunk=64)
    shard = ShardedMeshBackend(_t(c), 10, lat, n_shards=4, n_workers=3)
    ref = RefSharded(jnp.asarray(c), 10, RefLatency(), n_shards=4,
                     n_workers=3)
    assert isinstance(shard, FullRetrievalBackend)
    assert shard.n_workers == ref.n_workers == 3
    assert shard.n_shards == ref.n_shards == 4
    s0, i0 = flat.search(_t(q))
    s1, i1 = shard.search(_t(q))
    assert torch.equal(i0, i1)
    torch.testing.assert_close(s0, s1, **TOL)
    _same_topk(*ref.search(jnp.asarray(q)), s1, i1)
    assert shard.latency(16) == ref.latency(16) < flat.latency(16)
    # shard < k through the same pair
    c2 = _unit(rng, 8, 16)
    f2 = LocalFlatBackend(_t(c2), 10, lat, chunk=8)
    sh2 = ShardedMeshBackend(_t(c2), 10, lat, n_shards=4)
    assert torch.equal(f2.search(_t(q))[1], sh2.search(_t(q))[1])


def test_sharded_backend_mesh_raises():
    c = torch.zeros((16, 4))
    with pytest.raises(NotImplementedError, match="mesh"):
        ShardedMeshBackend(c, 4, LatencyModel(), mesh=object())
    assert ShardedMeshBackend(c, 4, LatencyModel(), n_shards=0).n_shards == 1


WORLD = dict(n_entities=300, d=32, seed=0)


@pytest.mark.parametrize("dsim", [0.98, None])
def test_hybrid_sharded_matches_reference(dsim):
    rw, pw = RefWorld(RefWorldCfg(**WORLD)), PtWorld(PtWorldCfg(**WORLD))
    kw = dict(dense="sharded", n_shards=3, diversify_sim=dsim, chunk=256)
    ref = RefHybrid(jnp.asarray(rw.doc_emb), 10, RefLatency(), rw.doc_terms,
                    rw.doc_term_weights, backend="xla", **kw)
    pt = HybridBackend(pw.doc_emb, 10, LatencyModel(), pw.doc_terms,
                       pw.doc_term_weights, device="cpu", **kw)
    qs = rw.sample_queries(40, seed=3)
    e = np.stack([q["emb"] for q in qs])
    qt = np.stack([q["terms"] for q in qs]).astype(np.int32)
    qw = np.stack([q["term_weights"] for q in qs]).astype(np.float32)
    rv, ri = ref.search(*map(jnp.asarray, (e, qt, qw)))
    with dispatch.capture() as probe:
        pv, pi = pt.search(_t(e), _t(qt), _t(qw))
    assert probe.counts() == {"hybrid_backend_search": 1}
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_allclose(np.asarray(rv), pv.numpy(), **TOL)
    assert pt.latency(1) == ref.latency(1)
    flat = HybridBackend(pw.doc_emb, 10, LatencyModel(), pw.doc_terms,
                         pw.doc_term_weights, device="cpu",
                         diversify_sim=dsim)
    assert torch.equal(flat.search(_t(e), _t(qt), _t(qw))[1], pi)
    assert pt.latency(1) < flat.latency(1)
