"""Port parity of live ingest (``IVFBackend.ingest_docs``,
``HybridBackend.ingest_docs``) and of ``ReplicaBackend``.

The port's k-means cannot repeat the reference's ``jax.random`` draws, so
the port gets the reference's centroids: at the first build
(``centroids=``) and, for a rebuild, the reference's rebuilt centroids
before the port's ingest that triggers it.  With equal centroids every
host array must be equal: bucket ids, codes or vectors, scales, counts,
the residual buffer, ``rebuilds``.  Search ids are held to the
reference's up to swaps of near-tied scores (the plain bucket scan sums
in another order).
"""
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sched_util import (CFG, assert_same_result, make_env,
                               port_index)
from _torch_sched_util import one_torch_thread  # noqa: F401 (autouse)
from repro.checkpoint import CheckpointManager as RefMgr
from repro.core.has import HasConfig as RefCfg
from repro.data.synthetic import SyntheticWorld as RefWorld
from repro.data.synthetic import WorldConfig as RefWorldCfg
from repro.retrieval.service import HybridBackend as RefHybrid
from repro.retrieval.service import IVFBackend as RefIVF
from repro.retrieval.service import LocalFlatBackend as RefFlat
from repro.retrieval.service import ReplicaBackend as RefReplica
from repro.retrieval.service import RetrievalService as RefService
from repro.retrieval.service import ShardedMeshBackend as RefSharded
from repro.serving.latency import LatencyModel as RefLatency
from repro.serving.replication import WarmStandby as RefStandby
from repro.serving.scheduler import ContinuousBatchingScheduler as RefSched
from repro.serving.scheduler import SchedulerConfig as RefSchedCfg
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.has import (HasConfig, cache_update_chunked,
                                  init_has_state)
from repro_torch.data.synthetic import SyntheticWorld as PtWorld
from repro_torch.data.synthetic import WorldConfig as PtWorldCfg
from repro_torch.retrieval.service import (HybridBackend, IVFBackend,
                                           LocalFlatBackend, ReplicaBackend,
                                           RetrievalService,
                                           ShardedMeshBackend)
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.replication import WarmStandby
from repro_torch.serving.scheduler import ContinuousBatchingScheduler
from repro_torch.serving.scheduler import SchedulerConfig

HOST = ("_bids_np", "_bvecs_np", "_bscales_np", "_counts_np", "_res_vecs_np",
        "_res_ids_np", "_corpus_np", "_ids_np", "_cents_np")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n, d, n_protos=32, spread=0.2):
    protos = _unit(rng, n_protos, d)
    x = protos[rng.integers(0, n_protos, n)] + spread * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _near(c, n, rng, d, spread=0.01):
    x = c[None] + spread * rng.normal(size=(n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _same_host(ref, pt):
    for f in HOST:
        a, b = getattr(ref, f), getattr(pt, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f)
    assert ref.residual_count == pt.residual_count
    assert ref.rebuilds == pt.rebuilds
    assert ref._next_id == pt._next_id


def _same_search(ref, pt, q, tol=1e-5):
    rv, ri = map(np.asarray, ref.search(jnp.asarray(q)))
    pv, pi = pt.search(_t(q))
    np.testing.assert_allclose(rv, pv.numpy(), rtol=tol, atol=tol)
    pi = pi.numpy()
    for r in range(len(q)):
        for j in np.flatnonzero(ri[r] != pi[r]):      # near-tie swaps only
            assert np.abs(rv[r] - rv[r, j]).min() <= tol
    return pi


def _pair(corpus, compressed, **kw):
    kw = dict(n_clusters=16, nprobe=4, residual_cap=8, seed=2,
              compressed=compressed, **kw)
    ref = RefIVF(jnp.asarray(corpus), 10, RefLatency(), backend="xla",
                 interpret=True, **kw)
    pt = IVFBackend(corpus, 10, LatencyModel(), device="cpu",
                    centroids=ref._cents_np, **kw)
    return ref, pt


@pytest.mark.parametrize("compressed", [False, True])
def test_ivf_ingest_matches_reference(compressed):
    rng = np.random.default_rng(10)
    d = 32
    corpus = _clustered(rng, 1600, d)
    ref, pt = _pair(corpus, compressed)
    _same_host(ref, pt)
    # one doc, twice under one key: grown once, same ids
    v = _unit(rng, 1, d)
    ids = pt.ingest_docs(v, ingest_key="batch-1")
    np.testing.assert_array_equal(ref.ingest_docs(v, ingest_key="batch-1"),
                                  ids)
    assert pt.ingest_docs(v, ingest_key="batch-1") is ids
    assert pt._corpus_np.shape[0] == 1601
    _same_host(ref, pt)
    assert int(_same_search(ref, pt, v)[0, 0]) == int(ids[0])
    # docs of the world's kind, then a spill into the residual
    more = _clustered(rng, 40, d)
    np.testing.assert_array_equal(ref.ingest_docs(more), pt.ingest_docs(more))
    b0 = int(np.argmax(pt._counts_np))
    need = pt._bids_np.shape[1] - int(pt._counts_np[b0]) + 5
    spill = _near(pt._cents_np[b0], need, rng, d)
    np.testing.assert_array_equal(ref.ingest_docs(spill),
                                  pt.ingest_docs(spill))
    assert pt.residual_count > 0 and pt.rebuilds == 0
    _same_host(ref, pt)
    got = _same_search(ref, pt, spill[-3:])
    assert all(s in row for s, row in zip(pt._ids_np[-3:], got))
    # a flood near one centroid overflows the residual: a rebuild, with the
    # reference's rebuilt centroids handed over
    flood = _near(pt._cents_np[0], 300, rng, d)
    want = ref.ingest_docs(flood, ingest_key="flood")
    assert ref.rebuilds == 1 and ref.residual_count == 0
    pt.centroids = ref._cents_np
    np.testing.assert_array_equal(pt.ingest_docs(flood, ingest_key="flood"),
                                  want)
    _same_host(ref, pt)
    assert pt.rebuilds == 1 and pt._dirty
    got = _same_search(ref, pt, flood[:16])
    assert not pt._dirty
    assert np.mean([f in row for f, row in zip(want[:16], got)]) >= 0.9
    assert pt.latency(1) == ref.latency(1)
    assert pt.index.capacity == ref.index.capacity > 1600 * 2 // 16


def test_ivf_device_index_never_aliases_the_host_arrays():
    rng = np.random.default_rng(11)
    corpus = _clustered(rng, 800, 16)
    be = IVFBackend(corpus, 10, LatencyModel(), n_clusters=8, nprobe=2,
                    residual_cap=4, device="cpu")
    before = be.index.bucket_ids.clone()
    res_before = be._res_ids.clone()
    b0 = int(np.argmax(be._counts_np))
    be.ingest_docs(_near(be._cents_np[b0], be._bids_np.shape[1]
                         - int(be._counts_np[b0]) + 2, rng, 16))
    assert be.residual_count == 2 and be._dirty
    # the host mirrors moved; the device copies did not, until a search
    assert torch.equal(be.index.bucket_ids, before)
    assert torch.equal(be._res_ids, res_before)
    be.search(_t(corpus[:2]))
    assert not torch.equal(be.index.bucket_ids, before)
    assert (be._res_ids >= 0).sum() == 2
    for t, a in ((be.index.bucket_ids, be._bids_np),
                 (be._res_vecs, be._res_vecs_np)):
        assert t.data_ptr() != a.ctypes.data


WORLD = dict(n_entities=300, d=32, seed=0)


@pytest.mark.parametrize("dense", ["flat", "ann"])
def test_hybrid_ingest_matches_reference(dense):
    rw, pw = RefWorld(RefWorldCfg(**WORLD)), PtWorld(PtWorldCfg(**WORLD))
    ann = dict(n_clusters=16, nprobe=4, residual_cap=16, compressed=True)
    ref = RefHybrid(jnp.asarray(rw.doc_emb), 10, RefLatency(), rw.doc_terms,
                    rw.doc_term_weights, dense=dense, backend="xla",
                    **({"ann_kwargs": dict(ann)} if dense == "ann" else {}))
    if dense == "ann":
        ann["centroids"] = ref._ivf._cents_np
    pt = HybridBackend(pw.doc_emb, 10, LatencyModel(), pw.doc_terms,
                       pw.doc_term_weights, dense=dense, device="cpu",
                       **({"ann_kwargs": ann} if dense == "ann" else {}))
    n0 = pw.cfg.n_docs
    rng = np.random.default_rng(4)
    vecs = _unit(rng, 5, 32)
    with pytest.raises(ValueError, match="sequential"):
        pt.ingest_docs(vecs, ids=np.arange(n0 + 1, n0 + 6))
    # terms: a narrower batch, -1s and explicit weights; one doc with none
    terms = np.array([[7, -1], [7, 9], [11, 12], [-1, -1], [3, 3]], np.int32)
    tw = np.array([[0.5, 0.9], [1.0, 0.25], [2.0, 1.0], [1.0, 1.0],
                   [0.75, 0.75]], np.float32)
    got = pt.ingest_docs(vecs, ids=np.arange(n0, n0 + 5), terms=terms,
                         term_weights=tw, ingest_key="k1")
    want = ref.ingest_docs(vecs, ids=np.arange(n0, n0 + 5), terms=terms,
                           term_weights=tw, ingest_key="k1")
    np.testing.assert_array_equal(got, want)
    assert pt.ingest_docs(vecs, terms=terms, ingest_key="k1") is got
    np.testing.assert_array_equal(pt._terms_np, ref._terms_np)
    np.testing.assert_array_equal(pt._tw_np, ref._tw_np)
    L = pt.lexical_terms
    assert (pt._terms_np[n0 + 3] == -1).all() and (pt._tw_np[n0 + 3] == 0).all()
    assert pt._tw_np[n0, 1 % L] == (0.0 if L > 1 else 0.5)
    # a doc with no terms at all, ids left to the backend
    more = _unit(rng, 3, 32)
    np.testing.assert_array_equal(pt.ingest_docs(more), ref.ingest_docs(more))
    assert pt._corpus_np.shape[0] == n0 + 8 == pt._terms_np.shape[0]
    np.testing.assert_array_equal(pt._corpus_np, ref._corpus_np)
    qt = np.array([[7, 9], [11, -1], [3, -1]], np.int32)
    qw = (qt >= 0).astype(np.float32)
    q = np.concatenate([vecs[:2], more[:1]])
    rv, ri = ref.search(*map(jnp.asarray, (q, qt, qw)))
    pv, pi = pt.search(_t(q), _t(qt), _t(qw))
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_allclose(np.asarray(rv), pv.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert n0 in pi[0].tolist() and n0 + 5 in pi[2].tolist()
    assert pt.corpus.shape[0] == n0 + 8
    assert pt.latency(1) == ref.latency(1)


def _standby(cfg, mk, mgr_cls, **kw):
    return mk(cfg, mgr_cls(tempfile.mkdtemp(prefix="standby-")),
              snapshot_every=10**9, max_lag=10**6, **kw)


def test_replica_padded_ids_gather_zero_vectors():
    rng = np.random.default_rng(7)
    n, k, d = 5, 7, 16                       # whole corpus < k
    corpus = _unit(rng, n, d)
    cfg = HasConfig(k=k, tau=0.2, h_max=16, doc_capacity=64, d=d)
    sb = _standby(cfg, WarmStandby, CheckpointManager, device="cpu")
    be = ReplicaBackend(ShardedMeshBackend(_t(corpus), k, LatencyModel(),
                                           n_shards=2), [sb], _t(corpus))
    ref = RefReplica(RefSharded(jnp.asarray(corpus), k, RefLatency(),
                                n_shards=2), [], jnp.asarray(corpus))
    qs = _unit(rng, 6, d)
    _, ids = be.search(_t(qs))
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(ref.search(jnp.asarray(qs))[1]))
    ids = ids.numpy()
    assert (ids < 0).any()
    primary = cache_update_chunked(cfg, init_has_state(cfg, device="cpu"), qs,
                                   ids, corpus=_t(corpus), chunk=4)
    be.on_ingest(qs, ids, primary)
    for q, row_ids, vecs in sb.log:
        assert (vecs[row_ids < 0] == 0.0).all()
        np.testing.assert_array_equal(vecs[row_ids >= 0],
                                      corpus[row_ids[row_ids >= 0]])
    rec = sb.failover()
    for f in ("query_emb", "query_doc_ids", "q_ptr", "doc_emb", "doc_ids",
              "d_ptr"):
        assert torch.equal(getattr(rec, f), getattr(primary, f)), f
    assert be.uses_lexical is False and be.q_term_width == 0
    assert be.n_workers == 1 and be.latency(4) == ref.latency(4)


def test_replica_ingest_passthrough_refreshes_the_mirror():
    rng = np.random.default_rng(8)
    corpus = _clustered(rng, 400, 16)
    inner = IVFBackend(corpus, 10, LatencyModel(), n_clusters=8, nprobe=2,
                       device="cpu")
    be = ReplicaBackend(inner, [], _t(corpus))
    new = _unit(rng, 3, 16)
    ids = be.ingest_docs(new, ingest_key="a")
    assert be._corpus_np is inner._corpus_np
    np.testing.assert_array_equal(be._corpus_np[ids], new)
    with pytest.raises(AttributeError, match="no ingest_docs"):
        ReplicaBackend(LocalFlatBackend(_t(corpus), 10, LatencyModel()), [],
                       _t(corpus)).ingest_docs(new)


@pytest.fixture(scope="module")
def env():
    return make_env(n_entities=600, n_queries=300)


@pytest.mark.parametrize("snapshot_every", [10**9, 40])
def test_replica_failover_matches_reference_scheduler(env, snapshot_every):
    """``serve --retrieval-backend replica`` under the scheduler: results
    equal the reference's, each standby's log holds every folded row once,
    and a failover rebuilds the primary's rings exactly."""
    rc, pc = RefCfg(**CFG), HasConfig(**CFG)
    kw = dict(snapshot_every=snapshot_every, max_lag=10**6)
    rsb = [RefStandby(rc, RefMgr(tempfile.mkdtemp()), **kw)
           for _ in range(2)]
    psb = [WarmStandby(pc, CheckpointManager(tempfile.mkdtemp()),
                       device="cpu", **kw) for _ in range(2)]
    rs, ps = env.ref_service, env.pt_service
    rback = RefReplica(RefFlat(rs.corpus, 10, rs.latency, chunk=2048), rsb,
                       rs.corpus)
    pback = ReplicaBackend(LocalFlatBackend(ps.corpus, 10, ps.latency,
                                            chunk=2048), psb, ps.corpus)
    sk = dict(max_spec_batch=16, full_batch=8, full_max_wait_s=0.1)
    ref = RefSched(RefService(rs.world, RefLatency(), k=10, chunk=2048,
                              backend=rback), rc, RefSchedCfg(**sk))
    pt = ContinuousBatchingScheduler(
        RetrievalService(ps.world, LatencyModel(), k=10, chunk=2048,
                         backend=pback, device="cpu"), pc,
        SchedulerConfig(**sk), index=port_index(ref.index))
    assert pt.n_full_workers == ref.n_full_workers == 2
    r = ref.serve(env.queries, None, seed=0)
    p = pt.serve(env.queries, None, seed=0)
    assert_same_result(r, p)
    folded = int(pt.state.q_ptr)
    for sb in psb:
        sb.mgr.wait()
        rows = sb._step
        assert rows == folded                 # every folded row, once
        rec = sb.failover()
        for f in ("query_emb", "query_doc_ids", "query_valid", "q_ptr",
                  "doc_emb", "doc_ids", "d_ptr"):
            assert torch.equal(getattr(rec, f), getattr(pt.state, f)), f
    want, got = rsb[0].failover(), psb[0].failover()
    for f in ("query_emb", "query_doc_ids", "q_ptr", "doc_emb", "doc_ids",
              "d_ptr"):
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
