"""Port parity of the hybrid cloud stage: ``lexical_score``,
``fused_rerank``, ``HybridBackend`` (flat and ANN dense channels), the
service's term forwarding, and HaS with fused-list speculation over it.

Lexical scores and ids must be bit-equal to the reference (the Pallas
kernel in interpret mode and its XLA oracle), including the reference's
tie order, which is not the exact top-k by (score desc, row asc).  On the
CPU, XLA contracts ``s + qw * m`` into a fused multiply-add; the port
rounds each product as the reference's code reads, so the random cases use
weights whose products are exact in f32 (the world's own postings, entity
weight 1.0, are such).  Fused masses must be bit-equal and ids equal.  The
ANN channel starts from the reference's centroids (the port's k-means draws
differ).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.has import HasConfig as RefCfg
from repro.data.synthetic import DATASETS
from repro.data.synthetic import SyntheticWorld as RefWorld
from repro.data.synthetic import WorldConfig as RefWorldCfg
from repro.kernels import ops as ref_ops
from repro.kernels.fused_rerank import _fuse_scores
from repro.kernels.lexical_score import _tile_scores
from repro.kernels.ref import fused_rerank_ref, lexical_score_ref
from repro.retrieval.service import HybridBackend as RefHybrid
from repro.serving.engine import FullRetrievalEngine as RefFull
from repro.serving.engine import HasEngine as RefHas
from repro.serving.engine import RetrievalService as RefService
from repro.serving.latency import LatencyModel as RefLatency
from repro_torch import convert
from repro_torch.core import dispatch
from repro_torch.core.has import HasConfig as PtCfg
from repro_torch.data.synthetic import SyntheticWorld as PtWorld
from repro_torch.data.synthetic import WorldConfig as PtWorldCfg
from repro_torch.kernels import ops
from repro_torch.kernels.fused_rerank import (fused_rerank, fused_scores,
                                              fused_scores_plain)
from repro_torch.kernels.lexical_score import (lexical_score,
                                               lexical_score_plain)
from repro_torch.retrieval.flat import chunked_flat_search
from repro_torch.retrieval.lexical import lexical_topk
from repro_torch.retrieval.service import (FullRetrievalBackend,
                                           HybridBackend, LocalFlatBackend)
from repro_torch.retrieval.service import RetrievalService as PtService
from repro_torch.serving.engine import FullRetrievalEngine as PtFull
from repro_torch.serving.engine import HasEngine as PtHas
from repro_torch.serving.latency import LatencyModel

WORLD = dict(n_entities=240, d=32, seed=0)
ANN = dict(n_clusters=16, nprobe=4, compressed=True)
METRICS = ("dar", "car", "doc_hit_rate", "ra_qwen3-8b", "ra_llama3-8b",
           "ra_mixtral-7b", "ra_at_da")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- lexical_score -----------------------------------------------------------

def _lexical_case(rng, n, b, vocab, tile_n):
    l_w, t_q = 5, 2
    dt = rng.integers(-1, vocab, (n, l_w)).astype(np.int32)
    # products of these weights are exact in f32 (module docstring)
    dw = rng.choice([0.25, 0.375, 0.5, 0.75, 1.0], (n, l_w)).astype(np.float32)
    dw[dt < 0] = 0.0
    dt[::11] = -1                                  # empty postings rows
    dw[::11] = 0.0
    qt = rng.integers(0, vocab, (b, t_q)).astype(np.int32)
    qw = rng.choice([0.5, 0.75, 1.0], (b, t_q)).astype(np.float32)
    qt[0, 1] = -1                                  # an inert query term
    qw[1, 0] = 0.0                                 # a zero-weight term
    if b > 2:
        qt[2] = -1                                 # a term-less query
    return qt, qw, dt, dw


def _exact_topk(qt, qw, dt, dw, k):
    """The exact top-k by (score desc, row asc) of the reference's scores."""
    s = np.asarray(_tile_scores(*map(jnp.asarray, (qt, qw, dt, dw))))
    out = []
    for row in s:
        order = np.lexsort((np.arange(len(row)), -row))[:k]
        out.append(np.where(np.isfinite(row[order]), order, -1))
    return np.stack(out)


@pytest.mark.parametrize("n,b,vocab,tile_n,k", [
    (700, 4, 50, 256, 8),        # tail tile, sparse matches
    (2500, 6, 6, 256, 10),       # tie-heavy: many tiles of equal scores
    (1030, 3, 6, 512, 10),       # the backend's tile width, tail tile
    (90, 3, 4, 32, 12),          # k > matches in some rows
])
def test_lexical_score_plain_bit_equal_to_reference(n, b, vocab, tile_n, k):
    rng = np.random.default_rng(n)
    qt, qw, dt, dw = _lexical_case(rng, n, b, vocab, tile_n)
    jargs = tuple(map(jnp.asarray, (qt, qw, dt, dw)))
    rv, ri = lexical_score_ref(*jargs, k, tile_n=tile_n)
    kv, ki = ref_ops.lexical_score(*jargs, k, tile_n=tile_n, interpret=True)
    pv, pi = lexical_score(*map(_t, (qt, qw, dt, dw)), k, tile_n=tile_n)
    for v, i in ((rv, ri), (kv, ki)):
        np.testing.assert_array_equal(np.asarray(v), pv.numpy())
        np.testing.assert_array_equal(np.asarray(i), pi.numpy())
    assert pi.dtype == torch.int32
    if b > 2:
        assert (pi[2] == -1).all() and torch.isneginf(pv[2]).all()
    assert not np.isin(np.arange(0, n, 11), pi.numpy()).any()


def test_lexical_port_follows_reference_where_it_is_not_exact_topk():
    """The reference's streamed merge is not the exact top-k by (score,
    row): the port must reproduce the reference, not the exact answer."""
    rng = np.random.default_rng(11)
    differs = 0
    for _ in range(6):
        qt, qw, dt, dw = _lexical_case(rng, 2000, 3, 6, 256)
        ri = np.asarray(lexical_score_ref(*map(jnp.asarray,
                                               (qt, qw, dt, dw)),
                                          10, tile_n=256)[1])
        _, pi = lexical_score_plain(*map(_t, (qt, qw, dt, dw)), 10,
                                    tile_n=256)
        np.testing.assert_array_equal(ri, pi.numpy())
        exact = _exact_topk(qt, qw, dt, dw, 10)
        differs += int((exact != ri).any(axis=1).sum())
    assert differs > 0


def test_lexical_topk_on_world_postings():
    w = RefWorld(RefWorldCfg(**WORLD))
    qs = w.sample_queries(16, seed=3)
    qt = np.stack([q["terms"] for q in qs]).astype(np.int32)
    qw = np.stack([q["term_weights"] for q in qs]).astype(np.float32)
    rv, ri = ref_ops.lexical_score(*map(jnp.asarray, (
        qt, qw, w.doc_terms, w.doc_term_weights)), 10, interpret=True)
    n = lexical_score.launches
    for backend in (None, "cuda", "torch"):           # CPU: plain each time
        pv, pi = lexical_topk(_t(qt), _t(qw), _t(w.doc_terms),
                              _t(w.doc_term_weights), 10, backend=backend)
        np.testing.assert_array_equal(np.asarray(rv), pv.numpy())
        np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    assert lexical_score.launches == n


# -- fused_rerank ------------------------------------------------------------

def _pool(rng, b=8, d=16, kd=10, kl=10):
    q = rng.normal(size=(b, d)).astype(np.float32)
    ids = rng.integers(0, 30, size=(b, kd + kl)).astype(np.int32)
    ids[0] = -1                                  # nothing retrieved at all
    ids[1, kd:] = ids[1, :kl]                    # lexical repeats dense
    ids[2, 3] = ids[2, 15] = -1                  # -1 slots in both channels
    vecs = rng.normal(size=(b, kd + kl, d)).astype(np.float32)
    vecs[:, 5] = vecs[:, 4] + 0.01 * rng.normal(size=(b, d))   # near dup
    vecs[ids < 0] = 0.0
    return q, ids, vecs, kd


@pytest.mark.parametrize("dsim", [None, 0.5, 0.98])
def test_fused_rerank_plain_matches_reference(dsim):
    rng = np.random.default_rng(13)
    q, ids, vecs, kd = _pool(rng)
    kl = ids.shape[1] - kd
    jargs = tuple(map(jnp.asarray, (q, ids, vecs)))
    ref_mass = np.asarray(jax.vmap(functools.partial(
        _fuse_scores, kd=kd, kl=kl, rrf_k=60.0, diversify_sim=dsim))(
        *jargs)[0])
    mass, rscore = fused_scores(*map(_t, (q, ids, vecs)), kd, 60.0, dsim)
    np.testing.assert_array_equal(ref_mass, mass.numpy())
    np.testing.assert_allclose(np.einsum("bpd,bd->bp", vecs, q),
                               rscore.numpy(), rtol=1e-5, atol=1e-5)
    rv, ri = fused_rerank_ref(*jargs, kd, 10, rrf_k=60.0, diversify_sim=dsim)
    kv, ki = ref_ops.fused_rerank(*jargs, kd, 10, rrf_k=60.0,
                                  diversify_sim=dsim, interpret=True)
    pv, pi = fused_rerank(*map(_t, (q, ids, vecs)), kd, 10, 60.0, dsim)
    for v, i in ((rv, ri), (kv, ki)):
        np.testing.assert_array_equal(np.asarray(v), pv.numpy())
        np.testing.assert_array_equal(np.asarray(i), pi.numpy())
    assert (pi[0] == -1).all()                   # empty pool -> empty result
    served = pi[1][pi[1] >= 0].tolist()
    assert len(served) == len(set(served))       # duplicates served once
    if dsim == 0.5:                              # diversification dropped some
        assert torch.isneginf(mass[3:]).sum() > torch.isneginf(
            fused_scores_plain(*map(_t, (q, ids, vecs)), kd)[0][3:]).sum()


# -- HybridBackend -----------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _worlds():
    return RefWorld(RefWorldCfg(**WORLD)), PtWorld(PtWorldCfg(**WORLD))


def _backends(dense, **kw):
    rw, pw = _worlds()
    ann = dict(ann_kwargs=dict(ANN)) if dense == "ann" else {}
    ref = RefHybrid(jnp.asarray(rw.doc_emb), 10, RefLatency(), rw.doc_terms,
                    rw.doc_term_weights, dense=dense, backend="xla", **ann,
                    **kw)
    if dense == "ann":
        ann["ann_kwargs"]["centroids"] = np.asarray(ref._ivf.index.centroids)
    pt = HybridBackend(pw.doc_emb, 10, LatencyModel(), pw.doc_terms,
                       pw.doc_term_weights, dense=dense, device="cpu", **ann,
                       **kw)
    return ref, pt


def _batch(world, n, seed=3):
    qs = world.sample_queries(n, seed=seed)
    return (np.stack([q["emb"] for q in qs]),
            np.stack([q["terms"] for q in qs]).astype(np.int32),
            np.stack([q["term_weights"] for q in qs]).astype(np.float32))


@pytest.mark.parametrize("dense,dsim", [("flat", 0.98), ("ann", 0.98),
                                        ("ann", None)])
def test_hybrid_backend_matches_reference(dense, dsim):
    ref, pt = _backends(dense, diversify_sim=dsim)
    assert isinstance(pt, FullRetrievalBackend)
    if dense == "ann":
        for f in convert.COMPRESSED_IVF_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(ref._ivf.index, f)),
                getattr(pt._ivf.index, f).numpy(), err_msg=f)
    e, qt, qw = _batch(_worlds()[0], 48)
    rv, ri = ref.search(*map(jnp.asarray, (e, qt, qw)))
    with dispatch.capture() as probe:
        pv, pi = pt.search(_t(e), _t(qt), _t(qw))
    assert probe.counts() == {"hybrid_backend_search": 1}
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_array_equal(np.asarray(rv), pv.numpy())
    # term-less search: inert terms, the same as explicit -1 terms
    rv0, ri0 = ref.search(jnp.asarray(e))
    pv0, pi0 = pt.search(_t(e))
    np.testing.assert_array_equal(np.asarray(ri0), pi0.numpy())
    _, pi1 = pt.search(_t(e), torch.full((48, 2), -1, dtype=torch.int32))
    assert torch.equal(pi0, pi1)
    assert pt.latency(1) == ref.latency(1)


def test_hybrid_latency_model_and_knob_validation():
    _, pw = _worlds()
    lat = LatencyModel()
    hb = HybridBackend(pw.doc_emb, 10, lat, pw.doc_terms,
                       pw.doc_term_weights, device="cpu")
    flat = LocalFlatBackend(hb.corpus, 10, lat)
    assert flat.latency(1) < hb.latency(1) <= 1.25 * flat.latency(1)
    hb1 = HybridBackend(pw.doc_emb, 10, lat, pw.doc_terms,
                        pw.doc_term_weights, lexical_terms=1, device="cpu")
    assert hb1.latency(1) < hb.latency(1) and hb1.lexical_terms == 1
    bad = [dict(rrf_k=0.5), dict(diversify_sim=1.5), dict(diversify_sim=0.0),
           dict(dense="faiss"), dict(backend="xla")]
    for kw in bad:
        with pytest.raises(ValueError):
            HybridBackend(pw.doc_emb, 10, lat, pw.doc_terms,
                          pw.doc_term_weights, device="cpu", **kw)
    with pytest.raises(ValueError):
        HybridBackend(pw.doc_emb, 10, lat, pw.doc_terms[:10],
                      pw.doc_term_weights[:10], device="cpu")
    # the sharded dense channel: the shard scan's modelled speed-up
    hs = HybridBackend(pw.doc_emb, 10, lat, pw.doc_terms,
                       pw.doc_term_weights, dense="sharded", n_shards=4,
                       device="cpu")
    assert hs.n_shards == 4 and hs.latency(1) < hb.latency(1)


def test_service_forwards_terms_only_to_lexical_backends():
    _, pt = _backends("flat")
    _, pw = _worlds()
    svc = PtService(pw, LatencyModel(), k=10, backend=pt, device="cpu")
    assert svc.corpus is pt.corpus
    e, qt, qw = _batch(pw, 6, seed=5)
    ids, t = svc.full_search_batch(e, qt, qw)
    np.testing.assert_array_equal(ids, pt.search(_t(e), _t(qt),
                                                 _t(qw))[1].numpy())
    assert t == pt.latency(6)
    one, vecs, _ = svc.full_search(e[0], qt[0], qw[0])
    np.testing.assert_array_equal(one, ids[0])
    assert torch.equal(vecs, svc.corpus[torch.as_tensor(one).clamp_min(0)
                                        .long()])
    # weights default to 1 per valid term
    _, i_def = pt.search(_t(e), _t(qt))
    _, i_one = pt.search(_t(e), _t(qt), (_t(qt) >= 0).float())
    assert torch.equal(i_def, i_one)
    flat_svc = PtService(pw, LatencyModel(), k=10, device="cpu")
    assert flat_svc._term_kw(qt, qw) == {}
    fi, _ = flat_svc.full_search_batch(e, qt, qw)          # terms ignored
    np.testing.assert_array_equal(
        fi, chunked_flat_search(flat_svc.corpus, _t(e), 10,
                                flat_svc.chunk)[1].numpy())


# -- engines over the hybrid cloud stage --------------------------------------

@pytest.fixture(scope="module")
def hybrid_setup():
    rw, pw = _worlds()
    ds = DATASETS["granola"]
    queries = rw.sample_queries(240, pattern=ds["pattern"],
                                zipf_a=ds["zipf_a"],
                                p_uncovered=ds["p_uncovered"], seed=1)
    # narrow channels (a 12-slot pool for k=10), so duplicates across them
    # leave fused results with -1 slots
    ref_b, pt_b = _backends("ann", dense_k=6, lexical_k=6)
    rs = RefService(rw, RefLatency(), k=10, backend=ref_b)
    ps = PtService(pw, LatencyModel(), k=10, backend=pt_b, device="cpu")
    return queries, rs, ps


def _recording(engine):
    log, step = [], engine.step

    def rec(*a, **kw):
        out = step(*a, **kw)
        log.append(out)
        return out

    engine.step = rec
    return log


def test_full_retrieval_engine_over_hybrid_matches_reference(hybrid_setup):
    queries, rs, ps = hybrid_setup
    ref = RefFull(rs).serve(queries[:60])
    pt = PtFull(ps).serve(queries[:60])
    np.testing.assert_array_equal(ref.doc_hits, pt.doc_hits)
    for llm in ref.ra:
        np.testing.assert_array_equal(ref.ra[llm], pt.ra[llm])
    for q in queries[:8]:
        ri, _, _ = rs.full_search(q["emb"], q["terms"], q["term_weights"])
        pi, _, _ = ps.full_search(q["emb"], q["terms"], q["term_weights"])
        np.testing.assert_array_equal(ri, pi)


def test_has_engine_rrf_over_hybrid_matches_reference(hybrid_setup):
    queries, rs, ps = hybrid_setup
    # rrf-weighted homology of a draft half from a 10-doc ring sits near
    # 0.5: tau=0.55 gives both accepts and rejects here
    cfg = dict(k=10, tau=0.55, h_max=64, nprobe=4, n_buckets=32, d=32,
               fusion="rrf")
    ref_eng = RefHas(rs, RefCfg(**cfg), backend="xla")
    index = convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(ref_eng.index, f))
         for f in convert.IVF_FIELDS}, device="cpu")
    pt_eng = PtHas(ps, PtCfg(**cfg), backend="torch", index=index)
    ref_log, pt_log = _recording(ref_eng), _recording(pt_eng)
    ref = ref_eng.serve(queries)
    pt = pt_eng.serve(queries)
    np.testing.assert_array_equal(ref.accepts, pt.accepts)
    np.testing.assert_array_equal(ref.doc_hits, pt.doc_hits)
    np.testing.assert_array_equal(ref.correct_accepts, pt.correct_accepts)
    rsum, psum = ref.summary(), pt.summary()
    for m in METRICS:
        assert rsum[m] == psum[m], m
    assert 0.0 < psum["dar"] < 1.0
    for i, (r, p) in enumerate(zip(ref_log, pt_log)):
        np.testing.assert_array_equal(np.asarray(r[0]), np.asarray(p[0]),
                                      err_msg=f"ids of query {i}")
        assert r[1] == p[1], f"accept of query {i}"
    ref_state = {f: np.asarray(getattr(ref_eng.state, f))
                 for f in convert.STATE_FIELDS}
    pt_state = convert.has_state_to_numpy(pt_eng.state)
    for f in ("query_doc_ids", "query_valid", "q_ptr", "doc_ids", "d_ptr"):
        np.testing.assert_array_equal(ref_state[f], pt_state[f], err_msg=f)
    np.testing.assert_allclose(ref_state["doc_emb"], pt_state["doc_emb"])
    # fused results drop slots: -1 ids reached cache_update's query ring
    assert (pt_state["query_doc_ids"][pt_state["query_valid"]] == -1).any()
