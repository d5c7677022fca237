"""Port parity of the baselines: ``core/baselines.py``, the int8 store of
``retrieval/flat.py`` and the engines beside HaS in ``serving/engine.py``.

Each engine of the reference (XLA backend) and of the port
(``device="cpu"``) serves the same small world and stream; the port gets
the reference's IVF index (for ``"scann"`` the index before its int8
rounding, which both packages then apply).  Per-query ids and accept bits
must be equal, and so must DAR, CAR, DocHit and RA; AvgL is not compared
(it includes measured wall-clock).  The int8 codes and scales are
bit-equal, quantized search ids equal and scores within 1e-5 (f32 sums in
another order); the match rules give equal (ok, slot) and scores within
1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as rb
from repro.core.has import HasConfig as RefCfg
from repro.data.synthetic import DATASETS
from repro.data.synthetic import SyntheticWorld as RefWorld
from repro.data.synthetic import WorldConfig as RefWorldCfg
from repro.retrieval.flat import quantize_store as ref_quantize
from repro.retrieval.flat import quantized_search as ref_qsearch
from repro.retrieval.ivf import build_ivf as ref_build_ivf
from repro.serving import engine as re
from repro.serving.latency import LatencyModel as RefLatency
from repro_torch import convert
from repro_torch.core import baselines as pb
from repro_torch.core.has import HasConfig as PtCfg
from repro_torch.data.synthetic import SyntheticWorld as PtWorld
from repro_torch.data.synthetic import WorldConfig as PtWorldCfg
from repro_torch.retrieval.flat import quantize_store, quantized_search
from repro_torch.retrieval.service import RetrievalService as PtService
from repro_torch.serving import engine as pe
from repro_torch.serving.latency import LatencyModel as PtLatency

WORLD = dict(n_entities=300, d=32, seed=0)
CFG = dict(k=10, tau=0.2, h_max=64, nprobe=4, n_buckets=32, d=32)
ANN = dict(n_buckets=32, nprobe=4)
METRICS = ("dar", "car", "doc_hit_rate", "ra_qwen3-8b", "ra_llama3-8b",
           "ra_mixtral-7b")


@pytest.fixture(scope="module")
def setup():
    rw, pw = RefWorld(RefWorldCfg(**WORLD)), PtWorld(PtWorldCfg(**WORLD))
    ds = DATASETS["granola"]
    queries = rw.sample_queries(160, pattern=ds["pattern"],
                                zipf_a=ds["zipf_a"],
                                p_uncovered=ds["p_uncovered"], seed=1)
    rs = re.RetrievalService(rw, RefLatency(), k=10)
    ps = PtService(pw, PtLatency(), k=10, device="cpu")
    return queries, rs, ps


def _record(engine):
    """Wrap ``engine._step`` to keep every (ids, accept) it serves."""
    log, step = [], engine._step

    def rec(q, rng, dataset):
        out = step(q, rng, dataset)
        log.append((np.asarray(out[0]), bool(out[1])))
        return out

    engine._step = rec
    return log


def _port_index(ref_index):
    return convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(ref_index, f)) for f in convert.IVF_FIELDS},
        device="cpu")


def _serve_both(ref_eng, pt_eng, queries, dataset="granola"):
    ref_log, pt_log = _record(ref_eng), _record(pt_eng)
    ref = ref_eng.serve(queries, dataset=dataset)
    pt = pt_eng.serve(queries, dataset=dataset)
    for i, (r, p) in enumerate(zip(ref_log, pt_log)):
        np.testing.assert_array_equal(r[0], p[0], err_msg=f"ids of {i}")
        assert r[1] == p[1], f"accept of query {i}"
    np.testing.assert_array_equal(ref.accepts, pt.accepts)
    rs, ps = ref.summary(), pt.summary()
    for m in METRICS:
        assert rs[m] == ps[m], m
    return pt.summary()


def _anns_pair(rs, ps, method, seed=0):
    """Both packages' ANNSEngine over one reference-built index."""
    ref = re.ANNSEngine(rs, method, seed=seed, **ANN)
    base = ref_build_ivf(rs.corpus, ANN["n_buckets"], seed=seed)
    pt = pe.ANNSEngine(ps, method, backend="torch", index=_port_index(base),
                       **ANN)
    return ref, pt


@pytest.mark.parametrize("method", ["ivf", "scann"])
def test_anns_engine_matches_reference(setup, method):
    queries, rs, ps = setup
    ref, pt = _anns_pair(rs, ps, method)
    # the int8-rounded bucket store is bit-equal (the reference divides)
    np.testing.assert_array_equal(np.asarray(ref.index.bucket_vecs),
                                  pt.index.bucket_vecs.numpy())
    assert pt.scope == ref.scope and pt.nprobe == ref.nprobe
    for q in queries[:5]:
        (ri, rt), (pi, pt_t) = ref.search(q["emb"]), pt.search(q["emb"])
        np.testing.assert_array_equal(ri, pi)
        assert rt == pt_t
    _serve_both(ref, pt, queries[:60])


def test_has_engine_with_anns_fallback_matches_reference(setup):
    queries, rs, ps = setup
    ref_fb, pt_fb = _anns_pair(rs, ps, "ivf")
    ref = re.HasEngine(rs, RefCfg(**CFG), fallback=ref_fb, backend="xla")
    pt = pe.HasEngine(ps, PtCfg(**CFG), fallback=pt_fb, backend="torch",
                      index=_port_index(ref.index))
    s = _serve_both(ref, pt, queries)
    assert 0.0 < s["dar"] < 1.0


def test_has_engine_tenants_match_reference(setup):
    """Three partitions (query tags = entity % 3): per-query ids and
    accept bits, and every tenant's rings."""
    queries, rs, ps = setup
    tagged = [dict(q, tenant=int(q["entity"]) % 3) for q in queries]
    ref = re.HasEngine(rs, RefCfg(**CFG), backend="xla", n_tenants=3)
    pt = pe.HasEngine(ps, PtCfg(**CFG), backend="torch", n_tenants=3,
                      index=_port_index(ref.index))
    s = _serve_both(ref, pt, tagged)
    assert 0.0 < s["dar"] < 1.0
    got = convert.tenant_state_to_numpy(pt.state)
    for f in ("query_doc_ids", "query_valid", "q_ptr", "doc_ids", "d_ptr"):
        np.testing.assert_array_equal(np.asarray(getattr(ref.state, f)),
                                      got[f], err_msg=f)
    assert (got["q_ptr"] > 0).all()
    with pytest.raises(ValueError, match="tenant 3 out of range"):
        pt.step(queries[0]["emb"], 3)


@pytest.mark.parametrize("method,kw", [
    ("proximity", dict(theta=0.6)), ("saferadius", dict(alpha=4.0)),
    ("mincache", dict(t_lex=0.6, t_sem=0.9))])
def test_reuse_engine_matches_reference(setup, method, kw):
    queries, rs, ps = setup
    ref = re.ReuseEngine(rs, method, h_max=40, **kw)
    pt = pe.ReuseEngine(ps, method, h_max=40, **kw)
    s = _serve_both(ref, pt, queries)
    assert 0.0 < s["dar"] < 1.0
    for f in ("doc_ids", "minhash", "valid", "ptr"):
        np.testing.assert_array_equal(np.asarray(getattr(ref.state, f)),
                                      getattr(pt.state, f).numpy(),
                                      err_msg=f)
    np.testing.assert_allclose(np.asarray(ref.state.margins),
                               pt.state.margins.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dataset", ["granola", "popqa"])
def test_crag_engine_matches_reference(setup, dataset):
    """The evaluator's draws from the record rng and the latency model's
    draws come in the reference's order: every later query agrees."""
    queries, rs, ps = setup
    ref = re.CRAGEngine(rs, RefCfg(**CFG))
    pt = pe.CRAGEngine(ps, PtCfg(**CFG), index=_port_index(ref.index))
    s = _serve_both(ref, pt, queries[:100], dataset=dataset)
    assert 0.0 < s["dar"] < 1.0


def test_fuzzy_scope_matches_reference():
    cfg = PtCfg(**CFG)
    for n_buckets in (2, 32, 64):
        index = type("I", (), {"n_buckets": n_buckets})()
        assert pe.fuzzy_scope(cfg, index) == re.fuzzy_scope(RefCfg(**CFG),
                                                            index)


# -- the int8 store ---------------------------------------------------------

def test_quantize_store_matches_reference_bit_exactly():
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(500, 48)).astype(np.float32)
    corpus[3] = 0.0                                # a zero row
    ref = ref_quantize(jnp.asarray(corpus))
    got = quantize_store(torch.from_numpy(corpus))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ref["q"]), got["q"].numpy())
    np.testing.assert_array_equal(np.asarray(ref["scale"]),
                                  got["scale"].numpy())


@pytest.mark.parametrize("rescore", [False, True])
def test_quantized_search_matches_reference(rescore):
    rng = np.random.default_rng(1)
    corpus = rng.normal(size=(600, 32)).astype(np.float32)
    q = rng.normal(size=(9, 32)).astype(np.float32)
    rs_, ri = ref_qsearch(ref_quantize(jnp.asarray(corpus)), jnp.asarray(q),
                          7, rescore=jnp.asarray(corpus) if rescore else None)
    ps_, pi = quantized_search(quantize_store(torch.from_numpy(corpus)),
                               torch.from_numpy(q), 7,
                               rescore=torch.from_numpy(corpus)
                               if rescore else None)
    np.testing.assert_array_equal(np.asarray(ri), pi.numpy())
    np.testing.assert_allclose(np.asarray(rs_), ps_.numpy(), rtol=1e-5,
                               atol=1e-5)


# -- the match rules --------------------------------------------------------

def _reuse_pair(h=12, k=4, d=16, n_hash=8, fill=9, seed=0):
    """One reuse state filled through both packages' ``reuse_insert``."""
    rng = np.random.default_rng(seed)
    rst = rb.init_reuse_state(h, k, d, n_hash)
    pst = pb.init_reuse_state(h, k, d, n_hash, device="cpu")
    for _ in range(fill):
        q = rng.normal(size=d).astype(np.float32)
        q /= np.linalg.norm(q)
        ids = rng.integers(0, 99, k).astype(np.int32)
        vecs = rng.normal(size=(k, d)).astype(np.float32)
        scores = np.sort(rng.random(k).astype(np.float32))[::-1].copy()
        mh = rng.integers(0, 5, n_hash).astype(np.int32)
        rst = rb.reuse_insert(rst, jnp.asarray(q), jnp.asarray(ids),
                              jnp.asarray(vecs), jnp.asarray(scores),
                              jnp.asarray(mh))
        assert pb.reuse_insert(pst, q, ids, vecs, scores, mh) is pst
    return rst, pst, rng


def test_reuse_state_and_match_rules_match_reference():
    rst, pst, rng = _reuse_pair()
    for f in convert.REUSE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(rst, f)),
                                      getattr(pst, f).numpy(), err_msg=f)
    empty_r = rb.init_reuse_state(12, 4, 16, 8)
    empty_p = pb.init_reuse_state(12, 4, 16, 8, device="cpu")
    qs = rng.normal(size=(20, 16)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qs[:4] = np.asarray(rst.query_emb)[:4]            # exact repeats
    for q in qs:
        mh = rng.integers(0, 5, 8).astype(np.int32)
        for r_st, p_st in ((rst, pst), (empty_r, empty_p)):
            pairs = [
                (rb.proximity_match(r_st, jnp.asarray(q), jnp.float32(0.3)),
                 pb.proximity_match(p_st, q, 0.3)),
                (rb.saferadius_match(r_st, jnp.asarray(q), jnp.float32(2.0)),
                 pb.saferadius_match(p_st, q, 2.0)),
                (rb.mincache_match(r_st, jnp.asarray(q), jnp.asarray(mh),
                                   jnp.float32(0.3), jnp.float32(0.5)),
                 pb.mincache_match(p_st, q, mh, 0.3, 0.5))]
            for (ro, rh, rsc), (po, ph, psc) in pairs:
                assert bool(ro) == bool(po)
                assert int(rh) == int(ph) and ph.dtype == torch.int32
                np.testing.assert_allclose(float(rsc), float(psc),
                                           rtol=1e-6, atol=1e-6)


def test_minhash_and_crag_evaluator_match_reference():
    tokens = np.array([1000, 1007, 3, 42, 42], np.int64)
    np.testing.assert_array_equal(rb.minhash_signature(tokens),
                                  pb.minhash_signature(tokens))
    golden = np.array([True, False, False, True, False])
    for ood in (False, True):
        r, p = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(50):
            assert rb.CRAGEvaluator().evaluate(r, golden, ood) == \
                pb.CRAGEvaluator().evaluate(p, golden, ood)
    assert pb.CRAGEvaluator() == pb.CRAGEvaluator(0.5, 0.01, 0.8, 0.7)
