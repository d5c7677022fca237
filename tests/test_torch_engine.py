"""Port parity of the sequential engines (Algorithm 1 end to end).

A small world is served by the reference's ``FullRetrievalEngine`` and
``HasEngine`` (XLA backend) and by the port's (``device="cpu"``), with the
reference's IVF index handed to the port.  Per-query ids, accept bits and
homology must agree, and so must DAR, CAR, DocHit and RA.  AvgL is not
compared: it includes measured wall-clock.
"""
import numpy as np
import pytest

from repro.core.has import HasConfig as RefCfg
from repro.data.synthetic import DATASETS
from repro.retrieval.ivf import subset_index as RefSubset
from repro.data.synthetic import SyntheticWorld as RefWorld
from repro.data.synthetic import WorldConfig as RefWorldCfg
from repro.serving.engine import FullRetrievalEngine as RefFull
from repro.serving.engine import HasEngine as RefHas
from repro.serving.engine import RetrievalService as RefService
from repro.serving.latency import LatencyModel as RefLatency
from repro_torch import convert
from repro_torch.core.has import HasConfig as PtCfg
from repro_torch.data.synthetic import SyntheticWorld as PtWorld
from repro_torch.data.synthetic import WorldConfig as PtWorldCfg
from repro_torch.retrieval.service import FullRetrievalBackend
from repro_torch.retrieval.service import RetrievalService as PtService
from repro_torch.serving.engine import FullRetrievalEngine as PtFull
from repro_torch.serving.engine import HasEngine as PtHas
from repro_torch.serving.latency import LatencyModel as PtLatency

WORLD = dict(n_entities=300, d=32, seed=0)
CFG = dict(k=10, tau=0.2, h_max=64, nprobe=4, n_buckets=32, d=32)
METRICS = ("dar", "car", "doc_hit_rate", "ra_qwen3-8b", "ra_llama3-8b",
           "ra_mixtral-7b", "ra_at_da")


@pytest.fixture(scope="module")
def setup():
    rw, pw = RefWorld(RefWorldCfg(**WORLD)), PtWorld(PtWorldCfg(**WORLD))
    ds = DATASETS["granola"]
    queries = rw.sample_queries(200, pattern=ds["pattern"],
                                zipf_a=ds["zipf_a"],
                                p_uncovered=ds["p_uncovered"], seed=1)
    rs = RefService(rw, RefLatency(), k=10)
    ps = PtService(pw, PtLatency(), k=10, device="cpu")
    return queries, rs, ps


def _recording(engine):
    """Wrap ``engine.step`` to keep every returned tuple."""
    log, step = [], engine.step

    def rec(*a, **kw):
        out = step(*a, **kw)
        log.append(out)
        return out

    engine.step = rec
    return log


def _assert_results(ref, pt):
    np.testing.assert_array_equal(ref.accepts, pt.accepts)
    np.testing.assert_array_equal(ref.doc_hits, pt.doc_hits)
    np.testing.assert_array_equal(ref.correct_accepts, pt.correct_accepts)
    for llm in ref.ra:
        np.testing.assert_array_equal(ref.ra[llm], pt.ra[llm])
    rs, ps = ref.summary(), pt.summary()
    for m in METRICS:
        assert rs[m] == ps[m], m


def test_full_retrieval_engine_matches_reference(setup):
    queries, rs, ps = setup
    ref = RefFull(rs).serve(queries[:60])
    pt = PtFull(ps).serve(queries[:60])
    _assert_results(ref, pt)
    for q in queries[:10]:
        ri, rv, _ = rs.full_search(q["emb"])
        pi, pv, _ = ps.full_search(q["emb"])
        np.testing.assert_array_equal(ri, pi)
        np.testing.assert_array_equal(rv, pv.numpy())


@pytest.mark.parametrize("fusion,fraction", [("score", 1.0), ("rrf", 1.0),
                                             ("score", 0.5)])
def test_has_engine_matches_reference(setup, fusion, fraction):
    queries, rs, ps = setup
    ref_eng = RefHas(rs, RefCfg(**CFG, fusion=fusion), backend="xla")
    # the reference's full index goes across; each engine cuts it itself
    index = convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(ref_eng.index, f))
         for f in convert.IVF_FIELDS}, device="cpu")
    ref_eng.index = RefSubset(ref_eng.index, fraction)
    pt_eng = PtHas(ps, PtCfg(**CFG, fusion=fusion), backend="torch",
                   index=index, fuzzy_fraction=fraction)
    assert pt_eng.index.capacity == ref_eng.index.capacity
    ref_log, pt_log = _recording(ref_eng), _recording(pt_eng)
    ref = ref_eng.serve(queries)
    pt = pt_eng.serve(queries)
    _assert_results(ref, pt)
    assert 0.0 < pt.summary()["dar"] < 1.0      # both branches exercised
    for i, (r, p) in enumerate(zip(ref_log, pt_log)):
        np.testing.assert_array_equal(np.asarray(r[0]), np.asarray(p[0]),
                                      err_msg=f"ids of query {i}")
        assert r[1] == p[1], f"accept of query {i}"
        np.testing.assert_allclose(r[3], p[3], rtol=1e-5, atol=1e-5)
    ref_state = {f: np.asarray(getattr(ref_eng.state, f))
                 for f in convert.STATE_FIELDS}
    pt_state = convert.has_state_to_numpy(pt_eng.state)
    for f in ("query_doc_ids", "query_valid", "q_ptr", "doc_ids", "d_ptr"):
        np.testing.assert_array_equal(ref_state[f], pt_state[f], err_msg=f)


def test_service_batch_search_calibration_and_injected_backend(setup):
    queries, rs, ps = setup
    embs = np.stack([q["emb"] for q in queries[:8]])
    ri, _ = rs.full_search_batch(embs)
    pi, t = ps.full_search_batch(embs)
    np.testing.assert_array_equal(ri, pi)
    assert t == ps.latency.full_scan_time()
    world = ps.world
    lat = PtLatency()
    PtService(world, lat, k=10, calibrate=True, device="cpu")
    assert lat.bandwidth != PtLatency().bandwidth and lat.bandwidth > 0
    # an injected backend is used as given, its corpus shared
    backend = ps.backend
    svc = PtService(world, PtLatency(), k=10, backend=backend, device="cpu")
    assert svc.backend is backend and svc.corpus is backend.corpus
    assert isinstance(backend, FullRetrievalBackend)


# -- HasEngine's parameters follow the reference's, in its order -----------

def _port_engine(ps, *args, **kw):
    return PtHas(ps, PtCfg(**CFG), *args, backend="torch", **kw)


def test_has_engine_step_tenant_zero_is_the_default(setup):
    """``step(q, 0)`` (the reference's positional tenant) serves exactly
    what ``step(q)`` does; a tag of 1 raises as the reference's ``_tids``
    does with one tenant."""
    queries, _, ps = setup
    a, b = _port_engine(ps), _port_engine(ps)
    for q in queries[:40]:
        ra, rb = a.step(q["emb"]), b.step(q["emb"], 0)
        np.testing.assert_array_equal(np.asarray(ra[0]), np.asarray(rb[0]))
        assert ra[1] == rb[1] and ra[3] == rb[3]
    with pytest.raises(ValueError, match="tenant 1 out of range"):
        a.step(queries[0]["emb"], 1)


def test_has_engine_serve_routes_the_tenant_key(setup):
    queries, _, ps = setup
    eng = _port_engine(ps)
    tagged = [dict(q, tenant=0) for q in queries[:20]]
    got = eng.serve(tagged)
    want = _port_engine(ps).serve(queries[:20])
    np.testing.assert_array_equal(got.accepts, want.accepts)
    np.testing.assert_array_equal(got.doc_hits, want.doc_hits)
    with pytest.raises(ValueError, match="tenant 1 out of range"):
        eng.serve([dict(queries[0], tenant=1)])


def test_has_engine_third_positional_is_fallback(setup):
    _, _, ps = setup
    eng = PtHas(ps, PtCfg(**CFG), None)
    assert eng.fallback is None and eng.n_tenants == 1
    assert eng.fuzzy_scope == CFG["nprobe"] / CFG["n_buckets"]


@pytest.mark.parametrize("kw", [dict(fallback="anns"),
                                dict(n_tenants=2)])
def test_has_engine_unported_options_raise(setup, kw):
    """The two options that raised before their slice was ported now
    build the engine: an ANNS fallback is kept, two tenants stack the
    cache (neither raises NotImplementedError any more)."""
    _, _, ps = setup
    from repro_torch.core.has import tenant_count
    from repro_torch.serving.engine import ANNSEngine
    if kw.get("fallback") == "anns":
        kw = dict(fallback=ANNSEngine(ps, n_buckets=32, nprobe=4))
    eng = _port_engine(ps, **kw)
    assert eng.fallback is kw.get("fallback")
    assert tenant_count(eng.state) == kw.get("n_tenants", 1)


def test_has_engine_reference_style_call_matches_reference(setup):
    """``HasEngine(service, cfg).step(q, 0, terms, weights)``, written as a
    reference caller writes it, serves the reference's ids and accept bits
    (the reference's index handed across)."""
    queries, rs, ps = setup
    ref_eng = RefHas(rs, RefCfg(**CFG), None, 1.0, 0, "xla")
    index = convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(ref_eng.index, f))
         for f in convert.IVF_FIELDS}, device="cpu")
    pt_eng = PtHas(ps, PtCfg(**CFG), None, 1.0, 0, "torch", index=index)
    accepts = []
    for i, q in enumerate(queries[:80]):
        r = ref_eng.step(q["emb"], 0, q["terms"], q["term_weights"])
        p = pt_eng.step(q["emb"], 0, q["terms"], q["term_weights"])
        np.testing.assert_array_equal(np.asarray(r[0]), np.asarray(p[0]),
                                      err_msg=f"ids of query {i}")
        assert r[1] == p[1], f"accept of query {i}"
        accepts.append(p[1])
    assert any(accepts) and not all(accepts)    # both branches exercised
