"""Port parity of the micro-batched engine (``serving/batched.py``) and of
the quickstart twin (``examples/quickstart_torch.py``).

A small world is served by the reference's ``BatchedHasEngine`` (XLA
backend) and by the port's (``device="cpu"``), with the reference's IVF
index handed to the port, at ``batch_size`` 16 and 32 and with 1 and 3
tenants; 200 queries leave a tail batch in each case.  Per-query ids and
accept bits must be equal, and so must DAR, CAR, DocHit and RA and the
final rings.  AvgL is not compared: it includes measured wall-clock.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.core.has import HasConfig as RefCfg
from repro.data.synthetic import DATASETS
from repro.data.synthetic import SyntheticWorld as RefWorld
from repro.data.synthetic import WorldConfig as RefWorldCfg
from repro.serving.batched import BatchedHasEngine as RefBatched
from repro.serving.engine import FullRetrievalEngine as RefFull
from repro.serving.engine import HasEngine as RefHasEngine
from repro.serving.engine import RetrievalService as RefService
from repro.serving.latency import LatencyModel as RefLatency
from repro_torch import convert
from repro_torch.core.has import HasConfig as PtCfg
from repro_torch.data.synthetic import SyntheticWorld as PtWorld
from repro_torch.data.synthetic import WorldConfig as PtWorldCfg
from repro_torch.retrieval.service import RetrievalService as PtService
from repro_torch.serving.batched import BatchedHasEngine as PtBatched
from repro_torch.serving.latency import LatencyModel as PtLatency

ROOT = Path(__file__).resolve().parents[1]
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


def _record_batches(engine):
    """Wrap ``engine._step_batch`` to keep every (ids, accept) it serves."""
    log, step = [], engine._step_batch

    def rec(group, rng, dataset):
        out = step(group, rng, dataset)
        log.extend((np.asarray(ids), bool(acc)) for ids, acc, _ in out)
        return out

    engine._step_batch = rec
    return log


def _port_index(ref_index):
    return convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(ref_index, f)) for f in convert.IVF_FIELDS},
        device="cpu")


def _assert_results(ref, pt):
    np.testing.assert_array_equal(ref.accepts, pt.accepts)
    np.testing.assert_array_equal(ref.doc_hits, pt.doc_hits)
    np.testing.assert_array_equal(ref.correct_accepts, pt.correct_accepts)
    for llm in ref.ra:
        np.testing.assert_array_equal(ref.ra[llm], pt.ra[llm])
    rs, ps = ref.summary(), pt.summary()
    for m in METRICS:
        assert rs[m] == ps[m], m


@pytest.mark.parametrize("n_tenants", [1, 3])
@pytest.mark.parametrize("batch_size", [16, 32])
def test_batched_engine_matches_reference(setup, batch_size, n_tenants):
    queries, rs, ps = setup
    if n_tenants > 1:
        queries = [dict(q, tenant=int(q["entity"]) % n_tenants)
                   for q in queries]
    ref_eng = RefBatched(rs, RefCfg(**CFG), batch_size=batch_size,
                         backend="xla", n_tenants=n_tenants)
    pt_eng = PtBatched(ps, PtCfg(**CFG), batch_size=batch_size,
                       backend="torch", n_tenants=n_tenants,
                       index=_port_index(ref_eng.index))
    assert pt_eng.fuzzy_scope == ref_eng.fuzzy_scope
    ref_log, pt_log = _record_batches(ref_eng), _record_batches(pt_eng)
    ref = ref_eng.serve(queries)
    pt = pt_eng.serve(queries)
    assert len(pt.latencies) == 200 and np.isfinite(pt.latencies).all()
    _assert_results(ref, pt)
    assert 0.0 < pt.summary()["dar"] < 1.0      # both branches exercised
    for i, (r, p) in enumerate(zip(ref_log, pt_log)):
        np.testing.assert_array_equal(r[0], p[0], err_msg=f"ids of {i}")
        assert r[1] == p[1], f"accept of query {i}"
    ref_state = {f: np.asarray(getattr(ref_eng.state, f))
                 for f in convert.STATE_FIELDS}
    pt_state = convert.has_state_to_numpy(pt_eng.state)
    for f in ("query_doc_ids", "query_valid", "q_ptr", "doc_ids", "d_ptr"):
        np.testing.assert_array_equal(ref_state[f], pt_state[f], err_msg=f)


def test_batched_engine_rejects_bad_tenant_tags(setup):
    queries, rs, ps = setup
    eng = PtBatched(ps, PtCfg(**CFG), batch_size=8, backend="torch",
                    n_tenants=2)
    with pytest.raises(ValueError, match="out of range for n_tenants=2"):
        eng.serve([dict(queries[0], tenant=2)])


def _load_quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin_matches_reference():
    """The twin's two engines at a reduced size (600 entities, 300
    queries), the reference's fuzzy index handed over: DAR, CAR and DocHit
    (and the full engine's DocHit and RA) equal to the reference's
    quickstart steps on the same world."""
    qs_mod = _load_quickstart()
    n_entities, n_queries = 600, 300
    world = RefWorld(RefWorldCfg(n_entities=n_entities, seed=0))
    service = RefService(world, RefLatency(), k=10)
    queries = world.sample_queries(n_queries, **qs_mod.stream_kw(), seed=1)
    full = RefFull(service).serve(queries[:qs_mod.FULL_QUERIES]).summary()
    ref_has = RefHasEngine(service, RefCfg(**qs_mod.HAS_CFG), backend="xla")
    ref = ref_has.serve(queries).summary()
    got = qs_mod.run(n_queries, device="cpu", n_entities=n_entities,
                     index=_port_index(ref_has.index))
    for m in ("dar", "car", "doc_hit_rate"):
        assert got["has"][m] == ref[m], m
    for m in ("doc_hit_rate", "ra_qwen3-8b"):
        assert got["full"][m] == full[m], m
    assert 0.0 < got["has"]["dar"] < 1.0
