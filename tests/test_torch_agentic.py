"""Port parity of agentic multi-hop serving (``serving/agentic.py`` and the
scheduler's hop-graph branches).

The decomposition is host numpy in both packages: datasets, plans, their
per-(complex query, hop) substreams and the root sub-queries must be equal.
The sequential ``AutoRagPipeline`` is held on DAR and accuracy (its AvgL
carries measured wall-clock), and exactly on the always-full arm, whose
latency is modelled.  The scheduler's clock is modelled, so a scheduled
hop trace must be equal in every channel, span, ``t_done``, hop identity,
cancellation and complex-query record, with ``speculate_hops`` on and off
(the reference's index handed over).
"""
import numpy as np
import pytest

from _torch_sched_util import (assert_same_result, make_env, make_pair,
                               port_index)
from _torch_sched_util import one_torch_thread  # noqa: F401 (autouse)
from repro.core.has import HasConfig as RefCfg
from repro.serving import agentic as ref_ag
from repro.serving.engine import HasEngine as RefHas
from repro.serving.scheduler import poisson_arrivals
from repro_torch.core.has import HasConfig
from repro_torch.serving import agentic as pt_ag
from repro_torch.serving.engine import HasEngine

CFG = dict(k=10, tau=0.2, h_max=400, nprobe=4, n_buckets=256, d=64)


@pytest.fixture(scope="module")
def env():
    """The 400-entity world of ``benchmarks/sched_agentic.py``'s fixed
    fixture, in both packages, and both datasets over it."""
    e = make_env(n_entities=400, n_queries=160)
    e.ref_ds = ref_ag.TwoHopDataset(e.ref_service.world, seed=0)
    e.pt_ds = pt_ag.TwoHopDataset(e.pt_service.world, seed=0)
    ref, _ = make_pair(e, cfg_kw=CFG)
    e.index = ref.index
    return e


def _same_query(a: dict, b: dict):
    assert a.keys() == b.keys()
    for key in a:
        if key == "hop_plan":
            continue
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


def _same_plan(a, b):
    for f in ("entities", "rels", "attr", "hops", "uid", "seed", "tenant",
              "rel_attr"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("hops", [1, 2, 3])
def test_dataset_and_samples_equal_reference(env, hops):
    for r, p in zip(env.ref_ds.relations, env.pt_ds.relations):
        np.testing.assert_array_equal(r, p)
    assert env.ref_ds.rel_attr == env.pt_ds.rel_attr
    rs = env.ref_ds.sample(120, seed=2, hops=hops)
    ps = env.pt_ds.sample(120, seed=2, hops=hops)
    assert rs == ps
    with pytest.raises(ValueError):
        env.pt_ds.sample(2, hops=0)


def test_hop_trace_and_plan_draws_equal_reference(env):
    cqs = env.ref_ds.sample(60, seed=2, hops=3)
    tenants = [i % 3 for i in range(60)]
    rt = ref_ag.build_hop_trace(env.ref_ds, cqs, seed=4, tenants=tenants)
    pt = pt_ag.build_hop_trace(env.pt_ds, cqs, seed=4, tenants=tenants)
    assert len(rt) == len(pt) == 60
    for a, b in zip(rt, pt):
        _same_query(a, b)
        ra, pa = a["hop_plan"], b["hop_plan"]
        assert isinstance(pa, pt_ag.HopPlan)
        _same_plan(ra, pa)
        for h in (1, 2, 3):
            ids = np.arange(10 * h, 10 * h + 10)
            assert ra.hit(h, ids) == pa.hit(h, ids)
            assert ra.attr_of(h) == pa.attr_of(h)
            for hit in (False, True):
                if h < 3:                    # the last hop has no bridge
                    assert ra.bridge(h, hit) == pa.bridge(h, hit)
            _same_query(ra.query(h, 7 + h), pa.query(h, 7 + h))
        for dataset in ("granola", "popqa"):
            for ok in (False, True):
                assert ra.accuracy(ok, dataset) == pa.accuracy(ok, dataset)
    # the legacy 2-hop dict form decomposes identically
    legacy = [{"e1": 3, "rel": 1, "e2": 9, "attr2": 2}]
    _same_plan(ref_ag.decompose(env.ref_ds, legacy)[0],
               pt_ag.decompose(env.pt_ds, legacy)[0])
    with pytest.raises(ValueError, match="relations"):
        pt_ag.HopPlan(env.pt_service.world, [0], [1, 2], [], 0, uid=0)


def test_sequential_pipeline_matches_reference(env):
    cqs = env.ref_ds.sample(40, seed=2)
    rs, ps = env.ref_service, env.pt_service
    rf = ref_ag.AutoRagPipeline(env.ref_ds, None, rs).run(cqs)
    pf = pt_ag.AutoRagPipeline(env.pt_ds, None, ps).run(cqs)
    assert rf == pf                          # modelled latency: exact
    ref_eng = RefHas(rs, RefCfg(**CFG), backend="xla")
    pt_eng = HasEngine(ps, HasConfig(**CFG), backend="torch",
                       index=port_index(ref_eng.index))
    rh = ref_ag.AutoRagPipeline(env.ref_ds, ref_eng, rs).run(cqs)
    ph = pt_ag.AutoRagPipeline(env.pt_ds, pt_eng, ps).run(cqs)
    assert rh.keys() == ph.keys() == rf.keys()
    assert (rh["dar"], rh["accuracy"]) == (ph["dar"], ph["accuracy"])
    assert 0 < ph["dar"] < 1
    with pytest.raises(ValueError, match="arrivals"):
        pt_ag.AutoRagPipeline(env.pt_ds, None, ps).run(cqs, arrivals=[0.0])


def _same_hops(r, p):
    assert_same_result(r, p)
    for f in ("hop", "speculative"):
        np.testing.assert_array_equal(getattr(r, f), getattr(p, f),
                                      err_msg=f)
    assert len(r.complex_records) == len(p.complex_records)
    for a, b in zip(r.complex_records, p.complex_records):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]), err_msg=key)


@pytest.mark.parametrize("speculate,hops,qps", [(True, 2, 10.0),
                                                (False, 2, 10.0),
                                                (True, 3, 30.0)])
def test_scheduled_hop_trace_matches_reference(env, speculate, hops, qps):
    n = 48
    ref, pt = make_pair(env, dict(speculate_hops=speculate), cfg_kw=CFG,
                        ref_index=env.index)
    cqs = env.ref_ds.sample(n, seed=2, hops=hops)
    arr = poisson_arrivals(n, qps=qps, seed=5)
    r = ref_ag.AutoRagPipeline(env.ref_ds, ref, env.ref_service).run(
        cqs, arrivals=arr)
    p = pt_ag.AutoRagPipeline(env.pt_ds, pt, env.pt_service).run(
        cqs, arrivals=arr)
    _same_hops(r.pop("sched_result"), p.pop("sched_result"))
    np.testing.assert_equal(r, p)              # nan where nothing prespec'd
    res = pt.serve(pt_ag.build_hop_trace(env.pt_ds, cqs), arr, seed=0)
    s = res.summary()
    assert s["complex_n"] == n and res.trace.spans["reason"].sum() > 0
    np.testing.assert_allclose(res.trace.conservation_residual(), 0.0,
                               atol=1e-9)
    if speculate:
        assert s["hop_prespec_rate"] > 0
    else:
        assert s["cancelled"] == 0 and s["hop_prespec_rate"] == 0


def test_mixed_plain_and_hop_trace_matches_reference(env):
    """``serve --agentic-frac``'s shape: a seeded choice of arrival slots
    carries hop-1 sub-queries, the rest are plain queries."""
    queries = list(env.queries)
    cqs = env.ref_ds.sample(40, seed=4)
    slots = np.sort(np.random.default_rng(5).choice(len(queries), 40,
                                                    replace=False))
    rq, pq = list(queries), list(queries)
    for i, a, b in zip(slots, ref_ag.build_hop_trace(env.ref_ds, cqs),
                       pt_ag.build_hop_trace(env.pt_ds, cqs)):
        rq[int(i)], pq[int(i)] = a, b
    ref, pt = make_pair(env, cfg_kw=CFG, ref_index=env.index)
    arr = poisson_arrivals(len(queries), qps=30.0, seed=5)
    _same_hops(ref.serve(rq, arr, seed=3), pt.serve(pq, arr, seed=3))


def test_agentic_multihop_twin_matches_reference():
    """``examples/agentic_multihop_torch.py``'s ``run()`` at a small size
    (400 entities, 60 complex queries) with the reference's fuzzy index
    handed over: the always-full arm equal to the reference's example
    exactly, the HaS arm in DAR and accuracy."""
    import importlib.util
    from pathlib import Path

    from repro.data.synthetic import SyntheticWorld as RefWorld
    from repro.data.synthetic import WorldConfig as RefWorldCfg
    from repro.serving.engine import RetrievalService as RefService
    from repro.serving.latency import LatencyModel as RefLatency

    path = Path(__file__).resolve().parents[1] / "examples" \
        / "agentic_multihop_torch.py"
    spec = importlib.util.spec_from_file_location("agentic_multihop_torch",
                                                  path)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    world = RefWorld(RefWorldCfg(n_entities=400, seed=0))
    service = RefService(world, RefLatency(), k=10)
    ds = ref_ag.TwoHopDataset(world, seed=0)
    cqs = ds.sample(60, seed=2)
    base = ref_ag.AutoRagPipeline(ds, None, service).run(cqs)
    cfg = dict(twin.HAS_CFG, n_buckets=64)
    engine = RefHas(service, RefCfg(**cfg), backend="xla")
    plug = ref_ag.AutoRagPipeline(ds, engine, service).run(cqs)
    twin.HAS_CFG = cfg
    got = twin.run(60, device="cpu", n_entities=400,
                   index=port_index(engine.index))
    assert got["full"] == base
    assert (got["has"]["dar"], got["has"]["accuracy"]) == (plug["dar"],
                                                           plug["accuracy"])
    assert 0 < got["has"]["dar"] < 1
