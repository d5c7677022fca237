"""Port parity of the continuous-batching scheduler (``serving/scheduler.py``).

The reference's scheduler (XLA on the CPU) and the port's (``device="cpu"``,
the reference's IVF index handed across) serve the same stream under the
same config; channels, accepts, served ids, ``leader_idx``, every request's
spans and ``t_done``, the counters, ``summary()``, ``per_tenant()`` and the
final rings must be EXACTLY equal (the clock is modelled: equal ids and
accept bits leave nothing to differ).  Also: the reference's ``ValueError``s
for bad configs, a stream that carries ``hop_plan`` queries (agentic
hop graphs), and the async serving twin over both cloud backends.

The reference's own ``test_scheduler.py::test_dar_parity_vs_batched`` is a
property of the reference that does not hold there; the port is held to the
reference's numbers, not to that property.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_sched_util import (BASE, CFG, assert_same_result, make_env,
                               make_pair, plans, port_index, serve_pair)
from _torch_sched_util import one_torch_thread  # noqa: F401 (autouse)
from repro.serving.scheduler import poisson_arrivals
from repro_torch.core.has import HasConfig
from repro_torch.serving import scheduler as pt_sched_mod


@pytest.fixture(scope="module")
def env():
    e = make_env(n_entities=600, n_queries=400)
    ref, _ = make_pair(e)
    e.index = ref.index                  # one k-means build for the module
    return e


CASES = {
    "saturated": (dict(), None),
    "poisson": (dict(), 20.0),
    "share_off": (dict(share=False), None),
    "revalidate_off": (dict(revalidate=False), None),
    "ingest_followers_off": (dict(ingest_followers=False), None),
    "follower_score_weighted_off": (dict(follower_score_weighted=False),
                                    None),
    "free_ingest_replay": (dict(free_ingest_replay=True,
                                follower_score_weighted=False), 30.0),
    "trace_off": (dict(trace=False), 30.0),
    "overload_shed": (dict(slo_deadline_s=3.0, overload_policy="shed"),
                      400.0),
    "overload_degrade": (dict(slo_deadline_s=3.0,
                              overload_policy="degrade"), 400.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_matches_reference(env, case):
    kw, qps = CASES[case]
    ref, pt = make_pair(env, kw, ref_index=env.index)
    n = len(env.queries)
    arr = None if qps is None else poisson_arrivals(n, qps=qps, seed=7)
    r, p = serve_pair(ref, pt, env.queries, arr, seed=3)
    s = p.summary()
    assert 0.0 < s["dar"] < 1.0
    if case == "saturated":
        assert s["shared_accepts"] > 0 and s["reval_accepts"] > 0
    if case.startswith("overload"):
        assert s["shed" if case.endswith("shed") else "degraded"] > 0
    if p.trace is not None:
        np.testing.assert_allclose(p.trace.conservation_residual(), 0.0,
                                   atol=1e-9)


def test_tenants_with_weights_and_quota_match_reference(env):
    """T = 3, weighted-fair admission (1, 2, 1) and a per-batch quota of
    6; tenants by entity, passed as ``tenant_ids``; Poisson arrivals."""
    kw = dict(n_tenants=3, tenant_weights=(1.0, 2.0, 1.0), tenant_quota=6)
    ref, pt = make_pair(env, kw, ref_index=env.index)
    tids = np.array([q["entity"] % 3 for q in env.queries], np.int32)
    arr = poisson_arrivals(len(env.queries), qps=40.0, seed=7)
    r, p = serve_pair(ref, pt, env.queries, arr, seed=0, tenant_ids=tids)
    per = p.per_tenant()
    assert sorted(per) == [0, 1, 2]
    sh = np.flatnonzero(p.channels == "shared")
    assert (p.tenant_ids[p.leader_idx[sh]] == p.tenant_ids[sh]).all()
    # the "tenant" key of a query is read when tenant_ids is not given
    tagged = [dict(q, tenant=int(t)) for q, t in zip(env.queries, tids)]
    serve_pair(ref, pt, tagged[:120], None, seed=1)


def test_empty_stream_matches_reference(env):
    ref, pt = make_pair(env, ref_index=env.index)
    r, p = serve_pair(ref, pt, [], None)
    assert p.trace.n == 0 and p.summary()["throughput_qps"] == 0.0


BAD = [
    dict(max_spec_batch=0),
    dict(full_batch=0),
    dict(full_max_wait_s=-0.1),
    dict(ingest_batch=0),
    dict(overload_policy="panic", slo_deadline_s=1.0),
    dict(overload_policy="shed"),
    dict(slo_deadline_s=0.0),
    dict(slo_deadline_s=1.0, overload_policy="shed", overload_exit_frac=0.0),
    dict(retry_max=-1),
    dict(retry_backoff_s=-1.0),
    dict(hedge_after=1.0),
    dict(n_tenants=2, tenant_weights=(1.0,)),
    dict(n_tenants=2, tenant_weights=(1.0, 0.0)),
    dict(tenant_quota=0),
    dict(edge_replicas=0),
    dict(edge_sync_every=0),
]
BAD_PLANS = [
    (dict(), [dict(t=1.0, kind="worker_crash", target=1, down_s=1.0)]),
    (dict(), [dict(t=1.0, kind="worker_crash", target=0)]),
    (dict(), [dict(t=1.0, kind="replica_crash", target=0)]),
    (dict(edge_replicas=2), [dict(t=1.0, kind="replica_crash", target=2)]),
    (dict(), [dict(t=1.0, kind="delta_dup")]),
    (dict(edge_replicas=2, free_ingest_replay=True),
     [dict(t=1.0, kind="delta_drop")]),
]


def _raises_same(build_ref, build_pt, exc):
    with pytest.raises(exc) as want:
        build_ref()
    with pytest.raises(exc) as got:
        build_pt()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bad", BAD + BAD_PLANS,
                         ids=[f"cfg{i}" for i in range(len(BAD))]
                         + [f"plan{i}" for i in range(len(BAD_PLANS))])
def test_bad_configs_raise_the_reference_errors(env, bad):
    kw, plan = (bad, None) if isinstance(bad, dict) else bad
    _raises_same(lambda: make_pair(env, kw, plan=plan, ref_index=env.index),
                 lambda: _port_only(env, kw, plan), ValueError)


def _port_only(env, kw, plan):
    return pt_sched_mod.ContinuousBatchingScheduler(
        env.pt_service, HasConfig(**CFG),
        pt_sched_mod.SchedulerConfig(**dict(BASE, **kw),
                                     fault_plan=plans(plan)[1]),
        index=port_index(env.index))


def test_fault_plan_type_and_serve_errors_match_reference(env):
    from repro.serving import scheduler as ref_sched_mod
    _raises_same(
        lambda: ref_sched_mod.ContinuousBatchingScheduler(
            env.ref_service, None,
            ref_sched_mod.SchedulerConfig(fault_plan="crash@1"),
            index=env.index),
        lambda: pt_sched_mod.ContinuousBatchingScheduler(
            env.pt_service, None,
            pt_sched_mod.SchedulerConfig(fault_plan="crash@1")),
        TypeError)
    ref, pt = make_pair(env, dict(n_tenants=2), ref_index=env.index)
    bad = np.array([0, 2] + [0] * 8, np.int32)
    _raises_same(lambda: ref.serve(env.queries[:10], tenant_ids=bad),
                 lambda: pt.serve(env.queries[:10], tenant_ids=bad),
                 ValueError)


@pytest.mark.parametrize("speculate", [True, False])
def test_hop_plan_stream_matches_reference(env, speculate):
    """A stream whose every fourth query is the hop-1 sub-query of a
    two-hop chain (``serving/agentic.py``): equal to the reference's in
    channels, spans, ``t_done``, hop identity and complex records."""
    from repro.serving import agentic as ref_ag
    from repro_torch.serving import agentic as pt_ag
    ref, pt = make_pair(env, dict(speculate_hops=speculate),
                        ref_index=env.index)
    cqs = ref_ag.TwoHopDataset(env.ref_service.world, seed=0).sample(
        50, seed=2)
    rq, pq = list(env.queries[:200]), list(env.queries[:200])
    hops = zip(ref_ag.build_hop_trace(
        ref_ag.TwoHopDataset(env.ref_service.world, seed=0), cqs),
        pt_ag.build_hop_trace(
            pt_ag.TwoHopDataset(env.pt_service.world, seed=0), cqs))
    for i, (a, b) in zip(range(0, 200, 4), hops):
        rq[i], pq[i] = a, b
    arr = poisson_arrivals(200, qps=20.0, seed=7)
    r, p = serve_pair(ref, pt, rq, arr, seed=3)
    for f in ("hop", "speculative"):
        np.testing.assert_array_equal(getattr(r, f), getattr(p, f))
    np.testing.assert_equal(r.complex_records, p.complex_records)
    assert p.summary()["complex_n"] == 50
    assert p.trace.spans["reason"].sum() > 0


def test_max_inflight_full_is_deprecated_and_sizes_the_pool(env):
    with pytest.warns(DeprecationWarning, match="max_inflight_full"):
        ref, pt = make_pair(env, dict(max_inflight_full=3),
                            ref_index=env.index)
    assert pt.n_full_workers == ref.n_full_workers == 3
    arr = poisson_arrivals(200, qps=60.0, seed=7)
    r, p = serve_pair(ref, pt, env.queries[:200], arr, seed=3)
    assert p.max_inflight_full_batches > 1


def test_async_serving_twin_matches_reference():
    """``examples/async_serving_torch.py``'s ``run()`` at a small size
    (600 entities, 200 requests), the reference's fuzzy index handed over:
    the scheduler's result equal to the reference scheduler's under the
    example's own config and stream."""
    from repro.core.has import HasConfig as RefCfg
    from repro.data.synthetic import DATASETS
    from repro.data.synthetic import SyntheticWorld as RefWorld
    from repro.data.synthetic import WorldConfig as RefWorldCfg
    from repro.serving import scheduler as ref_sched_mod
    from repro.serving.engine import RetrievalService as RefService
    from repro.serving.latency import LatencyModel as RefLatency

    path = Path(__file__).resolve().parents[1] / "examples" \
        / "async_serving_torch.py"
    spec = importlib.util.spec_from_file_location("async_serving_torch", path)
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    n, qps, n_entities = 200, 25.0, 600
    world = RefWorld(RefWorldCfg(n_entities=n_entities, seed=0))
    ds = DATASETS["granola"]
    queries = world.sample_queries(n, pattern=ds["pattern"],
                                   zipf_a=ds["zipf_a"],
                                   p_uncovered=ds["p_uncovered"], seed=1)
    ref = ref_sched_mod.ContinuousBatchingScheduler(
        RefService(world, RefLatency(), k=10), RefCfg(**twin.HAS_CFG),
        ref_sched_mod.SchedulerConfig(**twin.SCHED_CFG))
    want = ref.serve(queries, poisson_arrivals(n, qps=qps, seed=7), seed=0)
    got = twin.run(n, qps, device="cpu", n_entities=n_entities,
                   index=port_index(ref.index))
    assert_same_result(want, got["sched"])
    assert got["n_full_workers"] == 1 and 0 < got["seq"]["dar"] < 1
    # the sharded backend: 4 row shards, 4 workers, as the reference's
    # example builds it
    from repro.retrieval.service import ShardedMeshBackend as RefSharded
    lat = RefLatency()
    ref = ref_sched_mod.ContinuousBatchingScheduler(
        RefService(world, lat, k=10, backend=RefSharded(
            jnp.asarray(world.doc_emb), 10, lat, n_shards=4, n_workers=4)),
        RefCfg(**twin.HAS_CFG),
        ref_sched_mod.SchedulerConfig(**twin.SCHED_CFG))
    want = ref.serve(queries, poisson_arrivals(n, qps=qps, seed=7), seed=0)
    got = twin.run(n, qps, "sharded", device="cpu", n_entities=n_entities,
                   index=port_index(ref.index))
    assert_same_result(want, got["sched"])
    assert got["n_full_workers"] == 4
    assert got["summary"]["max_inflight_full_batches"] > 1
    with pytest.raises(SystemExit, match="unknown backend"):
        twin.run(n, qps, "mesh", device="cpu")
