"""Port parity of the fault plans (``serving/faults.py``), the per-stage
tracing (``serving/tracing.py``), ``training/fault.py`` and the scheduler
under fault plans.

The copied host modules are held to the reference on the same inputs
(validation messages, parse results, injector windows, span breakdowns,
straggler deadlines).  The scheduler runs plans with every fault kind,
once against a three-worker cloud pool (``max_inflight_full=3``, so hedges
and retries rotate across workers) and once against the lone
``LocalFlatBackend`` worker; both must equal the reference exactly, keep
span conservation exact and fold no ingest twice.
"""
import numpy as np
import pytest

from _torch_sched_util import make_env, make_pair, serve_pair
from _torch_sched_util import one_torch_thread  # noqa: F401 (autouse)
from repro.serving import faults as rf
from repro.serving import tracing as rt
from repro.serving.scheduler import poisson_arrivals
from repro.training import fault as rfault
from repro_torch.serving import faults as pf
from repro_torch.serving import tracing as pt
from repro_torch.training import fault as pfault

BAD_EVENTS = [
    dict(t=1.0, kind="meteor"),
    dict(t=-1.0, kind="worker_crash"),
    dict(t=0.0, kind="worker_crash", target=-1),
    dict(t=0.0, kind="straggler"),
    dict(t=0.0, kind="straggler", duration_s=1.0, factor=1.0),
    dict(t=0.0, kind="search_fail"),
    dict(t=0.0, kind="worker_crash", down_s=-1.0),
    dict(t=0.0, kind="delta_drop", count=0),
    dict(t=0.0, kind="delta_dup", count=-2),
]
BAD_SPECS = ["worker_crash", "worker_crash@soon", "worker_crash@1,fuzz=3",
             "delta_drop@1,count=many", "meteor@1", "straggler@1,factor=x"]


def _message(fn, exc):
    with pytest.raises(exc) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("ev", BAD_EVENTS,
                         ids=[f"{i}-{e['kind']}"
                              for i, e in enumerate(BAD_EVENTS)])
def test_fault_plan_validation_matches_reference(ev):
    got = _message(lambda: pf.FaultPlan((pf.FaultEvent(**ev),)), ValueError)
    want = _message(lambda: rf.FaultPlan((rf.FaultEvent(**ev),)), ValueError)
    assert got == want
    assert _message(lambda: pf.FaultPlan(("x",)), TypeError) == \
        _message(lambda: rf.FaultPlan(("x",)), TypeError)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_fault_plan_parse_errors_match_reference(spec):
    assert _message(lambda: pf.FaultPlan.parse(spec), ValueError) == \
        _message(lambda: rf.FaultPlan.parse(spec), ValueError)


def test_fault_plan_parse_and_order_match_reference():
    spec = ("worker_crash@2.0,target=1,down=3.0;"
            "straggler@1.0,duration=5,factor=4;delta_drop@0.5,count=3;"
            "search_fail@1.0,target=2,duration_s=0.5;replica_crash@0.7;"
            "delta_dup@0.5,count=2")
    a, b = pf.FaultPlan.parse(spec), rf.FaultPlan.parse(spec)
    assert pf.KINDS == rf.KINDS
    for x, y in ((a.events, b.events), (a.sorted_events(),
                                        b.sorted_events())):
        assert [vars(e) for e in x] == [vars(e) for e in y]
    assert len(pf.FaultPlan.parse(" ; ")) == 0


def test_injector_matches_reference():
    events = [dict(t=1.0, kind="straggler", target=0, duration_s=2.0,
                   factor=3.0),
              dict(t=2.0, kind="straggler", target=0, duration_s=2.0,
                   factor=2.0),
              dict(t=1.0, kind="search_fail", target=1, duration_s=1.5),
              dict(t=0.0, kind="delta_drop", count=2),
              dict(t=0.0, kind="delta_dup", count=1),
              dict(t=0.0, kind="worker_crash")]
    a, b = pf.FaultInjector(pf.FaultPlan()), rf.FaultInjector(rf.FaultPlan())
    for e in events:
        a.activate(pf.FaultEvent(**e))
        b.activate(rf.FaultEvent(**e))
    for w in (0, 1, 2):
        for t in np.linspace(0.0, 5.0, 21):
            assert a.latency_multiplier(w, t) == b.latency_multiplier(w, t)
            assert a.search_fails(w, t) == b.search_fails(w, t)
    assert [a.delta_fault() for _ in range(5)] == \
        [b.delta_fault() for _ in range(5)]
    assert (a.dropped_appends, a.duplicated_appends) == \
        (b.dropped_appends, b.duplicated_appends) == (2, 1)


def _trace_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    t_arrive = np.sort(rng.uniform(0.0, 4.0, n))
    spans = {s: rng.uniform(0.0, 0.3, n) * (rng.random(n) < 0.7)
             for s in rt.STAGES}
    t_done = t_arrive + np.sum([spans[s] for s in rt.STAGES], axis=0)
    channels = rng.choice(["draft", "reval", "shared", "full"], n)
    return t_arrive, t_done, channels, spans


@pytest.mark.parametrize("n", [0, 1, 50])
def test_trace_matches_reference(n):
    assert pt.STAGES == rt.STAGES
    t_arrive, t_done, channels, spans = _trace_inputs(n)

    class Req:                       # build_trace reads .spans only
        def __init__(self, i):
            self.spans = {s: spans[s][i] for s in rt.STAGES}

    reqs = [Req(i) for i in range(n)]
    a = pt.build_trace(reqs, t_arrive, t_done, channels)
    b = rt.build_trace(reqs, t_arrive, t_done, channels)
    assert a.n == b.n == n
    np.testing.assert_array_equal(a.total(), b.total())
    np.testing.assert_array_equal(a.conservation_residual(),
                                  b.conservation_residual())
    for sel in (None, ("draft",), ("shared", "full"), ("nothing",)):
        x, y = a.stage_breakdown(sel), b.stage_breakdown(sel)
        for s in rt.STAGES:
            for k in ("total_s", "mean_s", "frac"):
                assert x[s][k] == y[s][k] or (np.isnan(x[s][k])
                                              and np.isnan(y[s][k]))
    for bucket in (0.25, 1.0):
        x, y = a.timeline(bucket), b.timeline(bucket)
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    with pytest.raises(ValueError, match="bucket_s must be > 0"):
        a.timeline(0.0)
    assert pt.empty_spans() == rt.empty_spans()


def test_straggler_detector_and_elastic_plan_match_reference():
    rng = np.random.default_rng(4)
    steps = rng.lognormal(0.0, 0.4, 300)
    steps[rng.choice(300, 12, replace=False)] *= 8.0
    for cfg in (dict(), dict(window=7, deadline_factor=2.0, min_samples=3)):
        a = pfault.StragglerDetector(pfault.StragglerConfig(**cfg))
        b = rfault.StragglerDetector(rfault.StragglerConfig(**cfg))
        assert a.deadline is None
        for i, x in enumerate(steps):
            assert a.observe(i, x) == b.observe(i, x)
            assert a.deadline == b.deadline
        assert a.flagged == b.flagged and len(a.flagged) > 0
    for args in ((16, 12), (16, 7, 2, 3), (4, 0), (8, 16)):
        assert vars(pfault.ElasticPlan.plan(*args)) == \
            vars(rfault.ElasticPlan.plan(*args))


def test_run_with_retries_matches_reference():
    for mod in (pfault, rfault):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("device lost")
            return "ok"

        assert mod.run_with_retries(flaky, max_retries=2) == ("ok", 2)
        with pytest.raises(RuntimeError, match="failed after 2 attempts"):
            mod.run_with_retries(lambda: 1 / 0, max_retries=1, step_id=5)


# ---------------------------------------------------------------------------
# The scheduler under fault plans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    e = make_env(n_entities=400, n_queries=160)
    ref, _ = make_pair(e, cfg_kw=dict(h_max=400))
    e.index = ref.index
    return e


#: every fault kind at once, against a three-worker pool
POOL_PLAN = [
    dict(t=0.3, kind="straggler", target=1, duration_s=2.0, factor=6.0),
    dict(t=0.5, kind="worker_crash", target=0, down_s=1.0),
    dict(t=0.8, kind="search_fail", target=2, duration_s=1.0),
    dict(t=1.0, kind="replica_crash", target=1),
    dict(t=0.6, kind="delta_drop", count=2),
    dict(t=1.2, kind="delta_dup", count=2),
]
#: every fault kind at once, the cloud events on the lone worker
LONE_PLAN = [
    dict(t=0.3, kind="straggler", target=0, duration_s=1.0, factor=6.0),
    dict(t=0.9, kind="worker_crash", target=0, down_s=0.5),
    dict(t=1.6, kind="search_fail", target=0, duration_s=0.4),
    dict(t=1.0, kind="replica_crash", target=1),
    dict(t=0.6, kind="delta_drop", count=2),
    dict(t=1.2, kind="delta_dup", count=2),
]
CHAOS = {"pool": (dict(max_inflight_full=3), POOL_PLAN),
         "lone_worker": (dict(), LONE_PLAN)}


@pytest.mark.filterwarnings("ignore:SchedulerConfig.max_inflight_full")
@pytest.mark.parametrize("case", list(CHAOS))
def test_chaos_run_matches_reference(env, case):
    kw, plan = CHAOS[case]
    kw = dict(kw, edge_replicas=3, retry_max=3)
    arr = poisson_arrivals(len(env.queries), qps=40.0, seed=5)
    ref, pt_ = make_pair(env, kw, cfg_kw=dict(h_max=400), plan=plan,
                         ref_index=env.index)
    r, p = serve_pair(ref, pt_, env.queries, arr, seed=3)
    s = p.summary()
    assert s["worker_deaths"] == 1 and s["replica_rebuilds"] >= 1
    assert s["retries"] >= 1
    if case == "pool":
        assert s["hedges"] >= 1
    np.testing.assert_allclose(p.trace.conservation_residual(), 0.0,
                               atol=1e-9)
    for st in pt.STAGES:
        assert p.trace.spans[st].min() >= 0.0, st
    assert p.trace.spans["lost"].sum() > 0
    # the duplicated appends folded once: the replicas the pool rebuilt or
    # replayed hold no row twice beyond the primary's own ring
    for rep in pt_.edge_pool.states:
        assert int(rep.q_ptr) <= int(pt_.state.q_ptr)


def test_dup_only_plan_equals_fault_free(env):
    """Duplicated replication appends are absorbed by the ingest keys: a
    dup-only run IS the fault-free run, and equals the reference's."""
    kw = dict(edge_replicas=3)
    arr = poisson_arrivals(len(env.queries), qps=40.0, seed=5)
    ref, pt_ = make_pair(env, kw, cfg_kw=dict(h_max=400),
                         plan=[dict(t=0.2, kind="delta_dup", count=3)],
                         ref_index=env.index)
    _, p_dup = serve_pair(ref, pt_, env.queries, arr, seed=3)
    _, free = make_pair(env, kw, cfg_kw=dict(h_max=400), ref_index=env.index)
    p_free = free.serve(env.queries, arr, seed=3)
    np.testing.assert_array_equal(p_dup.t_done, p_free.t_done)
    np.testing.assert_array_equal(p_dup.served_ids, p_free.served_ids)
    np.testing.assert_array_equal(p_dup.channels, p_free.channels)
