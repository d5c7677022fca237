"""Shared setup of the scheduler-slice parity tests (``test_torch_*``).

One small world is built by both packages (the reference and the port
draw the same numpy data), served by the reference's scheduler on its XLA
path and by the port's with ``device="cpu"``, with the reference's IVF
index handed to the port.  :func:`assert_same_result` holds the two
``SchedResult``s to exact equality: the virtual clock is modelled, so with
equal accept bits and ids every time, span and summary must be equal too.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.has import HasConfig as RefCfg
from repro.data.synthetic import DATASETS
from repro.data.synthetic import SyntheticWorld as RefWorld
from repro.data.synthetic import WorldConfig as RefWorldCfg
from repro.serving import faults as ref_faults
from repro.serving.engine import RetrievalService as RefService
from repro.serving.latency import LatencyModel as RefLatency
from repro.serving.scheduler import ContinuousBatchingScheduler as RefSched
from repro.serving.scheduler import SchedulerConfig as RefSchedCfg
from repro.serving.tracing import STAGES
from repro_torch import convert
from repro_torch.core.has import HasConfig as PtCfg
from repro_torch.data.synthetic import SyntheticWorld as PtWorld
from repro_torch.data.synthetic import WorldConfig as PtWorldCfg
from repro_torch.retrieval.service import RetrievalService as PtService
from repro_torch.serving import faults as pt_faults
from repro_torch.serving.latency import LatencyModel as PtLatency
from repro_torch.serving.scheduler import ContinuousBatchingScheduler as PtSched
from repro_torch.serving.scheduler import SchedulerConfig as PtSchedCfg

#: the reference's scheduler-test sizes (tests/test_scheduler.py:22-31)
CFG = dict(k=10, tau=0.2, h_max=600, nprobe=4, n_buckets=256, d=64)
BASE = dict(max_spec_batch=16, full_batch=8, full_max_wait_s=0.1)
RESULT_ARRAYS = ("t_arrive", "t_done", "cloud_s", "channels", "latencies",
                 "accepts", "doc_hits", "correct_accepts", "tenant_ids",
                 "leader_idx", "served_ids", "replica_ids",
                 "cache_versions")
RESULT_COUNTS = ("full_retrievals", "spec_batches", "full_batches",
                 "max_inflight_full_batches", "max_inflight_spec_batches",
                 "edge_replays", "retries", "hedges", "worker_deaths",
                 "replica_rebuilds")
STATE_FIELDS = ("query_emb", "query_doc_ids", "query_valid", "q_ptr",
                "doc_emb", "doc_ids", "d_ptr")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain path at these sizes is thousands of small ops;
    with torch's intra-op pool at its default width, parallel test workers
    spin against each other (5-6x slower).  One thread for the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass
class Env:
    ref_service: RefService
    pt_service: PtService
    queries: list


def make_env(n_entities: int = 600, n_queries: int = 400) -> Env:
    world = dict(n_entities=n_entities, seed=0)
    rw, pw = RefWorld(RefWorldCfg(**world)), PtWorld(PtWorldCfg(**world))
    ds = DATASETS["granola"]
    queries = rw.sample_queries(n_queries, pattern=ds["pattern"],
                                zipf_a=ds["zipf_a"],
                                p_uncovered=ds["p_uncovered"], seed=1)
    return Env(RefService(rw, RefLatency(), k=10, chunk=2048),
               PtService(pw, PtLatency(), k=10, chunk=2048, device="cpu"),
               queries)


def port_index(ref_index):
    return convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(ref_index, f)) for f in convert.IVF_FIELDS},
        device="cpu")


def plans(events) -> tuple:
    """The same fault plan in each package: events as FaultEvent kwargs."""
    if events is None:
        return None, None
    return (ref_faults.FaultPlan(tuple(ref_faults.FaultEvent(**e)
                                       for e in events)),
            pt_faults.FaultPlan(tuple(pt_faults.FaultEvent(**e)
                                      for e in events)))


def make_pair(env: Env, sched_kw: dict | None = None,
              cfg_kw: dict | None = None, plan=None, ref_index=None,
              seed: int = 0):
    """The reference's scheduler and the port's, on one config; the port
    gets the reference's index (and ``ref_index``, if given, goes to
    both)."""
    cfg = dict(CFG, **(cfg_kw or {}))
    sk = dict(BASE, **(sched_kw or {}))
    rp, pp = plans(plan)
    ref = RefSched(env.ref_service, RefCfg(**cfg),
                   RefSchedCfg(**sk, fault_plan=rp), seed=seed,
                   index=ref_index)
    pt = PtSched(env.pt_service, PtCfg(**cfg),
                 PtSchedCfg(**sk, fault_plan=pp), seed=seed,
                 index=port_index(ref.index))
    return ref, pt


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    return a == b


def assert_same_result(ref, pt) -> None:
    """Exact equality of two ``SchedResult``s, span by span."""
    for f in RESULT_ARRAYS:
        a, b = getattr(ref, f), getattr(pt, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f)
    for llm in ref.ra:
        np.testing.assert_array_equal(ref.ra[llm], pt.ra[llm], err_msg=llm)
    for f in RESULT_COUNTS:
        assert getattr(ref, f) == getattr(pt, f), f
    assert ref.slo_deadline_s == pt.slo_deadline_s
    assert (ref.trace is None) == (pt.trace is None)
    if ref.trace is not None:
        for s in STAGES:
            np.testing.assert_array_equal(ref.trace.spans[s],
                                          pt.trace.spans[s], err_msg=s)
    rs, ps = ref.summary(), pt.summary()
    assert rs.keys() == ps.keys()
    for k in rs:
        assert _same(rs[k], ps[k]), (k, rs[k], ps[k])
    rt, pt_ = ref.per_tenant(), pt.per_tenant()
    assert rt.keys() == pt_.keys()
    for t in rt:
        for k in rt[t]:
            assert _same(rt[t][k], pt_[t][k]), (t, k)


def assert_same_state(ref_state, pt_state) -> None:
    """The final rings: every field equal."""
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref_state, f)),
                                      getattr(pt_state, f).numpy(),
                                      err_msg=f)


def serve_pair(ref, pt, queries, arrivals=None, seed: int = 0,
               tenant_ids=None):
    r = ref.serve(queries, arrivals, seed=seed, tenant_ids=tenant_ids)
    p = pt.serve(queries, arrivals, seed=seed, tenant_ids=tenant_ids)
    assert_same_result(r, p)
    assert_same_state(ref.state, pt.state)
    return r, p
