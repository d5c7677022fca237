"""Port parity of the edge speculation replica pool (``serving/edge_pool.py``)
and of the scheduler with R > 1 edge replicas.

The same delta stream goes through the reference's pool and the port's
(``device="cpu"``): versions, lags, the log's base and head, replay counts,
the replica states after every step and the gap and validation errors must
be equal.  Then the scheduler serves a Poisson stream with R = 2 and 3
replicas at two ``edge_sync_every`` values (and R = 3 with two tenants),
equal to the reference in every channel, replica id, cache version, span
and ``t_done``.
"""
import numpy as np
import pytest

from _torch_sched_util import make_env, make_pair, serve_pair
from _torch_sched_util import one_torch_thread  # noqa: F401 (autouse)
from repro.core.has import HasConfig as RefCfg
from repro.serving import edge_pool as re_
from repro.serving.scheduler import poisson_arrivals
from repro_torch.core.has import HasConfig
from repro_torch.serving import edge_pool as pe

FIELDS = ("query_emb", "query_doc_ids", "query_valid", "q_ptr", "doc_emb",
          "doc_ids", "d_ptr")
CFG = dict(k=4, h_max=16, doc_capacity=64, d=8)


def _rows(rng, n, hi=200):
    return (rng.normal(size=(n, 8)).astype(np.float32),
            rng.integers(-1, hi, size=(n, 4)).astype(np.int32),
            rng.normal(size=(n, 4, 8)).astype(np.float32))


def _pools(**kw):
    return (re_.EdgeReplicaPool(RefCfg(**CFG), **kw),
            pe.EdgeReplicaPool(HasConfig(**CFG), device="cpu", **kw))


def _assert_pools_equal(a, b, msg=""):
    assert a.cursors == b.cursors, msg
    assert (a.log.base, a.log.head, len(a.log)) == \
        (b.log.base, b.log.head, len(b.log)), msg
    assert a.replays == b.replays and a.retired == b.retired, msg
    for r in range(a.n_replicas):
        assert a.lag(r) == b.lag(r) and a.version(r) == b.version(r)
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(a.states[r], f)),
                getattr(b.states[r], f).numpy(), err_msg=f"{msg} r{r} {f}")


def _both(pools, method, *a, **kw):
    """Call ``method`` on both pools: equal counts (``sync``) or equal
    errors; a returned state (``promote``) is compared through the pools."""
    out = []
    for p in pools:
        try:
            res = getattr(p, method)(*a, **kw)
            out.append(("ok", res if isinstance(res, int) else None))
        except (ValueError, LookupError) as e:
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1], out
    return out[1]


@pytest.mark.parametrize("n_replicas,sync_every,compact,on_record", [
    (3, 5, False, True), (2, 4, True, True), (3, 3, True, False)])
def test_pool_replay_matches_reference(n_replicas, sync_every, compact,
                                       on_record):
    pools = _pools(n_replicas=n_replicas, sync_every=sync_every,
                   compact=compact, sync_on_record=on_record)
    rng = np.random.default_rng(n_replicas + sync_every)
    for step in range(8):
        rows = _rows(rng, int(rng.integers(1, 5)))
        key = step if step != 5 else 4          # one duplicated send
        for p in pools:
            p.record_batch(*rows, ingest_key=key)
        if not on_record:
            r = int(rng.integers(0, n_replicas))
            assert _both(pools, "sync", r)[1] >= 0
        _assert_pools_equal(*pools, msg=f"step {step}")
        assert pools[1].freshest(range(n_replicas)) == \
            pools[0].freshest(range(n_replicas))
    _both(pools, "sync_all")
    _assert_pools_equal(*pools, msg="sync_all")


def test_pool_promote_resync_and_gaps_match_reference():
    pools = _pools(n_replicas=2, sync_every=100, compact=False,
                   sync_on_record=False)
    rng = np.random.default_rng(1)
    rows = _rows(rng, 3)
    for p in pools:
        p.record_batch(*rows)
    _both(pools, "sync", 0)
    for p in pools:
        p.mark_lost(2)
        p.record_batch(*_rows(np.random.default_rng(2), 2))
    for r in (0, 1):                             # gap mid-log: same errors
        assert _both(pools, "sync", r)[0] == "ValueError"
    primaries = [p.states[0] for p in pools]
    for p, st in zip(pools, primaries):
        p.resync_from(1, st, p.log.head)
    _assert_pools_equal(*pools, msg="resync")
    _both(pools, "promote", 1)
    assert _both(pools, "sync", 1)[0] == "ValueError"   # retired
    for p in pools:
        p.mark_lost(1)                           # trailing loss
    assert _both(pools, "sync", 0)[0] == "ValueError"
    _assert_pools_equal(*pools, msg="after promote")


def test_pool_tenants_and_validation_match_reference():
    pools = _pools(n_replicas=2, sync_every=3, n_tenants=3, compact=False)
    rng = np.random.default_rng(3)
    rows = _rows(rng, 9, hi=60)
    tids = np.array([0, 2, 0, 2, 2, 1, 0, 1, 2], np.int32)
    for p in pools:
        p.record_batch(*rows, tenant_ids=tids)
    _both(pools, "sync_all")
    _assert_pools_equal(*pools, msg="tenants")
    for call in (dict(tenant_ids=None), dict(tenant_ids=tids[:9] + 1)):
        assert _both(pools, "record_batch", *rows, **call)[0] == "ValueError"
    assert _both(pools, "record_batch", rows[0], rows[1][:3], rows[2])[0] \
        == "ValueError"
    for kw in (dict(n_replicas=0), dict(n_replicas=2, sync_every=0)):
        msgs = []
        for cls, cfg in ((re_.EdgeReplicaPool, RefCfg(**CFG)),
                         (pe.EdgeReplicaPool, HasConfig(**CFG))):
            with pytest.raises(ValueError) as e:
                cls(cfg, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert pe.DEFAULT_EDGE_SYNC_EVERY == re_.DEFAULT_EDGE_SYNC_EVERY


# ---------------------------------------------------------------------------
# The scheduler with an edge replica pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    e = make_env(n_entities=400, n_queries=160)
    ref, _ = make_pair(e, cfg_kw=dict(h_max=400))
    e.index = ref.index
    return e


@pytest.mark.parametrize("replicas", [2, 3])
@pytest.mark.parametrize("sync_every", [8, 32])
def test_scheduler_edge_replicas_match_reference(env, replicas, sync_every):
    kw = dict(edge_replicas=replicas, edge_sync_every=sync_every)
    ref, pt = make_pair(env, kw, cfg_kw=dict(h_max=400), ref_index=env.index)
    arr = poisson_arrivals(len(env.queries), qps=60.0, seed=5)
    r, p = serve_pair(ref, pt, env.queries, arr, seed=3)
    assert p.max_inflight_spec_batches > 1
    assert (p.replica_ids[p.channels != "shed"] >= 0).all()
    # every replica's final state equals the reference replica's
    for a, b in zip(ref.edge_pool.states, pt.edge_pool.states):
        for f in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy(), err_msg=f)
    if sync_every == 8:
        assert p.edge_replays > 0 and p.trace.spans["replay"].sum() > 0


def test_scheduler_replicas_with_tenants_match_reference(env):
    kw = dict(edge_replicas=3, edge_sync_every=16, n_tenants=2)
    ref, pt = make_pair(env, kw, cfg_kw=dict(h_max=400), ref_index=env.index)
    tids = np.array([i % 2 for i in range(len(env.queries))], np.int32)
    arr = poisson_arrivals(len(env.queries), qps=60.0, seed=5)
    serve_pair(ref, pt, env.queries, arr, seed=3, tenant_ids=tids)
