"""Port parity of the replication substrate (``serving/replication.py``)
and the checkpoint manager (``checkpoint/manager.py``).

``DeltaLog``, ``validate_ingest_batch`` and ``gather_doc_vecs`` are held to
the reference on the same calls; ``WarmStandby`` and ``snapshot`` /
``restore`` rebuild states equal to the reference's on the same update
stream (the port with ``device="cpu"``).  The port's cache updates mutate a
state in place, so a test asserts that no edge replica, standby or
restored state shares storage with the primary.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefMgr
from repro.core.has import HasConfig as RefCfg
from repro.core.has import cache_update_batched as ref_update
from repro.core.has import init_has_state as ref_init
from repro.core.has import init_tenant_states as ref_init_t
from repro.serving import replication as rr
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.has import HasConfig, cache_update_batched
from repro_torch.core.has import init_has_state, init_tenant_states
from repro_torch.serving import replication as pr
from repro_torch.serving.edge_pool import EdgeReplicaPool

FIELDS = ("query_emb", "query_doc_ids", "query_valid", "q_ptr", "doc_emb",
          "doc_ids", "d_ptr")
CFG = dict(k=4, h_max=16, doc_capacity=128, d=8)


def _rows(rng, n, k=4, d=8, hi=200):
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.integers(-1, hi, size=(n, k)).astype(np.int32),
            rng.normal(size=(n, k, d)).astype(np.float32))


def _assert_equal(ref_state, pt_state, msg=""):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ref_state, f)),
                                      getattr(pt_state, f).numpy(),
                                      err_msg=f"{msg} {f}")


def _both_folded(rows, n_tenants=1, tids=None):
    """The same rows folded into a fresh reference state and port state."""
    qs, ids, vecs = rows
    rs = (ref_init(RefCfg(**CFG)) if n_tenants == 1
          else ref_init_t(RefCfg(**CFG), n_tenants))
    ps = (init_has_state(HasConfig(**CFG), device="cpu") if n_tenants == 1
          else init_tenant_states(HasConfig(**CFG), n_tenants,
                                  device="cpu"))
    kw = {} if tids is None else {"tenant_ids": tids}
    rs = ref_update(RefCfg(**CFG), rs, jnp.asarray(qs), jnp.asarray(ids),
                    jnp.asarray(vecs),
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    cache_update_batched(HasConfig(**CFG), ps, qs, ids, vecs, **kw)
    return rs, ps


# ---------------------------------------------------------------------------
# DeltaLog, validate_ingest_batch, gather_doc_vecs
# ---------------------------------------------------------------------------

def _log_script(log):
    """One script of appends, losses, compaction and reads; its trace (an
    error's text where a read raises)."""
    def read(fn, *a):
        try:
            return fn(*a)
        except (LookupError, ValueError) as e:
            return f"{type(e).__name__}: {e}"

    out = []
    for i in range(5):
        log.append(i)
    out.append((log.base, log.head, len(log), read(log.since, 0),
                read(log.since, 3)))
    log.mark_lost(2)
    log.append(7)
    out.append((log.base, log.head,
                read(lambda c: [s for s, _ in log.since_items(c)], 4)))
    log.compact_below(3)
    out.append((log.base, log.head, len(log), list(log)))
    out += [read(log.since, 1), read(log.since, -1), read(log.mark_lost, -1)]
    log.clear()
    log.append(9)
    out.append((log.base, log.head, log.since(log.base)))
    return out


@pytest.mark.parametrize("maxlen", [None, 3])
def test_delta_log_matches_reference(maxlen):
    assert _log_script(pr.DeltaLog(maxlen)) == _log_script(rr.DeltaLog(maxlen))


def test_validate_and_gather_match_reference():
    rng = np.random.default_rng(0)
    qs, ids, vecs = _rows(rng, 4)
    for bad in [(qs[:3], ids, vecs, None), (qs, ids[:2], vecs, None),
                (qs, ids, vecs[:1], None),
                (qs, ids, vecs, np.zeros(3, np.int32))]:
        with pytest.raises(ValueError) as want:
            rr.validate_ingest_batch(*bad)
        with pytest.raises(ValueError) as got:
            pr.validate_ingest_batch(*bad)
        assert str(got.value) == str(want.value)
    corpus = rng.normal(size=(50, 8)).astype(np.float32)
    ids = np.array([[0, 49, -1], [-1, 2, -1]], np.int32)
    np.testing.assert_array_equal(pr.gather_doc_vecs(corpus, ids),
                                  rr.gather_doc_vecs(corpus, ids))
    assert not pr.gather_doc_vecs(corpus, ids)[ids < 0].any()


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params/w": torch.randn(8, 4, generator=g),
            "ids": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "mask": torch.rand(5, generator=g) < 0.5,
            "step": np.int32(7)}


def test_checkpoint_roundtrip_keep_n_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    t = _tree()
    mgr.save(10, t)
    got = mgr.restore(10, t)
    for key, leaf in t.items():
        want = leaf.numpy() if isinstance(leaf, torch.Tensor) else leaf
        assert isinstance(got[key], type(leaf) if isinstance(
            leaf, torch.Tensor) else np.ndarray), key
        np.testing.assert_array_equal(np.asarray(got[key]), want)
        assert np.asarray(got[key]).dtype == np.asarray(want).dtype
    for s in (11, 12):
        mgr.save(s, _tree(s), blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [11, 12]
    step, last = mgr.restore_latest(t)
    assert step == 12
    np.testing.assert_array_equal(last["params/w"].numpy(),
                                  _tree(12)["params/w"].numpy())
    with pytest.raises(KeyError):
        mgr.restore(12, {"missing": torch.zeros(1)})
    with pytest.raises(TypeError):
        mgr.save(13, {"nested": {"w": torch.zeros(1)}})


def test_checkpoint_manifest_matches_reference(tmp_path):
    """The same leaves give the reference's manifest (file names, shapes,
    dtypes, checksums)."""
    t = _tree()
    CheckpointManager(str(tmp_path / "pt")).save(3, t)
    RefMgr(str(tmp_path / "ref")).save(3, {
        k: jnp.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
        for k, v in t.items()})
    read = [json.load(open(tmp_path / d / "step_000000000003"
                           / "manifest.json")) for d in ("pt", "ref")]
    assert read[0]["leaves"].keys() == read[1]["leaves"].keys()
    for key, meta in read[0]["leaves"].items():
        ref_meta = read[1]["leaves"][key]
        assert meta["shape"] == ref_meta["shape"], key
        assert meta["dtype"] == ref_meta["dtype"], key
        assert meta["checksum"] == ref_meta["checksum"], key


def test_restore_latest_skips_corrupt_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    t = _tree()
    for s in (1, 2, 3):
        mgr.save(s, _tree(s))
    assert mgr.restore_latest(t)[0] == 3
    # a lost manifest (killed mid-write) and a leaf whose bytes changed
    os.remove(tmp_path / "step_000000000003" / "manifest.json")
    np.save(tmp_path / "step_000000000002" / "params__w.npy",
            np.zeros((8, 4), np.float32))
    step, got = mgr.restore_latest(t)
    assert step == 1
    np.testing.assert_array_equal(got["params/w"].numpy(),
                                  _tree(1)["params/w"].numpy())
    with pytest.raises(FileNotFoundError):
        mgr.restore(2, t)
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(t) \
        is None


def test_async_save_copies_before_an_in_place_update(tmp_path):
    """The writer thread gets host copies: an in-place ingest right after
    ``snapshot(..., blocking=False)`` cannot reach the checkpoint."""
    captured = {}

    class SpyMgr(CheckpointManager):
        def _write(self, step, host):
            captured.update(host)
            super()._write(step, host)

    cfg = HasConfig(**CFG)
    mgr = SpyMgr(str(tmp_path))
    rng = np.random.default_rng(5)
    state = init_has_state(cfg, device="cpu")
    cache_update_batched(cfg, state, *_rows(rng, 6))
    expect = {f: getattr(state, f).clone() for f in FIELDS}
    pr.snapshot(mgr, 1, state, blocking=False)
    mgr.wait()
    for f in FIELDS:
        assert not np.shares_memory(captured[f], getattr(state, f).numpy())
    for _ in range(4):
        cache_update_batched(cfg, state, *_rows(rng, 6))
    _, restored = pr.restore(mgr, cfg, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(restored, f), expect[f]), f


# ---------------------------------------------------------------------------
# snapshot / restore / WarmStandby against the reference
# ---------------------------------------------------------------------------

def test_snapshot_restore_matches_reference(tmp_path):
    rng = np.random.default_rng(1)
    rs, ps = _both_folded(_rows(rng, 7))
    rr.snapshot(RefMgr(str(tmp_path / "ref")), 7, rs)
    pr.snapshot(CheckpointManager(str(tmp_path / "pt")), 7, ps)
    step_r, got_r = rr.restore(RefMgr(str(tmp_path / "ref")), RefCfg(**CFG))
    step_p, got_p = pr.restore(CheckpointManager(str(tmp_path / "pt")),
                               HasConfig(**CFG), device="cpu")
    assert step_p == step_r == 7
    _assert_equal(got_r, got_p)
    assert pr.restore(CheckpointManager(str(tmp_path / "none")),
                      HasConfig(**CFG), device="cpu") is None


@pytest.mark.parametrize("saved,asked", [(3, 2), (3, 1), ("stacked1", 1),
                                         (1, 2)])
def test_restore_tenant_errors_match_reference(tmp_path, saved, asked):
    msgs = []
    for mod, mgr_cls, cfg, init1, init_t, kw in (
            (rr, RefMgr, RefCfg(**CFG), ref_init, ref_init_t, {}),
            (pr, CheckpointManager, HasConfig(**CFG),
             lambda c: init_has_state(c, device="cpu"),
             lambda c, t: init_tenant_states(c, t, device="cpu"),
             {"device": "cpu"})):
        mgr = mgr_cls(str(tmp_path / mod.__name__))
        state = (init1(cfg) if saved == 1 else
                 init_t(cfg, 1 if saved == "stacked1" else saved))
        mod.snapshot(mgr, 1, state)
        with pytest.raises(ValueError) as e:
            mod.restore(mgr, cfg, n_tenants=asked, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("n_tenants", [1, 3])
def test_warm_standby_failover_matches_reference(tmp_path, n_tenants):
    """The same update stream through both standbys (a snapshot mid-way
    at snapshot_every=8, ingest keys with one duplicate): failover states
    equal to each other and to the primary."""
    rng = np.random.default_rng(7)
    ref_sb = rr.WarmStandby(RefCfg(**CFG), RefMgr(str(tmp_path / "r")),
                            snapshot_every=8, n_tenants=n_tenants,
                            replay_batch=4)
    pt_sb = pr.WarmStandby(HasConfig(**CFG),
                           CheckpointManager(str(tmp_path / "p")),
                           snapshot_every=8, n_tenants=n_tenants,
                           replay_batch=4, device="cpu")
    all_rows = []
    for key, n in enumerate((3, 5, 4, 2)):
        rows = _rows(rng, n)
        tids = (None if n_tenants == 1 else
                rng.integers(0, n_tenants, n).astype(np.int32))
        all_rows.append((rows, tids))
        flat = [np.concatenate(x) for x in zip(*[r for r, _ in all_rows])]
        ftids = (None if n_tenants == 1 else
                 np.concatenate([t for _, t in all_rows]))
        rs, ps = _both_folded(flat, n_tenants, ftids)
        for _ in range(2 if key == 1 else 1):          # key 1 sent twice
            ref_sb.record_batch(*rows, rs, tenant_ids=tids, ingest_key=key)
            pt_sb.record_batch(*rows, ps, tenant_ids=tids, ingest_key=key)
        ref_sb.mgr.wait()
        assert [len(x) for x in pt_sb.logs] == [len(x) for x in ref_sb.logs]
    got, want = pt_sb.failover(), ref_sb.failover()
    _assert_equal(want, got)
    _assert_equal(rs, got, "primary vs failover")
    if n_tenants > 1:
        with pytest.raises(ValueError, match="requires tenant_ids"):
            pt_sb.record_batch(*_rows(rng, 1), ps)
    cold = pr.WarmStandby(HasConfig(**CFG),
                          CheckpointManager(str(tmp_path / "cold")),
                          device="cpu").failover()
    assert int(cold.q_ptr) == 0


def test_no_replica_standby_or_restored_state_aliases_the_primary(tmp_path):
    """Every state handed out by the pool, a standby or a restore owns its
    storage: none shares a tensor with the primary."""
    cfg = HasConfig(**CFG)
    rng = np.random.default_rng(9)
    primary = init_has_state(cfg, device="cpu")
    cache_update_batched(cfg, primary, *_rows(rng, 5))

    def ptrs(state):
        return {getattr(state, f).untyped_storage().data_ptr()
                for f in FIELDS}

    owned = ptrs(primary)
    pool = EdgeReplicaPool(cfg, n_replicas=3, sync_every=2, device="cpu")
    pool.record_batch(*_rows(rng, 5))
    pool.resync_from(1, primary, pool.log.head)
    promoted = pool.promote(2)
    sb = pr.WarmStandby(cfg, CheckpointManager(str(tmp_path)),
                        snapshot_every=5, device="cpu")
    sb.record_batch(*_rows(rng, 5), primary)
    held = [*pool.states, promoted, sb.failover(),
            pr.restore(sb.mgr, cfg, device="cpu")[1]]
    for i, st in enumerate(held):
        assert not ptrs(st) & owned, f"state {i} aliases the primary"
    # and an ingest into the primary leaves the resynced replica unchanged
    before = {f: getattr(pool.states[1], f).clone() for f in FIELDS}
    cache_update_batched(cfg, primary, *_rows(rng, 3))
    for f in FIELDS:
        assert torch.equal(getattr(pool.states[1], f), before[f]), f
