"""Port parity: tenant-partitioned states, intra-batch sharing, the chunked
update and the legacy speculation entries.

The reference's ``core/has.py`` (``backend="xla"``, and ``"pallas"`` in
interpret mode with ``tile_c=32``, as ``tests/test_multitenant.py`` runs
it) is held against the port's ``backend="torch"`` path on the CPU, from
one numpy-built stacked state and one reference-built IVF index.  Ids,
accept bits, flat matched slots, leaders, ring pointers and ring contents
must be equal; float scores agree to rtol = atol = 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import has as ref_has
from repro.retrieval.ivf import build_ivf as ref_build_ivf
from repro_torch import convert
from repro_torch.core import dispatch
from repro_torch.core import has as pt_has

TOL = dict(rtol=1e-6, atol=1e-6)
OUT_KEYS = ("accept", "homology", "matched_slot", "val_ids", "draft_ids",
            "draft_scores")
BASE = dict(k=5, tau=0.2, h_max=16, doc_capacity=48, nprobe=2, n_buckets=8,
            d=16)


def _world(cfg, n_corpus=192, seed=0):
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n_corpus, cfg.d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    index = ref_build_ivf(jnp.asarray(corpus), cfg.n_buckets, seed=0)
    pidx = convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(index, f)) for f in convert.IVF_FIELDS},
        device="cpu")
    return corpus, index, pidx


def _full_ids(corpus, q, k):
    return np.argsort(-(corpus @ q))[:k].astype(np.int32)


def _state_np(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in convert.STATE_FIELDS}


def _warm_tenants(rcfg, corpus, n_tenants, rounds, skip=(), seed=5):
    """A reference stacked state warmed by ``rounds`` full results per
    tenant (tenants in ``skip`` get none), the port's copy, and each
    tenant's queries."""
    rng = np.random.default_rng(seed)
    st = ref_has.init_tenant_states(rcfg, n_tenants)
    seen = [[] for _ in range(n_tenants)]
    for i in range(rounds * n_tenants):
        t = i % n_tenants
        q = rng.normal(size=(rcfg.d,)).astype(np.float32)
        if t in skip:
            continue
        seen[t].append(q)
        ids = _full_ids(corpus, q, rcfg.k)
        st = ref_has.cache_update(rcfg, st, jnp.asarray(q), jnp.asarray(ids),
                                  jnp.asarray(corpus[ids]), tenant_id=t)
    return (st, convert.tenant_state_from_numpy(_state_np(st), device="cpu"),
            seen)


def _assert_outputs(ref, pt):
    for key in OUT_KEYS:
        a, b = np.asarray(ref[key]), pt[key].numpy()
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, err_msg=key, **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


def _assert_states(ref_state, pt_state):
    ref = _state_np(ref_state)
    got = convert.has_state_to_numpy(pt_state)
    for f in convert.STATE_FIELDS:
        np.testing.assert_array_equal(ref[f], got[f], err_msg=f)


# -- tenant speculation -----------------------------------------------------

@pytest.mark.parametrize("fusion", ["score", "rrf"])
@pytest.mark.parametrize("ref_backend", ["xla", "pallas"])
@pytest.mark.parametrize("n_tenants,skip", [(1, ()), (3, ()), (3, (2,))])
def test_tenant_speculation_matches_reference(ref_backend, n_tenants, skip,
                                              fusion):
    """A mixed-tenant batch (a tenant with an empty partition in the last
    case: its rows all score 0, so its flat matched_slot is row 0, which
    belongs to tenant 0, in both packages)."""
    rcfg = ref_has.HasConfig(**BASE, fusion=fusion)
    pcfg = pt_has.HasConfig(**BASE, fusion=fusion)
    corpus, index, pidx = _world(rcfg)
    rst, pst, seen = _warm_tenants(rcfg, corpus, n_tenants, rounds=8,
                                   skip=skip)
    rng = np.random.default_rng(11)
    tids = np.arange(8, dtype=np.int32) % n_tenants
    # half the queries repeat one of their tenant's cached queries, so
    # some drafts are accepted
    q = rng.normal(size=(8, rcfg.d)).astype(np.float32)
    for i in range(0, 8, 2):
        if seen[tids[i]]:
            q[i] = seen[tids[i]][i // 2] + 0.05 * q[i]
    kw = dict(interpret=True, tile_c=32) if ref_backend == "pallas" else {}
    ref = ref_has.speculate_batch(rcfg, rst, index, jnp.asarray(q),
                                  backend=ref_backend,
                                  tenant_ids=jnp.asarray(tids), **kw)
    with dispatch.capture() as probe:
        pt = pt_has.speculate_batch(pcfg, pst, pidx, q, backend="torch",
                                    tenant_ids=tids)
    assert probe.counts() == {"speculate_batch": 1}
    _assert_outputs(ref, pt)
    acc = pt["accept"].numpy()
    assert acc.any()
    if fusion == "score":
        assert not acc.all()                     # both outcomes exercised
    for t in skip:
        rows = tids == t
        assert not acc[rows].any()
        assert (pt["matched_slot"].numpy()[rows] == 0).all()
        assert (pt["homology"].numpy()[rows] == 0).all()


def test_t1_stacked_equals_unstacked():
    """A [1, ...] store with tenant_ids == 0 serves exactly what the
    unstacked single-tenant state serves."""
    pcfg = pt_has.HasConfig(**BASE)
    corpus, _, pidx = _world(pcfg)
    s1 = pt_has.init_has_state(pcfg, device="cpu")
    sT = pt_has.init_tenant_states(pcfg, 1, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(6):
        q = rng.normal(size=(pcfg.d,)).astype(np.float32)
        ids = _full_ids(corpus, q, pcfg.k)
        pt_has.cache_update(pcfg, s1, q, ids, corpus[ids])
        pt_has.cache_update(pcfg, sT, q, ids, corpus[ids], tenant_id=0)
    q = rng.normal(size=(7, pcfg.d)).astype(np.float32)
    o1 = pt_has.speculate_batch(pcfg, s1, pidx, q, backend="torch")
    oT = pt_has.speculate_batch(pcfg, sT, pidx, q, backend="torch",
                                tenant_ids=np.zeros(7, np.int32))
    for key in OUT_KEYS:
        assert torch.equal(o1[key], oT[key]), key


def test_tenant_state_shapes_views_and_errors():
    cfg = pt_has.HasConfig(**BASE)
    rcfg = ref_has.HasConfig(**BASE)
    st = pt_has.init_tenant_states(cfg, 3, device="cpu")
    ref = ref_has.init_tenant_states(rcfg, 3)
    for f in convert.STATE_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(st, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert pt_has.tenant_count(st) == 3
    assert pt_has.tenant_count(pt_has.init_has_state(cfg, device="cpu")) == 1
    sl = pt_has.tenant_slice(st, 1)
    assert sl.query_emb.shape == (cfg.h_max, cfg.d)
    sl.q_ptr += 5                              # a view: writes through
    sl.doc_ids[3] = 42
    assert st.q_ptr.tolist() == [0, 5, 0] and int(st.doc_ids[1, 3]) == 42
    with pytest.raises(ValueError, match="n_tenants must be >= 1"):
        pt_has.init_tenant_states(cfg, 0, device="cpu")
    corpus, _, pidx = _world(cfg)
    z = np.zeros((2, cfg.d), np.float32)
    ids, vecs = np.arange(cfg.k), corpus[:cfg.k]
    with pytest.raises(ValueError, match="requires tenant_ids"):
        pt_has.speculate_batch(cfg, st, pidx, z, backend="torch")
    with pytest.raises(ValueError, match="requires a stacked"):
        pt_has.speculate_batch(cfg, pt_has.init_has_state(cfg, device="cpu"),
                               pidx, z, backend="torch",
                               tenant_ids=np.zeros(2, np.int32))
    with pytest.raises(ValueError, match="requires tenant_id"):
        pt_has.cache_update(cfg, st, z[0], ids, vecs)
    with pytest.raises(ValueError, match="tenant_id 3 out of range"):
        pt_has.cache_update(cfg, st, z[0], ids, vecs, tenant_id=3)
    with pytest.raises(ValueError, match="tenant_id -1 out of range"):
        pt_has.cache_update(cfg, st, z[0], ids, vecs, tenant_id=-1)
    with pytest.raises(ValueError, match="requires tenant_ids"):
        pt_has.cache_update_batched(cfg, st, z, np.tile(ids, (2, 1)),
                                    np.stack([vecs, vecs]))


# -- tenant updates ---------------------------------------------------------

def _update_rows(corpus, cfg, n, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, cfg.d)).astype(np.float32)
    ids = np.stack([_full_ids(corpus, x, cfg.k) for x in q])
    # repeated ids within and across rows: the dedup must match
    ids[1::3, 2] = ids[1::3, 0]
    ids[2::5] = ids[0]
    return q, ids


def test_tenant_cache_update_matches_reference():
    """Every ring (contents, validity, pointers) equal after tenant-tagged
    single updates that wrap both rings of a tenant."""
    rcfg = ref_has.HasConfig(**BASE)
    pcfg = pt_has.HasConfig(**BASE)
    corpus, _, _ = _world(rcfg)
    rst = ref_has.init_tenant_states(rcfg, 3)
    pst = pt_has.init_tenant_states(pcfg, 3, device="cpu")
    q, ids = _update_rows(corpus, rcfg, 40, seed=1)
    tids = np.random.default_rng(2).choice([0, 0, 1], size=40)
    for x, i, t in zip(q, ids, tids):
        rst = ref_has.cache_update(rcfg, rst, jnp.asarray(x),
                                   jnp.asarray(i), jnp.asarray(corpus[i]),
                                   tenant_id=int(t))
        pt_has.cache_update(pcfg, pst, x, i, corpus[i], tenant_id=int(t))
    assert int(pst.q_ptr[0]) > pcfg.h_max      # tenant 0's query ring wraps
    assert int(pst.d_ptr[0]) > pcfg.doc_cap    # and its doc ring
    _assert_states(rst, pst)


@pytest.mark.parametrize("n,chunk", [(23, 8), (8, 8), (5, 16)])
def test_tenant_chunked_and_batched_update_match_reference(n, chunk):
    """``cache_update_chunked`` with tenant tags (a tail chunk, pad rows
    of tenant 0 masked off, a chunk of pads only in the last case) from a
    device corpus and from explicit vectors, and the masked
    ``cache_update_batched`` it runs, leave the reference's rings."""
    rcfg = ref_has.HasConfig(**BASE)
    pcfg = pt_has.HasConfig(**BASE)
    corpus, _, _ = _world(rcfg)
    q, ids = _update_rows(corpus, rcfg, n, seed=n)
    tids = (np.arange(n) % 3).astype(np.int32)
    tids[::4] = 2
    rst = ref_has.cache_update_chunked(
        rcfg, ref_has.init_tenant_states(rcfg, 3), q, ids,
        corpus=jnp.asarray(corpus), chunk=chunk, tenant_ids=tids)
    for kw in (dict(corpus=torch.from_numpy(corpus)),
               dict(full_vecs=corpus[ids])):
        pst = pt_has.init_tenant_states(pcfg, 3, device="cpu")
        with dispatch.capture() as probe:
            out = pt_has.cache_update_chunked(pcfg, pst, q, ids, chunk=chunk,
                                              tenant_ids=tids, **kw)
        assert out is pst
        assert probe.counts() == {"cache_update_batched": -(-n // chunk)}
        _assert_states(rst, pst)
    # the masked batch directly: pad rows untouched, tags of masked rows
    # ignored
    mask = np.arange(n) % 4 != 1
    rb = ref_has.cache_update_batched(
        rcfg, ref_has.init_tenant_states(rcfg, 3), jnp.asarray(q),
        jnp.asarray(ids), jnp.asarray(corpus[ids]), jnp.asarray(mask),
        tenant_ids=jnp.asarray(tids))
    pb = pt_has.cache_update_batched(
        pcfg, pt_has.init_tenant_states(pcfg, 3, device="cpu"), q, ids,
        corpus[ids], mask, tenant_ids=tids)
    _assert_states(rb, pb)


def test_untenanted_chunked_update_matches_reference():
    rcfg = ref_has.HasConfig(**BASE)
    pcfg = pt_has.HasConfig(**BASE)
    corpus, _, _ = _world(rcfg)
    q, ids = _update_rows(corpus, rcfg, 30, seed=3)
    rst = ref_has.cache_update_chunked(rcfg, ref_has.init_has_state(rcfg), q,
                                       ids, corpus=jnp.asarray(corpus),
                                       chunk=16)
    pst = pt_has.cache_update_chunked(
        pcfg, pt_has.init_has_state(pcfg, device="cpu"), q, ids,
        corpus=torch.from_numpy(corpus), chunk=16)
    _assert_states(rst, pst)


# -- intra-batch sharing ----------------------------------------------------

def _share_inputs(b=24, k=5, seed=0):
    """Drafts over a small id range (real overlaps between rows)."""
    rng = np.random.default_rng(seed)
    val = rng.integers(-1, 14, (b, k)).astype(np.int32)
    rejected = rng.random(b) < 0.7
    pending = (rng.random(b) < 0.2) & ~rejected
    tids = rng.integers(0, 3, b).astype(np.int32)
    return val, rejected, pending, tids


@pytest.mark.parametrize("with_pending", [False, True])
@pytest.mark.parametrize("with_tenants", [False, True])
@pytest.mark.parametrize("tau", [0.1, 0.3])
def test_intra_batch_share_matches_reference(with_pending, with_tenants, tau):
    val, rej, pend, tids = _share_inputs(seed=int(tau * 10))
    kw_r, kw_p = {}, {}
    if with_pending:
        kw_r["pending"], kw_p["pending"] = jnp.asarray(pend), pend
    if with_tenants:
        kw_r["tenant_ids"], kw_p["tenant_ids"] = jnp.asarray(tids), tids
    ref = ref_has.intra_batch_share(jnp.asarray(val), jnp.asarray(rej),
                                    jnp.float32(tau), **kw_r)
    for backend in (None, "torch"):
        pt = pt_has.intra_batch_share(torch.from_numpy(val), rej, tau,
                                      backend=backend, **kw_p)
        np.testing.assert_array_equal(np.asarray(ref["is_leader"]),
                                      pt["is_leader"].numpy())
        np.testing.assert_array_equal(np.asarray(ref["leader"]),
                                      pt["leader"].numpy())
        np.testing.assert_allclose(np.asarray(ref["share_score"]),
                                   pt["share_score"].numpy(), **TOL)
        assert pt["leader"].dtype == torch.int32
    leader = pt["leader"].numpy()
    follow = leader != np.arange(len(val))
    assert follow.any()                          # some rows follow
    if with_tenants:
        assert (tids[leader[follow]] == tids[follow]).all()


# -- legacy entries and the traffic model -----------------------------------

def test_legacy_speculate_entries_match_reference():
    rcfg = ref_has.HasConfig(**BASE)
    pcfg = pt_has.HasConfig(**BASE)
    corpus, index, pidx = _world(rcfg)
    rst = ref_has.init_has_state(rcfg)
    rng = np.random.default_rng(4)
    for _ in range(6):
        x = rng.normal(size=(rcfg.d,)).astype(np.float32)
        i = _full_ids(corpus, x, rcfg.k)
        rst = ref_has.cache_update(rcfg, rst, jnp.asarray(x), jnp.asarray(i),
                                   jnp.asarray(corpus[i]))
    pst = convert.has_state_from_numpy(_state_np(rst), device="cpu")
    q = rng.normal(size=(5, rcfg.d)).astype(np.float32)
    q[0] = corpus[3]
    with dispatch.capture() as probe:
        batched = pt_has.speculate_batched(pcfg, pst, pidx, q,
                                           backend="torch")
        singles = [pt_has.speculate(pcfg, pst, pidx, x) for x in q]
    assert probe.counts() == {"speculate_batched": 1, "speculate": 5}
    _assert_outputs(ref_has.speculate_batched(rcfg, rst, index,
                                              jnp.asarray(q)), batched)
    for x, got in zip(q, singles):
        ref = ref_has.speculate(rcfg, rst, index, jnp.asarray(x))
        assert got["val_ids"].shape == (rcfg.k,) and got["accept"].ndim == 0
        _assert_outputs(ref, got)
    with pytest.raises(ValueError, match="requires tenant_ids"):
        pt_has.speculate(pcfg, pt_has.init_tenant_states(pcfg, 2,
                                                         device="cpu"),
                         pidx, q[0])


@pytest.mark.parametrize("b", [1, 64])
def test_speculation_bytes_moved_matches_reference(b):
    cfg = dict(k=10, h_max=5000, doc_capacity=50_000, nprobe=64,
               n_buckets=8192, d=768)
    rcfg, pcfg = ref_has.HasConfig(**cfg), pt_has.HasConfig(**cfg)
    for ref_b, pt_b in (("pallas", "cuda"), ("xla", "torch")):
        assert pt_has.speculation_bytes_moved(pcfg, 8192, 123, b, pt_b) == \
            ref_has.speculation_bytes_moved(rcfg, 8192, 123, b, ref_b)
    with pytest.raises(ValueError):
        pt_has.speculation_bytes_moved(pcfg, 8192, 123, b, None)


def test_convert_tenant_and_reuse_states_round_trip():
    from repro.core.baselines import init_reuse_state as ref_reuse
    rcfg = ref_has.HasConfig(**BASE)
    corpus, _, _ = _world(rcfg)
    rst, pst, _ = _warm_tenants(rcfg, corpus, 3, rounds=2)
    back = convert.tenant_state_to_numpy(pst)
    for f, a in _state_np(rst).items():
        np.testing.assert_array_equal(a, back[f], err_msg=f)
        assert back[f].dtype == a.dtype, f
    with pytest.raises(ValueError, match="not a stacked tenant state"):
        convert.tenant_state_from_numpy(
            _state_np(ref_has.init_has_state(rcfg)), device="cpu")
    with pytest.raises(ValueError, match="not a stacked tenant state"):
        convert.tenant_state_to_numpy(
            pt_has.init_has_state(pt_has.HasConfig(**BASE), device="cpu"))
    rr = ref_reuse(4, 3, 8, n_hash=6)
    arrays = {f: np.asarray(getattr(rr, f)) for f in convert.REUSE_FIELDS}
    pr = convert.reuse_state_from_numpy(arrays, device="cpu")
    for f, a in convert.reuse_state_to_numpy(pr).items():
        np.testing.assert_array_equal(arrays[f], a, err_msg=f)
        assert arrays[f].dtype == a.dtype, f
