"""Port parity: speculation, channel merges, homology and ring updates.

The reference's ``speculate_batch(backend="xla")`` and its
``cache_update`` are held against the port's ``backend="torch"`` path on
the CPU, from one numpy-built state and one reference-built IVF index.
Ids, accept bits, matched slots, ring pointers and ring contents must be
equal; float scores agree to rtol = atol = 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import has as ref_has
from repro.core import homology as ref_hom
from repro.retrieval.ivf import build_ivf as ref_build_ivf
from repro_torch import convert
from repro_torch.core import dispatch
from repro_torch.core import has as pt_has
from repro_torch.core import homology as pt_hom

TOL = dict(rtol=1e-5, atol=1e-5)
OUT_KEYS = ("accept", "homology", "matched_slot", "val_ids", "draft_ids",
            "draft_scores")


def _cfgs(cfg_kw):
    return ref_has.HasConfig(**cfg_kw), pt_has.HasConfig(**cfg_kw)


def _state_np(state) -> dict:
    return {f: np.asarray(getattr(state, f)) for f in convert.STATE_FIELDS}


def _setup(cfg_kw, n_corpus=256, n_ingests=6, seed=0):
    """Reference index + a reference state warmed with real full results,
    and the port's copies of both."""
    rcfg, pcfg = _cfgs(cfg_kw)
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n_corpus, rcfg.d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    index = ref_build_ivf(jnp.asarray(corpus), rcfg.n_buckets, seed=0)
    state = ref_has.init_has_state(rcfg)
    for _ in range(n_ingests):
        q = rng.normal(size=(rcfg.d,)).astype(np.float32)
        ids = np.argsort(-(corpus @ q))[:rcfg.k].astype(np.int32)
        state = ref_has.cache_update(rcfg, state, jnp.asarray(q),
                                     jnp.asarray(ids),
                                     jnp.asarray(corpus[ids]))
    pidx = convert.ivf_index_from_numpy(
        {f: np.asarray(getattr(index, f)) for f in convert.IVF_FIELDS},
        device="cpu")
    pstate = convert.has_state_from_numpy(_state_np(state), device="cpu")
    return rcfg, pcfg, corpus, index, state, pidx, pstate


def _assert_outputs(ref, pt):
    for key in OUT_KEYS:
        a, b = np.asarray(ref[key]), pt[key].numpy()
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, err_msg=key, **TOL)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


BASE = dict(k=5, tau=0.2, h_max=32, doc_capacity=96, nprobe=2, n_buckets=8,
            d=16)


@pytest.mark.parametrize("extra", [
    {},
    dict(fusion="rrf"),
    dict(use_fuzzy_validation=False),
    dict(use_fuzzy_enhancement=False, fusion="rrf"),
])
@pytest.mark.parametrize("b", [1, 6])
def test_speculate_batch_matches_reference(extra, b):
    rcfg, pcfg, corpus, index, state, pidx, pstate = _setup(
        {**BASE, **extra})
    rng = np.random.default_rng(b)
    # half the queries are near cached results so some drafts accept
    q = rng.normal(size=(b, rcfg.d)).astype(np.float32)
    q[::2] = corpus[rng.integers(0, len(corpus), (b + 1) // 2)] * 4 \
        + q[::2] * 0.1
    ref = ref_has.speculate_batch(rcfg, state, index, jnp.asarray(q),
                                  backend="xla")
    with dispatch.capture() as probe:
        pt = pt_has.speculate_batch(pcfg, pstate, pidx, q, backend="torch")
    assert probe.counts() == {"speculate_batch": 1}
    _assert_outputs(ref, pt)


def test_speculate_batch_all_invalid_cache():
    rcfg, pcfg, corpus, index, _, pidx, _ = _setup(BASE, n_ingests=0)
    state = ref_has.init_has_state(rcfg)
    pstate = pt_has.init_has_state(pcfg, device="cpu")
    q = np.random.default_rng(5).normal(size=(3, rcfg.d)).astype(np.float32)
    ref = ref_has.speculate_batch(rcfg, state, index, jnp.asarray(q),
                                  backend="xla")
    pt = pt_has.speculate_batch(pcfg, pstate, pidx, q)
    _assert_outputs(ref, pt)
    assert not pt["accept"].any()


def test_speculate_batch_float64_input_is_narrowed():
    _, pcfg, corpus, _, _, pidx, pstate = _setup(BASE)
    q = corpus[:2].astype(np.float64)
    a = pt_has.speculate_batch(pcfg, pstate, pidx, q)
    b = pt_has.speculate_batch(pcfg, pstate, pidx, q.astype(np.float32))
    assert a["draft_scores"].dtype == torch.float32
    for key in OUT_KEYS:
        assert torch.equal(a[key], b[key]), key


def _merge_inputs(rng, b, k):
    s_a = -np.sort(-rng.normal(size=(b, k)), axis=1).astype(np.float32)
    s_b = -np.sort(-rng.normal(size=(b, k)), axis=1).astype(np.float32)
    i_a = rng.integers(0, 12, (b, k)).astype(np.int32)
    i_b = rng.integers(-1, 12, (b, k)).astype(np.int32)
    i_a[0, -2:] = -1                        # empty slots
    s_a[0, -2:] = -np.inf
    i_b[1, :3] = i_a[1, :3]                 # cross-channel duplicates
    return s_a, i_a, s_b, i_b


def test_channel_merges_match_reference():
    rng = np.random.default_rng(0)
    k = 6
    s_a, i_a, s_b, i_b = _merge_inputs(rng, 4, k)
    ref_d = jax.vmap(lambda *x: ref_has._dedup_merge(*x, k))(
        *map(jnp.asarray, (s_a, i_a, s_b, i_b)))
    pt_d = pt_has._dedup_merge(*map(torch.from_numpy, (s_a, i_a, s_b, i_b)),
                               k)
    ref_r = jax.vmap(lambda a, b: ref_has._rrf_merge(a, b, k, 60.0))(
        jnp.asarray(i_a), jnp.asarray(i_b))
    pt_r = pt_has._rrf_merge(torch.from_numpy(i_a), torch.from_numpy(i_b),
                             k, 60.0)
    for ref, pt in ((ref_d, pt_d), (ref_r, pt_r)):
        np.testing.assert_array_equal(np.asarray(ref[1]), pt[1].numpy())
        np.testing.assert_allclose(np.asarray(ref[0]), pt[0].numpy(), **TOL)


def test_homology_functions_match_reference():
    rng = np.random.default_rng(2)
    k, h = 10, 40
    draft = rng.integers(-1, 25, k).astype(np.int32)
    cache = rng.integers(-1, 25, (h, k)).astype(np.int32)
    valid = rng.random(h) < 0.7
    j = [jnp.asarray(x) for x in (draft, cache, valid)]
    t = [torch.from_numpy(x) for x in (draft, cache, valid)]
    np.testing.assert_array_equal(np.asarray(ref_hom.homology_scores(*j)),
                                  pt_hom.homology_scores(*t).numpy())
    ra = ref_hom.reidentify(*j, jnp.float32(0.2))
    pa = pt_hom.reidentify(*t, 0.2)
    for x, y in zip(ra, pa):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    w_r = ref_hom.rrf_draft_weights(j[0], 60.0)
    w_p = pt_hom.rrf_draft_weights(t[0], 60.0)
    np.testing.assert_allclose(np.asarray(w_r), w_p.numpy(), **TOL)
    np.testing.assert_allclose(
        np.asarray(ref_hom.homology_scores_weighted(*j, w_r)),
        pt_hom.homology_scores_weighted(*t, w_p).numpy(), **TOL)
    assert float(ref_hom.pairwise_homology(j[0], j[1][0])) == \
        float(pt_hom.pairwise_homology(t[0], t[1][0]))


def _assert_state_equal(ref_state, pt_state, step):
    ref = _state_np(ref_state)
    pt = convert.has_state_to_numpy(pt_state)
    for f in convert.STATE_FIELDS:
        np.testing.assert_array_equal(ref[f], pt[f],
                                      err_msg=f"{f} after update {step}")


def test_cache_update_rings_wrap_like_reference():
    cfg_kw = dict(k=5, h_max=4, doc_capacity=12, d=8)
    rcfg, pcfg = _cfgs(cfg_kw)
    rng = np.random.default_rng(9)
    rstate = ref_has.init_has_state(rcfg)
    pstate = pt_has.init_has_state(pcfg, device="cpu")
    for step in range(11):                   # wraps both rings repeatedly
        q = rng.normal(size=(8,)).astype(np.float32)
        ids = rng.integers(-1, 30, 5).astype(np.int32)
        ids[rng.integers(5)] = ids[0]        # in-batch duplicate
        vecs = rng.normal(size=(5, 8)).astype(np.float32)
        rstate = ref_has.cache_update(rcfg, rstate, jnp.asarray(q),
                                      jnp.asarray(ids), jnp.asarray(vecs))
        same = pt_has.cache_update(pcfg, pstate, q, ids, vecs)
        assert same is pstate                # updated in place
        _assert_state_equal(rstate, pstate, step)


def test_cache_update_batched_matches_reference():
    cfg_kw = dict(k=4, h_max=3, doc_capacity=10, d=8)
    rcfg, pcfg = _cfgs(cfg_kw)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(7, 8)).astype(np.float32)
    ids = rng.integers(-1, 20, (7, 4)).astype(np.int32)
    vecs = rng.normal(size=(7, 4, 8)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1, 1], bool)
    rstate = ref_has.cache_update_batched(
        rcfg, ref_has.init_has_state(rcfg), jnp.asarray(q),
        jnp.asarray(ids), jnp.asarray(vecs), jnp.asarray(mask))
    pstate = pt_has.cache_update_batched(
        pcfg, pt_has.init_has_state(pcfg, device="cpu"), q, ids, vecs, mask)
    _assert_state_equal(rstate, pstate, "batched")
    assert pt_has.cache_memory_bytes(pcfg) == \
        ref_has.cache_memory_bytes(rcfg)
