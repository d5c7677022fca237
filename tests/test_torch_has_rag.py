"""Port parity of the paper's batched HaS step (``repro_torch.configs.
has_rag``) against the JAX package on the CPU.

The same numpy inputs go through ``repro.configs.has_rag`` and the port.
Ids and accept bits are held exactly; the homology score ``best`` is a
count over k in both (exact), held with ``assert_allclose`` at
``BEST_RTOL``; the chunk-local top-k (``merge_chunks`` 4 and 8) must equal
the whole-row sort (``merge_chunks=0``) exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import has_rag as rhr
from repro_torch.configs import has_rag as phr

BEST_RTOL = 1e-7


def _to_np(args):
    return [np.asarray(a) for a in args]


def _ref(args, merge_chunks=0, k=4, tau=0.2):
    ids, acc, best = rhr.has_retrieval_step(
        *[jnp.asarray(a) for a in args], k=k, tau=tau, rules=None,
        merge_chunks=merge_chunks)
    return np.asarray(ids), np.asarray(acc), np.asarray(best)


def _port(args, merge_chunks=0, k=4, tau=0.2):
    ids, acc, best = phr.has_retrieval_step(
        *[torch.tensor(a) for a in args], k=k, tau=tau,
        merge_chunks=merge_chunks)
    return ids.numpy(), acc.numpy(), best.numpy()


def _check(got, want):
    assert got[0].dtype == np.int32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=BEST_RTOL)


def _filled_args(seed=0, n=512, d=16, k=4, b=8, h=8, dc=64):
    """The smoke's shapes, with the query cache holding the full scan's
    results of queries that half of the batch repeats (so both accepts and
    rejects occur) and the doc store holding those docs."""
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    scale = np.abs(corpus).max(axis=1) / np.float32(127.0)
    fq = np.clip(np.round(corpus / scale[:, None]), -127, 127).astype(
        np.int8)
    past = rng.normal(size=(h, d)).astype(np.float32)
    past_ids = np.argsort(-(past @ corpus.T), axis=1, kind="stable")[:, :k]
    doc_ids = np.full(dc, -1, np.int32)
    uniq = np.unique(past_ids)[:dc]
    doc_ids[:len(uniq)] = uniq
    doc_emb = np.zeros((dc, d), np.float32)
    doc_emb[:len(uniq)] = corpus[uniq]
    q = rng.normal(size=(b, d)).astype(np.float32)
    q[: b // 2] = past[: b // 2] + 0.01 * q[: b // 2]
    valid = np.ones(h, bool)
    valid[-2:] = False
    return [corpus, fq, scale.astype(np.float32), doc_emb, doc_ids,
            past_ids.astype(np.int32), valid, q]


def test_smoke_args_equal_reference():
    cfg, fn, args = rhr._smoke()
    pcfg, pargs = phr.smoke_args("cpu")
    assert (pcfg.corpus_size, pcfg.d, pcfg.k) == (cfg.corpus_size, cfg.d,
                                                  cfg.k)
    for got, want in zip(pargs, args):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("merge_chunks", [0, 4, 8])
def test_smoke_step_matches_reference(merge_chunks):
    _, _, args = rhr._smoke()
    args = _to_np(args)
    want = _ref(args, merge_chunks)
    got = _port(args, merge_chunks)
    _check(got, want)
    _check(got, _port(args, 0))


@pytest.mark.parametrize("merge_chunks", [0, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_filled_cache_accepts_and_rejects(seed, merge_chunks):
    args = _filled_args(seed)
    want = _ref(args, merge_chunks)
    got = _port(args, merge_chunks)
    _check(got, want)
    assert got[1].any() and not got[1].all()
    _check(got, _port(args, 0))


def test_masked_cache_slots_give_minus_one():
    """A doc store with fewer than k live slots: the cache channel's empty
    slots draft as -1 and never match, in both packages."""
    args = _filled_args(2)
    args[4] = np.full_like(args[4], -1)
    args[4][:2] = [5, 7]
    args[3] = np.zeros_like(args[3])
    sc = args[7] @ args[3].T
    sc = np.where(args[4][None] >= 0, sc, -np.inf)
    assert np.isinf(np.sort(sc, axis=1)[:, ::-1][:, 2:4]).all()
    _check(_port(args), _ref(args))
    # the cache channel's own result: two ids, then -1
    port_ids, _, _ = phr.has_retrieval_step(
        *[torch.tensor(a) for a in args], k=4, tau=1.1)
    assert (port_ids.numpy() >= 0).all()      # rejected: the full scan's
    s_c, slots = phr.stable_topk(torch.tensor(sc), 4)
    i_c = torch.where(torch.isfinite(s_c), torch.tensor(args[4])[slots], -1)
    assert (i_c[:, 2:] == -1).all() and (i_c[:, :2] >= 0).all()


@pytest.mark.parametrize("k", [1, 3, 10])
def test_iterative_topk_matches_reference(k):
    rng = np.random.default_rng(k)
    sc = rng.integers(-3, 3, (2, 3, 17)).astype(np.float32)   # many ties
    sc[0, 1, :] = -np.inf
    rv, ri = rhr._iterative_topk(jnp.asarray(sc), k)
    pv, pi = phr._iterative_topk(torch.tensor(sc), k)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    rv, ri = rhr._sharded_topk(jnp.asarray(sc.reshape(2, -1)), k, 3, None)
    pv, pi = phr._sharded_topk(torch.tensor(sc.reshape(2, -1)), k, 3)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))


def test_quantize_rows_matches_reference_smoke():
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(512, 16)).astype(np.float32)
    cj = jnp.asarray(corpus)
    scale = jnp.max(jnp.abs(cj), axis=1) / 127.0
    fq = jnp.clip(jnp.round(cj / scale[:, None]), -127, 127).astype(jnp.int8)
    codes, s = phr.quantize_rows(torch.tensor(corpus))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(fq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(scale))


def test_config_and_registration_match_reference():
    import dataclasses
    from repro.configs import get_arch as rget
    from repro_torch.configs import get_arch as pget
    assert dataclasses.asdict(phr.HasRagConfig()) == \
        dataclasses.asdict(rhr.HasRagConfig())
    r, p = rget("has-rag"), pget("has-rag")
    assert (p.family, p.source) == (r.family, r.source) == \
        ("rag", "the paper (HaS)")
    cfg, fn, args = p.make_smoke(device="cpu")
    ids, acc, best = fn(*args)
    assert tuple(ids.shape) == (args[-1].shape[0], cfg.k)
    assert not torch.isnan(best).any()
    rcfg, rfn, rargs = r.make_smoke()
    want = jax.jit(rfn)(*rargs)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want[1]))


def test_fuzzy_chunks_equal_whole(monkeypatch):
    """The fuzzy channel widened a row chunk at a time gives the step's
    result with one chunk."""
    args = _filled_args(3, n=600)
    whole = _port(args)
    monkeypatch.setattr(phr, "FUZZY_CHUNK", 128)
    _check(_port(args), whole)
