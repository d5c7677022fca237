"""The plain reference against the port at small sizes on the CPU.  The
reference imports nothing of the port; these tests import both."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.reference import has as ref_has
from perfbench.reference import index, judge, search
from perfbench.stages import flat as flat_stage


def _corpus(n=6000, d=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g)
    return x / x.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("cap_factor", [2.0, 1.0])
@pytest.mark.parametrize("iters", [0, 10])
def test_buckets_equal_the_ports_build_ivf(cap_factor, iters):
    from repro_torch.retrieval.ivf import build_ivf
    corpus = _corpus()
    with index.deterministic():
        port = build_ivf(corpus, 64, capacity_factor=cap_factor,
                         kmeans_iters=iters, seed=11, device="cpu")
    ref = index.build(corpus, 64, cap_factor, 11, 131072, iters)
    assert torch.equal(port.centroids, ref.centroids)
    assert port.capacity == ref.cap
    assert torch.equal(port.bucket_counts.long(), ref.counts)
    for b in range(64):
        want = torch.nonzero((ref.assign == b) & ref.kept)[:, 0]
        got = port.bucket_ids[b][port.bucket_ids[b] >= 0].long()
        assert torch.equal(got, want)
    if cap_factor == 1.0:
        assert not bool(ref.kept.all())      # the cap dropped rows


def test_the_lloyd_steps_move_the_centroids():
    corpus = _corpus()
    seeded = index.build(corpus, 64, 2.0, 11, 131072, 0)
    trained = index.build(corpus, 64, 2.0, 11, 131072, 10)
    assert not torch.equal(seeded.centroids, trained.centroids)
    # trained buckets are more even: fewer rows over the cap
    assert int(trained.counts.sum()) >= int(seeded.counts.sum())


def test_exact_topk_equals_chunked_flat_search():
    from repro_torch.retrieval.flat import chunked_flat_search
    corpus = _corpus()
    q = _corpus(40, seed=3)
    _, want = chunked_flat_search(corpus, q, 10, chunk=1000)
    vals, got = flat_stage.select(None, corpus, [q[:25], q[25:]], 10, "f64")
    assert torch.equal(got, want.long())
    s = flat_stage.rescore(None, corpus, [q[:25], q[25:]], want)
    assert judge.gap(vals, want, s) < 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_equals_cache_update_chunked(seed):
    from repro_torch.core.has import (HasConfig, cache_update_chunked,
                                      init_has_state)
    rng = np.random.default_rng(seed)
    d, k, h, dc = 8, 4, 7, 23
    corpus = _corpus(60, d, seed)
    cfg = HasConfig(k=k, h_max=h, doc_capacity=dc, d=d)
    state = init_has_state(cfg, device="cpu")
    rings = ref_has.Rings.empty(h, k, dc)
    queries = rng.standard_normal((200, d)).astype(np.float32)
    src = 0
    for _ in range(12):
        m = int(rng.integers(1, 9))
        ids = rng.integers(0, 60, (m, k)).astype(np.int32)  # repeats, wraps
        state = cache_update_chunked(cfg, state, queries[src:src + m], ids,
                                     corpus=corpus, chunk=4)
        for i in range(m):
            rings.fold(src + i, ids[i])
        src += m
    assert judge.state_misses(state, rings, queries, corpus) == 0
    rings.fold(src, np.arange(k, dtype=np.int32))     # one fold too many
    assert judge.state_misses(state, rings, queries, corpus) > 0


def _served_rings(corpus, queries, k, h, dc, seed):
    """Port state and reference rings after folding exact results."""
    from repro_torch.core.has import (HasConfig, cache_update_chunked,
                                      init_has_state)
    from repro_torch.retrieval.flat import chunked_flat_search
    cfg = HasConfig(k=k, h_max=h, doc_capacity=dc, d=corpus.shape[1],
                    n_buckets=64, nprobe=8)
    state = init_has_state(cfg, device="cpu")
    rings = ref_has.Rings.empty(h, k, dc)
    _, ids = chunked_flat_search(corpus, torch.as_tensor(queries), k)
    ids = ids.numpy()
    state = cache_update_chunked(cfg, state, queries, ids, corpus=corpus,
                                 chunk=16)
    for i in range(len(queries)):
        rings.fold(i, ids[i])
    return cfg, state, rings


def test_speculation_drafts_and_accepts_equal_the_ports():
    from repro_torch.core.has import speculate_batch
    from repro_torch.retrieval.ivf import build_ivf
    corpus = _corpus(4000, 32, 9)
    # homologous queries: perturbed corpus rows
    g = torch.Generator().manual_seed(1)
    base = corpus[torch.randint(0, 4000, (96,), generator=g)]
    q = base + 0.05 * torch.randn(base.shape, generator=g)
    q = (q / q.norm(dim=1, keepdim=True)).numpy()
    cfg, state, rings = _served_rings(corpus, q[:64], 10, 50, 400, 0)
    with index.deterministic():
        fuzzy = build_ivf(corpus, 64, seed=3, device="cpu")
    buckets = index.build(corpus, 64, 2.0, 3, 131072, 10)
    qt = torch.as_tensor(q[64:])
    out = speculate_batch(cfg, state, fuzzy, qt)
    probe, _ = index.probe(buckets, qt, 8)
    probed = torch.zeros(32, 64, dtype=torch.bool).scatter_(1, probe, True)
    mask, at = judge.draft_eligible(rings, buckets, probed, 4000, "cpu")
    vals, want = search.blocked_topk(
        search.exact_block(qt, corpus, torch.float64), mask, 4000, 32, 10,
        "cpu")
    drafts = out["val_ids"].long()
    assert judge.draft_reading(vals, drafts, search.exact_rows(qt, corpus),
                               at) < 1e-6
    acc = ref_has.accepts(drafts, rings, 0.2)
    assert torch.equal(acc, out["accept"])
    assert 0 < int(acc.sum()) < 32          # both outcomes exercised


def test_gap_reads_inf_for_a_foreign_or_repeated_id():
    ref = torch.tensor([[3.0, 2.0, 1.0]], dtype=torch.float64)
    ok = torch.tensor([[3.0, 2.0, 1.0]], dtype=torch.float64)
    ids = torch.tensor([[5, 6, 7]])
    assert judge.gap(ref, ids, ok) == 0.0
    assert judge.gap(ref, torch.tensor([[5, 5, 7]]), ok) == float("inf")
    assert judge.gap(ref, ids, torch.tensor(
        [[3.0, -np.inf, 1.0]], dtype=torch.float64)) == float("inf")
    assert judge.gap(ref, ids, torch.tensor(
        [[3.0, 1.5, 1.0]], dtype=torch.float64)) == 0.5
