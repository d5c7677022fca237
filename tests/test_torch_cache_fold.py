"""The fold of a chunk of full retrievals into the HaS rings
(``kernels/cache_fold.py``): the kernel's algorithm and the kernel.

On the CPU: a numpy model of the three launches of ``csrc/cache_fold.cu``
(the lookup's largest entry offset of each candidate, the walk's ballot of
new ids against that offset and the last insertion of each id, the final
writers, the copy) against ``cache_fold_plain``, the row loop, on chunks
that evict and re-insert an id, insert more than the doc ring holds, write
more rows than the query ring holds, repeat ids within and across rows,
carry ``-1`` ids, masked rows and four tenants.  (The plain loop is held to
the JAX reference in ``tests/test_torch_has.py`` and
``tests/test_torch_tenants.py``.)  That ``backend="torch"`` keeps every
ingest entry, and the engines that take a backend, on the row loop.

On the card (marked ``cuda``, skips without one): the kernel against the
plain loop on the card, every field equal, at the serving shape and the
same hard chunks; no host wait inside a call (sync debug mode ``error``);
three launches whatever the number of rows, and three a slice of
``rows_per_call(k)`` rows past it; the serving entry
``cache_update_chunked`` uploading a chunk once and counting
``fold_rows``, and launching nothing under ``backend="torch"``.  This file imports nothing of JAX, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cache_fold.py
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.core import dispatch
from repro_torch.core import has as pt_has
from repro_torch.kernels import cache_fold as CF
from repro_torch.kernels.ops import cache_fold_op

FIELDS = tuple(f.name for f in dataclasses.fields(pt_has.HasState))


@dataclasses.dataclass(frozen=True)
class Case:
    t: int = 1              # tenants (1: an unstacked state)
    h: int = 4              # query ring
    dc: int = 12            # doc ring
    k: int = 5
    d: int = 8
    b: int = 7              # rows in the chunk
    live: int = 7           # unmasked rows among them (at random places)
    ids: int = 30           # ids drawn from [0, ids)
    fill: bool = True       # start from a filled ring
    dup_ring: bool = False  # an id at two slots of the entry ring
    seed: int = 0


# the hard chunks: eviction and re-insertion within the chunk, more inserts
# than the doc ring holds, more rows than the query ring holds, tenants
CASES = {
    "wrap": Case(),
    "reinsert": Case(h=3, dc=6, k=3, b=12, live=12, ids=10, seed=1),
    "over_doc_cap": Case(h=8, dc=8, k=4, b=9, live=9, ids=200, seed=2),
    "over_h_max": Case(h=3, dc=40, k=4, b=16, live=11, ids=25, seed=3),
    "empty": Case(live=0, seed=4),
    "one_row": Case(b=5, live=1, seed=5),
    "fresh_state": Case(fill=False, seed=6),
    "dup_in_ring": Case(dup_ring=True, ids=14, seed=7),
    "tenants4": Case(t=4, h=3, dc=9, k=4, b=20, live=16, ids=20, seed=8),
    "tenants4_k33": Case(t=4, h=5, dc=70, k=33, b=6, live=5, ids=60,
                         seed=9),
}


def _state(c: Case, rng, dev="cpu"):
    cfg = pt_has.HasConfig(k=c.k, h_max=c.h, doc_capacity=c.dc, d=c.d)
    st = (pt_has.init_has_state(cfg, device=dev) if c.t == 1 else
          pt_has.init_tenant_states(cfg, c.t, device=dev))
    if not c.fill:
        return st
    views = [st] if c.t == 1 else [pt_has.tenant_slice(st, t)
                                   for t in range(c.t)]
    for v in views:
        ring = rng.permutation(max(c.ids, c.dc))[:c.dc].astype(np.int32)
        ring[rng.random(c.dc) < 0.2] = -1              # empty slots
        if c.dup_ring:
            ring[1] = ring[c.dc - 2] = c.ids - 1
        v.doc_ids.copy_(torch.from_numpy(ring))
        v.doc_emb.copy_(torch.from_numpy(
            rng.standard_normal((c.dc, c.d), dtype=np.float32)))
        v.query_doc_ids.copy_(torch.from_numpy(
            rng.integers(-1, c.ids, (c.h, c.k)).astype(np.int32)))
        v.query_valid.copy_(torch.from_numpy(rng.random(c.h) < 0.7))
        v.query_emb.copy_(torch.from_numpy(
            rng.standard_normal((c.h, c.d), dtype=np.float32)))
        v.q_ptr.fill_(int(rng.integers(0, 10 * c.h)))
        v.d_ptr.fill_(int(rng.integers(0, 10 * c.dc)))
    return st


def _chunk(c: Case, rng, n_corpus: int):
    q = rng.normal(size=(c.b, c.d)).astype(np.float32)
    ids = rng.integers(-1, c.ids, (c.b, c.k)).astype(np.int32)
    ids[1::3, -1] = ids[1::3, 0]                       # in-row repeats
    ids[2::5] = ids[0]                                 # cross-row repeats
    mask = np.zeros(c.b, bool)
    mask[rng.permutation(c.b)[:c.live]] = True
    tids = rng.integers(0, c.t, c.b).astype(np.int32) if c.t > 1 else None
    corpus = rng.standard_normal((n_corpus, c.d), dtype=np.float32)
    return q, ids, mask, tids, corpus


def _clone(st):
    return dataclasses.replace(st, **{f: getattr(st, f).clone()
                                      for f in FIELDS})


def _assert_equal(a, b, what=""):
    for f in FIELDS:
        x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
        assert torch.equal(x, y), f"{what}: {f} differs"


def _fold_model(st, q, ids, vecs, mask, tids) -> None:
    """The kernel's three launches in numpy, on a CPU state, in place."""
    f = {n: getattr(st, n).numpy() for n in FIELDS}
    stacked = f["q_ptr"].ndim == 1
    if not stacked:
        f = {n: a[None] for n, a in f.items()}
    t_n, h = f["query_valid"].shape
    dc = f["doc_ids"].shape[1]
    b, k = ids.shape
    tid = np.zeros(b, np.int32) if tids is None else tids
    active = [(mask is None or mask[r]) for r in range(b)]
    # 1. lookup: the largest (s - d_ptr) mod Dc of a slot holding the id
    life = np.zeros(b * k, np.int64)
    for cand in range(b * k):
        r, x = cand // k, ids[cand // k, cand % k]
        if not active[r] or x < 0:
            continue
        t = tid[r]
        slots = np.flatnonzero(f["doc_ids"][t] == x)
        if len(slots):
            life[cand] = ((slots - f["d_ptr"][t]) % dc).max() + 1
    qslot, dslot = np.full(b, -1), np.full(b * k, -1)
    for t in range(t_n):
        # 2. the walk
        rows = [r for r in range(b) if active[r] and tid[r] == t]
        last, ins, n = {}, {}, 0
        for r in rows:
            made = 0
            for j in range(k):
                x = ids[r, j]
                if x < 0 or x in ids[r, :j]:
                    continue
                if life[r * k + j] - 1 < n and \
                        last.get(x, -(1 << 30)) + dc < n:
                    ins[r * k + j] = last[x] = n + made
                    made += 1
            n += made
        qp, dp = int(f["q_ptr"][t]), int(f["d_ptr"][t])
        for cand, i in ins.items():
            if i + dc >= n:
                dslot[cand] = (dp + i) % dc
        for i, r in enumerate(rows):
            if i + h >= len(rows):
                qslot[r] = (qp + i) % h
        f["q_ptr"][t] += len(rows)
        f["d_ptr"][t] += n
    # 3. the copy of each final writer, in reverse (the card keeps no
    # order: a slot written twice would keep its first writer here)
    for cand in np.flatnonzero(dslot >= 0)[::-1]:
        t, s = tid[cand // k], dslot[cand]
        f["doc_ids"][t, s] = ids[cand // k, cand % k]
        f["doc_emb"][t, s] = vecs[cand // k, cand % k]
    for r in np.flatnonzero(qslot >= 0)[::-1]:
        t, s = tid[r], qslot[r]
        f["query_emb"][t, s] = q[r]
        f["query_doc_ids"][t, s] = ids[r]
        f["query_valid"][t, s] = True


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_kernels_walk_equals_the_row_loop(name):
    """The model of the three launches leaves the plain loop's rings."""
    c = CASES[name]
    rng = np.random.default_rng(c.seed)
    st = _state(c, rng)
    q, ids, mask, tids, corpus = _chunk(c, rng, c.ids + 1)
    vecs = corpus[np.clip(ids, 0, None)]
    plain = _clone(st)
    CF.cache_fold_plain(plain, torch.from_numpy(q), torch.from_numpy(ids),
                        torch.from_numpy(vecs), None, torch.from_numpy(mask),
                        None if tids is None else torch.from_numpy(tids))
    model = _clone(st)
    _fold_model(model, q, ids, vecs, mask, tids)
    _assert_equal(plain, model, name)
    assert not torch.equal(plain.q_ptr, st.q_ptr) or c.live == 0


def _inserts(c: Case):
    """(insertions, re-insertions) of a single-tenant case's chunk, folded
    plainly: a re-insertion is an id that was in the ring earlier in the
    chunk (at its start or inserted by an earlier row) and was evicted."""
    rng = np.random.default_rng(c.seed)
    st = _state(c, rng)
    _, ids, mask, _, _ = _chunk(c, rng, c.ids + 1)
    ring, ptr = st.doc_ids.numpy().copy(), int(st.d_ptr)
    seen, n, again = set(ring[ring >= 0].tolist()), 0, 0
    for r in np.flatnonzero(mask):
        new = [x for j, x in enumerate(ids[r].tolist())
               if x >= 0 and x not in ring and x not in ids[r, :j]]
        for x in new:
            again += x in seen
            seen.add(x)
            ring[ptr % c.dc] = x
            ptr += 1
        n += len(new)
    return n, again


def test_the_hard_chunks_are_hard():
    """The chunks do what their names say, so that the equalities above
    are not met by chunks too easy to part the two."""
    assert _inserts(CASES["reinsert"])[1] >= 5
    assert _inserts(CASES["over_doc_cap"])[0] > 2 * CASES["over_doc_cap"].dc
    c = CASES["over_h_max"]
    assert c.live > 3 * c.h


def test_rows_per_call_fits_the_walks_shared_memory():
    for k in (1, 10, 33, 100):
        r = CF.rows_per_call(k)
        assert CF.walk_smem(r, k) <= CF.SMEM_MAX < CF.walk_smem(r + 1, k)
    assert CF.rows_per_call(10) >= 256             # serving chunks fit
    assert CF.hash_entries(64, 10) == 2048


def test_the_cpu_runs_the_row_loop_and_launches_nothing():
    c = CASES["wrap"]
    rng = np.random.default_rng(0)
    st = _state(c, rng)
    q, ids, mask, _, corpus = _chunk(c, rng, c.ids + 1)
    n0 = CF.cache_fold.launches
    other = _clone(st)
    args = (torch.from_numpy(q), torch.from_numpy(ids), None,
            torch.from_numpy(corpus), torch.from_numpy(mask))
    cache_fold_op(st, *args)
    cache_fold_op(other, *args, backend="torch")
    assert CF.cache_fold.launches == n0
    _assert_equal(st, other)


def _no_kernel(*a, **kw):
    raise AssertionError("the kernel wrapper was called")


@pytest.mark.parametrize("entry", ["cache_update", "cache_update_batched",
                                   "cache_update_chunked"])
def test_backend_torch_keeps_each_ingest_entry_on_the_row_loop(monkeypatch,
                                                               entry):
    """``backend="torch"`` reaches ``cache_fold_op`` from every entry (the
    kernel wrapper is never called), and the default reaches the wrapper."""
    from repro_torch.kernels import ops
    c = CASES["wrap"]
    rng = np.random.default_rng(31)
    st = _state(c, rng)
    q, ids, mask, _, corpus = _chunk(c, rng, c.ids + 1)
    vecs = corpus[np.clip(ids, 0, None)]
    cfg = pt_has.HasConfig(k=c.k, h_max=c.h, doc_capacity=c.dc, d=c.d)
    calls = {
        "cache_update": lambda s, **kw: pt_has.cache_update(
            cfg, s, q[0], ids[0], vecs[0], **kw),
        "cache_update_batched": lambda s, **kw: pt_has.cache_update_batched(
            cfg, s, q, ids, vecs, mask, **kw),
        "cache_update_chunked": lambda s, **kw: pt_has.cache_update_chunked(
            cfg, s, q, ids, vecs, chunk=3, **kw)}
    want = _clone(st)
    calls[entry](want)
    monkeypatch.setattr(ops, "cache_fold", _no_kernel)
    calls[entry](st, backend="torch")
    _assert_equal(st, want, entry)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        calls[entry](_clone(st))


@pytest.fixture(scope="module")
def tiny_service():
    from repro_torch.data.synthetic import DATASETS, SyntheticWorld, \
        WorldConfig
    from repro_torch.retrieval.service import RetrievalService
    from repro_torch.serving.latency import LatencyModel
    world = SyntheticWorld(WorldConfig(n_entities=300, d=32, seed=0))
    ds = DATASETS["granola"]
    queries = world.sample_queries(48, pattern=ds["pattern"],
                                   zipf_a=ds["zipf_a"],
                                   p_uncovered=ds["p_uncovered"], seed=1)
    return RetrievalService(world, LatencyModel(), k=10,
                            device="cpu"), queries


@pytest.mark.parametrize("engine", ["sequential", "batched", "scheduler"])
def test_the_engines_pass_their_backend_to_the_ingest(monkeypatch,
                                                      tiny_service, engine):
    """An engine made with ``backend="torch"`` ingests through the row
    loop, so that its replay stays a plain check of the kernels' run."""
    from repro_torch.kernels import ops
    from repro_torch.serving.batched import BatchedHasEngine
    from repro_torch.serving.engine import HasEngine
    from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                               SchedulerConfig)
    service, queries = tiny_service
    cfg = pt_has.HasConfig(k=10, tau=0.2, h_max=64, nprobe=4, n_buckets=32,
                           d=32)
    make = {
        "sequential": lambda b: HasEngine(service, cfg, backend=b),
        "batched": lambda b: BatchedHasEngine(service, cfg, batch_size=16,
                                              backend=b),
        "scheduler": lambda b: ContinuousBatchingScheduler(
            service, cfg, SchedulerConfig(max_spec_batch=16, full_batch=8,
                                          full_max_wait_s=0.1, backend=b))}
    monkeypatch.setattr(ops, "cache_fold", _no_kernel)
    eng = make[engine]("torch")
    folded = int(eng.state.q_ptr)
    eng.serve(queries)
    assert int(eng.state.q_ptr) > folded          # rejects were ingested
    with pytest.raises(AssertionError, match="kernel wrapper"):
        make[engine](None).serve(queries)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

SERVE = Case(h=5000, dc=50_000, k=10, d=768, b=64, ids=120_000)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in arrays]


def _card_pair(c: Case, dev, use_corpus: bool):
    """(kernel result, plain result) of one chunk on the card."""
    rng = np.random.default_rng(c.seed + 100)
    st = _state(c, rng, dev="cpu")
    st = dataclasses.replace(st, **{f: getattr(st, f).to(dev)
                                    for f in FIELDS})
    q, ids, mask, tids, corpus = _chunk(c, rng, c.ids + 1)
    q, ids, mask, tids, corpus = _on(dev, q, ids, mask, tids, corpus)
    vecs = None if use_corpus else corpus[ids.clamp_min(0).long()]
    kern, plain = _clone(st), _clone(st)
    CF.cache_fold(kern, q, ids, vecs, corpus if use_corpus else None, mask,
                  tids)
    CF.cache_fold_plain(plain, q, ids, vecs, corpus, mask, tids)
    torch.cuda.synchronize()
    return kern, plain


@pytest.mark.cuda
@pytest.mark.parametrize("live", [0, 1, 20, 64])
def test_kernel_equals_the_row_loop_at_the_serving_shape(cuda_dev, live):
    for use_corpus in (True, False):
        kern, plain = _card_pair(dataclasses.replace(SERVE, live=live,
                                                     seed=live),
                                 cuda_dev, use_corpus)
        _assert_equal(kern, plain, f"{live} rows, corpus={use_corpus}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_the_row_loop_on_the_hard_chunks(cuda_dev, name):
    for use_corpus in (True, False):
        kern, plain = _card_pair(CASES[name], cuda_dev, use_corpus)
        _assert_equal(kern, plain, f"{name}, corpus={use_corpus}")


@pytest.mark.cuda
def test_a_chunk_of_64_rows_folds_without_a_host_wait(cuda_dev):
    c = dataclasses.replace(SERVE, live=64)
    rng = np.random.default_rng(11)
    st = _state(c, rng, dev="cpu")
    st = dataclasses.replace(st, **{f: getattr(st, f).to(cuda_dev)
                                    for f in FIELDS})
    q, ids, mask, _, corpus = _chunk(c, rng, c.ids + 1)
    q, ids, mask, corpus = _on(cuda_dev, q, ids, mask, corpus)
    plain = _clone(st)
    CF.cache_fold(_clone(st), q, ids, None, corpus, mask)   # build, scratch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        CF.cache_fold(st, q, ids, None, corpus, mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    CF.cache_fold_plain(plain, q, ids, None, corpus, mask)
    _assert_equal(st, plain)


@pytest.mark.cuda
def test_three_launches_whatever_the_number_of_rows(cuda_dev):
    from torch.profiler import ProfilerActivity, profile
    kernels = {}
    for live in (1, 20, 64):
        c = dataclasses.replace(SERVE, live=live, seed=live)
        rng = np.random.default_rng(live)
        st = _state(c, rng, dev="cpu")
        st = dataclasses.replace(st, **{f: getattr(st, f).to(cuda_dev)
                                        for f in FIELDS})
        q, ids, mask, _, corpus = _chunk(c, rng, c.ids + 1)
        q, ids, mask, corpus = _on(cuda_dev, q, ids, mask, corpus)
        CF.cache_fold(_clone(st), q, ids, None, corpus, mask)   # warm
        torch.cuda.synchronize()
        # CUPTI can drop the records of a short window: take it again
        for _ in range(3):
            n0 = CF.cache_fold.launches
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(0.02)      # Kineto drops records at the edges
                CF.cache_fold(_clone(st), q, ids, None, corpus, mask)
                torch.cuda.synchronize()
                time.sleep(0.02)
            assert CF.cache_fold.launches - n0 == CF.LAUNCHES
            kernels[live] = sorted(e.name for e in prof.events()
                                   if e.device_type.name == "CUDA"
                                   and "fold_" in e.name)
            if len(kernels[live]) >= CF.LAUNCHES:
                break
    assert len(kernels[1]) == CF.LAUNCHES, kernels[1]
    assert kernels[1] == kernels[20] == kernels[64], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("rows_per_call", [None, 5])
def test_rows_past_rows_per_call_fold_in_slices(cuda_dev, monkeypatch,
                                                rows_per_call):
    """A call with more rows than one walk holds (700 at k=10, past 611;
    and 20 rows of a hard chunk in slices of 5) folds them slice after
    slice, three launches each, equal to the row loop."""
    if rows_per_call is None:
        c = dataclasses.replace(SERVE, b=700, live=650, seed=41)
        assert c.b > CF.rows_per_call(c.k)
    else:
        c = CASES["tenants4"]
        monkeypatch.setattr(CF, "rows_per_call", lambda k: rows_per_call)
    step = CF.rows_per_call(c.k)
    for use_corpus in (True, False):
        n0 = CF.cache_fold.launches
        kern, plain = _card_pair(c, cuda_dev, use_corpus)
        assert CF.cache_fold.launches - n0 == \
            CF.LAUNCHES * -(-c.b // step)
        _assert_equal(kern, plain, f"{c.b} rows in slices of {step}, "
                                   f"corpus={use_corpus}")


@pytest.mark.cuda
def test_backend_torch_on_the_card_launches_nothing(cuda_dev):
    """On a card state ``backend="torch"`` runs the row loop: no launch,
    no ``fold_rows``, the kernel's rings."""
    c = dataclasses.replace(SERVE, b=40)
    rng = np.random.default_rng(51)
    cpu = _state(c, rng)
    st = dataclasses.replace(cpu, **{f: getattr(cpu, f).to(cuda_dev)
                                     for f in FIELDS})
    q, ids, _, _, corpus = _chunk(c, rng, c.ids + 1)
    cfg = pt_has.HasConfig(k=c.k, h_max=c.h, doc_capacity=c.dc, d=c.d)
    on_card = torch.from_numpy(corpus).to(cuda_dev)
    kern = _clone(st)
    pt_has.cache_update_chunked(cfg, kern, q, ids, corpus=on_card, chunk=32)
    n0 = CF.cache_fold.launches
    with dispatch.span("ingest") as sp:
        pt_has.cache_update_chunked(cfg, st, q, ids, corpus=on_card,
                                    chunk=32, backend="torch")
    torch.cuda.synchronize()
    assert CF.cache_fold.launches == n0
    assert "fold_rows" not in sp.counts
    _assert_equal(st, kern)


@pytest.mark.cuda
def test_the_serving_entry_uploads_a_chunk_once(cuda_dev):
    """``cache_update_chunked`` from host rows and a device corpus: one
    upload a chunk, ``fold_rows`` the rows folded, and the rings that the
    same call leaves on the CPU (the row loop)."""
    c = dataclasses.replace(SERVE, b=50)
    rng = np.random.default_rng(21)
    cpu = _state(c, rng)
    st = dataclasses.replace(cpu, **{f: getattr(cpu, f).to(cuda_dev)
                                     for f in FIELDS})
    q, ids, _, _, corpus = _chunk(c, rng, c.ids + 1)
    cfg = pt_has.HasConfig(k=c.k, h_max=c.h, doc_capacity=c.dc, d=c.d)
    on_card = torch.from_numpy(corpus).to(cuda_dev)
    pt_has.cache_update_chunked(cfg, _clone(st), q, ids, corpus=on_card,
                                chunk=32)                      # warm
    with dispatch.span("ingest") as sp:
        pt_has.cache_update_chunked(cfg, st, q, ids, corpus=on_card,
                                    chunk=32)
    pt_has.cache_update_chunked(cfg, cpu, q, ids,
                                corpus=torch.from_numpy(corpus), chunk=32)
    torch.cuda.synchronize()
    assert sp.counts == {"host_syncs": 2, "fold_rows": 50}
    _assert_equal(st, cpu)
