"""HaS pipeline state + two-channel speculation (paper §II-B, Algorithm 1).

The state lives in fixed-shape tensors on one device:
  * query cache P = (query_emb [H,d], query_doc_ids [H,k], query_valid [H])
    — a FIFO ring (the paper's FIFO replacement policy) with pointer q_ptr;
  * cache channel C_c = FIFO ring of *deduplicated* documents previously
    retrieved from the full database (doc_emb [Dc,d], doc_ids [Dc]);
  * fuzzy channel C_f = an aggressively configured IVFIndex
    (retrieval/ivf.py), optionally subset-compressed (Table VII).

``speculate_batch`` runs [B, d] queries through the two channels, the
channel merge and homology validation behind ``backend="cuda" | "torch"``
(``kernels/ops.py``).  ``"cuda"`` sends the cache channel to the
``topk_search`` kernel, the fuzzy channel's bucket scan to ``ivf_scan`` and
validation, with its best row, to ``homology_validate`` (the
``homology_score`` kernel); ``"torch"`` runs their plain versions.
``None`` follows the state's device.  ``speculate`` and
``speculate_batched`` are the reference's legacy entries over the same
path.  ``cache_update`` folds one full retrieval into the rings
(Algorithm 1 line 16); ``cache_update_batched`` folds several in order,
and ``cache_update_chunked`` pads host rows to one chunk shape first.  All
three upload their host rows in one copy and fold them through
``cache_fold_op`` (``kernels/cache_fold.py``: on the card three launches
that the host does not wait for; on the CPU the row loop).

Multi-tenant partitioning: :func:`init_tenant_states` stacks T independent
stores into one ``[T, ...]`` state (per-tenant ``q_ptr``/``d_ptr``), and
every batch entry point takes an optional ``tenant_ids [B]``: speculation
flattens the doc ring to ``[T*Dc]`` and the query cache to ``[T*H]`` rows
tagged with their tenant and masks the rows of other tenants (the kernels'
group masks), and the updates write into each row's tenant through the
views of :func:`tenant_slice`.  ``intra_batch_share`` elects leaders
among a batch's rejected drafts, never across tenants.

Fused-list speculation (``HasConfig.fusion == "rrf"``): both channels merge
in rank domain (``_rrf_merge``: mass ``1/(rrf_k + rank)``, cross-channel
duplicates combined onto the first occurrence) and validation weighs each
draft slot by its normalized RRF mass.  ``fusion="score"`` is the
score-domain dedup merge.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.homology import rrf_draft_weights
from repro_torch.kernels.ops import (cache_fold_op, check_backend,
                                     homology_score_op, homology_validate_op,
                                     ivf_scan_op, topk_search_op)
from repro_torch.retrieval.ivf import IVFIndex, probe_buckets
from repro_torch.utils import (as_f32, as_i32, host_array, resolve_device,
                               stable_topk, upload)


@dataclasses.dataclass(frozen=True)
class HasConfig:
    k: int = 10                    # documents per retrieval (draft size)
    tau: float = 0.2               # homology threshold
    h_max: int = 5000              # query-cache capacity (paper default)
    doc_capacity: int = 0          # doc-store slots; 0 -> h_max * k
    nprobe: int = 64               # fuzzy channel buckets probed
    n_buckets: int = 8192          # fuzzy channel total buckets
    use_fuzzy_validation: bool = True    # Table VI 'V'
    use_fuzzy_enhancement: bool = True   # Table VI 'E'
    d: int = 64                    # embedding dim
    fusion: str = "score"          # channel merge: "score" | "rrf"
    rrf_k: float = 60.0            # RRF rank constant (fusion == "rrf")

    @property
    def doc_cap(self) -> int:
        return self.doc_capacity or self.h_max * self.k


@dataclasses.dataclass
class HasState:
    query_emb: torch.Tensor      # [H, d] f32
    query_doc_ids: torch.Tensor  # [H, k] int32
    query_valid: torch.Tensor    # [H] bool
    q_ptr: torch.Tensor          # scalar int32
    doc_emb: torch.Tensor        # [Dc, d] f32
    doc_ids: torch.Tensor        # [Dc] int32 (-1 = empty)
    d_ptr: torch.Tensor          # scalar int32

    @property
    def device(self) -> torch.device:
        return self.doc_emb.device


def init_has_state(cfg: HasConfig, device=None,
                   dtype=torch.float32) -> HasState:
    """Empty rings on ``device`` (CUDA unless asked; raises without one)."""
    dev = resolve_device(device)
    return HasState(
        query_emb=torch.zeros((cfg.h_max, cfg.d), dtype=dtype, device=dev),
        query_doc_ids=torch.full((cfg.h_max, cfg.k), -1, dtype=torch.int32,
                                 device=dev),
        query_valid=torch.zeros((cfg.h_max,), dtype=torch.bool, device=dev),
        q_ptr=torch.zeros((), dtype=torch.int32, device=dev),
        doc_emb=torch.zeros((cfg.doc_cap, cfg.d), dtype=dtype, device=dev),
        doc_ids=torch.full((cfg.doc_cap,), -1, dtype=torch.int32, device=dev),
        d_ptr=torch.zeros((), dtype=torch.int32, device=dev),
    )


def init_tenant_states(cfg: HasConfig, n_tenants: int, device=None,
                       dtype=torch.float32) -> HasState:
    """Tenant-partitioned store: a stacked ``[T, ...]`` :class:`HasState`.

    Every tensor gains a leading tenant axis (``q_ptr``/``d_ptr`` become
    ``[T]``), so each tenant owns a query cache and doc ring of the full
    per-tenant capacity (``h_max`` / ``doc_cap`` EACH).  ``n_tenants == 1``
    gives the single-tenant results on a ``[1, ...]`` store.
    """
    if n_tenants < 1:
        raise ValueError(f"n_tenants must be >= 1, got {n_tenants}")
    one = init_has_state(cfg, device, dtype)
    return HasState(**{
        f.name: getattr(one, f.name).expand(
            n_tenants, *getattr(one, f.name).shape).clone()
        for f in dataclasses.fields(HasState)})


def tenant_count(state: HasState) -> int:
    """Number of tenant partitions (1 for an unstacked single-tenant state)."""
    return state.q_ptr.shape[0] if state.q_ptr.ndim else 1


def tenant_slice(state: HasState, t: int) -> HasState:
    """Tenant t's partition as an unstacked state of VIEWS: an in-place
    update of the slice writes into the stacked store."""
    return HasState(**{f.name: getattr(state, f.name)[t]
                       for f in dataclasses.fields(HasState)})


def _check_stacked(state: HasState, tagged: bool, what: str) -> None:
    """The reference's errors for a stacked state without tenant tags and
    for tags on an unstacked state."""
    if not tagged and state.q_ptr.ndim != 0:
        raise ValueError(
            f"stacked tenant state requires {what} (or slice one tenant out "
            f"with tenant_slice)")
    if tagged and state.q_ptr.ndim != 1:
        raise ValueError(f"{what} requires a stacked init_tenant_states "
                         f"state")


# ---------------------------------------------------------------------------
# Two-channel fast retrieval + homology validation
# ---------------------------------------------------------------------------

def _dedup_merge(s_a, i_a, s_b, i_b, k: int):
    """Merge two candidate lists [B, *], dropping b-entries duplicated in a.

    A dup-masked (or bucket-starved) entry carries -inf but may keep a stale
    id; it is normalized to -1 so validation never counts phantom overlaps.
    """
    dup = (i_b[:, :, None] == i_a[:, None, :]).any(dim=2) & (i_b >= 0)
    s = torch.cat([s_a, s_b.masked_fill(dup, -torch.inf)], dim=1)
    i = torch.cat([i_a, i_b], dim=1)
    ts, t = stable_topk(s, k)
    ids = torch.gather(i, 1, t.clamp_min(0))
    return ts, torch.where(torch.isfinite(ts), ids, -1)


def _rrf_merge(i_a, i_b, k: int, rrf_k: float):
    """Rank-domain RRF merge of two candidate lists [B, *].

    Every slot contributes mass ``1/(rrf_k + rank)`` within its channel;
    ids in both channels sum their mass onto the FIRST occurrence (the
    duplicate carries 0 and never wins), and the merged top-k is ordered by
    total mass.  Empty slots return (-inf, -1).
    """
    ka, kb = i_a.shape[1], i_b.shape[1]
    dev = i_a.device
    ids = torch.cat([i_a, i_b], dim=1)                         # [B, K]
    rank = torch.cat([torch.arange(ka, device=dev),
                      torch.arange(kb, device=dev)]).to(torch.float32)
    pos = torch.arange(ka + kb, device=dev)
    valid = ids >= 0
    raw = torch.where(valid, 1.0 / (rrf_k + rank), 0.0)       # [B, K]
    same = ((ids[:, :, None] == ids[:, None, :])
            & valid[:, :, None] & valid[:, None, :])          # [B, K, K]
    first = ~(same & (pos[None, :] < pos[:, None])).any(dim=2)
    mass = torch.where(same, raw[:, None, :], 0.0).sum(dim=2)
    mass = torch.where(first & valid, mass, 0.0)
    ts, t = stable_topk(mass, k)
    top = ts > 0
    return (torch.where(top, ts, -torch.inf),
            torch.where(top, torch.gather(ids, 1, t), -1))


def _channel_merge(cfg: HasConfig):
    if cfg.fusion == "rrf":
        return lambda sa, ia, sb, ib: _rrf_merge(ia, ib, cfg.k, cfg.rrf_k)
    if cfg.fusion == "score":
        return lambda sa, ia, sb, ib: _dedup_merge(sa, ia, sb, ib, cfg.k)
    raise ValueError(f"unknown fusion mode {cfg.fusion!r}")


def _speculate(cfg: HasConfig, state: HasState, index: IVFIndex, q_embs,
               backend: str | None, tenant_ids=None) -> dict:
    dev = state.device
    check_backend(backend)
    q = as_f32(q_embs, dev)
    doc_emb, doc_ids = state.doc_emb, state.doc_ids
    cache_ids, cache_valid = state.query_doc_ids, state.query_valid
    ring_groups = cache_groups = {}
    if tenant_ids is not None:
        # flat rings: tenant t's rows at [t*Dc, (t+1)*Dc) and [t*H, (t+1)*H),
        # each masked for the queries of other tenants
        t, dc = doc_ids.shape
        h = cache_valid.shape[1]
        doc_emb, doc_ids = doc_emb.reshape(t * dc, -1), doc_ids.reshape(-1)
        cache_ids = cache_ids.reshape(t * h, cfg.k)
        cache_valid = cache_valid.reshape(-1)
        q_group = as_i32(tenant_ids, dev)
        tenant = torch.arange(t, dtype=torch.int32, device=dev)
        ring_groups = dict(row_group=tenant.repeat_interleave(dc),
                           q_group=q_group)
        cache_groups = dict(row_group=tenant.repeat_interleave(h),
                            q_group=q_group)

    # cache channel: exact top-k over the doc ring (empty slots masked)
    s_c, slots = topk_search_op(q, doc_emb, cfg.k, valid=doc_ids >= 0,
                                backend=backend, **ring_groups)
    i_c = torch.where(torch.isfinite(s_c),
                      doc_ids[slots.clamp_min(0).long()], -1)

    # fuzzy channel: centroid top-nprobe (a plain product), then the scan
    probe = probe_buckets(index, q, cfg.nprobe)
    s_f, i_f = ivf_scan_op(q, probe, index.bucket_vecs, index.bucket_ids,
                           cfg.k, backend=backend)

    merged = _channel_merge(cfg)(s_c, i_c, s_f, i_f) \
        if cfg.use_fuzzy_validation or cfg.use_fuzzy_enhancement else None
    s_val, i_val = merged if cfg.use_fuzzy_validation else (s_c, i_c)
    s_out, i_out = merged if cfg.use_fuzzy_enhancement else (s_c, i_c)

    w_val = rrf_draft_weights(i_val, cfg.rrf_k) \
        if cfg.fusion == "rrf" else None
    # each draft's first maximal row and its score (one launch on CUDA);
    # under tenants the row is flat over [T*H], row 0 when none scores
    _, best, slot = homology_validate_op(i_val, cache_ids, cache_valid,
                                         draft_weights=w_val, backend=backend,
                                         **cache_groups)
    accept = best > torch.tensor(cfg.tau, dtype=torch.float32)

    return {"draft_ids": i_out, "draft_scores": s_out,
            "val_ids": i_val, "accept": accept,
            "homology": best, "matched_slot": slot}


def speculate_batch(cfg: HasConfig, state: HasState, index: IVFIndex,
                    q_embs, backend: str | None = None,
                    tenant_ids=None) -> dict:
    """Batch-native speculation (Algorithm 1 lines 1-14) for [B, d] queries.

    Returns dict of [B]-leading tensors: draft_ids / draft_scores (the
    output draft), val_ids (the draft validated), accept, homology (best
    score) and matched_slot (its first maximal cache row).

    ``tenant_ids [B]`` (optional) routes each query through its tenant's
    partition of a stacked :func:`init_tenant_states` store; the fuzzy
    channel is shared.  ``matched_slot`` is then flat over ``[T*H]``
    (tenant t's slot s at ``t * h_max + s``).
    """
    dispatch.record("speculate_batch")
    _check_stacked(state, tenant_ids is not None, "tenant_ids")
    return _speculate(cfg, state, index, q_embs, backend, tenant_ids)


def speculate(cfg: HasConfig, state: HasState, index: IVFIndex, q_emb,
              backend: str | None = None) -> dict:
    """One speculative retrieval for a query [d]: :func:`speculate_batch`'s
    dict without the batch axis."""
    dispatch.record("speculate")
    _check_stacked(state, False, "tenant_ids")
    out = _speculate(cfg, state, index, as_f32(q_emb, state.device)[None],
                     backend)
    return {key: v[0] for key, v in out.items()}


def speculate_batched(cfg: HasConfig, state: HasState, index: IVFIndex,
                      q_embs, backend: str | None = None) -> dict:
    """The reference's legacy batch lifting of :func:`speculate`: the same
    results as :func:`speculate_batch`."""
    dispatch.record("speculate_batched")
    _check_stacked(state, False, "tenant_ids")
    return _speculate(cfg, state, index, q_embs, backend)


# ---------------------------------------------------------------------------
# Intra-batch homology sharing (continuous-batching acceptance channel)
# ---------------------------------------------------------------------------

def intra_batch_share(val_ids, rejected, tau: float, pending=None,
                      tenant_ids=None, backend: str | None = None) -> dict:
    """Greedy leader election among the rejected drafts of a full batch.

    ``val_ids [B, k]`` are the validation drafts, ``rejected [B]`` marks
    queries awaiting a full retrieval.  Scanning in admission order, each
    rejected query becomes a *leader* (pays one full retrieval) or a
    *follower* of the best earlier leader with homology > tau.
    ``pending [B]`` marks rows that are already leaders of unresolved
    retrievals: they stay leaders and can be followed.  ``tenant_ids [B]``
    scores cross-tenant pairs -1, so no follower crosses tenants.

    The pairwise scores ``s(q_i, q_j)`` are the ``homology_score`` kernel
    on the card (drafts against drafts, columns neither rejected nor
    pending scoring 0); the serial scan over B rows then runs on the host
    over one copy of that ``[B, B]`` matrix, comparing the same f32
    values with ``tau`` in f32.  Returns dict(is_leader [B] bool,
    leader [B] int32, share_score [B] f32) on ``val_ids``' device: rows
    neither rejected nor pending keep leader[i] == i, is_leader False.
    """
    dev = val_ids.device
    b = val_ids.shape[0]
    rej = torch.as_tensor(rejected, dtype=torch.bool, device=dev)
    pend = (torch.zeros_like(rej) if pending is None
            else torch.as_tensor(pending, dtype=torch.bool, device=dev))
    scores = homology_score_op(val_ids, val_ids, rej | pend,
                               backend=backend).cpu().numpy()
    if tenant_ids is not None:
        tids = np.asarray(torch.as_tensor(tenant_ids).cpu())
        scores = np.where(tids[:, None] == tids[None, :], scores,
                          np.float32(-1.0))
    rej, pend = rej.cpu().numpy(), pend.cpu().numpy()
    tau = np.float32(tau)
    is_leader = pend.copy()
    leader = np.arange(b, dtype=np.int32)
    share = np.zeros(b, np.float32)
    for i in range(b):
        s = np.where(is_leader & (np.arange(b) < i), scores[i],
                     np.float32(-1.0))
        best = int(np.argmax(s))
        follow = bool(rej[i] and not pend[i] and s[best] > tau)
        is_leader[i] = (rej[i] and not follow) or pend[i]
        if follow:
            leader[i], share[i] = best, s[best]
    return {"is_leader": torch.as_tensor(is_leader, device=dev),
            "leader": torch.as_tensor(leader, device=dev),
            "share_score": torch.as_tensor(share, device=dev)}


# ---------------------------------------------------------------------------
# Cache update on rejection (Algorithm 1 line 16)
# ---------------------------------------------------------------------------

def _check_tenants(state: HasState, tenant_ids) -> None:
    """The reference's range check of tenant tags."""
    n = state.q_ptr.shape[0]
    for t in tenant_ids:
        if not 0 <= t < n:
            raise ValueError(f"tenant_id {t} out of range for {n} tenants")


def _tenant(state: HasState, t) -> HasState:
    """Tenant t's views, after the reference's range check."""
    t = int(t)
    _check_tenants(state, [t])
    return tenant_slice(state, t)


def _fold(state: HasState, q_embs, full_ids, full_vecs, corpus, mask,
          tenant_ids, rows: int, backend: str | None) -> None:
    """Upload a chunk's host rows in one copy and fold them
    (``cache_fold_op``); ``rows`` is the number of unmasked rows."""
    dev = state.device
    if corpus is not None and isinstance(full_ids, np.ndarray) and \
            full_ids.size and full_ids.max() >= corpus.shape[0]:
        raise IndexError(f"cache update: doc id {full_ids.max()} is past "
                         f"the corpus's {corpus.shape[0]} rows")
    q, ids, vecs, m, tids = upload(
        dev, (q_embs, torch.float32), (full_ids, torch.int32),
        (full_vecs, torch.float32), (mask, torch.bool),
        (tenant_ids, torch.int32))
    cache_fold_op(state, q, ids, vecs, corpus, m, tids, backend=backend)
    if dev.type == "cuda" and check_backend(backend) != "torch":
        dispatch.count("fold_rows", rows)


def cache_update(cfg: HasConfig, state: HasState, q_emb, full_ids,
                 full_vecs, tenant_id=None, *,
                 backend: str | None = None) -> HasState:
    """Insert (q, D_full) into P and the new docs into C_c (FIFO, dedup).

    Updates ``state``'s tensors IN PLACE (where the reference donates its
    buffers and returns new ones) and returns the same ``state``.
    ``tenant_id`` (optional) targets one partition of a stacked
    :func:`init_tenant_states` store; the others are untouched.  One row
    of :func:`cache_update_batched`'s fold; ``backend`` is the kernel
    switch of ``cache_fold_op`` (None: by device).
    """
    dispatch.record("cache_update")
    _check_stacked(state, tenant_id is not None, "tenant_id")
    target = state if tenant_id is None else _tenant(state, tenant_id)
    k, d = target.query_doc_ids.shape[-1], target.doc_emb.shape[-1]
    _fold(target, _reshape(q_emb, 1, d), _reshape(full_ids, 1, k),
          _reshape(full_vecs, 1, k, d), None, None, None, 1, backend)
    return state


def _reshape(x, *shape):
    return (x if isinstance(x, torch.Tensor) else np.asarray(x)) \
        .reshape(shape)


def cache_update_batched(cfg: HasConfig, state: HasState, q_embs, full_ids,
                         full_vecs=None, mask=None, tenant_ids=None, *,
                         corpus=None, backend: str | None = None) -> HasState:
    """Fold a full-retrieval batch into the cache, in place.

    q_embs [B,d], full_ids [B,k], and full_vecs [B,k,d] or a device
    ``corpus`` to read them from by id; ``mask [B]`` (optional) marks real
    rows (masked rows leave the state untouched).  Equal to folding
    :func:`cache_update` over the unmasked rows in order; ``tenant_ids
    [B]`` (optional) sends each row into its tenant's partition of a
    stacked store.  The host arrays go to the card in one copy; on CUDA
    the fold is ``csrc/cache_fold.cu``'s three launches, which the host
    does not wait for (``kernels/cache_fold.py``), unless ``backend`` is
    ``"torch"``.
    """
    dispatch.record("cache_update_batched")
    _check_stacked(state, tenant_ids is not None, "tenant_ids")
    dev = state.device
    if mask is not None:
        mask = host_array(mask, dev).astype(bool)
    rows = np.arange(len(q_embs)) if mask is None else np.flatnonzero(mask)
    if tenant_ids is not None:
        tenant_ids = host_array(tenant_ids, dev).astype(np.int32)
        _check_tenants(state, tenant_ids[rows].tolist())
    _fold(state, q_embs, full_ids, full_vecs, corpus, mask, tenant_ids,
          len(rows), backend)
    return state


def cache_update_chunked(cfg: HasConfig, state: HasState, q_embs, full_ids,
                         full_vecs=None, *, corpus=None, chunk: int,
                         tenant_ids=None,
                         backend: str | None = None) -> HasState:
    """Fold N host-side update rows through :func:`cache_update_batched`.

    Rows go in chunks of ``chunk``, and EVERY chunk, the last partial one
    too, is zero-padded to ``[chunk, ...]`` with masked rows (the
    reference's one-shape contract, which the serving layers rely on).
    ``q_embs [N, d]`` and ``full_ids [N, k]`` are host arrays; pass either
    ``full_vecs [N, k, d]`` or a device ``corpus`` that the fold reads
    them from by id.  ``tenant_ids [N]`` (optional) sends each row into
    its tenant's partition; pad rows carry tenant 0.  ``backend`` goes
    to ``cache_fold_op``.
    """
    q_embs = np.asarray(q_embs, np.float32)
    full_ids = np.asarray(full_ids, np.int32)
    n, k, d = len(q_embs), full_ids.shape[1], q_embs.shape[1]
    if full_vecs is not None:
        full_vecs = np.asarray(full_vecs, np.float32)
        corpus = None
    if tenant_ids is not None:
        tenant_ids = np.asarray(tenant_ids, np.int32)
    for i0 in range(0, n, chunk):
        m = min(chunk, n - i0)
        embs = np.zeros((chunk, d), np.float32)
        ids = np.zeros((chunk, k), np.int32)
        mask = np.zeros((chunk,), bool)
        embs[:m] = q_embs[i0:i0 + m]
        ids[:m] = full_ids[i0:i0 + m]
        mask[:m] = True
        vecs = None
        if full_vecs is not None:
            vecs = np.zeros((chunk, k, d), np.float32)
            vecs[:m] = full_vecs[i0:i0 + m]
        tids = None
        if tenant_ids is not None:
            tids = np.zeros((chunk,), np.int32)
            tids[:m] = tenant_ids[i0:i0 + m]
        state = cache_update_batched(cfg, state, embs, ids, vecs, mask,
                                     tenant_ids=tids, corpus=corpus,
                                     backend=backend)
    return state


def cache_memory_bytes(cfg: HasConfig) -> int:
    """Memory footprint of the cache (Table IX 'Mem' column)."""
    d = cfg.d
    per_query = d * 4 + cfg.k * 4 + 1
    per_doc = d * 4 + 4
    return cfg.h_max * per_query + cfg.doc_cap * per_doc


def speculation_bytes_moved(cfg: HasConfig, n_buckets: int, bucket_cap: int,
                            b: int, backend: str) -> int:
    """Analytic device-memory traffic of one ``speculate_batch`` call.

    Shared terms: the centroid product reads [C, d] once and validation
    reads the [H, k] id table once.  ``"cuda"``: the kernels stream the doc
    ring once whatever B and read each probed bucket once.  ``"torch"``:
    the plain cache channel writes and re-reads a [B, Dc] score matrix, and
    the plain bucket scan gathers [B, nprobe, cap, d] (written, then read
    again to score), tripling the bucket traffic.
    """
    d, k = cfg.d, cfg.k
    nprobe = min(cfg.nprobe, n_buckets)
    common = n_buckets * d * 4 + cfg.h_max * k * 4
    doc_stream = cfg.doc_cap * d * 4
    bucket_read = b * nprobe * bucket_cap * d * 4
    if check_backend(backend) == "cuda":
        return common + doc_stream + bucket_read
    if backend != "torch":
        raise ValueError("speculation_bytes_moved needs backend='cuda' or "
                         "'torch'")
    score_mat = 2 * b * cfg.doc_cap * 4          # write + re-read
    return common + doc_stream + score_mat + 3 * bucket_read
