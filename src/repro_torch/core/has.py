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
validation to ``homology_score``; ``"torch"`` runs their plain versions.
``None`` follows the state's device.  ``cache_update`` folds one full
retrieval into the rings (Algorithm 1 line 16); ``cache_update_batched``
folds several in order.

Fused-list speculation (``HasConfig.fusion == "rrf"``): both channels merge
in rank domain (``_rrf_merge``: mass ``1/(rrf_k + rank)``, cross-channel
duplicates combined onto the first occurrence) and validation weighs each
draft slot by its normalized RRF mass.  ``fusion="score"`` is the
score-domain dedup merge.

Not ported yet: tenant-partitioned states, ``intra_batch_share``,
``cache_update_chunked`` and the legacy ``speculate`` /
``speculate_batched``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dispatch
from repro_torch.core.homology import rrf_draft_weights
from repro_torch.kernels.ops import (homology_score_op, ivf_scan_op,
                                     check_backend, topk_search_op)
from repro_torch.retrieval.ivf import IVFIndex, probe_buckets
from repro_torch.utils import (as_f32, as_i32, first_argmax, resolve_device,
                               stable_topk)


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


def speculate_batch(cfg: HasConfig, state: HasState, index: IVFIndex,
                    q_embs, backend: str | None = None) -> dict:
    """Batch-native speculation (Algorithm 1 lines 1-14) for [B, d] queries.

    Returns dict of [B]-leading tensors: draft_ids / draft_scores (the
    output draft), val_ids (the draft validated), accept, homology (best
    score) and matched_slot (its first maximal cache row).
    """
    dispatch.record("speculate_batch")
    dev = state.device
    check_backend(backend)
    q = as_f32(q_embs, dev)

    # cache channel: exact top-k over the doc ring (empty slots masked)
    s_c, slots = topk_search_op(q, state.doc_emb, cfg.k,
                                valid=state.doc_ids >= 0, backend=backend)
    i_c = torch.where(torch.isfinite(s_c),
                      state.doc_ids[slots.clamp_min(0).long()], -1)

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
    scores = homology_score_op(i_val, state.query_doc_ids, state.query_valid,
                               draft_weights=w_val, backend=backend)
    slot = first_argmax(scores)                                # [B]
    best = torch.gather(scores, 1, slot[:, None])[:, 0]
    accept = best > torch.tensor(cfg.tau, dtype=torch.float32)

    return {"draft_ids": i_out, "draft_scores": s_out,
            "val_ids": i_val, "accept": accept,
            "homology": best, "matched_slot": slot.to(torch.int32)}


# ---------------------------------------------------------------------------
# Cache update on rejection (Algorithm 1 line 16)
# ---------------------------------------------------------------------------

def _cache_update_rows(cfg: HasConfig, state: HasState, q_emb, full_ids,
                       full_vecs) -> None:
    h = cfg.h_max
    dc = state.doc_ids.shape[0]
    slot = (state.q_ptr % h).long()
    state.query_emb[slot] = q_emb
    state.query_doc_ids[slot] = full_ids
    state.query_valid[slot] = True

    # doc dedup: only insert ids not already in the store AND not duplicated
    # earlier in this full result (first occurrence wins)
    present = (full_ids[:, None] == state.doc_ids[None, :]).any(dim=1)
    pos_in = torch.arange(full_ids.shape[0], device=full_ids.device)
    dup_in_batch = ((full_ids[:, None] == full_ids[None, :])
                    & (pos_in[None, :] < pos_in[:, None])).any(dim=1)
    new = ~present & ~dup_in_batch & (full_ids >= 0)
    offs = torch.cumsum(new.to(torch.int32), dim=0) - 1
    pos = ((state.d_ptr + offs) % dc).long()
    # the reference scatters non-new rows to index Dc with mode="drop";
    # here they are masked out (an out-of-range index would fault)
    state.doc_ids[pos[new]] = full_ids[new]
    state.doc_emb[pos[new]] = full_vecs[new]
    state.d_ptr += new.sum(dtype=torch.int32)
    state.q_ptr += 1


def cache_update(cfg: HasConfig, state: HasState, q_emb, full_ids,
                 full_vecs) -> HasState:
    """Insert (q, D_full) into P and the new docs into C_c (FIFO, dedup).

    Updates ``state``'s tensors IN PLACE (where the reference donates its
    buffers and returns new ones) and returns the same ``state``.
    """
    dispatch.record("cache_update")
    dev = state.device
    _cache_update_rows(cfg, state, as_f32(q_emb, dev).reshape(-1),
                       as_i32(full_ids, dev).reshape(-1),
                       as_f32(full_vecs, dev))
    return state


def cache_update_batched(cfg: HasConfig, state: HasState, q_embs, full_ids,
                         full_vecs, mask=None) -> HasState:
    """Fold a full-retrieval batch into the cache, in place.

    q_embs [B,d], full_ids [B,k], full_vecs [B,k,d]; ``mask [B]`` (optional)
    marks real rows (masked rows leave the state untouched).  Equal to
    folding :func:`cache_update` over the unmasked rows in order.
    """
    dispatch.record("cache_update_batched")
    dev = state.device
    q_embs = as_f32(q_embs, dev)
    full_ids = as_i32(full_ids, dev)
    full_vecs = as_f32(full_vecs, dev)
    rows = range(q_embs.shape[0]) if mask is None else \
        torch.as_tensor(mask, dtype=torch.bool).cpu().nonzero()[:, 0].tolist()
    for i in rows:
        _cache_update_rows(cfg, state, q_embs[i], full_ids[i], full_vecs[i])
    return state


def cache_memory_bytes(cfg: HasConfig) -> int:
    """Memory footprint of the cache (Table IX 'Mem' column)."""
    d = cfg.d
    per_query = d * 4 + cfg.k * 4 + 1
    per_doc = d * 4 + 4
    return cfg.h_max * per_query + cfg.doc_cap * per_doc
