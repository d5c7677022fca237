"""The fold of full retrievals into the HaS rings (Algorithm 1 line 16):
kernel + plain.

``cache_fold`` replaces no Pallas kernel: the JAX package folds a batch by
``lax.scan`` over ``_cache_update_impl`` (``src/repro/core/has.py:577-599``).
It writes a chunk of rows ``q_embs [B,d]``, ``full_ids [B,k]`` (with their
doc rows ``full_vecs [B,k,d]``, or read by id from ``corpus [N,d]``) into
the rings of ``state`` (a ``HasState``: one tenant, or a stacked
``[T, ...]`` store with ``tenant_ids [B]``), IN PLACE, equal to folding the
unmasked rows (``mask [B]``) one after another in order: each row writes
its query slot, then appends, in result order, each id that is not
negative, not in the doc ring at the row's start and not earlier in the
row; both pointers count up without wrapping.

On a CUDA state it launches the three kernels of ``csrc/cache_fold.cu``
(lookup, walk, copy) on the current stream and returns without waiting for
the card; on a CPU state it runs :func:`cache_fold_plain`, the row loop.
Inputs must already lie on the state's device.  One launch of the walk
takes at most ``rows_per_call(k)`` rows (611 at k=10: it holds every
candidate in shared memory); a call with more folds them in slices of
that many, in order, three launches a slice.  ``cache_fold.launches``
counts the kernel launches.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.kernels import _build
from repro_torch.utils import host_array

LAUNCHES = 3                  # lookup, walk, copy
SMEM_MAX = 226 * 1024         # the walk's dynamic shared memory, at most


def _fold_row(state, q_emb, full_ids, full_vecs) -> None:
    h = state.query_valid.shape[0]
    dc = state.doc_ids.shape[0]
    dev = state.doc_ids.device
    slot = (state.q_ptr % h).long()
    state.query_emb[slot] = q_emb
    state.query_doc_ids[slot] = full_ids
    state.query_valid[slot] = True
    # indexing by the device scalar ``slot`` reads it to the host: a sync
    # in each of the three writes, and one more for the ``True`` written
    # (counted once a block: a count costs about 1 us of host)
    dispatch.count_syncs(dev, 4)

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
    dispatch.count_syncs(dev, 4)            # two boolean masks a write
    state.d_ptr += new.sum(dtype=torch.int32)
    state.q_ptr += 1


def cache_fold_plain(state, q_embs: torch.Tensor, full_ids: torch.Tensor,
                     full_vecs: torch.Tensor | None = None,
                     corpus: torch.Tensor | None = None, mask=None,
                     tenant_ids=None) -> None:
    """The row loop: :func:`_fold_row` over the unmasked rows in order,
    each into its tenant's views (module docstring)."""
    from repro_torch.core.has import tenant_slice
    dev = state.doc_ids.device
    if full_vecs is None:
        full_vecs = corpus[full_ids.clamp_min(0).long()]
    rows = range(q_embs.shape[0]) if mask is None else \
        np.flatnonzero(host_array(mask, dev)).tolist()
    tids = None if tenant_ids is None else \
        host_array(tenant_ids, dev).tolist()
    for i in rows:
        target = state if tids is None else tenant_slice(state, tids[i])
        _fold_row(target, q_embs[i], full_ids[i], full_vecs[i])


def hash_entries(rows: int, k: int) -> int:
    """The walk's hash table: a power of two >= 2 * rows * k (and >= 32)."""
    return max(32, 1 << max(0, 2 * rows * k - 1).bit_length())


def walk_smem(rows: int, k: int) -> int:
    """Bytes of the walk's dynamic shared memory for ``rows`` rows of k."""
    return 4 * (4 * rows * k + rows + 2 * hash_entries(rows, k))


@functools.lru_cache(maxsize=None)
def rows_per_call(k: int) -> int:
    """The most rows one call of the kernels folds (the walk's shared
    memory holds every candidate of a call)."""
    rows = SMEM_MAX // (16 * k + 4)
    while rows > 0 and walk_smem(rows, k) > SMEM_MAX:
        rows -= 1
    if rows == 0:
        raise ValueError(f"cache_fold: a row of k={k} ids does not fit the "
                         f"walk's shared memory")
    return rows


def _check(state, q, ids, vecs, corpus, mask, tids):
    stacked = state.q_ptr.ndim == 1
    t = state.q_ptr.shape[0] if stacked else 1
    h, k = state.query_doc_ids.shape[-2:]
    dc, d = state.doc_emb.shape[-2:]
    b = q.shape[0]
    want = {"query_emb": (h, d), "query_valid": (h,), "doc_ids": (dc,),
            "q_ptr": ()}
    for f, shape in want.items():
        if getattr(state, f).shape != ((t,) if stacked else ()) + shape:
            raise ValueError(f"cache_fold: state.{f} "
                             f"{tuple(getattr(state, f).shape)}")
    if q.shape != (b, d) or ids.shape != (b, k) or \
            (vecs is not None and vecs.shape != (b, k, d)) or \
            (vecs is None and (corpus is None or corpus.dim() != 2
                               or corpus.shape[1] != d)) or \
            (mask is not None and mask.shape != (b,)) or \
            (tids is not None and tids.shape != (b,)):
        raise ValueError(
            f"cache_fold: rows {tuple(q.shape)}, ids {tuple(ids.shape)}, "
            f"vecs {None if vecs is None else tuple(vecs.shape)}, corpus "
            f"{None if corpus is None else tuple(corpus.shape)} for k={k}, "
            f"d={d}")
    if tids is not None and not stacked:
        raise ValueError("cache_fold: tenant_ids need a stacked state")
    floats = [state.query_emb, state.doc_emb, q,
              vecs if vecs is not None else corpus]
    if any(x.dtype is not torch.float32 for x in floats) or \
            state.query_valid.dtype is not torch.bool or \
            (mask is not None and mask.dtype is not torch.bool) or \
            any(x is not None and x.dtype is not torch.int32 for x in
                (state.query_doc_ids, state.doc_ids, state.q_ptr,
                 state.d_ptr, ids, tids)):
        raise ValueError("cache_fold: rows and embeddings must be float32, "
                         "ids, tags and pointers int32, masks bool")
    return t, h, dc, d, k


def cache_fold(state, q_embs: torch.Tensor, full_ids: torch.Tensor,
               full_vecs: torch.Tensor | None = None,
               corpus: torch.Tensor | None = None,
               mask: torch.Tensor | None = None,
               tenant_ids: torch.Tensor | None = None) -> None:
    """Same contract as :func:`cache_fold_plain`; on CUDA three launches
    for each ``rows_per_call(k)`` rows and no host wait (module
    docstring)."""
    if state.doc_ids.device.type != "cuda":
        return cache_fold_plain(state, q_embs, full_ids, full_vecs, corpus,
                                mask, tenant_ids)
    dims = _check(state, q_embs, full_ids, full_vecs, corpus, mask,
                  tenant_ids)
    step = rows_per_call(dims[-1])
    for i in range(0, q_embs.shape[0], step):
        cut = slice(i, i + step)
        _fold_slice(state, dims, q_embs[cut], full_ids[cut],
                    None if full_vecs is None else full_vecs[cut], corpus,
                    None if mask is None else mask[cut],
                    None if tenant_ids is None else tenant_ids[cut])
    return None


def _fold_slice(state, dims, q_embs, full_ids, full_vecs, corpus, mask,
                tenant_ids) -> None:
    """One launch of the three kernels over at most ``rows_per_call(k)``
    rows that ``_check`` passed (``dims``: what it returned)."""
    t, h, dc, d, k = dims
    b = q_embs.shape[0]
    rows = full_vecs if full_vecs is not None else corpus
    corpus = None if full_vecs is not None else corpus
    mask = None if mask is None else mask.view(torch.uint8)
    rings = [getattr(state, f.name) for f in dataclasses.fields(state)]
    dev = _build.check_operands(
        "cache_fold", *rings, q_embs,
        full_ids, full_vecs, corpus, mask, tenant_ids)
    vec4 = d % 4 == 0 and all(x.data_ptr() % 16 == 0 for x in
                              (state.query_emb, state.doc_emb, q_embs, rows))
    st = _build.stream(dev)
    life, words = _build.scratch("cache_fold", dev, st, -(-b * k // 32) * 32,
                                 b + b * k)
    _build.check(_build.entry("cache_fold", "has_cache_fold")(
        *(_build.ptr(x) for x in rings), _build.ptr(q_embs),
        _build.ptr(full_ids), _build.ptr(full_vecs), _build.ptr(corpus),
        _build.ptr(mask), _build.ptr(tenant_ids), life, words, words + 4 * b,
        t, h, dc, d, k, b, hash_entries(b, k), walk_smem(b, k), vec4, st),
        "cache_fold")
    cache_fold.launches += LAUNCHES


cache_fold.launches = 0
