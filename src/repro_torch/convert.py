"""Carry state across the two packages as plain numpy arrays.

The reference (``repro``) and the port build their IVF indexes with
different random draws, so a comparison hands one index to both.  These
functions turn a mapping of numpy arrays (field name -> array) into the
port's :class:`IVFIndex` / :class:`HasState` on a device, and back.  A
caller holding the reference's objects makes the mapping with
``{f: np.asarray(getattr(obj, f)) for f in IVF_FIELDS}``.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.has import HasState
from repro_torch.retrieval.ivf import IVFIndex
from repro_torch.utils import resolve_device

IVF_FIELDS = ("centroids", "bucket_vecs", "bucket_ids", "bucket_counts")
STATE_FIELDS = ("query_emb", "query_doc_ids", "query_valid", "q_ptr",
                "doc_emb", "doc_ids", "d_ptr")
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int32,
           np.dtype(np.bool_): torch.bool}


def _tensor(a, dev) -> torch.Tensor:
    # a copy: the port updates its state in place, the arrays stay as given
    a = np.asarray(a)
    return torch.tensor(a, dtype=_DTYPES[a.dtype], device=dev)


def ivf_index_from_numpy(arrays: Mapping[str, np.ndarray],
                         device=None) -> IVFIndex:
    dev = resolve_device(device)
    return IVFIndex(**{f: _tensor(arrays[f], dev) for f in IVF_FIELDS})


def ivf_index_to_numpy(index: IVFIndex) -> dict[str, np.ndarray]:
    return {f: getattr(index, f).cpu().numpy() for f in IVF_FIELDS}


def has_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device=None) -> HasState:
    dev = resolve_device(device)
    return HasState(**{f: _tensor(arrays[f], dev) for f in STATE_FIELDS})


def has_state_to_numpy(state: HasState) -> dict[str, np.ndarray]:
    return {f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS}
