"""Carry state across the two packages as plain numpy arrays.

The reference (``repro``) and the port build their IVF indexes and draw
their weights with different random draws, so a comparison hands one set
to both.  These functions turn a mapping of numpy arrays (field name ->
array) into the port's :class:`IVFIndex` / :class:`CompressedIVFIndex` /
:class:`HasState` (unstacked, or a stacked tenant store) / :class:`ReuseState`
on a device, and back.  A caller holding the reference's
objects makes the mapping with
``{f: np.asarray(getattr(obj, f)) for f in IVF_FIELDS}``
(``COMPRESSED_IVF_FIELDS`` for a compressed index).  A transformer's
parameters go across as the reference's nested dict of numpy arrays, with
the per-layer leaves stacked over a leading ``n_layers`` dim, as serving
weights (``transformer_params_*``) or as training masters
(``transformer_master_params_from_numpy``); an optimizer state goes
across in the reference's stacked layout (``opt_state_*``).
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch.core.baselines import ReuseState
from repro_torch.core.has import HasState
from repro_torch.models.transformer import TransformerConfig
from repro_torch.retrieval.ivf import CompressedIVFIndex, IVFIndex
from repro_torch.utils import resolve_device

IVF_FIELDS = ("centroids", "bucket_vecs", "bucket_ids", "bucket_counts")
COMPRESSED_IVF_FIELDS = ("centroids", "bucket_vecs", "bucket_scales",
                         "bucket_ids", "bucket_counts")
STATE_FIELDS = ("query_emb", "query_doc_ids", "query_valid", "q_ptr",
                "doc_emb", "doc_ids", "d_ptr")
REUSE_FIELDS = ("query_emb", "doc_ids", "doc_vecs", "margins", "minhash",
                "valid", "ptr")
_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int32,
           np.dtype(np.int8): torch.int8,
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


def compressed_ivf_index_from_numpy(arrays: Mapping[str, np.ndarray],
                                    device=None) -> CompressedIVFIndex:
    dev = resolve_device(device)
    return CompressedIVFIndex(**{f: _tensor(arrays[f], dev)
                                 for f in COMPRESSED_IVF_FIELDS})


def compressed_ivf_index_to_numpy(
        index: CompressedIVFIndex) -> dict[str, np.ndarray]:
    return {f: getattr(index, f).cpu().numpy() for f in COMPRESSED_IVF_FIELDS}


def has_state_from_numpy(arrays: Mapping[str, np.ndarray],
                         device=None) -> HasState:
    dev = resolve_device(device)
    return HasState(**{f: _tensor(arrays[f], dev) for f in STATE_FIELDS})


def has_state_to_numpy(state: HasState) -> dict[str, np.ndarray]:
    return {f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS}


def _check_tenant_arrays(shapes: Mapping[str, tuple]) -> None:
    """A stacked store: ``[T]`` pointers, every field led by the same T."""
    t = shapes["q_ptr"]
    if len(t) != 1 or any(s[:1] != t or len(s) < 2
                          for f, s in shapes.items()
                          if f not in ("q_ptr", "d_ptr")) \
            or shapes["d_ptr"] != t:
        raise ValueError(f"not a stacked tenant state: {dict(shapes)}")


def tenant_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device=None) -> HasState:
    """The reference's ``init_tenant_states`` store (a ``[T, ...]`` pytree
    as numpy arrays) -> the port's stacked :class:`HasState`."""
    _check_tenant_arrays({f: np.shape(arrays[f]) for f in STATE_FIELDS})
    return has_state_from_numpy(arrays, device)


def tenant_state_to_numpy(state: HasState) -> dict[str, np.ndarray]:
    _check_tenant_arrays({f: tuple(getattr(state, f).shape)
                          for f in STATE_FIELDS})
    return has_state_to_numpy(state)


def reuse_state_from_numpy(arrays: Mapping[str, np.ndarray],
                           device=None) -> ReuseState:
    dev = resolve_device(device)
    return ReuseState(**{f: _tensor(arrays[f], dev) for f in REUSE_FIELDS})


def reuse_state_to_numpy(state: ReuseState) -> dict[str, np.ndarray]:
    return {f: getattr(state, f).cpu().numpy() for f in REUSE_FIELDS}


def transformer_params_from_numpy(tree: Mapping, cfg: TransformerConfig,
                                  device=None,
                                  dtype=torch.bfloat16) -> dict:
    """The reference's parameter tree (numpy leaves, layers stacked) -> the
    port's parameters in ``dtype`` (``final_norm`` stays f32, as the
    reference never casts it).  Every subtree of a layer goes across as it
    is: ``attn``, the norms, ``mlp``, and for an MoE config ``moe``
    (``router``, ``w_in``, ``w_gate``, ``w_out``, each stacked over
    layers) with Arctic's dense-residual ``mlp`` beside it.  The router is
    f32 in the reference's tree and ``dtype`` here: the reference casts it
    to its compute dtype before use, so the port holds the value it
    computes with (and widens it to f32 for the routing product)."""
    dev = resolve_device(device)

    def leaf(a, dt=dtype):
        return torch.tensor(np.asarray(a, np.float32), dtype=dt, device=dev)

    def layer(sub, i):
        return {k: layer(v, i) if isinstance(v, Mapping) else leaf(v[i])
                for k, v in sub.items()}

    n = len(tree["layers"]["attn"]["wq"])
    if n != cfg.n_layers:
        raise ValueError(f"{cfg.name}: {n} stacked layers, config has "
                         f"{cfg.n_layers}")
    return {"embed": leaf(tree["embed"]), "unembed": leaf(tree["unembed"]),
            "final_norm": {"scale": leaf(tree["final_norm"]["scale"],
                                         torch.float32)},
            "layers": [layer(tree["layers"], i) for i in range(n)]}


def transformer_master_params_from_numpy(tree: Mapping,
                                         cfg: TransformerConfig,
                                         device=None, dtype=None) -> dict:
    """The reference's parameter tree -> the port's training masters, with
    the reference's per-leaf dtypes: every leaf in ``dtype`` (default
    ``cfg.param_dtype``), the norms and ``final_norm`` too, and the MoE
    router in f32 (``init_master_params``' layout)."""
    dtype = cfg.param_dtype if dtype is None else dtype
    params = transformer_params_from_numpy(tree, cfg, device, dtype)
    params["final_norm"]["scale"] = params["final_norm"]["scale"].to(dtype)
    for i, lp in enumerate(params["layers"]):
        if "moe" in lp:
            lp["moe"]["router"] = _tensor(
                np.asarray(tree["layers"]["moe"]["router"][i], np.float32),
                lp["moe"]["router"].device)
    return params


def transformer_params_to_numpy(params: Mapping) -> dict:
    """The port's parameters, serving weights or training masters (or a
    tree of their gradients) -> the reference's tree of f32 numpy arrays,
    per-layer leaves stacked over layers (the ``moe`` subtree too); bf16
    leaves widen exactly."""
    def arr(t):
        return t.float().cpu().numpy()

    def stack(subs):
        first = subs[0]
        return {k: stack([s[k] for s in subs]) if isinstance(first[k], Mapping)
                else np.stack([arr(s[k]) for s in subs]) for k in first}

    return {"embed": arr(params["embed"]), "unembed": arr(params["unembed"]),
            "final_norm": {"scale": arr(params["final_norm"]["scale"])},
            "layers": stack(params["layers"])}


def opt_state_from_numpy(tree: Mapping, device=None) -> dict:
    """The reference's optimizer state (AdamW's ``m``, ``v``, ``step`` or
    Adafactor's ``v`` with ``vr`` / ``vc`` / ``v`` leaves and ``step``, as
    numpy, per-layer leaves stacked) -> the port's: the same tree, f32
    tensors and an int32 ``step``."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, Mapping):
            return {k: conv(v) for k, v in t.items()}
        return _tensor(t, dev)

    return conv(tree)


def opt_state_to_numpy(state: Mapping) -> dict:
    """The port's optimizer state -> the reference's tree of numpy arrays
    (f32 moments, an int32 ``step``)."""
    if isinstance(state, Mapping):
        return {k: opt_state_to_numpy(v) for k, v in state.items()}
    return state.cpu().numpy()
