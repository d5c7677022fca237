"""Device resolution, dtype casts, the tie rule and the logical-axis
sharding rules shared by the port.

Tie rule: wherever the reference uses ``lax.top_k`` or ``argmax``, ties go
to the lowest index.  ``torch.topk`` promises no order among equal values
on CUDA, so every selection in the port goes through :func:`stable_topk`
(a stable descending sort) or :func:`first_argmax` (an explicit minimum
over the tied positions).

Sharding (twin of ``src/repro/utils.py:49-109``): every parameter and
activation dim has a *logical* name; a rules table maps each name to mesh
axes, and :func:`logical_to_placements` resolves a tuple of names into
``torch.distributed.tensor`` placements on a named ``DeviceMesh``.
:func:`tree_distribute` places a tree of tensors as ``DTensor`` leaves and
:func:`constrain` redistributes an activation at the points the reference
constrains it.  With ``rules=None`` (the default everywhere) nothing is
placed and every function runs on plain tensors as before.
"""
from __future__ import annotations

import contextlib
import math
from collections.abc import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core import dispatch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``None`` means ``cuda``; asking for CUDA without a card raises instead of
    running on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def seeded_generator(device: torch.device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; ``None`` on
    the ``meta`` device, whose tensors hold no values (the dry run's
    parameters)."""
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def _count_upload(x, device) -> None:
    """A copy of host data to a CUDA device waits for the card."""
    if device is None or (isinstance(x, torch.Tensor)
                          and x.device.type == "cuda"):
        return
    dispatch.count_syncs(torch.device(device))


def as_f32(x, device) -> torch.Tensor:
    """``x`` as float32 on ``device`` (float64 input is narrowed)."""
    _count_upload(x, device)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def as_i32(x, device) -> torch.Tensor:
    """``x`` as int32 on ``device`` (int64 input is narrowed)."""
    _count_upload(x, device)
    return torch.as_tensor(x, dtype=torch.int32, device=device)


_NP = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


def upload(device, *items) -> list:
    """Each ``(x, dtype)`` of ``items`` as a ``dtype`` tensor on ``device``
    (``None`` stays ``None``), the host arrays in ONE copy.

    A tensor already on an accelerator is cast in place of a copy.  On a
    CUDA device the host arrays are laid end to end in one buffer, each at
    a 16-byte boundary, and copied over once: one host sync where a copy
    each would wait once each.  On the CPU they become tensors, views of
    the arrays where the dtype allows.
    """
    dev = torch.device(device)
    out, host = [None] * len(items), []
    for i, (x, dt) in enumerate(items):
        if x is None:
            continue
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            out[i] = x.to(dev, dt)
            continue
        a = np.ascontiguousarray(x, dtype=_NP[dt])
        if dev.type == "cpu":
            out[i] = torch.from_numpy(a)
        else:
            host.append((i, a))
    if host:
        offs, total = [], 0
        for _, a in host:
            offs.append(total)
            total += -(-a.nbytes // 16) * 16
        buf = np.empty(total, np.uint8)
        for (_, a), o in zip(host, offs):
            buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        dbuf = torch.from_numpy(buf).to(dev)
        dispatch.count_syncs(dev)
        for (i, a), o in zip(host, offs):
            out[i] = dbuf[o:o + a.nbytes].view(items[i][1]).view(a.shape)
    return out


def host_array(x, device: torch.device) -> np.ndarray:
    """``x`` as a numpy array; reading a CUDA tensor back waits for the
    card (one ``host_syncs``)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            dispatch.count_syncs(device)
        return x.cpu().numpy()
    return np.asarray(x)


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        dispatch.count_syncs(device)


def stable_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index.

    ``x [..., N]`` -> (vals [..., k] descending, pos [..., k] int64).  When
    ``N < k`` the tail is padded with ``-inf`` at position ``-1``.  A
    ``DTensor`` is sorted whole on every rank (:func:`run_replicated`).
    """
    if isinstance(x, DTensor):
        return run_replicated(lambda t: stable_topk(t, k), x)
    n = x.shape[-1]
    if n < k:
        x = torch.cat([x, x.new_full((*x.shape[:-1], k - n), -torch.inf)],
                      dim=-1)
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    vals, pos = vals[..., :k], pos[..., :k]
    if n < k:
        pos = torch.where(pos < n, pos, -1)
    return vals, pos


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (``jnp.argmax``);
    a ``DTensor`` is searched whole on every rank."""
    if isinstance(x, DTensor):
        return run_replicated(first_argmax, x)
    n = x.shape[-1]
    best = x.max(dim=-1, keepdim=True).values
    pos = torch.arange(n, device=x.device).expand_as(x)
    return torch.where(x == best, pos, n).min(dim=-1).values


# ---------------------------------------------------------------------------
# Logical axis rules (the reference's tables, copied)
# ---------------------------------------------------------------------------

# Production rules for the (pod, data, model) mesh.  ``fsdp`` is the
# weight-sharding axis (ZeRO-3 style); ``tensor`` the tensor-parallel one.
PRODUCTION_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),          # data-parallel batch
    "seq": "model",                    # residual-stream sequence parallelism
    "kv_seq": "model",                 # decode-time KV cache sharding
    "kv_seq_long": ("data", "model"),  # 500k-context decode KV sharding
    "d_model": None,                   # activations stay replicated on d_model
    "heads": "model",                  # attention-head tensor parallel
    "kv_heads": None,                  # GQA KV heads are few -> replicate
    "d_ff": "model",                   # FFN tensor parallel
    "vocab": "model",                  # vocab-parallel embedding / logits
    "experts": "model",                # MoE expert parallel
    "fsdp": "data",                    # ZeRO-3 weight shard axis
    "corpus": ("data", "model"),       # retrieval corpus shards
    "emb_vocab": "model",              # recsys embedding-table vocab shards
    "nodes": ("data", "model"),        # GNN node partition
    "edges": ("data", "model"),        # GNN edge partition
}

# Single-device rules (tests / smoke): everything replicated.
LOCAL_RULES: dict[str, tuple[str, ...] | str | None] = {
    k: None for k in PRODUCTION_RULES}


def _axes(value) -> tuple[str, ...]:
    if value is None:
        return ()
    return (value,) if isinstance(value, str) else tuple(value)


def logical_to_placements(logical: Sequence[str | None],
                          rules: Mapping, mesh) -> tuple:
    """Placements on ``mesh`` of a tensor whose dims carry the logical
    names ``logical``: a dim whose name maps to mesh axes is
    ``Shard(dim)`` on each of them, every other mesh dim ``Replicate()``.
    Axes the mesh lacks are dropped, and an axis of size 1 shards nothing
    (``Replicate``: one shard is the whole).  A tuple of axes shards major
    to minor in its order (the reference's ``PartitionSpec``); ``DTensor``
    shards in mesh-dim order, so the two must agree, and an axis taken by
    two dims raises, as the reference's spec would."""
    names = tuple(mesh.mesh_dim_names or ())
    out: list = [Replicate()] * mesh.ndim
    taken: set = set()
    for dim, name in enumerate(logical):
        if name is None:
            continue
        idx = [names.index(a) for a in _axes(rules.get(name)) if a in names]
        if idx != sorted(idx):
            raise ValueError(f"logical axis {name!r}: mesh axes "
                             f"{rules.get(name)} out of the mesh's order "
                             f"{names}")
        for i in idx:
            if i in taken:
                raise ValueError(f"mesh axis {names[i]!r} maps two dims of "
                                 f"{tuple(logical)}")
            taken.add(i)
            if mesh.size(i) > 1:
                out[i] = Shard(dim)
    return tuple(out)


def is_logical(x) -> bool:
    """A leaf of a logical tree: a tuple of axis names (or None)."""
    return isinstance(x, tuple) and all(
        isinstance(e, str) or e is None for e in x)


def _map_logical(fn, tree, logical):
    """``fn(leaf, logical_leaf)`` over a tree and its logical twin (dicts,
    lists and tuples of leaves; logical leaves are tuples of names)."""
    if is_logical(logical):
        return fn(tree, logical)
    if isinstance(logical, Mapping):
        return {k: _map_logical(fn, tree[k], logical[k]) for k in tree}
    out = [_map_logical(fn, t, lg) for t, lg in zip(tree, logical)]
    return type(tree)(out) if isinstance(tree, tuple) else out


def tree_placements(logical_tree, rules: Mapping, mesh):
    """A logical tree's placements, leaf by leaf (the reference's
    ``tree_specs``)."""
    return _map_logical(lambda lg, _: logical_to_placements(lg, rules, mesh),
                        logical_tree, logical_tree)


def tree_distribute(tree, logical_tree, rules: Mapping, mesh):
    """``tree`` with every tensor leaf a ``DTensor`` on ``mesh``, placed by
    its logical leaf (the reference's ``tree_shardings`` + ``device_put``).
    Each rank passes the same full tensors; a leaf that is no tensor (a
    host int) passes through."""
    from torch.distributed.tensor import distribute_tensor

    def place(t, lg):
        if not isinstance(t, torch.Tensor):
            return t
        return distribute_tensor(t, mesh,
                                 logical_to_placements(lg, rules, mesh))
    return _map_logical(place, tree, logical_tree)


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _laid_out(g: DTensor, placements) -> DTensor:
    return g if tuple(g.placements) == tuple(placements) \
        else g.redistribute(g.device_mesh, placements)


class _GradLaidOut(torch.autograd.Function):
    """The identity on a ``DTensor``, whose gradient is laid out as the
    ``DTensor`` (a partial sum reduced at once)."""

    @staticmethod
    def forward(ctx, x):
        ctx.pl = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _laid_out(g, ctx.pl)


def constrain(x, logical: Sequence[str | None], rules: Mapping | None):
    """Redistribute ``x`` to the placements of ``logical`` (the
    reference's ``with_sharding_constraint``), its gradient too: as the
    reference's constraint holds the cotangent to the same sharding, the
    gradient is laid out as the placements at this point in the backward
    (a partial sum reduced here, not where a release's ``DTensor`` would
    choose).  Nothing happens when ``rules`` is None or ``x`` is a plain
    tensor.  A dim that its mesh axes do not divide is left whole: the
    reference's compiler pads it, and ``DTensor`` cannot view an uneven
    shard."""
    if rules is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = list(logical_to_placements(logical, rules, mesh))
    for d in range(x.ndim):
        if x.shape[d] % math.prod(mesh.size(i) for i, p in
                                  enumerate(placements) if p == Shard(d)):
            placements = [Replicate() if p == Shard(d) else p
                          for p in placements]
    placements = tuple(placements)
    if tuple(x.placements) != placements:
        x = x.redistribute(mesh, placements)
    if x.requires_grad and torch.is_grad_enabled():
        return _GradLaidOut.apply(x)
    return x


def settled(x):
    """A ``DTensor`` with its partial placements reduced (replicated); a
    plain tensor as it is.  A reduction over a sharded dim leaves a
    partial result, reduced here before a later step changes its
    shape."""
    if not isinstance(x, DTensor) or not any(
            p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_partial() else p
                           for p in x.placements])


def _gathered(x: DTensor, dim: int, n: int | None = None) -> DTensor:
    """``x`` with ``dim`` gathered over each mesh dim that shards it and
    whose size does not divide ``n`` (every such mesh dim when ``n`` is
    None)."""
    mesh = x.device_mesh
    pl = [Replicate() if p == Shard(dim) and (n is None or n % mesh.size(i))
          else p for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def _merge(x: DTensor, dim: int) -> DTensor:
    x = _gathered(_gathered(x, dim + 1), dim, x.shape[dim])
    return x.flatten(dim, dim + 1)


def _split(x: DTensor, dim: int, a: int) -> DTensor:
    return _gathered(x, dim, a).unflatten(dim, (a, x.shape[dim] // a))


class _Merge(torch.autograd.Function):
    """Dims ``dim, dim+1`` of a ``DTensor`` merged into one, each way first
    laid out so that ``DTensor`` can view it (a merged dim is sharded only
    on its leading dim, by mesh sizes that divide it): a view of a sharded
    inner dim is refused, as it would need a redistribution.  The gradient
    is laid out as the input was, so the backward of the step that made
    the input sees its own output's layout (its plan then needs no choice
    of a release's cost model)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.a, ctx.pl = dim, x.shape[dim], tuple(x.placements)
        return _merge(x, dim)

    @staticmethod
    def backward(ctx, g):
        return _laid_out(_split(g, ctx.dim, ctx.a), ctx.pl), None


class _Split(torch.autograd.Function):
    """The inverse of :class:`_Merge`: ``dim`` split into ``(a, -1)``."""

    @staticmethod
    def forward(ctx, x, dim, a):
        ctx.dim, ctx.pl = dim, tuple(x.placements)
        return _split(x, dim, a)

    @staticmethod
    def backward(ctx, g):
        return _laid_out(_merge(g, ctx.dim), ctx.pl), None, None


def merge_dims(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x.flatten(dim, dim + 1)``; on a ``DTensor`` through :class:`_Merge`
    (differentiable both ways)."""
    if isinstance(x, DTensor):
        return _Merge.apply(x, dim)
    return x.flatten(dim, dim + 1)


def split_dim(x: torch.Tensor, dim: int, a: int) -> torch.Tensor:
    """``x.unflatten(dim, (a, -1))``; on a ``DTensor`` through
    :class:`_Split`."""
    if isinstance(x, DTensor):
        return _Split.apply(x, dim, a)
    return x.unflatten(dim, (a, x.shape[dim] // a))


def replicated(x):
    """A ``DTensor`` redistributed to be whole on every rank; a plain
    tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def run_replicated(fn, *args):
    """``fn`` over whole tensors: ``DTensor`` arguments are gathered whole
    (``full_tensor``, differentiable) and ``fn`` runs on every rank on
    plain tensors; if any argument was a ``DTensor``, each tensor ``fn``
    returns comes back replicated on that mesh.  Every rank then holds
    each argument and result whole and repeats the whole step: an
    all-gather of each sharded argument, the whole step's memory and work
    on each rank, and a whole-tensor gradient (reduced to its argument's
    layout in the backward).  Kept for small tensors only, whose steps
    ``DTensor`` has no rule for: sorts with ties kept over per-query rows
    (:func:`stable_topk`, :func:`first_argmax`, the merge of the ranks'
    top-k candidates in ``retrieval/flat.py``) and has-rag's cache
    channel and validation; the large steps run on each rank's shard
    (:func:`per_rows`, :func:`gather_rows`, :func:`segment_sum`,
    :func:`vocab_lookup`, :func:`vocab_logits`)."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    out = fn(*[a.full_tensor() if isinstance(a, DTensor) else a
               for a in args])
    rep = [Replicate()] * mesh.ndim

    def wrap(t):
        if isinstance(t, torch.Tensor):
            return DTensor.from_local(t, mesh, rep, run_check=False)
        if isinstance(t, (tuple, list)):
            return type(t)(wrap(v) for v in t)
        return t
    return wrap(out)


def _has_dtensor(tree) -> bool:
    if isinstance(tree, DTensor):
        return True
    if isinstance(tree, Mapping):
        return any(_has_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_dtensor(v) for v in tree)
    return False


@contextlib.contextmanager
def mesh_scope(*trees):
    """While open, when any leaf of ``trees`` is a ``DTensor``: plain
    tensors meeting a ``DTensor`` in an operation (positions, masks,
    ``arange``) count as replicated, as constants do in the reference's
    SPMD program.  Nests (``implicit_replication`` does not), and does
    nothing on plain trees."""
    if not _has_dtensor(trees):
        yield
        return
    d = DTensor._op_dispatcher
    prev = d._allow_implicit_replication
    d._allow_implicit_replication = True
    try:
        yield
    finally:
        d._allow_implicit_replication = prev


# ---------------------------------------------------------------------------
# Shard-local steps: each rank computes on its own shards, the collectives
# stated (the reference's compiler partitions a gather, a scatter or a
# per-row step so)
# ---------------------------------------------------------------------------

def rows_of(x: DTensor) -> tuple:
    """``x``'s placements with only its leading dim kept sharded: the
    layout of a step that splits ``x``'s rows among the ranks."""
    return tuple(p if p == Shard(0) else Replicate() for p in x.placements)


def _partial_over(pl) -> tuple:
    """``Partial`` on each mesh dim that ``pl`` shards, ``Replicate``
    elsewhere: how the gradient of a whole operand lies when each rank
    uses it for its own share of the work laid out as ``pl`` (the work is
    repeated, so is each rank's gradient, on the dims that do not split
    it)."""
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in pl)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


class _Local(torch.autograd.Function):
    """A ``DTensor`` laid out as ``placements`` (an all-gather where they
    replicate a sharded dim) and taken as its local tensor.  Its gradient
    is the rank's local gradient laid out as ``grad_placements``
    (``Partial`` where each rank's share of the work adds its own part),
    redistributed to the input's own placements: a reduce-scatter where
    the input is sharded, an all-reduce where it is replicated."""

    @staticmethod
    def forward(ctx, x, placements, grad_placements):
        ctx.spec = (x.device_mesh, tuple(x.placements), x.shape, x.stride())
        ctx.grad_placements = grad_placements
        local = x.redistribute(x.device_mesh, placements).to_local()
        return local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        mesh, pl, shape, stride = ctx.spec
        g = DTensor.from_local(g, mesh, ctx.grad_placements, run_check=False,
                               shape=shape, stride=stride)
        return g.redistribute(mesh, pl), None, None


class _Wrap(torch.autograd.Function):
    """A local tensor as the rank's shard of a ``DTensor`` of global
    ``shape`` laid out as ``placements`` (``Partial`` where the ranks hold
    parts of a sum).  Its gradient is the output's gradient laid out as
    ``placements`` with ``Partial`` read as ``Replicate`` (each part of a
    sum takes the whole sum's gradient), taken locally."""

    @staticmethod
    def forward(ctx, t, mesh, placements, shape):
        ctx.spec = (mesh, tuple(Replicate() if p.is_partial() else p
                                for p in placements))
        shape = torch.Size(shape)
        return DTensor.from_local(t, mesh, placements, run_check=False,
                                  shape=shape,
                                  stride=_contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        mesh, pl = ctx.spec
        return g.redistribute(mesh, pl).to_local(), None, None, None


def local(x, placements=None, grad_placements=None) -> torch.Tensor:
    """``x``'s local tensor laid out as ``placements`` (default its own),
    differentiable: the gradient, laid out as ``grad_placements`` (default
    ``placements``), is redistributed to ``x``'s placements.  A plain
    tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = tuple(x.placements) if placements is None else tuple(placements)
    return _Local.apply(x, pl, pl if grad_placements is None
                        else tuple(grad_placements))


def wrap(t: torch.Tensor, mesh, placements, shape) -> DTensor:
    """The local tensor ``t`` as the rank's shard of a ``DTensor`` of
    global ``shape`` on ``mesh`` (differentiable; see :class:`_Wrap`)."""
    return _Wrap.apply(t, mesh, tuple(placements), tuple(shape))


def _as_dtensor(x, mesh):
    """``x`` as a ``DTensor`` on ``mesh`` (a plain tensor replicated)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def per_rows(fn, x: torch.Tensor, *others):
    """``fn(x, *others)`` for a step with no dependency across ``x``'s rows
    (its leading dim).  On a ``DTensor`` ``x``, each rank runs ``fn`` on
    its own rows (``x`` laid out with only its rows sharded), with the
    tensors of ``others`` (trees of ``DTensor`` weights) whole; their
    gradients, partial over the mesh dims that split the rows, are reduced
    to their own layouts, and the result's rows are laid out as ``x``'s."""
    if not isinstance(x, DTensor):
        return fn(x, *others)
    mesh, rows = x.device_mesh, rows_of(x)
    rep = (Replicate(),) * mesh.ndim
    whole = _partial_over(rows)
    ol = _tree_map(lambda o: local(o, rep, whole)
                   if isinstance(o, DTensor) else o, others)
    out = fn(local(x, rows), *ol)
    return wrap(out, mesh, rows, (x.shape[0],) + tuple(out.shape[1:]))


def gather_rows(src: torch.Tensor, *idx: torch.Tensor):
    """``F.embedding(i, src)``, the rows of ``src`` at each index tensor
    ``i`` of ``idx`` (one result each; ``F.embedding``'s backward sums a
    row's duplicates in parallel).  On a mesh ``src`` is gathered whole
    once (an all-gather over the axes that shard it), each rank takes the
    rows of its own part of the indices, and each result is laid out as
    its indices, its rows sharded.  ``src``'s gradient, each rank's part
    of a whole-shape sum, is reduce-scattered back to ``src``'s layout.
    All of ``idx`` share one layout."""
    if not any(isinstance(a, DTensor) for a in (src, *idx)):
        out = tuple(F.embedding(i, src) for i in idx)
        return out if len(out) > 1 else out[0]
    mesh = next(a.device_mesh for a in (src, *idx) if isinstance(a, DTensor))
    idx = [_as_dtensor(i, mesh) for i in idx]
    rows = rows_of(idx[0])
    full = local(_as_dtensor(src, mesh), (Replicate(),) * mesh.ndim,
                 _partial_over(rows))
    out = tuple(wrap(F.embedding(i.redistribute(mesh, rows).to_local(), full),
                     mesh, rows, tuple(i.shape) + tuple(src.shape[1:]))
                for i in idx)
    return out if len(out) > 1 else out[0]


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int,
                logical: Sequence[str | None] = (None,),
                rules: Mapping | None = None) -> torch.Tensor:
    """The rows of ``x`` summed by segment ids ``seg`` into ``[n, ...]``
    (``index_add``, the reference's ``jax.ops.segment_sum``).  On a mesh
    each rank adds its own rows into a whole ``[n, ...]`` and the ranks'
    partial sums are reduce-scattered to the layout of ``logical`` under
    ``rules`` (all-reduced where it replicates).  ``seg`` is laid out as
    ``x``'s rows."""
    if not isinstance(x, DTensor):
        return x.new_zeros((n,) + x.shape[1:]).index_add(0, seg, x)
    mesh, rows = x.device_mesh, rows_of(x)
    sl = _as_dtensor(seg, mesh).redistribute(mesh, rows).to_local()
    xl = local(x, rows)
    part = xl.new_zeros((n,) + xl.shape[1:]).index_add(0, sl, xl)
    part = wrap(part, mesh, _partial_over(rows), (n,) + tuple(x.shape[1:]))
    return constrain(part, tuple(logical) + (None,) * (x.ndim - len(logical)),
                     rules or {})


class _RowLookup(torch.autograd.Function):
    """``F.embedding(ids, table)`` of a table whose rows are sharded: each
    rank gathers the ids in its own row block (zero rows elsewhere), a
    partial result over the table's vocab axes.  The backward scatters
    into the rank's own rows only and reduces that shard's gradient over
    the axes the ids split (the data-parallel reduction), so the gradient
    has the table's placements and no rank holds a whole-table one."""

    @staticmethod
    def forward(ctx, table, ids, vocab, id_pl):
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        mesh = table.device_mesh
        shape, offset = compute_local_shape_and_global_offset(
            table.shape, mesh, table.placements)
        pos = ids - offset[0]
        valid = (pos >= 0) & (pos < shape[0])
        pos = torch.where(valid, pos, 0)
        out = F.embedding(pos, table.to_local()) * valid[..., None].to(
            table.dtype)
        ctx.save_for_backward(pos, valid)
        ctx.meta = (mesh, tuple(table.placements), table.shape, table.stride(),
                    tuple(shape), vocab, id_pl)
        return out

    @staticmethod
    def backward(ctx, g):
        pos, valid = ctx.saved_tensors
        mesh, pl, shape, stride, local_shape, vocab, id_pl = ctx.meta
        g = g * valid[..., None].to(g.dtype)
        grad = torch.ops.aten.embedding_dense_backward(
            g, pos, local_shape[0], -1, False)
        grad_pl = [pl[i] if i in vocab else
                   Partial() if isinstance(id_pl[i], Shard) else Replicate()
                   for i in range(mesh.ndim)]
        grad = DTensor.from_local(grad, mesh, grad_pl, run_check=False,
                                  shape=shape, stride=stride)
        # one all-reduce a data-parallel axis, each sum dropped as the next
        # is made: a rank holds two copies of its shard's gradient at most
        for i in range(mesh.ndim):
            if grad_pl[i] != pl[i]:
                grad_pl[i] = pl[i]
                grad = grad.redistribute(mesh, grad_pl)
        return grad, None, None, None


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``: ``table [V, D]``, ``ids`` integer of any
    shape -> ``[*ids.shape, D]``.  On a mesh whose vocab axes shard the
    table's rows (``Shard(0)``), each rank gathers the ids of its own row
    block and the parts are all-reduced over those axes, the result laid
    out as ``ids`` (:class:`_RowLookup`); a table with whole rows is
    gathered from locally."""
    if not isinstance(table, DTensor):
        return F.embedding(ids, table)
    mesh = table.device_mesh
    if any(isinstance(p, Shard) and p.dim != 0 for p in table.placements):
        raise ValueError(f"vocab_lookup: table placements {table.placements}")
    vocab = tuple(i for i, p in enumerate(table.placements) if p == Shard(0))
    ids = _as_dtensor(ids, mesh)
    id_pl = tuple(Replicate() if i in vocab else p
                  for i, p in enumerate(rows_of(ids)))
    il = ids.redistribute(mesh, id_pl).to_local()
    shape = tuple(ids.shape) + (table.shape[1],)
    if not vocab:
        return wrap(F.embedding(il, local(table, grad_placements=[
            Partial() if isinstance(p, Shard) else q
            for p, q in zip(id_pl, table.placements)])), mesh, id_pl, shape)
    out = _RowLookup.apply(table, il, vocab, id_pl)
    out = wrap(out, mesh, [Partial() if i in vocab else p
                           for i, p in enumerate(id_pl)], shape)
    return out.redistribute(mesh, id_pl)


def vocab_logits(x: torch.Tensor, table: torch.Tensor, n: int):
    """``x [..., D] @ table[:n].T -> [..., n]``, the scores of the first
    ``n`` table rows (a padded table's real rows).  On a mesh whose vocab
    axes shard the table's rows, each rank scores its own rows of ``x``
    against its own block of the ``n`` columns, laid out as ``DTensor``
    lays out ``n`` columns over those axes (the last block short when
    they do not divide ``n``): the table (small) is gathered whole, and
    no rank holds all ``n`` columns of its rows.  ``x``'s gradient is
    reduced over the vocab axes, the table's over every axis that split
    the work, back to its layout."""
    if not isinstance(table, DTensor):
        out = x @ table.T
        return out[..., :n] if table.shape[0] > n else out
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, last = table.device_mesh, x.ndim - 1
    x = _as_dtensor(x, mesh)
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    x_pl = tuple(Replicate() if i in vocab else p
                 for i, p in enumerate(rows_of(x)))
    out_pl = tuple(Shard(last) if i in vocab else p
                   for i, p in enumerate(x_pl))
    shape = tuple(x.shape[:-1]) + (n,)
    blk, off = compute_local_shape_and_global_offset(shape, mesh, out_pl)
    tl = local(table, (Replicate(),) * mesh.ndim, _partial_over(out_pl))
    xl = local(x, x_pl, [Partial() if i in vocab else p
                         for i, p in enumerate(x_pl)])
    out = xl @ tl[off[last]:off[last] + blk[last]].T
    return wrap(out, mesh, out_pl, shape)


# ---------------------------------------------------------------------------
# Cross-entropy pieces over a last dim that may be sharded (the vocab)
# ---------------------------------------------------------------------------

def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim.  On a ``DTensor`` sharded there it
    is the max (held fixed), the sum of exponentials and the log, each a
    reduction that ``DTensor`` completes with a small all-reduce; the
    plain form is ``torch.logsumexp``."""
    if not isinstance(x, DTensor):
        return torch.logsumexp(x, dim=-1)
    m = settled(x.detach().amax(dim=-1, keepdim=True))
    total = settled((x - m).exp().sum(dim=-1))
    return m[..., 0] + total.log()


class _TakeLast(torch.autograd.Function):
    """``x[..., idx]`` along a ``DTensor``'s last dim, sharded or not:
    each rank takes the entries its shard holds (zero elsewhere) and the
    shards' results add up; the backward scatters into the local shard
    only, so no rank holds the whole of ``x`` or its gradient."""

    @staticmethod
    def forward(ctx, x, idx):
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        mesh, last = x.device_mesh, x.ndim - 1
        rest = [Replicate() if p == Shard(last) else p
                for p in x.placements]
        if not isinstance(idx, DTensor):
            idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        idx = idx.redistribute(mesh, rest).to_local().long()
        local = x.to_local()
        shape, offset = compute_local_shape_and_global_offset(
            x.shape, mesh, x.placements)
        pos = idx - offset[last]
        valid = (pos >= 0) & (pos < shape[last])
        pos = pos.clamp(0, max(shape[last] - 1, 0))
        out = local.gather(-1, pos[..., None])[..., 0] * valid
        ctx.save_for_backward(pos, valid)
        ctx.meta = (mesh, tuple(x.placements), local.shape, local.dtype,
                    x.shape, x.stride())
        part = [Partial() if p == Shard(last) else p for p in x.placements]
        return DTensor.from_local(out, mesh, part,
                                  run_check=False).redistribute(mesh, rest)

    @staticmethod
    def backward(ctx, g):
        pos, valid = ctx.saved_tensors
        mesh, placements, shape, dtype, whole, stride = ctx.meta
        rest = [Replicate() if isinstance(p, Shard) and p.dim == len(shape)
                - 1 else p for p in placements]
        g = g.redistribute(mesh, rest).to_local()
        grad = torch.zeros(shape, dtype=dtype, device=g.device)
        grad.scatter_(-1, pos[..., None], (g * valid).to(dtype)[..., None])
        return DTensor.from_local(grad, mesh, placements, run_check=False,
                                  shape=whole, stride=stride), None


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]``, one entry of the last dim per position (``idx``
    shaped as ``x`` without its last dim): ``gather`` on plain tensors,
    :class:`_TakeLast` on a ``DTensor``."""
    if not isinstance(x, DTensor):
        return x.gather(-1, idx.long()[..., None])[..., 0]
    return _TakeLast.apply(x, idx)
