"""Optimizers: AdamW (dense archs) and Adafactor (giant MoE archs).

Twin of ``src/repro/training/optimizer.py``, term for term (not
``torch.optim``'s formulas): AdamW divides the bias-corrected first moment
by ``sqrt(v / bc2) + eps`` and adds the decay to the update; Adafactor
keeps factored second moments with ``beta = 1 - t^-decay``, no momentum,
``g*g + 1e-30``, and clips each leaf's update to RMS 1.  ``opt_update``
clips the gradients by their global norm first.

Trees are nested dicts of tensors.  A list in a tree stands for the
reference's leaves stacked over its length: the port keeps one dict per
layer in ``params["layers"]``, the reference one ``[L, ...]`` leaf per
name.  The optimizer treats each such name as the one stacked leaf, so:

* the state has the reference's stacked layout and shapes (the ``layers``
  list becomes a dict of ``[L, ...]`` tensors), ``step`` an int32 scalar;
* Adafactor factors every stacked leaf, the per-layer norm scales (``[L,
  d]``: ``vr [L]``, ``vc [d]``) too, and takes the RMS clip over the whole
  stacked leaf, across layers, in two passes over its layer slices with a
  shared sum of ``u*u``.

The updates write parameters and state in place under ``torch.no_grad()``
(the twin of the reference's donated buffers): one set of weights and
moments is held, and the f32 temporaries are bounded by working through
slices of at most ``CHUNK`` elements.  ``clip_by_global_norm`` scales the
gradients in place.  ``OptConfig`` has no ``min_dim_factored``, which the
reference never reads.

On a mesh (``DTensor`` parameters) :func:`opt_state_logical` places the
state as the reference does: AdamW's moments follow the parameters,
Adafactor's ``vr`` drops the last axis and ``vc`` the second to last.  A
gradient is first laid out as its parameter (the data-parallel reduction),
AdamW then runs the same arithmetic on each rank's local shards, and
Adafactor runs on the ``DTensor`` leaves whole, its factored means over a
sharded dim being partial reductions that ``DTensor`` completes.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch
from torch.distributed.tensor import DTensor

from repro_torch.utils import is_logical

# elements of the largest slice an update works on at once (256 MB in f32)
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor (every leaf of 2+ dims, stacked, is factored)
    decay: float = 0.8


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def leaves(tree, path: tuple = ()):
    """``(path, parts)`` of every leaf in dict order: ``parts`` is
    ``[tensor]``, or for a leaf under a list, its tensor in each element
    (the slices of the reference's stacked leaf)."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for sub, _ in leaves(tree[0]):
            yield path + sub, [_get(t, sub) for t in tree]
    else:
        yield path, [tree]


def _stacked(tree, path) -> bool:
    node = tree
    for k in path:
        if isinstance(node, (list, tuple)):
            return True
        node = node[k]
    return False


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _shape(parts, stacked: bool) -> tuple:
    return ((len(parts),) if stacked else ()) + tuple(parts[0].shape)


def _slices(t: torch.Tensor):
    """``t``'s flat slices of at most CHUNK elements (views: ``t`` must be
    contiguous, since the updates write through them)."""
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


# ---------------------------------------------------------------------------
# Global norm and clipping
# ---------------------------------------------------------------------------

def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s local shard (writes reach the ``DTensor``), or
    ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor; a
    plain one also for ``DTensor`` leaves, each leaf's sum being completed
    across the mesh)."""
    total = None
    for _, parts in leaves(tree):
        for t in parts:
            if isinstance(t, DTensor):
                sqs = [t.float().square().sum().full_tensor()]
            else:
                sqs = [c.float().square().sum() for c in _slices(t)]
            for sq in sqs:
                total = sq if total is None else total + sq
    return total.sqrt()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale ``grads`` in place by ``min(1, max_norm / max(norm, 1e-9))``
    (the factor cast to each leaf's dtype) -> ``(grads, norm)``, ``norm``
    the global norm before the clip (computed unless given)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(_local(norm), min=1e-9),
                        max=1.0)
    for _, parts in leaves(grads):
        for g in parts:
            _local(g).mul_(scale.to(g.dtype))
    return grads, norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _zeros(shape, dev) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=dev)


def _step0(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=dev)


def adamw_init(params) -> dict:
    state = {"m": {}, "v": {}}
    for path, parts in leaves(params):
        shape = _shape(parts, _stacked(params, path))
        _set(state["m"], path, _zeros(shape, parts[0].device))
        _set(state["v"], path, _zeros(shape, parts[0].device))
    state["step"] = _step0(parts[0].device)
    return state


def _views(state_leaf: torch.Tensor, stacked: bool) -> list:
    """A state leaf's per-layer slices (views), or the leaf itself."""
    return list(state_leaf) if stacked else [state_leaf]


def like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient laid out as its ``DTensor`` parameter (a partial sum over
    the ranks that replicate the parameter is reduced, a replicated one
    sliced), or ``g``.  A gradient that is partial where its parameter is
    sharded would have each rank hold the whole extent of a sharded dim
    (a row-sharded table's whole-table gradient): the step that made it
    must reduce it to its shard instead (``utils.vocab_lookup``), so it
    raises ``ValueError``."""
    if isinstance(p, DTensor) and isinstance(g, DTensor) \
            and tuple(g.placements) != tuple(p.placements):
        whole = [i for i, (a, b) in enumerate(zip(g.placements,
                                                  p.placements))
                 if a.is_partial() and not b.is_replicate()]
        if whole:
            raise ValueError(
                f"a gradient of shape {tuple(g.shape)} partial over mesh "
                f"dims {whole} where its parameter is sharded "
                f"({tuple(g.placements)} against {tuple(p.placements)})")
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params):
    """One AdamW step, in place -> ``(params, state)``."""
    step = state["step"].add_(1)
    t = _local(step).float()
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)
    for (path, ps), (_, gs) in zip(leaves(params), leaves(grads)):
        stacked = _stacked(params, path)
        ms = _views(_local(_get(state["m"], path)), stacked)
        vs = _views(_local(_get(state["v"], path)), stacked)
        gs = [_local(like_param(g, p)).contiguous() for g, p in zip(gs, ps)]
        for p, g, m, v in zip(map(_local, ps), gs, ms, vs):
            for pc, gc, mc, vc in zip(_slices(p), _slices(g), _slices(m),
                                      _slices(v)):
                g32 = gc.float()
                mc.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
                vc.mul_(cfg.b2).add_((g32 * (1 - cfg.b2)).mul_(g32))
                u = mc / bc1
                u.div_((vc / bc2).sqrt_().add_(cfg.eps))
                p32 = pc.float()
                u.add_(p32 * cfg.weight_decay)
                pc.copy_(p32 - u.mul_(cfg.lr))
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moments, no momentum)
# ---------------------------------------------------------------------------

def adafactor_init(params) -> dict:
    v = {}
    for path, parts in leaves(params):
        shape = _shape(parts, _stacked(params, path))
        dev = parts[0].device
        if len(shape) >= 2:
            _set(v, path, {"vr": _zeros(shape[:-1], dev),
                           "vc": _zeros(shape[:-2] + shape[-1:], dev)})
        else:
            _set(v, path, {"v": _zeros(shape, dev)})
    return {"v": v, "step": _step0(parts[0].device)}


def _factored_u(g: torch.Tensor, vr: torch.Tensor, vc: torch.Tensor,
                eps: float) -> torch.Tensor:
    """``g / (sqrt(vr vc^T / max(mean(vr), 1e-30)) + eps)``, f32, over the
    last two dims (``g [..., R, C]``, ``vr [..., R]``, ``vc [..., C]``)."""
    denom = vr[..., None] * vc[..., None, :]
    denom.div_(torch.clamp(vr.mean(-1, keepdim=True)[..., None], min=1e-30))
    denom.sqrt_().add_(eps)
    if isinstance(denom, DTensor):
        return g / denom
    return torch.div(g, denom, out=denom)


def _apply(cfg: OptConfig, p: torch.Tensor, u: torch.Tensor, rms) -> None:
    """``p <- p - lr * (u / max(1, rms) + wd * p)`` (f32, then p's dtype);
    ``u`` is scratch."""
    p32 = p.float()
    u.div_(torch.clamp(rms, min=1.0)).add_(p32 * cfg.weight_decay)
    p.copy_(p32 - u.mul_(cfg.lr))


def _matrix_slices(t: torch.Tensor):
    """``t [..., R, C]`` as ``[N, R, C]`` and the ranges of N whose slices
    hold at most CHUNK elements (at least one matrix each)."""
    m = t.view(-1, t.shape[-2], t.shape[-1])
    per = max(1, CHUNK // (m.shape[1] * m.shape[2]))
    return m, [(i, min(i + per, m.shape[0]))
               for i in range(0, m.shape[0], per)]


def _adafactor_matrices(cfg, ps, gs, vrs, vcs, beta, numel) -> None:
    """A factored leaf whose slices are matrices (``[..., R, C]`` each, the
    per-layer slices of a stacked leaf or one plain leaf): pass 1 updates
    ``vr`` / ``vc`` slice by slice and sums ``u*u``; pass 2 recomputes
    ``u`` and applies it with the leaf's RMS clip."""
    ss = None
    for g, vr, vc in zip(gs, vrs, vcs):
        gm, ranges = _matrix_slices(g)
        vr2, vc2 = vr.view(-1, vr.shape[-1]), vc.view(-1, vc.shape[-1])
        for a, b in ranges:
            g32 = gm[a:b].float()
            g2 = g32.square().add_(1e-30)
            vr2[a:b].mul_(beta).add_(g2.mean(-1) * (1 - beta))
            vc2[a:b].mul_(beta).add_(g2.mean(-2) * (1 - beta))
            del g2
            u = _factored_u(g32, vr2[a:b], vc2[a:b], cfg.eps)
            part = u.square().sum()
            ss = part if ss is None else ss + part
    rms = torch.sqrt(ss / numel + 1e-30)
    for p, g, vr, vc in zip(ps, gs, vrs, vcs):
        gm, ranges = _matrix_slices(g)
        pm = p.view(gm.shape)
        vr2, vc2 = vr.view(-1, vr.shape[-1]), vc.view(-1, vc.shape[-1])
        for a, b in ranges:
            u = _factored_u(gm[a:b].float(), vr2[a:b], vc2[a:b], cfg.eps)
            _apply(cfg, pm[a:b], u, rms)


def _adafactor_whole(cfg, ps, gs, v, beta, stacked) -> None:
    """A small leaf updated as the reference's stacked leaf: the slices are
    stacked (per-layer vectors such as the norm scales, whose ``vc`` and
    ``mean(vr)`` run across layers), or a plain 0-d/1-d leaf (``v``)."""
    g = (torch.stack(gs) if stacked else gs[0]).float()
    g2 = g * g + 1e-30
    if "vr" in v:
        vr, vc = v["vr"], v["vc"]
        vr.mul_(beta).add_(g2.mean(-1) * (1 - beta))
        vc.mul_(beta).add_(g2.mean(-2) * (1 - beta))
        u = _factored_u(g, vr, vc, cfg.eps)
    else:
        vv = v["v"]
        vv.mul_(beta).add_(g2 * (1 - beta))
        u = g / (vv.sqrt() + cfg.eps)
    rms = torch.sqrt((u * u).mean() + 1e-30)
    for i, p in enumerate(ps):
        _apply(cfg, p, u[i] if stacked else u, rms)


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params):
    """One Adafactor step, in place -> ``(params, state)``."""
    step = state["step"].add_(1)
    beta = 1.0 - torch.pow(_local(step).float(), -cfg.decay)
    for (path, ps), (_, gs) in zip(leaves(params), leaves(grads)):
        stacked = _stacked(params, path)
        v = _get(state["v"], path)
        if isinstance(ps[0], DTensor):
            gs = [like_param(g, p) for g, p in zip(gs, ps)]
            _adafactor_whole(cfg, ps, gs, v, beta, stacked)
        elif "vr" in v and ps[0].dim() >= 2:
            _adafactor_matrices(cfg, ps, gs, _views(v["vr"], stacked),
                                _views(v["vc"], stacked), beta,
                                len(ps) * math.prod(ps[0].shape))
        else:
            _adafactor_whole(cfg, ps, gs, v, beta, stacked)
    return params, state


# ---------------------------------------------------------------------------
# Unified interface
# ---------------------------------------------------------------------------

def opt_init(cfg: OptConfig, params) -> dict:
    if cfg.name == "adamw":
        return adamw_init(params)
    return adafactor_init(params)


def opt_update(cfg: OptConfig, grads, state, params, grad_norm=None):
    """Clip ``grads`` by their global norm (in place; ``grad_norm``, if
    given, is that norm) when ``cfg.grad_clip > 0``, then one step of
    ``cfg.name``, in place -> ``(params, state)``."""
    if cfg.grad_clip > 0:
        clip_by_global_norm(grads, cfg.grad_clip, grad_norm)
    if cfg.name == "adamw":
        return adamw_update(cfg, grads, state, params)
    return adafactor_update(cfg, grads, state, params)


def _stacked_logical(tree):
    """A parameters' logical tree with each list (one entry a layer) as
    the reference's stacked leaves: its first entry, each leaf led by an
    unsharded layer axis."""
    if is_logical(tree):
        return tree
    if isinstance(tree, Mapping):
        return {k: _stacked_logical(v) for k, v in tree.items()}
    return _map_leaves(lambda lg: (None,) + lg, _stacked_logical(tree[0]))


def _map_leaves(fn, tree):
    if is_logical(tree):
        return fn(tree)
    return {k: _map_leaves(fn, v) for k, v in tree.items()}


def opt_state_logical(cfg: OptConfig, params_logical) -> dict:
    """Logical axes of :func:`opt_init`'s state, from the parameters'
    (``src/repro/training/optimizer.py:143-155``)."""
    plog = _stacked_logical(params_logical)
    if cfg.name == "adamw":
        return {"m": plog, "v": plog, "step": ()}

    def v_logical(lg):
        # vr drops the last dim's axis, vc drops the second-to-last's
        return ({"vr": lg[:-1], "vc": lg[:-2] + lg[-1:]} if len(lg) >= 2
                else {"v": lg})
    return {"v": _map_leaves(v_logical, plog), "step": ()}
