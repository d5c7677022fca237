"""Transformer layers: RMSNorm, RoPE, GQA attention, SwiGLU/GeLU MLP, MoE.

Twins of ``src/repro/models/layers.py`` (norms, rotary embeddings,
attention, MLP, the top-k Mixture of Experts) as plain tensor functions
over parameter dicts with the reference's layouts (``wq [Dm,H,Dh]``,
``wo [H,Dh,Dm]``, ``w_in [E,Dm,F]``, activations ``[B,S,H,D]``).  The
reference's sharding constraints have no role on one card and are gone,
and so is ``moe_logical``, which only names the experts' mesh axes.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import decode_attention_op
from repro_torch.utils import stable_topk

NEG = -1e30            # the reference's mask value (not -inf)


def normal(g, shape, scale, dtype, dev) -> torch.Tensor:
    """``scale`` times a standard normal draw (f32, from ``g``), in
    ``dtype``."""
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=dev)
    return (x * scale).to(dtype)


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def rope_table(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """[.., dim/2] cos/sin tables for the given positions."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv_freq = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, fraction: float = 1.0) -> torch.Tensor:
    """Rotate the first ``fraction`` of head dims, in interleaved (even, odd)
    pairs.  x [B,S,H,D], positions [B,S]; ``fraction=0.5`` is ChatGLM's
    2D-RoPE (rotate half the dims, pass the rest)."""
    d = x.shape[-1]
    rot_d = int(d * fraction)
    if rot_d == 0:
        return x
    rot_d -= rot_d % 2
    x_rot, x_pass = x[..., :rot_d], x[..., rot_d:]
    cos, sin = rope_table(positions, rot_d, theta)          # [B,S,rot_d/2]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    out = torch.cat([y, x_pass], dim=-1) if x_pass.shape[-1] else y
    return out.to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """GQA: repeat KV heads [B,T,Hkv,D] to the query heads' count."""
    group = n_heads // k.shape[2]
    return k.repeat_interleave(group, dim=2) if group > 1 else k


def _attend_block(q_blk, k, v, scale, q_pos, causal, mask, dtype):
    """q_blk [B,bq,H,D], k/v [B,T,H,D], q_pos [bq] -> out [B,bq,H,D]."""
    scores = torch.einsum("bshd,bthd->bhst", q_blk, k) * scale
    t = k.shape[1]
    if causal:
        j = torch.arange(t, device=k.device)[None, :]
        scores = torch.where(j <= q_pos[:, None], scores, NEG)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :], scores, NEG)
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,Dm] @ w [Dm,H,D] -> [B,S,H,D]."""
    b, s, _ = x.shape
    return (x @ w.flatten(1)).view(b, s, w.shape[1], w.shape[2])


def attention(params, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool, rope_theta: float, rope_fraction: float = 1.0,
              kv_cache=None, cache_index=None, mask=None, block_q: int = 0,
              backend: str | None = None):
    """Multi-head GQA attention.  Returns ``(out [B,S,Dm], cache)``.

    ``block_q > 0`` scans the queries in blocks of that size, bounding the
    score transient to ``[B,H,block_q,T]``.  The reference's ``head_pad_to``
    zero-pads heads to a count its tensor-parallel mesh divides; the padded
    rows are sliced away before ``wo``, so the result is the same without
    them, and one card has no mesh to pad for.

    With ``kv_cache = (k [B,S,Hkv,D], v)`` (decode, x [B,1,Dm]) the new K/V
    are written at ``cache_index`` in place and the token attends to the
    positions ``<= cache_index`` through ``decode_attention`` (``backend``
    is its kernel switch); the returned cache is the same tensors.
    """
    b, s, _ = x.shape
    n_heads, d_head = params["wq"].shape[1], params["wq"].shape[2]
    scale = d_head ** -0.5

    q = apply_rope(_project(x, params["wq"]), positions, rope_theta,
                   rope_fraction)
    k = apply_rope(_project(x, params["wk"]), positions, rope_theta,
                   rope_fraction)
    v = _project(x, params["wv"])

    if kv_cache is not None:
        if s != 1:
            raise ValueError(f"attention: decode takes one token, got {s}")
        ck, cv = kv_cache
        ck[:, cache_index] = k[:, 0].to(ck.dtype)
        cv[:, cache_index] = v[:, 0].to(cv.dtype)
        out = decode_attention_op(q[:, 0].to(ck.dtype), ck, cv, cache_index,
                                  backend=backend)
        out = out.to(x.dtype)[:, None]
        new_cache = (ck, cv)
    else:
        kf, vf = _repeat_kv(k, n_heads), _repeat_kv(v, n_heads)
        if block_q and s % block_q == 0 and s > block_q:
            pos = torch.arange(s, device=x.device)
            out = torch.cat([
                _attend_block(q[:, i:i + block_q], kf, vf, scale,
                              pos[i:i + block_q], causal, mask, x.dtype)
                for i in range(0, s, block_q)], dim=1)
        else:
            out = _attend_block(q, kf, vf, scale,
                                torch.arange(s, device=x.device), causal,
                                mask, x.dtype)
        new_cache = None

    out = out.flatten(2) @ params["wo"].flatten(0, 1)
    return out, new_cache


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU (``w_gate`` present) or GeLU (tanh approximation, which is
    ``jax.nn.gelu``'s default) feed-forward."""
    h = x @ params["w_in"]
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k routing, sort-based capacity dispatch)
# ---------------------------------------------------------------------------

def init_moe(g, d_model: int, d_ff: int, n_experts: int, dtype, dev,
             router_dtype=None) -> dict:
    """The reference's shapes and scales, drawn from ``g`` one expert at a
    time (a full f32 draw of arctic-480b's ``[128, 7168, 4864]`` would take
    17.9 GB).  The router is held in ``router_dtype`` (default ``dtype``):
    serving holds it in the compute dtype like every other weight, since
    the reference draws it in f32 but casts it to the compute dtype before
    use, and :func:`moe` widens it back to f32 for the routing product;
    training masters hold it in f32, as the reference does."""
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5

    def experts(shape, scale):
        w = torch.empty((n_experts, *shape), dtype=dtype, device=dev)
        for i in range(n_experts):
            w[i] = normal(g, shape, scale, dtype, dev)
        return w

    return {"router": normal(g, (d_model, n_experts), s_in,
                             router_dtype or dtype, dev),
            "w_in": experts((d_model, d_ff), s_in),
            "w_gate": experts((d_model, d_ff), s_in),
            "w_out": experts((d_ff, d_model), s_out)}


@dataclasses.dataclass
class MoeRouting:
    """One token group's dispatch, in the reference's expert-major sorted
    order of the ``T*k`` (token, slot) entries: the buffer row ``slot``
    each entry reads (``expert * capacity + position``, position 0 when
    dropped), its token ``src`` (``T`` when dropped), its gate weight
    ``sw`` and ``keep``; ``add_order [T, k]``, each token's entries'
    sorted positions ascending (the order of the reference's scatter
    adds); ``gate_idx [T, k]``; ``overflow [E]``, the experts that dropped
    an entry (each also lost the token it kept at position 0, see
    :func:`_moe_dispatch`); and ``capacity``."""
    slot: torch.Tensor
    src: torch.Tensor
    sw: torch.Tensor
    keep: torch.Tensor
    add_order: torch.Tensor
    gate_idx: torch.Tensor
    overflow: torch.Tensor
    capacity: int


def _moe_dispatch(xt: torch.Tensor, router: torch.Tensor, top_k: int,
                  capacity: int, e: int):
    """Sort-based capacity dispatch of one token group (``layers.py:
    277-308``).  ``xt [T, Dm]`` -> (buf ``[E, capacity, Dm]``,
    :class:`MoeRouting`, the Switch-style aux loss).

    Routing is an f32 product with the router widened to f32, a softmax,
    the top-k with ties to the lower expert and the renormalised weights.
    The entries sort stably by expert, so each expert's are in (token,
    slot) order, and those past ``capacity`` are dropped.  The reference
    writes every dropped entry's zero row to position 0 of its expert,
    after the kept rows (the last of duplicate writes wins on its CPU), so
    an expert that drops anything also loses the token it kept at position
    0.  The port writes the kept rows, then zeroes position 0 of every
    expert that dropped an entry, without relying on the order of
    duplicate writes.  No step waits for the device.
    """
    t, dm = xt.shape
    dev = xt.device
    logits = xt.float() @ router.float()                          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_idx = stable_topk(probs, top_k)                  # [T, k]
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    # aux load-balancing loss (Switch-style)
    density = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = (density * probs.mean(dim=0)).sum() * e

    flat_e = gate_idx.reshape(-1)                                  # [T*k]
    order = torch.argsort(flat_e, stable=True)
    se, sw = flat_e[order], gate_w.reshape(-1)[order]
    st = order // top_k
    experts = torch.arange(e, device=dev)
    seg_start = torch.searchsorted(se, experts)
    overflow = torch.searchsorted(se, experts, right=True) - seg_start \
        > capacity
    pos = torch.arange(t * top_k, device=dev) - seg_start[se]
    keep = pos < capacity
    slot = se * capacity + torch.where(keep, pos, 0)
    # each token's entries in sorted (expert) order
    at = torch.empty_like(order)
    at[order] = torch.arange(t * top_k, device=dev)
    add_order = at.view(t, top_k).sort(dim=1).values

    # kept rows to their slots, dropped ones to a spare row cut off after
    buf = xt.new_zeros((e * capacity + 1, dm))
    buf[torch.where(keep, slot, e * capacity)] = xt[st]
    buf = buf[:-1].view(e, capacity, dm)
    buf[:, 0] = torch.where(overflow[:, None], 0.0, buf[:, 0])
    return buf, MoeRouting(slot, torch.where(keep, st, t), sw, keep,
                           add_order, gate_idx, overflow, capacity), aux


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference's XLA computes it, ``x * (1 / (1 +
    exp(-x)))`` with each step rounded to ``x``'s dtype.  In bf16 this is
    bit-equal to the reference on the CPU, where ``F.silu`` (one rounding)
    differs in about 40% of the elements by an ulp."""
    return x * (1 / (1 + torch.exp(-x)))


def _moe_experts(params, buf: torch.Tensor) -> torch.Tensor:
    """``buf [E, C, Dm]`` through each expert's SwiGLU -> ``[E, C, Dm]``."""
    h = silu(torch.bmm(buf, params["w_gate"])) * torch.bmm(buf,
                                                           params["w_in"])
    return torch.bmm(h, params["w_out"])


def _moe_combine(out_buf: torch.Tensor, r: MoeRouting,
                 dtype) -> torch.Tensor:
    """Each entry's expert output times ``sw * keep`` (an f32 product,
    then ``dtype``), summed per token in ``dtype`` in the reference's
    scatter order: its entries by ascending expert, rounded after each
    add.  Dropped entries add zeros.  -> ``[T, Dm]``."""
    flat = out_buf.reshape(-1, out_buf.shape[-1])
    w = (r.sw * r.keep)[:, None]
    parts = (flat[r.slot].float() * w).to(dtype)[r.add_order]    # [T,k,Dm]
    out = parts[:, 0]
    for j in range(1, parts.shape[1]):
        out = out + parts[:, j]
    return out


def moe(params, x: torch.Tensor, *, top_k: int,
        capacity_factor: float = 1.25, dp_groups: int = 1):
    """Top-k MoE with sort-based, fixed-capacity dispatch (``layers.py:
    327-386``).  ``x [B, S, Dm]`` -> ``(out [B, S, Dm], aux)``.

    ``dp_groups = G > 1`` dispatches each of G equal token groups on its
    own, at the per-group capacity ``int(cf * T/G * k / E) + 1``, and aux
    is the mean over groups (the reference's hierarchical dispatch; here a
    loop over groups, the experts run once over all groups' buffers).
    """
    b, s, dm = x.shape
    e = params["router"].shape[-1]
    t, g = b * s, max(dp_groups, 1)
    if t % g:
        raise ValueError(f"moe: {t} tokens over {g} groups")
    t_g = t // g
    capacity = int(capacity_factor * t_g * top_k / e) + 1
    groups = [_moe_dispatch(xt, params["router"], top_k, capacity, e)
              for xt in x.reshape(g, t_g, dm)]
    buf = torch.stack([gr[0] for gr in groups], dim=1)    # [E, G, C, Dm]
    out_buf = _moe_experts(params, buf.view(e, g * capacity, dm))
    out_buf = out_buf.view(e, g, capacity, dm)
    out = torch.cat([_moe_combine(out_buf[:, i], gr[1], x.dtype)
                     for i, gr in enumerate(groups)])
    aux = torch.stack([gr[2] for gr in groups]).mean()
    return out.view(b, s, dm), aux
