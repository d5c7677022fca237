"""Transformer layers: RMSNorm, RoPE, GQA attention, SwiGLU/GeLU MLP, MoE.

Twins of ``src/repro/models/layers.py`` (norms, rotary embeddings,
attention, MLP, the top-k Mixture of Experts) as plain tensor functions
over parameter dicts with the reference's layouts (``wq [Dm,H,Dh]``,
``wo [H,Dh,Dm]``, ``w_in [E,Dm,F]``, activations ``[B,S,H,D]``).

Each ``*_logical`` names the logical axes of its parameters, and
``rules`` (default None) reaches every point where the reference
constrains an activation (``utils.constrain``).  With ``rules=None`` the
layers run on plain tensors exactly as on one card.  With rules and
``DTensor`` parameters and inputs on a mesh they run sharded: attention
pads its heads to ``head_pad_to`` as the reference does, decode writes the
new K/V into the rank that holds its position and gathers a
sequence-sharded cache before ``decode_attention`` runs on each rank's
batch, and the MoE dispatches each data-parallel group's tokens on the
rank that holds them (see :func:`moe`).
"""
from __future__ import annotations

import dataclasses

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.ops import decode_attention_op
from repro_torch.utils import (constrain, is_dtensor, merge_dims, replicated,
                               split_dim, stable_topk)

NEG = -1e30            # the reference's mask value (not -inf)


def normal(g, shape, scale, dtype, dev) -> torch.Tensor:
    """``scale`` times a standard normal draw (f32, from ``g``), in
    ``dtype``."""
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=dev)
    return (x * scale).to(dtype)


def rmsnorm_logical() -> dict:
    return {"scale": ("d_model",)}


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


def _attend(q, kf, vf, scale, causal, mask, dtype, block_q: int):
    """Attention of q [B,S,H,D] over kf, vf [B,T,H,D], the queries in
    blocks of ``block_q`` when that divides S (bounding the score
    transient to ``[B,H,block_q,T]``)."""
    s = q.shape[1]
    pos = torch.arange(s, device=q.device)
    if block_q and s % block_q == 0 and s > block_q:
        return torch.cat([
            _attend_block(q[:, i:i + block_q], kf, vf, scale,
                          pos[i:i + block_q], causal, mask, dtype)
            for i in range(0, s, block_q)], dim=1)
    return _attend_block(q, kf, vf, scale, pos, causal, mask, dtype)


def _attend_local(q: DTensor, kf: DTensor, vf: DTensor, scale, causal,
                  mask, dtype, block_q: int) -> DTensor:
    """:func:`_attend` on each rank's rows and heads: q, kf and vf share
    their placements (batch and heads sharded, the sequences whole), so
    every rank attends with its local tensors alone, as each shard does
    under the reference's compiler."""
    mesh, pl = q.device_mesh, list(q.placements)
    if any(isinstance(p, Shard) and p.dim in (1, 3) for p in pl):
        raise ValueError(f"attention: placements {pl} shard a sequence")
    kf, vf = (a.redistribute(mesh, pl) for a in (kf, vf))
    if mask is not None:
        rows = [p if p == Shard(0) else Replicate() for p in pl]
        if not isinstance(mask, DTensor):
            mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        mask = mask.redistribute(mesh, rows).to_local()
    out = _attend(q.to_local(), kf.to_local(), vf.to_local(), scale, causal,
                  mask, dtype, block_q)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def _project(x: torch.Tensor, w: torch.Tensor, rules=None) -> torch.Tensor:
    """x [B,S,Dm] @ w [Dm,H,D] -> [B,S,H,D].  On a mesh the weight is
    gathered over ``fsdp`` and its H*D columns split over the heads' axes
    first (column parallel; a reduce-scatter of its gradient comes back),
    so the product's plan is the same whatever strategy a torch release's
    ``DTensor`` would pick for a product of shards, and no rank repeats
    another's columns."""
    heads = w.shape[1]
    w = merge_dims(w, 1)
    if rules is not None:
        w = constrain(w, (None, "heads"), rules)
    return split_dim(x @ w, 2, heads)


def _heads_to(a: torch.Tensor, n: int, rules) -> torch.Tensor:
    """``a [B,S,H,D]`` zero-padded, or cut, to ``n`` heads.  A ``DTensor``
    is first laid out with its heads whole and padded or cut on each rank
    (``DTensor``'s own rule for a pad of a sharded tensor is not sound in
    every release)."""
    if not is_dtensor(a):
        return F.pad(a, (0, 0, 0, n - a.shape[2]))
    a = constrain(a, ("batch", None, None, None), rules)
    local = a.to_local()
    local = (F.pad(local, (0, 0, 0, n - a.shape[2])) if n > a.shape[2]
             else local[:, :, :n])
    return DTensor.from_local(local, a.device_mesh, a.placements,
                              run_check=False)


def attention_logical(head_tp: bool) -> dict:
    """Logical axes of the attention weights: ``head_tp`` shards them by
    head (Megatron); without it the heads are replicated and the
    activations are padded and head-sharded instead (``head_pad_to``)."""
    h = "heads" if head_tp else None
    return {"wq": ("fsdp", h, None), "wk": ("fsdp", "kv_heads", None),
            "wv": ("fsdp", "kv_heads", None), "wo": (h, None, "fsdp")}


def _write_position(cache: DTensor, pos: int, new: DTensor) -> None:
    """``cache[:, pos] = new`` for a ``DTensor`` cache ``[B, S, Hkv, D]``
    whose S dim may be sharded: ``new [B, Hkv, D]`` is laid out as the
    cache without its S dim, and the rank whose shard holds ``pos``
    writes it into its local block."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = cache.device_mesh
    pl = [Replicate() if p == Shard(1) else
          Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1 else p
          for p in cache.placements]
    new = new.to(cache.dtype).redistribute(mesh, pl).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    if offset[1] <= pos < offset[1] + shape[1]:
        cache.to_local()[:, pos - offset[1]] = new


def _decode_sharded(q: DTensor, ck: DTensor, cv: DTensor, cache_index,
                    backend):
    """``decode_attention`` on each rank's rows: the cache is gathered
    along S where it is sharded (an all-gather), q takes the cache's batch
    placement, and the kernel (the plain version on the CPU) runs on the
    local tensors.  -> ``[B, H, D]`` f32 ``DTensor``."""
    mesh = ck.device_mesh
    cache_pl = [Replicate() if p == Shard(1) else p for p in ck.placements]
    if any(isinstance(p, Shard) and p.dim != 0 for p in cache_pl):
        raise ValueError(f"decode: cache placements {ck.placements}")
    ck = ck.redistribute(mesh, cache_pl)
    cv = cv.redistribute(mesh, cache_pl)
    q = q.redistribute(mesh, cache_pl)
    out = decode_attention_op(q.to_local(), ck.to_local(), cv.to_local(),
                              cache_index, backend=backend)
    return DTensor.from_local(out, mesh, cache_pl, run_check=False)


def kv_seq_axis(max_seq: int) -> str:
    """The logical axis of a KV cache's sequence: a cache of 2**18
    positions or more (the 500k-context decode) is sharded over both mesh
    axes."""
    return "kv_seq_long" if max_seq >= 2 ** 18 else "kv_seq"


def attention(params, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool, rope_theta: float, rope_fraction: float = 1.0,
              kv_cache=None, cache_index=None, mask=None, block_q: int = 0,
              backend: str | None = None, rules=None, head_tp: bool = True,
              head_pad_to: int = 0):
    """Multi-head GQA attention.  Returns ``(out [B,S,Dm], cache)``.

    ``block_q > 0`` scans the queries in blocks of that size, bounding the
    score transient to ``[B,H,block_q,T]``.

    With ``rules`` (a mesh), as the reference (``layers.py:124-214``): the
    queries, the repeated K/V and the output are head-sharded (``heads``
    when ``head_tp`` or ``head_pad_to``), and the heads are zero-padded to
    ``head_pad_to`` first; the padded rows are sliced away before ``wo``,
    so the result is the same.  Without rules nothing is padded.

    With ``kv_cache = (k [B,S,Hkv,D], v)`` (decode, x [B,1,Dm]) the new K/V
    are written at ``cache_index`` in place and the token attends to the
    positions ``<= cache_index`` through ``decode_attention`` (``backend``
    is its kernel switch); the returned cache is the same tensors.
    """
    b, s, _ = x.shape
    n_heads, d_head = params["wq"].shape[1], params["wq"].shape[2]
    scale = d_head ** -0.5
    # sequence parallelism: the projections take the whole sequence
    x = constrain(x, ("batch", None, "d_model"), rules)

    q = apply_rope(_project(x, params["wq"], rules), positions, rope_theta,
                   rope_fraction)
    k = apply_rope(_project(x, params["wk"], rules), positions, rope_theta,
                   rope_fraction)
    v = _project(x, params["wv"], rules)

    if kv_cache is not None:
        if s != 1:
            raise ValueError(f"attention: decode takes one token, got {s}")
        ck, cv = kv_cache
        if is_dtensor(ck):
            _write_position(ck, cache_index, k[:, 0])
            _write_position(cv, cache_index, v[:, 0])
            kv_ax = kv_seq_axis(ck.shape[1])
            ck = constrain(ck, ("batch", kv_ax, "kv_heads", None), rules)
            cv = constrain(cv, ("batch", kv_ax, "kv_heads", None), rules)
            out = _decode_sharded(q[:, 0].to(ck.dtype), ck, cv, cache_index,
                                  backend)
        else:
            ck[:, cache_index] = k[:, 0].to(ck.dtype)
            cv[:, cache_index] = v[:, 0].to(cv.dtype)
            out = decode_attention_op(q[:, 0].to(ck.dtype), ck, cv,
                                      cache_index, backend=backend)
        out = out.to(x.dtype)[:, None]
        new_cache = (ck, cv)
    else:
        # the K/V heads are repeated where they lie whole (``kv_heads``),
        # then laid out by the constraint below
        k, v = (constrain(a, ("batch", None, "kv_heads", None), rules)
                for a in (k, v))
        kf, vf = _repeat_kv(k, n_heads), _repeat_kv(v, n_heads)
        h_eff, head_ax = n_heads, None
        if rules is not None:
            head_ax = "heads" if (head_tp or head_pad_to) else None
            if head_ax:
                h_eff = max(head_pad_to, n_heads)
            if h_eff > n_heads:
                q, kf, vf = (_heads_to(a, h_eff, rules) for a in (q, kf, vf))
            q, kf, vf = (constrain(a, ("batch", None, head_ax, None), rules)
                         for a in (q, kf, vf))
        if is_dtensor(q):
            out = _attend_local(q, kf, vf, scale, causal, mask, x.dtype,
                                block_q)
        else:
            out = _attend(q, kf, vf, scale, causal, mask, x.dtype, block_q)
        out = constrain(out, ("batch", None, head_ax, None), rules)
        if h_eff > n_heads:
            out = _heads_to(out, n_heads, rules)
        new_cache = None

    # row parallel: the heads' H*D rows split over the heads' axes on both
    # sides (the weight gathered over ``fsdp``), the partial sums reduced
    # by the constraint below
    out, wo = merge_dims(out, 2), merge_dims(params["wo"], 0)
    if rules is not None:
        out = constrain(out, ("batch", None, "heads"), rules)
        wo = constrain(wo, ("heads", None), rules)
    out = out @ wo
    return constrain(out, ("batch", "seq", "d_model"), rules), new_cache


def mlp_logical(gated: bool = True) -> dict:
    p = {"w_in": ("fsdp", "d_ff"), "w_out": ("d_ff", "fsdp")}
    if gated:
        p["w_gate"] = ("fsdp", "d_ff")
    return p


def mlp(params, x: torch.Tensor, rules=None) -> torch.Tensor:
    """Gated SiLU (``w_gate`` present) or GeLU (tanh approximation, which is
    ``jax.nn.gelu``'s default) feed-forward; on a mesh the input takes the
    whole sequence, as in attention.  Its weights are gathered over
    ``fsdp`` and split over ``d_ff`` first (column parallel, then row
    parallel), so the plan does not depend on the torch release."""
    x = constrain(x, ("batch", None, "d_model"), rules)
    if rules is not None:
        params = {k: constrain(w, ("d_ff", None) if k == "w_out"
                               else (None, "d_ff"), rules)
                  for k, w in params.items()}
    h = x @ params["w_in"]
    if "w_gate" in params:
        h = F.silu(x @ params["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = constrain(h, ("batch", None, "d_ff"), rules)
    return constrain(h @ params["w_out"], ("batch", "seq", "d_model"), rules)


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


def moe_logical() -> dict:
    # experts own the 'model' axis (EP); the FSDP ('data') axis shards the
    # d_model dim -- a second use of 'model' (e.g. on d_ff) would double-map
    return {"router": ("fsdp", None), "w_in": ("experts", "fsdp", None),
            "w_gate": ("experts", "fsdp", None),
            "w_out": ("experts", None, "fsdp")}


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


def _moe_experts(params, buf: torch.Tensor, rules=None,
                 gax=None) -> torch.Tensor:
    """``buf [E, C, Dm]`` through each expert's SwiGLU -> ``[E, C, Dm]``.
    On a mesh each expert weight is gathered whole on its ``experts``
    ranks first (FSDP: an all-gather over ``fsdp``, a reduce-scatter of
    its gradient), and the hidden ``h`` is laid out as the reference lays
    it (``experts``, and ``gax`` over the rows): the plan is then the same
    whatever strategy a torch release's ``DTensor`` would pick for a
    product of shards."""
    w = {k: constrain(params[k], ("experts", None, None), rules)
         for k in ("w_gate", "w_in", "w_out")}
    h = silu(torch.bmm(buf, w["w_gate"])) * torch.bmm(buf, w["w_in"])
    h = constrain(h, ("experts", gax, None), rules)
    return torch.bmm(h, w["w_out"])


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


def _moe_sharded(params, x: DTensor, top_k: int, capacity_factor: float,
                 rules, g: int):
    """:func:`moe` on a mesh.  When the G groups are the data-parallel
    ranks (G equals the size of the ``batch`` axes and x's batch is
    sharded over them), each rank dispatches the group it holds, as the
    reference's vmap over ``batch``-sharded groups does; otherwise (flat
    dispatch, G = 1) every rank dispatches all tokens, gathered whole.  The
    buffers ``[E, G, C, Dm]`` shard their experts over ``experts``, the
    experts run on each rank's slice, and the outputs are gathered back
    over ``experts`` for the combine.  Routing runs on plain tensors: it
    sorts with ties kept, which ``DTensor`` has no rule for."""
    mesh = x.device_mesh
    b, s, dm = x.shape
    e = params["router"].shape[-1]
    t_g = b * s // g
    capacity = int(capacity_factor * t_g * top_k / e) + 1
    names = tuple(mesh.mesh_dim_names)
    batch_axes = rules.get("batch") or ()
    dp = [names.index(a) for a in
          ((batch_axes,) if isinstance(batch_axes, str) else batch_axes)
          if a in names]
    xb = constrain(x, ("batch", None, "d_model"), rules)
    local = (g > 1 and g == math.prod(mesh.size(i) for i in dp)
             and all(xb.placements[i] == Shard(0) for i in dp))
    if local:
        xs = xb.to_local().reshape(1, t_g, dm)
        grp = [Shard(1) if i in dp else Replicate()
               for i in range(mesh.ndim)]
    else:
        xs = replicated(x).to_local().reshape(g, t_g, dm)
        grp = [Replicate()] * mesh.ndim
    gax = "batch" if local else None
    # the router's gradient is the sum of the groups' (partial over the
    # data-parallel ranks when each dispatches its own group)
    router = replicated(params["router"]).to_local(grad_placements=[
        Partial() if local and i in dp else Replicate()
        for i in range(mesh.ndim)])
    groups = [_moe_dispatch(xt, router, top_k, capacity, e) for xt in xs]
    buf = DTensor.from_local(torch.stack([gr[0] for gr in groups], dim=1),
                             mesh, grp, run_check=False)   # [E, G, C, Dm]
    buf = constrain(buf, ("experts", gax, None, None), rules)
    out_buf = _moe_experts(params, buf.flatten(1, 2), rules, gax)
    out_buf = constrain(out_buf.view(e, g, capacity, dm),
                        (None, gax, None, None), rules).to_local()
    out = torch.cat([_moe_combine(out_buf[:, i], gr[1], x.dtype)
                     for i, gr in enumerate(groups)])
    aux = torch.stack([gr[2] for gr in groups]).mean()
    if local:
        out = DTensor.from_local(out.view(b // g, s, dm), mesh,
                                 xb.placements, run_check=False)
        aux = DTensor.from_local(aux.reshape(1), mesh,
                                 [Shard(0) if p == Shard(1) else p
                                  for p in grp], run_check=False).mean()
    else:
        rep = [Replicate()] * mesh.ndim
        out = DTensor.from_local(out.view(b, s, dm), mesh, rep,
                                 run_check=False)
        aux = DTensor.from_local(aux, mesh, rep, run_check=False)
    return constrain(out, ("batch", "seq", "d_model"), rules), aux


def moe(params, x: torch.Tensor, *, top_k: int,
        capacity_factor: float = 1.25, dp_groups: int = 1, rules=None):
    """Top-k MoE with sort-based, fixed-capacity dispatch (``layers.py:
    327-386``).  ``x [B, S, Dm]`` -> ``(out [B, S, Dm], aux)``.

    ``dp_groups = G > 1`` dispatches each of G equal token groups on its
    own, at the per-group capacity ``int(cf * T/G * k / E) + 1``, and aux
    is the mean over groups (the reference's hierarchical dispatch; here a
    loop over groups, the experts run once over all groups' buffers).
    With ``rules`` and a ``DTensor`` x it runs sharded
    (:func:`_moe_sharded`), with the same groups and results.
    """
    if rules is not None and is_dtensor(x):
        t, g = x.shape[0] * x.shape[1], max(dp_groups, 1)
        if t % g:
            raise ValueError(f"moe: {t} tokens over {g} groups")
        return _moe_sharded(params, x, top_k, capacity_factor, rules, g)
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
