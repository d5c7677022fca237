"""Dense transformer layers: RMSNorm, RoPE, GQA attention, SwiGLU/GeLU MLP.

Twins of ``src/repro/models/layers.py`` (norms, rotary embeddings,
attention, MLP) as plain tensor functions over parameter dicts with the
reference's layouts (``wq [Dm,H,Dh]``, ``wo [H,Dh,Dm]``, activations
``[B,S,H,D]``).  The reference's sharding constraints have no role on one
card and are gone.  The MoE layer is not ported.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import decode_attention_op

NEG = -1e30            # the reference's mask value (not -inf)


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
