"""Decoder-only dense LM transformer (GQA, RoPE, SwiGLU/GeLU) for serving.

Twin of the dense part of ``src/repro/models/transformer.py``:
``TransformerConfig``, ``init_params``, ``forward_hidden``, ``forward``,
``prefill`` and the KV-cache pair ``init_kv_cache`` / ``decode_step``.

Parameters are a dict with the reference's names and layouts, but with one
dict per layer in ``params["layers"]`` instead of leaves stacked over
layers (``convert.py`` maps between the two).  They are held in the compute
dtype: the reference casts every layer's weights, ``embed`` and ``unembed``
to its ``compute_dtype`` at each use, which gives the same values as casting
once at load.  ``final_norm``, which the reference does not cast, stays f32.
The MoE layers, the loss and the training path are not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 128
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0     # chatglm3 uses 0.5 (2D RoPE)
    gated_mlp: bool = True         # SwiGLU; False is GeLU
    moe_experts: int = 0           # MoE is not ported: must stay 0
    norm_eps: float = 1e-5
    attn_block_q: int = 0          # q-block scan size (long prefill)

    def __post_init__(self):
        if self.moe_experts:
            raise NotImplementedError(
                f"{self.name}: MoE transformers are not ported")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: {self.n_heads} heads over "
                             f"{self.n_kv_heads} KV heads")

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        attn = d * self.d_head * (self.n_heads * 2 + self.n_kv_heads * 2)
        ff = (3 if self.gated_mlp else 2) * d * f
        return self.n_layers * (attn + ff + 2 * d) + 2 * v * d + d


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _normal(g, shape, scale, dtype, dev):
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=dev)
    return (x * scale).to(dtype)


def _init_layer(cfg: TransformerConfig, g, dtype, dev) -> dict:
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)
    s = d ** -0.5
    p = {
        "attn_norm": {"scale": torch.ones(d, dtype=dtype, device=dev)},
        "mlp_norm": {"scale": torch.ones(d, dtype=dtype, device=dev)},
        "attn": {
            "wq": _normal(g, (d, h, dh), s, dtype, dev),
            "wk": _normal(g, (d, kv, dh), s, dtype, dev),
            "wv": _normal(g, (d, kv, dh), s, dtype, dev),
            "wo": _normal(g, (h, dh, d), (h * dh) ** -0.5, dtype, dev),
        },
        "mlp": {"w_in": _normal(g, (d, f), s, dtype, dev),
                "w_out": _normal(g, (f, d), f ** -0.5, dtype, dev)},
    }
    if cfg.gated_mlp:
        p["mlp"]["w_gate"] = _normal(g, (d, f), s, dtype, dev)
    return p


def init_params(cfg: TransformerConfig, seed: int = 0, device=None,
                dtype=torch.bfloat16) -> dict:
    """Random weights of the reference's shapes and scales (normal draws
    from a ``torch.Generator`` seeded with ``seed``, on ``device``; they
    are not the reference's ``jax.random`` draws), held in ``dtype``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model
    return {
        "embed": _normal(g, (cfg.vocab_size, d), d ** -0.5, dtype, dev),
        "unembed": _normal(g, (d, cfg.vocab_size), d ** -0.5, dtype, dev),
        "final_norm": {"scale": torch.ones(d, dtype=torch.float32,
                                           device=dev)},
        "layers": [_init_layer(cfg, g, dtype, dev)
                   for _ in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _layer_fn(cfg: TransformerConfig, x, positions, lp, kv_cache=None,
              cache_index=None, backend=None):
    h, cache = L.attention(
        lp["attn"], L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps), positions,
        causal=True, rope_theta=cfg.rope_theta,
        rope_fraction=cfg.rope_fraction, kv_cache=kv_cache,
        cache_index=cache_index, block_q=cfg.attn_block_q, backend=backend)
    x = x + h
    h = L.mlp(lp["mlp"], L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps))
    return x + h, cache


def forward_hidden(params, tokens: torch.Tensor,
                   cfg: TransformerConfig) -> torch.Tensor:
    """tokens [B,S] -> final-norm hidden states [B,S,Dm] (params' dtype)."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    for lp in params["layers"]:
        x, _ = _layer_fn(cfg, x, positions, lp)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward(params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens [B,S] -> logits [B,S,V] (params' dtype)."""
    return forward_hidden(params, tokens, cfg) @ params["unembed"]


def prefill(params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Last-position logits [B,V] (the TTFT path); the unembed runs on the
    last position only."""
    return forward_hidden(params, tokens, cfg)[:, -1] @ params["unembed"]


# ---------------------------------------------------------------------------
# Serving: single-token decode with a KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def decode_step(params, cache: dict, tokens: torch.Tensor, cache_index: int,
                cfg: TransformerConfig, backend: str | None = None):
    """One serving step: tokens [B], cache_index an int.  Writes each
    layer's K/V at ``cache_index`` into ``cache`` in place and returns
    ``(logits [B,V], cache)``.  ``backend`` switches ``decode_attention``
    (None: the kernel on CUDA, the plain version on the CPU)."""
    b = tokens.shape[0]
    x = params["embed"][tokens.long()][:, None, :]               # [B,1,Dm]
    positions = torch.full((b, 1), int(cache_index), dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(params["layers"]):
        x, _ = _layer_fn(cfg, x, positions, lp,
                         kv_cache=(cache["k"][i], cache["v"][i]),
                         cache_index=cache_index, backend=backend)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ params["unembed"])[:, 0], cache
