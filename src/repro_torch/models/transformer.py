"""Decoder-only LM transformer (dense + MoE, GQA, RoPE, SwiGLU/GeLU) for
serving.

Twin of the serving part of ``src/repro/models/transformer.py``:
``TransformerConfig``, ``init_params``, ``forward_hidden``, ``forward``,
``prefill`` and the KV-cache pair ``init_kv_cache`` / ``decode_step``.
``forward_hidden`` and ``forward`` return the MoE aux loss beside their
output, as the reference's do.

Parameters are a dict with the reference's names and layouts, but with one
dict per layer in ``params["layers"]`` instead of leaves stacked over
layers (``convert.py`` maps between the two).  They are held in the compute
dtype: the reference casts every layer's weights, ``embed`` and ``unembed``
to its ``compute_dtype`` at each use, which gives the same values as casting
once at load (the MoE router too: the reference draws it in f32 and casts
it like the rest).  ``final_norm``, which the reference does not cast,
stays f32.  The loss and the training path are not ported.
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
    moe_experts: int = 0           # 0 => dense FFN
    moe_top_k: int = 2
    moe_dense_residual: bool = False   # arctic: dense MLP in parallel w/ MoE
    moe_dp_groups: int = 1         # dispatch groups of the prefill's MoE
    capacity_factor: float = 1.25
    norm_eps: float = 1e-5
    attn_block_q: int = 0          # q-block scan size (long prefill)

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: {self.n_heads} heads over "
                             f"{self.n_kv_heads} KV heads")

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def _ff_count(self, experts: int) -> int:
        d, f = self.d_model, self.d_ff
        if not self.is_moe:
            return (3 if self.gated_mlp else 2) * d * f
        ff = experts * 3 * d * f + d * self.moe_experts
        return ff + (3 * d * f if self.moe_dense_residual else 0)

    def _count(self, experts: int) -> int:
        d = self.d_model
        attn = d * self.d_head * (self.n_heads * 2 + self.n_kv_heads * 2)
        return self.n_layers * (attn + self._ff_count(experts) + 2 * d) \
            + 2 * self.vocab_size * d + d

    def param_count(self) -> int:
        return self._count(self.moe_experts)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        return self._count(self.moe_top_k if self.is_moe else 0)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _init_layer(cfg: TransformerConfig, g, dtype, dev) -> dict:
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                       cfg.d_ff)
    s = d ** -0.5
    p = {
        "attn_norm": {"scale": torch.ones(d, dtype=dtype, device=dev)},
        "mlp_norm": {"scale": torch.ones(d, dtype=dtype, device=dev)},
        "attn": {
            "wq": L.normal(g, (d, h, dh), s, dtype, dev),
            "wk": L.normal(g, (d, kv, dh), s, dtype, dev),
            "wv": L.normal(g, (d, kv, dh), s, dtype, dev),
            "wo": L.normal(g, (h, dh, d), (h * dh) ** -0.5, dtype, dev),
        },
    }
    if cfg.is_moe:
        p["moe"] = L.init_moe(g, d, f, cfg.moe_experts, dtype, dev)
    if not cfg.is_moe or cfg.moe_dense_residual:
        p["mlp"] = {"w_in": L.normal(g, (d, f), s, dtype, dev),
                    "w_out": L.normal(g, (f, d), f ** -0.5, dtype, dev)}
        if cfg.gated_mlp:
            p["mlp"]["w_gate"] = L.normal(g, (d, f), s, dtype, dev)
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
        "embed": L.normal(g, (cfg.vocab_size, d), d ** -0.5, dtype, dev),
        "unembed": L.normal(g, (d, cfg.vocab_size), d ** -0.5, dtype, dev),
        "final_norm": {"scale": torch.ones(d, dtype=torch.float32,
                                           device=dev)},
        "layers": [_init_layer(cfg, g, dtype, dev)
                   for _ in range(cfg.n_layers)],
    }


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _layer_fn(cfg: TransformerConfig, x, positions, lp, kv_cache=None,
              cache_index=None, backend=None, dp_groups=1):
    """One block -> (x, cache, the MoE aux loss as an f32 scalar)."""
    h, cache = L.attention(
        lp["attn"], L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps), positions,
        causal=True, rope_theta=cfg.rope_theta,
        rope_fraction=cfg.rope_fraction, kv_cache=kv_cache,
        cache_index=cache_index, block_q=cfg.attn_block_q, backend=backend)
    x = x + h
    hn = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    if cfg.is_moe:
        h, aux = L.moe(lp["moe"], hn, top_k=cfg.moe_top_k,
                       capacity_factor=cfg.capacity_factor,
                       dp_groups=dp_groups)
        if cfg.moe_dense_residual:
            h = h + L.mlp(lp["mlp"], hn)
    else:
        h = L.mlp(lp["mlp"], hn)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, cache, aux


def forward_hidden(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens [B,S] -> (final-norm hidden states [B,S,Dm] in params' dtype,
    the MoE aux loss summed over layers, an f32 scalar).  The MoE layers
    dispatch in ``cfg.moe_dp_groups`` groups."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        x, _, a = _layer_fn(cfg, x, positions, lp,
                            dp_groups=cfg.moe_dp_groups)
        aux = aux + a
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig):
    """tokens [B,S] -> (logits [B,S,V] in params' dtype, aux)."""
    x, aux = forward_hidden(params, tokens, cfg)
    return x @ params["unembed"], aux


def prefill(params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """Last-position logits [B,V] (the TTFT path); the unembed runs on the
    last position only."""
    return forward_hidden(params, tokens, cfg)[0][:, -1] @ params["unembed"]


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
    (None: the kernel on CUDA, the plain version on the CPU).  The MoE
    layers dispatch the B tokens flat, whatever ``cfg.moe_dp_groups``, as
    the reference's decode does."""
    b = tokens.shape[0]
    x = params["embed"][tokens.long()][:, None, :]               # [B,1,Dm]
    positions = torch.full((b, 1), int(cache_index), dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _layer_fn(cfg, x, positions, lp,
                            kv_cache=(cache["k"][i], cache["v"][i]),
                            cache_index=cache_index, backend=backend)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ params["unembed"])[:, 0], cache
