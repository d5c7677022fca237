"""Decoder-only LM transformer (dense + MoE, GQA, RoPE, SwiGLU/GeLU) for
serving and training.

Twin of ``src/repro/models/transformer.py``: ``TransformerConfig``,
``init_params``, ``forward_hidden``, ``forward``, ``loss_fn``, ``prefill``
and the KV-cache pair ``init_kv_cache`` / ``decode_step``.
``forward_hidden`` and ``forward`` return the MoE aux loss beside their
output, as the reference's do.  :func:`params_logical` and
:func:`kv_cache_logical` name the logical axes of the parameters and the
cache; ``rules`` (default None) reaches the reference's constraints in
every entry point, which run sharded when the parameters are ``DTensor``
leaves on a mesh (``utils.tree_distribute``).  The config's ``head_tp``
and ``head_pad_to`` act only under rules.

Parameters are a dict with the reference's names and layouts, but with one
dict per layer in ``params["layers"]`` instead of leaves stacked over
layers (``convert.py`` maps between the two).  Two ways to hold them:

* Serving (``init_params``): every weight in the compute dtype, cast once
  at load.  The reference casts every layer's weights, ``embed`` and
  ``unembed`` to its ``compute_dtype`` at each use, which gives the same
  values (the MoE router too: the reference draws it in f32 and casts it
  like the rest).  ``final_norm``, which the reference does not cast,
  stays f32.  ``forward_hidden`` / ``forward`` called without
  ``compute_dtype`` use the weights as held.
* Training (``init_master_params``): master weights in the config's
  ``param_dtype`` (the router always f32), as the reference holds them.
  ``forward_hidden`` / ``forward`` / ``loss_fn`` with a ``compute_dtype``
  cast each layer's floating leaves inside the block, as the reference's
  scanned body does, so gradients reach the masters in their own dtype;
  ``cfg.remat`` recomputes each block in the backward
  (``torch.utils.checkpoint``), all of it (``"full"``) or all but the
  products without batch dims (``"dots"``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import layers as L
from repro_torch.utils import (constrain, is_dtensor, logsumexp_last,
                               mesh_scope, resolve_device, seeded_generator,
                               take_last)


REMAT_POLICIES = ("full", "dots")


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
    head_tp: bool = True           # shard attention WEIGHTS by head
    head_pad_to: int = 0           # pad activation heads to a TP-divisible
                                   # count when n_heads % tp != 0
    param_dtype: torch.dtype = torch.float32   # the training masters'
    remat: bool = True             # recompute each block in the backward
    # 'full' recomputes everything; 'dots' saves the products without
    # batch dims (jax's dots_with_no_batch_dims_saveable)
    remat_policy: str = "full"

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: {self.n_heads} heads over "
                             f"{self.n_kv_heads} KV heads")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"{self.name}: remat_policy "
                             f"{self.remat_policy!r} not in {REMAT_POLICIES}")

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

def _init_layer(cfg: TransformerConfig, g, dtype, dev, router_dtype) -> dict:
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
        p["moe"] = L.init_moe(g, d, f, cfg.moe_experts, dtype, dev,
                              router_dtype)
    if not cfg.is_moe or cfg.moe_dense_residual:
        p["mlp"] = {"w_in": L.normal(g, (d, f), s, dtype, dev),
                    "w_out": L.normal(g, (f, d), f ** -0.5, dtype, dev)}
        if cfg.gated_mlp:
            p["mlp"]["w_gate"] = L.normal(g, (d, f), s, dtype, dev)
    return p


def _init(cfg: TransformerConfig, seed, device, dtype, router_dtype,
          final_norm_dtype) -> dict:
    dev = resolve_device(device)
    g = seeded_generator(dev, seed)
    d = cfg.d_model
    return {
        "embed": L.normal(g, (cfg.vocab_size, d), d ** -0.5, dtype, dev),
        "unembed": L.normal(g, (d, cfg.vocab_size), d ** -0.5, dtype, dev),
        "final_norm": {"scale": torch.ones(d, dtype=final_norm_dtype,
                                           device=dev)},
        "layers": [_init_layer(cfg, g, dtype, dev, router_dtype)
                   for _ in range(cfg.n_layers)],
    }


def init_params(cfg: TransformerConfig, seed: int = 0, device=None,
                dtype=torch.bfloat16) -> dict:
    """Serving weights: random draws of the reference's shapes and scales
    (normal draws from a ``torch.Generator`` seeded with ``seed``, on
    ``device``; they are not the reference's ``jax.random`` draws), held in
    ``dtype``, ``final_norm`` in f32."""
    return _init(cfg, seed, device, dtype, dtype, torch.float32)


def init_master_params(cfg: TransformerConfig, seed: int = 0, device=None,
                       dtype=None) -> dict:
    """Training masters: the same draws as :func:`init_params`, held in
    ``dtype`` (default ``cfg.param_dtype``), the norms and ``final_norm``
    too, and the MoE router in f32, as the reference's ``init_params``
    holds them (``src/repro/models/layers.py:258``)."""
    dtype = cfg.param_dtype if dtype is None else dtype
    return _init(cfg, seed, device, dtype, torch.float32, dtype)


def params_logical(cfg: TransformerConfig) -> dict:
    """Logical axes of the parameters, the tree of :func:`init_params`:
    one dict a layer in ``layers`` (the reference's stacked leaves without
    their leading, never sharded, layer dim)."""
    layer = {"attn_norm": L.rmsnorm_logical(),
             "mlp_norm": L.rmsnorm_logical(),
             "attn": L.attention_logical(cfg.head_tp)}
    if cfg.is_moe:
        layer["moe"] = L.moe_logical()
    if not cfg.is_moe or cfg.moe_dense_residual:
        layer["mlp"] = L.mlp_logical(cfg.gated_mlp)
    return {
        # embed: rows replicated, d_model FSDP'd -- a vocab-sharded table
        # makes the token gather all-gather the whole table
        "embed": (None, "fsdp"),
        "unembed": ("fsdp", "vocab"),
        "final_norm": L.rmsnorm_logical(),
        "layers": [layer] * cfg.n_layers,
    }


# ---------------------------------------------------------------------------
# Forward (prefill, training) and the loss
# ---------------------------------------------------------------------------

def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``tokens``: an index on plain tensors, ``F.embedding``
    (which has a sharding rule) on a ``DTensor`` table."""
    if is_dtensor(table):
        return torch.nn.functional.embedding(tokens.long(), table)
    return table[tokens.long()]


def _layer_fn(cfg: TransformerConfig, x, positions, lp, kv_cache=None,
              cache_index=None, backend=None, dp_groups=1, rules=None):
    """One block -> (x, cache, the MoE aux loss as an f32 scalar)."""
    h, cache = L.attention(
        lp["attn"], L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps), positions,
        causal=True, rope_theta=cfg.rope_theta,
        rope_fraction=cfg.rope_fraction, kv_cache=kv_cache,
        cache_index=cache_index, block_q=cfg.attn_block_q, backend=backend,
        rules=rules, head_tp=cfg.head_tp, head_pad_to=cfg.head_pad_to)
    x = x + h
    hn = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
    if cfg.is_moe:
        h, aux = L.moe(lp["moe"], hn, top_k=cfg.moe_top_k,
                       capacity_factor=cfg.capacity_factor,
                       dp_groups=dp_groups, rules=rules)
        if cfg.moe_dense_residual:
            h = h + L.mlp(lp["mlp"], hn, rules)
    else:
        h = L.mlp(lp["mlp"], hn, rules)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, cache, aux


def _cast(tree: dict, dtype) -> dict:
    """A layer's parameters with every floating leaf in ``dtype``."""
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}


def _train_block(cfg: TransformerConfig, compute_dtype, rules, x,
                 positions, lp):
    """One block on master weights, cast to ``compute_dtype`` inside it (so
    a recomputed block casts them again) -> (x, aux)."""
    x, _, aux = _layer_fn(cfg, x, positions, _cast(lp, compute_dtype),
                          dp_groups=cfg.moe_dp_groups, rules=rules)
    return x, aux


# the products without batch dims: every ``x @ W`` of attention, the MLP
# and the router; attention's einsums and the experts' bmm have batch dims
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _run_block(cfg: TransformerConfig, compute_dtype, rules, x, positions,
               lp):
    block = functools.partial(_train_block, cfg, compute_dtype, rules)
    if not (cfg.remat and torch.is_grad_enabled()):
        return block(x, positions, lp)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(block, x, positions, lp, use_reentrant=False, **kw)


def forward_hidden(params, tokens: torch.Tensor, cfg: TransformerConfig,
                   compute_dtype=None, rules=None):
    """tokens [B,S] -> (final-norm hidden states [B,S,Dm], the MoE aux loss
    summed over layers, an f32 scalar).  The MoE layers dispatch in
    ``cfg.moe_dp_groups`` groups.

    Without ``compute_dtype`` the weights are used as held (serving) and
    the states are in their dtype.  With it, the embedded rows and each
    layer's floating leaves are cast to ``compute_dtype`` (inside the
    block, which ``cfg.remat`` recomputes in the backward); the rows are
    gathered before the cast, so the embedding's gradient adds in the
    masters' dtype."""
    with mesh_scope(params):
        b, s = tokens.shape
        x = _embed(params["embed"], tokens)
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        x = constrain(x, ("batch", "seq", "d_model"), rules)
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params["layers"]:
            if compute_dtype is None:
                x, _, a = _layer_fn(cfg, x, positions, lp,
                                    dp_groups=cfg.moe_dp_groups, rules=rules)
            else:
                x, a = _run_block(cfg, compute_dtype, rules, x, positions,
                                  lp)
            aux = aux + a
        return L.rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig,
            compute_dtype=None, rules=None):
    """tokens [B,S] -> (logits [B,S,V], aux); ``compute_dtype`` as in
    :func:`forward_hidden` (it casts ``unembed`` too)."""
    with mesh_scope(params):
        x, aux = forward_hidden(params, tokens, cfg, compute_dtype, rules)
        x = constrain(x, ("batch", None, "d_model"), rules)
        w = params["unembed"]
        w = w if compute_dtype is None else w.to(compute_dtype)
        # gathered over fsdp before the product, as the layers' weights
        w = constrain(w, (None, "vocab"), rules)
        logits = x @ w
        return constrain(logits, ("batch", None, "vocab"), rules), aux


def loss_fn(params, batch, cfg: TransformerConfig,
            compute_dtype=torch.bfloat16, aux_weight: float = 0.01,
            rules=None):
    """Next-token cross-entropy of ``batch = {tokens [B,S], labels [B,S]}``
    (int ids) on master weights: f32 logits, ``logsumexp`` minus the gold
    logit, the mean, plus ``aux_weight`` times the MoE aux loss ->
    ``(loss, {"ce", "aux"})``."""
    with mesh_scope(params):
        logits, aux = forward(params, batch["tokens"], cfg, compute_dtype,
                              rules)
        logits = logits.float()
        logz = logsumexp_last(logits)
        gold = take_last(logits, batch["labels"])
        ce = (logz - gold).mean()
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def prefill(params, tokens: torch.Tensor, cfg: TransformerConfig,
            rules=None) -> torch.Tensor:
    """Last-position logits [B,V] (the TTFT path); the unembed runs on the
    last position only."""
    with mesh_scope(params):
        x = forward_hidden(params, tokens, cfg, rules=rules)[0]
        x = constrain(x, ("batch", None, "d_model"), rules)
        return constrain(x[:, -1] @ params["unembed"], ("batch", "vocab"),
                         rules)


# ---------------------------------------------------------------------------
# Serving: single-token decode with a KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def kv_cache_logical(max_seq: int) -> dict:
    kv_ax = L.kv_seq_axis(max_seq)
    return {"k": (None, "batch", kv_ax, "kv_heads", None),
            "v": (None, "batch", kv_ax, "kv_heads", None)}


def decode_step(params, cache: dict, tokens: torch.Tensor, cache_index: int,
                cfg: TransformerConfig, backend: str | None = None,
                rules=None):
    """One serving step: tokens [B], cache_index an int.  Writes each
    layer's K/V at ``cache_index`` into ``cache`` in place and returns
    ``(logits [B,V], cache)``.  ``backend`` switches ``decode_attention``
    (None: the kernel on CUDA, the plain version on the CPU).  The MoE
    layers dispatch the B tokens flat, whatever ``cfg.moe_dp_groups``, as
    the reference's decode does."""
    with mesh_scope(params):
        b = tokens.shape[0]
        x = _embed(params["embed"], tokens)[:, None, :]          # [B,1,Dm]
        x = constrain(x, ("batch", None, "d_model"), rules)
        positions = torch.full((b, 1), int(cache_index), dtype=torch.int32,
                               device=x.device)
        for i, lp in enumerate(params["layers"]):
            x, _, _ = _layer_fn(cfg, x, positions, lp,
                                kv_cache=(cache["k"][i], cache["v"][i]),
                                cache_index=cache_index, backend=backend,
                                rules=rules)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = (x @ params["unembed"])[:, 0]
        return constrain(logits, ("batch", "vocab"), rules), cache
