"""RecSys model family: DLRM-RM2, DeepFM, AutoInt, BERT4Rec.

Twin of ``src/repro/models/recsys.py``.  Lookups gather rows of one
*concatenated* embedding table (``F.embedding`` of ``ids + offsets``, the
reference's ``jnp.take``); the multi-hot :func:`embedding_bag` substrate gathers and
sums with ``index_add_``.  No model here calls the ``embedding_bag``
kernel: the reference's forward gathers too, and its Pallas bag sits
behind ``kernels/ops.py`` with no model calling it.

Parameters are nested dicts of tensors with the reference's shapes and
scales, drawn from a ``torch.Generator`` (not the reference's
``jax.random`` draws; ``repro_torch.convert.float_tree_from_numpy``
carries the reference's across).  The reference keeps its per-layer MLP,
attention and block lists as Python lists of leaves of different shapes;
the port's optimizer reads a list in a tree as one stacked leaf, so here
they are dicts keyed by position (``"0"``, ``"1"``, ...).

Left out: ``rules`` and the sharding constraints (one card has no mesh),
and ``params_logical`` / ``_mlp_chain_logical``, which name mesh axes only.

Shapes (per the assignment):
  train_batch    batch=65536          training (logloss)
  serve_p99      batch=512            online inference
  serve_bulk     batch=262144         offline scoring
  retrieval_cand batch=1, 1M cands    two-tower scoring via the ENNS path
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.utils import resolve_device, seeded_generator, stable_topk

# Criteo Kaggle per-field vocabulary sizes (26 categorical fields), the
# standard DLRM benchmark tables [arXiv:1906.00091].
CRITEO_VOCABS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
                 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
                 7046547, 18, 15, 286181, 105, 142572)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                      # dlrm | deepfm | autoint | bert4rec
    vocab_sizes: tuple[int, ...]   # per sparse field
    embed_dim: int
    n_dense: int = 0
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    mlp: tuple[int, ...] = ()
    # autoint
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    # bert4rec
    n_blocks: int = 0
    seq_len: int = 0
    param_dtype: Any = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    def field_offsets(self, device=None) -> torch.Tensor:
        """[F] int32 row offset of each field in the concatenated table."""
        off = np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]])
        return torch.as_tensor(off, dtype=torch.int32,
                               device=resolve_device(device))

    def param_count(self) -> int:
        n = self.total_vocab * self.embed_dim
        dims_chain = []
        if self.kind == "dlrm":
            dims_chain += [(self.n_dense,) + self.bot_mlp]
            n_inter = (self.n_sparse + 1) * self.n_sparse // 2
            dims_chain += [(n_inter + self.bot_mlp[-1],) + self.top_mlp]
        elif self.kind == "deepfm":
            dims_chain += [(self.n_sparse * self.embed_dim,) + self.mlp + (1,)]
            n += self.total_vocab  # first-order weights
        elif self.kind == "autoint":
            per = self.embed_dim * self.d_attn * self.n_heads * 3 \
                + self.d_attn * self.n_heads * self.embed_dim
            n += self.n_attn_layers * per
            n += self.n_sparse * self.embed_dim  # final logit proj
        elif self.kind == "bert4rec":
            d = self.embed_dim
            per = 4 * d * d + 8 * d * d // 1  # attn + mlp(4x)
            n += self.n_blocks * per + self.seq_len * d
        for dims in dims_chain:
            for i in range(len(dims) - 1):
                n += dims[i] * dims[i + 1] + dims[i + 1]
        return n


# ---------------------------------------------------------------------------
# Embedding substrate
# ---------------------------------------------------------------------------

def padded_vocab(cfg: RecsysConfig) -> int:
    """Table rows rounded up to a multiple of 256 (the reference's shard
    divisibility; pad rows are never indexed: field offsets cover only the
    real vocabulary)."""
    return (cfg.total_vocab + 255) // 256 * 256


def _normal(g, shape, scale, dtype, dev) -> torch.Tensor:
    """``scale`` times a standard normal draw from ``g``, scaled in place
    (an 8.6 GB table takes no second copy)."""
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=dev)
    return x.mul_(scale).to(dtype)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """Single-valued categorical lookup: table [V_total, D], ids [B, F]
    per-field local ids, offsets [F] -> [B, F, D].  A gather through
    ``F.embedding``, whose backward sums each row's duplicates in parallel
    (Zipf ids repeat the head rows across the batch)."""
    return F.embedding(ids + offsets[None, :], table)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int, mode: str = "sum",
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-hot EmbeddingBag: ids [L] global row ids, segment_ids [L] the
    bag of each (sorted) -> [n_bags, D]; ``"mean"`` divides by the bag's
    size (at least 1).  The fixed-arity bag of the Pallas kernel is
    ``repro_torch.kernels.embedding_bag``."""
    vecs = table[ids.long()]
    if weights is not None:
        vecs = vecs * weights[:, None]
    seg = segment_ids.long()
    out = torch.zeros((n_bags, table.shape[1]), dtype=vecs.dtype,
                      device=table.device).index_add_(0, seg, vecs)
    if mode == "mean":
        cnt = torch.zeros(n_bags, dtype=torch.float32,
                          device=table.device).index_add_(
            0, seg, torch.ones(seg.shape, dtype=torch.float32,
                               device=table.device))
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out


def _init_mlp_chain(g, dims: Sequence[int], dtype, dev) -> dict:
    return {str(i): {"w": _normal(g, (dims[i], dims[i + 1]),
                                  dims[i] ** -0.5, dtype, dev),
                     "b": torch.zeros(dims[i + 1], dtype=dtype, device=dev)}
            for i in range(len(dims) - 1)}


def _mlp_chain(layers: dict, x: torch.Tensor,
               final_act: bool = False) -> torch.Tensor:
    n = len(layers)
    for i in range(n):
        lp = layers[str(i)]
        x = x @ lp["w"] + lp["b"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: RecsysConfig, seed: int = 0, device=None) -> dict:
    """Random parameters of the reference's shapes and scales, in
    ``cfg.param_dtype``, drawn on ``device`` (default CUDA) from a
    ``torch.Generator`` seeded with ``seed``: the table first, then each
    kind's leaves in the reference's order."""
    dev = resolve_device(device)
    g = seeded_generator(dev, seed)
    dt = cfg.param_dtype
    p: dict = {"table": _normal(g, (padded_vocab(cfg), cfg.embed_dim), 0.05,
                                dt, dev)}
    if cfg.kind == "dlrm":
        p["bot"] = _init_mlp_chain(g, (cfg.n_dense,) + cfg.bot_mlp, dt, dev)
        n_inter = (cfg.n_sparse + 1) * cfg.n_sparse // 2
        p["top"] = _init_mlp_chain(g, (n_inter + cfg.bot_mlp[-1],)
                                   + cfg.top_mlp, dt, dev)
    elif cfg.kind == "deepfm":
        p["w1"] = _normal(g, (padded_vocab(cfg),), 0.01, dt, dev)
        p["deep"] = _init_mlp_chain(
            g, (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp + (1,), dt, dev)
    elif cfg.kind == "autoint":
        d, da, h = cfg.embed_dim, cfg.d_attn, cfg.n_heads
        p["attn"] = {}
        for i in range(cfg.n_attn_layers):
            d_in = d if i == 0 else da * h
            p["attn"][str(i)] = {
                **{w: _normal(g, (d_in, h, da), 0.05, dt, dev)
                   for w in ("wq", "wk", "wv")},
                "wres": _normal(g, (d_in, h * da), 0.05, dt, dev)}
        p["out"] = _normal(g, (cfg.n_sparse * da * h,), 0.01, dt, dev)
    elif cfg.kind == "bert4rec":
        d, h = cfg.embed_dim, cfg.n_heads
        dh, s = d // h, d ** -0.5
        p["pos_embed"] = _normal(g, (cfg.seq_len, d), 0.02, dt, dev)
        p["blocks"] = {
            str(i): {
                "attn_norm": {"scale": torch.ones(d, dtype=dt, device=dev)},
                "mlp_norm": {"scale": torch.ones(d, dtype=dt, device=dev)},
                "attn": {"wq": _normal(g, (d, h, dh), s, dt, dev),
                         "wk": _normal(g, (d, h, dh), s, dt, dev),
                         "wv": _normal(g, (d, h, dh), s, dt, dev),
                         "wo": _normal(g, (h, dh, d), (h * dh) ** -0.5, dt,
                                       dev)},
                "mlp": {"w_in": _normal(g, (d, 4 * d), s, dt, dev),
                        "w_out": _normal(g, (4 * d, d), (4 * d) ** -0.5, dt,
                                         dev)}}
            for i in range(cfg.n_blocks)}
    else:
        raise ValueError(cfg.kind)
    return p


# ---------------------------------------------------------------------------
# Forward and loss
# ---------------------------------------------------------------------------

def _dot_interaction(vecs: torch.Tensor) -> torch.Tensor:
    """DLRM dot interaction: [B, F, D] -> strictly-upper-tri dots
    [B, F(F-1)/2], in ``triu_indices(F, k=1)``'s row-major order."""
    f = vecs.shape[1]
    z = torch.bmm(vecs, vecs.transpose(1, 2))                   # [B, F, F]
    iu, ju = torch.triu_indices(f, f, 1, device=vecs.device)
    return z[:, iu, ju]


def _bert4rec(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    table = params["table"]
    items = batch["items"]                                      # [B, S]
    b, s = items.shape
    x = F.embedding(items, table) + params["pos_embed"][None, :s]
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    for i in range(cfg.n_blocks):
        blk = params["blocks"][str(i)]
        h, _ = L.attention(blk["attn"], L.rmsnorm(blk["attn_norm"], x), pos,
                           causal=False, rope_theta=10000.0,
                           rope_fraction=0.0, mask=batch.get("mask"))
        x = x + h
        x = x + L.mlp(blk["mlp"], L.rmsnorm(blk["mlp_norm"], x))
    logits = x @ table.T                                        # [B, S, V]
    if table.shape[0] > cfg.total_vocab:   # drop pad-row logits
        logits = logits[..., :cfg.total_vocab]
    return logits


def _autoint(params, x: torch.Tensor) -> torch.Tensor:
    b, f, _ = x.shape
    for i in range(len(params["attn"])):
        lp = params["attn"][str(i)]
        h, da = lp["wq"].shape[1], lp["wq"].shape[2]
        q, k, v = ((x @ lp[w].flatten(1)).view(b, f, h, da)
                   for w in ("wq", "wk", "wv"))
        # a divisor on the device: CUDA's division by a host scalar
        # multiplies by its reciprocal, an ulp off the reference
        scale = torch.sqrt(torch.tensor(da, dtype=x.dtype, device=x.device))
        scores = torch.einsum("bfhk,bghk->bhfg", q, k) / scale
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhfg,bghk->bfhk", probs, v).reshape(b, f, h * da)
        x = torch.relu(o + x @ lp["wres"])
    return x.reshape(b, -1) @ params["out"]


def forward(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """CTR kinds -> logits [B]; bert4rec -> logits [B, S, V_items].  f32
    throughout, as the reference's only callers run it."""
    if cfg.kind == "bert4rec":
        return _bert4rec(params, batch, cfg)
    table = params["table"]
    ids = batch["sparse_ids"]                                   # [B, F]
    offsets = cfg.field_offsets(ids.device)
    vecs = embedding_lookup(table, ids, offsets)                # [B, F, D]
    if cfg.kind == "dlrm":
        dense = batch["dense"]                                  # [B, 13]
        bot = _mlp_chain(params["bot"], dense, final_act=True)
        allv = torch.cat([bot[:, None, :], vecs], dim=1)
        feat = torch.cat([_dot_interaction(allv), bot], dim=-1)
        return _mlp_chain(params["top"], feat)[:, 0]
    if cfg.kind == "deepfm":
        w1 = params["w1"][:, None]
        first = F.embedding(ids + offsets[None, :], w1)[..., 0].sum(dim=-1)
        sum_v = vecs.sum(dim=1)
        fm = 0.5 * (sum_v ** 2 - (vecs ** 2).sum(dim=1)).sum(dim=-1)
        deep = _mlp_chain(params["deep"],
                          vecs.reshape(vecs.shape[0], -1))[:, 0]
        return first + fm + deep
    if cfg.kind == "autoint":
        return _autoint(params, vecs)
    raise ValueError(cfg.kind)


def loss_fn(params, batch, cfg: RecsysConfig):
    """bert4rec: masked-item cross-entropy over the label mask; the CTR
    kinds: the mean logistic loss, written term for term as the reference
    writes it, ``max(l, 0) - l*y + log1p(exp(-|l|))`` ->
    ``(loss, {"loss": loss})``."""
    out = forward(params, batch, cfg)
    if cfg.kind == "bert4rec":
        logits = out.float()
        lmask = batch["label_mask"].float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
        loss = ((logz - gold) * lmask).sum() / torch.clamp_min(lmask.sum(),
                                                                1.0)
    else:
        logit = out.float()
        y = batch["labels"].float()
        loss = torch.mean(torch.clamp_min(logit, 0.0) - logit * y
                          + torch.log1p(torch.exp(-logit.abs())))
    return loss, {"loss": loss}


# ---------------------------------------------------------------------------
# Retrieval scoring (retrieval_cand shape): two-tower over 1M candidates
# ---------------------------------------------------------------------------

def retrieval_score(params, batch, cfg: RecsysConfig, top_k: int = 100):
    """Score the queries against every candidate embedding -> the top-k
    ``(vals [B, k], idx [B, k] int64)``, ties to the lower candidate.
    ``batch = {query [B, D], candidates [C, D]}``."""
    return stable_topk(batch["query"] @ batch["candidates"].T, top_k)
