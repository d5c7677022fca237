"""Family glue for the LM, GNN and recsys architectures: optimizer choice,
shape sets, train steps, the LM smoke and the cells' bundles.

Twin of ``src/repro/configs/families.py``.  :func:`lm_bundle`,
:func:`gnn_bundle` and :func:`recsys_bundle` wrap the steps the port runs
(the LM train step on master weights cast to bf16 at each use; prefill
and decode on the bf16 serving weights of ``transformer.init_params``;
:func:`adamw_step`; the recsys forward and ``retrieval_score``) with
``meta`` arguments of the reference's shapes and dtypes, for
``launch/dryrun.py``.  The one difference: the reference's prefill and
decode take its f32 masters and cast them at each use, while the port
serves bf16 weights (``final_norm`` f32), so those cells' weights are the
reference's shapes at half its bytes.  Serving steps run under
``torch.no_grad()``.

Left out of the bundles: the reference's logical shardings and
``_batch_ax`` (mesh only), and the variants ``unroll`` (its roofline's
unrolled probes: the dry run counts every layer), ``moe_dp_groups`` (the
prefill's hierarchical dispatch over a mesh's data axes) and
``remat_policy``.  The LM bundle takes ``n_layers``, ``global_batch`` and
``n_micro`` (gradient accumulation), the variants the card's dry-run
check uses to match the training step it measured.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.base import (META, LoweringBundle, ShapeSpec,
                                      abstract_init)
from repro_torch.models import dimenet as dn
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import OptConfig, opt_init
from repro_torch.training.train import make_train_step, make_train_step_accum
from repro_torch.utils import resolve_device

I32, F32, BF16, BOOL = torch.int32, torch.float32, torch.bfloat16, torch.bool


def meta(shape, dtype) -> torch.Tensor:
    """An argument of ``shape`` and ``dtype`` with no values."""
    return torch.empty(shape, dtype=dtype, device=META)


def serving(fn):
    """``fn`` run under ``torch.no_grad()``, as the port serves."""
    @functools.wraps(fn)
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run

# ---------------------------------------------------------------------------
# LM transformers
# ---------------------------------------------------------------------------


def lm_opt_config(cfg: tf.TransformerConfig) -> OptConfig:
    # giant MoE: factored states (AdamW's 8 B/param would exceed pod HBM)
    return OptConfig(name="adafactor" if cfg.is_moe else "adamw")


def lm_shapes() -> dict[str, ShapeSpec]:
    """The assigned LM shape set (same for all five LM archs).  The
    reference's ``skip_decode`` option has no caller here."""
    return {
        "train_4k": ShapeSpec("train_4k", "train",
                              dict(seq_len=4096, global_batch=256)),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 dict(seq_len=32768, global_batch=32)),
        "decode_32k": ShapeSpec("decode_32k", "decode",
                                dict(seq_len=32768, global_batch=128)),
        "long_500k": ShapeSpec(
            "long_500k", "decode", dict(seq_len=524288, global_batch=1),
            note="decode against a 512k KV cache is O(L)/step; runs for all "
                 "five full-attention archs (see DESIGN.md §5)"),
    }


def lm_bundle(cfg: tf.TransformerConfig, shape: ShapeSpec | str,
              n_layers: int | None = None, global_batch: int | None = None,
              n_micro: int = 1) -> LoweringBundle:
    """One LM cell: the train step (AdamW or Adafactor on the masters,
    bf16 compute; ``n_micro`` > 1 accumulates), or ``prefill`` or one
    ``decode_step`` at cache index ``seq_len - 1`` (every position
    covered) on the bf16 serving weights.  The reference's cache index is
    a traced int32 scalar; the port's is a host int."""
    if isinstance(shape, str):
        shape = lm_shapes()[shape]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    d = shape.dims
    b, s = global_batch or d["global_batch"], d["seq_len"]
    if shape.kind == "train":
        params = abstract_init(tf.init_master_params, cfg)
        opt_cfg = lm_opt_config(cfg)
        lossf = functools.partial(tf.loss_fn, cfg=cfg, compute_dtype=BF16)
        step = (make_train_step(lossf, opt_cfg) if n_micro == 1
                else make_train_step_accum(lossf, opt_cfg, n_micro))
        batch = {"tokens": meta((b, s), I32), "labels": meta((b, s), I32)}
        return LoweringBundle(step, (params, opt_init(opt_cfg, params),
                                     batch), donate_argnums=(0, 1))
    params = abstract_init(tf.init_params, cfg)
    if shape.kind == "prefill":
        fn = functools.partial(tf.prefill, cfg=cfg)
        return LoweringBundle(serving(fn), (params, meta((b, s), I32)))
    if shape.kind == "decode":
        cache = abstract_init(tf.init_kv_cache, cfg, b, s)
        fn = functools.partial(tf.decode_step, cfg=cfg)
        return LoweringBundle(serving(fn), (params, cache, meta((b,), I32),
                                            s - 1), donate_argnums=(1,))
    raise ValueError(shape.kind)


def lm_smoke(cfg_full: tf.TransformerConfig, device=None):
    """Reduced same-family config (2 layers, d=64, vocab 512, up to 4
    experts and top-2, no remat) and one train step's inputs, f32 compute
    -> ``(cfg, params, opt_state, step, batch)``.  The masters are the
    port's torch draws (f32, the reduced config's ``param_dtype``), the
    tokens and labels the reference's numpy draws."""
    dev = resolve_device(device)
    cfg = tf.TransformerConfig(
        name=cfg_full.name + "-smoke", n_layers=2,
        d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 * cfg_full.n_kv_heads // cfg_full.n_heads),
        d_ff=128, vocab_size=512, d_head=16,
        rope_fraction=cfg_full.rope_fraction,
        gated_mlp=cfg_full.gated_mlp,
        moe_experts=min(cfg_full.moe_experts, 4),
        moe_top_k=min(cfg_full.moe_top_k, 2),
        moe_dense_residual=cfg_full.moe_dense_residual,
        remat=False)
    params = tf.init_master_params(cfg, seed=0, device=dev)
    opt_cfg = lm_opt_config(cfg)
    opt_state = opt_init(opt_cfg, params)
    lossf = functools.partial(tf.loss_fn, cfg=cfg,
                              compute_dtype=torch.float32)
    step = make_train_step(lossf, opt_cfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, 512, (2, 16)),
                                dtype=torch.int32, device=dev)
             for k in ("tokens", "labels")}
    return cfg, params, opt_state, step, batch


# ---------------------------------------------------------------------------
# GNN (DimeNet) and RecSys
# ---------------------------------------------------------------------------

def adamw_step(loss_fn):
    """The GNN and recsys archs' train step as the reference's bundles
    build it: AdamW over ``loss_fn(params, batch)`` (f32 throughout) ->
    ``(opt_cfg, step)``."""
    opt_cfg = OptConfig(name="adamw")
    return opt_cfg, make_train_step(loss_fn, opt_cfg)


def gnn_abstract_batch(n: int, e: int, t: int, d_feat: int, task: str,
                       n_graphs: int = 1) -> dict:
    """A DimeNet batch of the given dims as ``meta`` tensors."""
    batch = {"x": meta((n, d_feat), F32), "pos": meta((n, 3), F32),
             "edge_src": meta((e,), I32), "edge_dst": meta((e,), I32),
             "edge_mask": meta((e,), BOOL),
             "tri_edge_in": meta((t,), I32), "tri_edge_out": meta((t,), I32),
             "tri_mask": meta((t,), BOOL), "node_mask": meta((n,), BOOL)}
    if task == "classification":
        batch["labels"] = meta((n,), I32)
    else:
        batch["graph_ids"] = meta((n,), I32)
        batch["targets"] = meta((n_graphs,), F32)
    return batch


def gnn_bundle(cfg: dn.DimeNetConfig, shape: ShapeSpec) -> LoweringBundle:
    """One DimeNet AdamW step at the shape's block dims."""
    d = shape.dims
    params = abstract_init(dn.init_params, cfg)
    batch = gnn_abstract_batch(d["n_nodes"], d["n_edges"], d["n_triplets"],
                               d["d_feat"], cfg.task, d.get("n_graphs", 1))
    opt_cfg, step = adamw_step(functools.partial(dn.loss_fn, cfg=cfg))
    return LoweringBundle(step, (params, opt_init(opt_cfg, params), batch),
                          donate_argnums=(0, 1))


def recsys_abstract_batch(cfg: rs.RecsysConfig, b: int) -> dict:
    """A recsys batch of ``b`` examples as ``meta`` tensors."""
    if cfg.kind == "bert4rec":
        s = cfg.seq_len
        return {"items": meta((b, s), I32), "labels": meta((b, s), I32),
                "label_mask": meta((b, s), BOOL), "mask": meta((b, s), BOOL)}
    batch = {"sparse_ids": meta((b, cfg.n_sparse), I32),
             "labels": meta((b,), I32)}
    if cfg.n_dense:
        batch["dense"] = meta((b, cfg.n_dense), F32)
    return batch


def recsys_bundle(cfg: rs.RecsysConfig,
                  shape: ShapeSpec | str) -> LoweringBundle:
    """One recsys cell: the top-100 candidate scoring, an AdamW step or a
    serving forward."""
    if isinstance(shape, str):
        shape = recsys_shapes()[shape]
    d = shape.dims
    params = abstract_init(rs.init_params, cfg)
    if shape.kind == "retrieval":
        dim = cfg.embed_dim
        cands = {"query": meta((d["batch"], dim), F32),
                 "candidates": meta((d["n_candidates"], dim), F32)}
        fn = functools.partial(rs.retrieval_score, cfg=cfg)
        return LoweringBundle(serving(fn), (params, cands))
    batch = recsys_abstract_batch(cfg, d["batch"])
    if shape.kind == "train":
        opt_cfg, step = adamw_step(functools.partial(rs.loss_fn, cfg=cfg))
        return LoweringBundle(step, (params, opt_init(opt_cfg, params),
                                     batch), donate_argnums=(0, 1))
    fn = functools.partial(rs.forward, cfg=cfg)
    return LoweringBundle(serving(fn), (params, batch))


def recsys_shapes() -> dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
        "serve_p99": ShapeSpec("serve_p99", "serve", dict(batch=512)),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
        "retrieval_cand": ShapeSpec(
            "retrieval_cand", "retrieval",
            dict(batch=1, n_candidates=1_000_448, real_candidates=1_000_000),
            note="1M candidates padded to 256-divisible shards"),
    }


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on ``device``, dtypes kept."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v), device=dev)
            for k, v in batch.items()}
