"""Family glue for the LM, GNN and recsys architectures: optimizer choice,
shape sets, train steps and the LM smoke.

Twin of ``src/repro/configs/families.py``.  Left out: ``lm_bundle``,
``gnn_bundle``, ``recsys_bundle`` and their abstract batches, which build
abstract arguments and logical shardings for the reference's lowering on
a TPU mesh (``launch/dryrun.py``) and have no counterpart on one card.
What the bundles fix that a run on the card needs stays: the optimizer
(AdamW for the GNN and recsys archs, f32 compute), as :func:`adamw_step`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import OptConfig, opt_init
from repro_torch.training.train import make_train_step
from repro_torch.utils import resolve_device

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
