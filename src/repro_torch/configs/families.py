"""Family glue for the LM transformers: optimizer choice, the train shape
and the reduced smoke config.

The LM part of ``src/repro/configs/families.py``.  Left out: ``lm_bundle``
and the GNN and recsys bundles, which build abstract arguments and logical
shardings for the reference's lowering on a TPU mesh (``launch/dryrun.py``)
and have no counterpart on one card; the GNN and recsys smokes belong to
later slices.  ``ShapeSpec`` is a copy of ``configs/base.py``'s.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import numpy as np
import torch

from repro_torch.models import transformer as tf
from repro_torch.training.optimizer import OptConfig, opt_init
from repro_torch.training.train import make_train_step
from repro_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str               # train | prefill | decode | serve | retrieval
    dims: Mapping[str, int]
    note: str = ""


def lm_opt_config(cfg: tf.TransformerConfig) -> OptConfig:
    # giant MoE: factored states (AdamW's 8 B/param would exceed pod HBM)
    return OptConfig(name="adafactor" if cfg.is_moe else "adamw")


def lm_shapes() -> dict[str, ShapeSpec]:
    """The LM train shape (the same for all five LM archs).  The
    reference's prefill, decode and long-context specs serve its lowering
    on a TPU mesh and are left out with ``lm_bundle``."""
    return {"train_4k": ShapeSpec("train_4k", "train",
                                  dict(seq_len=4096, global_batch=256))}


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
