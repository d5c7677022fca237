"""The four assigned RecSys architectures (exact public configs).

Twin of ``src/repro/configs/recsys_archs.py``; the port keeps its own copy
of their values.

  dlrm-rm2  [arXiv:1906.00091]  Criteo embedding tables, dot interaction
  bert4rec  [arXiv:1904.06690]  bidirectional sequential recommender
  autoint   [arXiv:1810.11921]  field self-attention interaction
  deepfm    [arXiv:1703.04247]  FM + deep branch

Embedding tables are one concatenated [sum(vocab), dim] matrix.
"""
from __future__ import annotations

import functools

from repro_torch.configs.base import ArchSpec
from repro_torch.configs.families import (adamw_step, recsys_bundle,
                                          recsys_shapes, to_device)
from repro_torch.models.recsys import CRITEO_VOCABS, RecsysConfig

# 39-field vocabularies for autoint/deepfm: Criteo's 26 + 13 Avazu-scale
_VOCABS_39 = CRITEO_VOCABS + (100_000,) * 13

RECSYS_CONFIGS = {
    "dlrm-rm2": RecsysConfig(
        name="dlrm-rm2", kind="dlrm", vocab_sizes=CRITEO_VOCABS,
        embed_dim=64, n_dense=13, bot_mlp=(512, 256, 64),
        top_mlp=(512, 512, 256, 1)),
    "bert4rec": RecsysConfig(
        name="bert4rec", kind="bert4rec", vocab_sizes=(26744,),
        embed_dim=64, n_blocks=2, n_heads=2, seq_len=200),
    "autoint": RecsysConfig(
        name="autoint", kind="autoint", vocab_sizes=_VOCABS_39,
        embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32),
    "deepfm": RecsysConfig(
        name="deepfm", kind="deepfm", vocab_sizes=_VOCABS_39,
        embed_dim=10, mlp=(400, 400, 400)),
}


def smoke_config(full_cfg: RecsysConfig) -> RecsysConfig:
    """The reference's reduced same-kind config."""
    kw = dict(vocab_sizes=(64,) * min(len(full_cfg.vocab_sizes), 6),
              embed_dim=8)
    if full_cfg.kind == "dlrm":
        return RecsysConfig(name="smoke", kind="dlrm", n_dense=13,
                            bot_mlp=(32, 16, 8), top_mlp=(32, 1), **kw)
    if full_cfg.kind == "deepfm":
        return RecsysConfig(name="smoke", kind="deepfm", mlp=(32, 32), **kw)
    if full_cfg.kind == "autoint":
        return RecsysConfig(name="smoke", kind="autoint", n_attn_layers=2,
                            n_heads=2, d_attn=8, **kw)
    return RecsysConfig(name="smoke", kind="bert4rec", vocab_sizes=(256,),
                        embed_dim=16, n_blocks=2, n_heads=2, seq_len=16)


def smoke_batch(cfg: RecsysConfig) -> dict:
    """The smoke's batch as the reference draws it (numpy arrays)."""
    from repro_torch.data.recsys import ClickLog, SessionLog
    if cfg.kind == "bert4rec":
        return SessionLog(256, seed=0).sample(4, 16)
    return ClickLog(cfg.vocab_sizes, n_dense=cfg.n_dense, seed=0).sample(8)


def _smoke_factory(full_cfg: RecsysConfig):
    def _smoke(device=None):
        """-> ``(cfg, params, opt_state, step, batch)`` on ``device``
        (default CUDA): the reduced config, the port's torch draws, AdamW
        and the reference's data draw."""
        from repro_torch.models import recsys as rs
        from repro_torch.training.optimizer import opt_init

        cfg = smoke_config(full_cfg)
        params = rs.init_params(cfg, seed=0, device=device)
        opt_cfg, step = adamw_step(functools.partial(rs.loss_fn, cfg=cfg))
        opt_state = opt_init(opt_cfg, params)
        return cfg, params, opt_state, step, to_device(smoke_batch(cfg),
                                                       device)
    return _smoke


for _name, _cfg in RECSYS_CONFIGS.items():
    ArchSpec(
        name=_name, family="recsys", source="assigned recsys pool",
        shapes=recsys_shapes(),
        make_bundle=functools.partial(recsys_bundle, _cfg),
        make_smoke=_smoke_factory(_cfg),
        config=_cfg,
    ).register()
