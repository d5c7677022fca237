"""DimeNet [arXiv:2003.03123] — assigned GNN architecture x 4 graph regimes.

Twin of ``src/repro/configs/dimenet.py``.  Triplet tensors are capped per
edge (static shapes on power-law graphs): full_graph_sm cap=8,
minibatch_lg/molecule cap=4, ogb_products cap=2 (the dominant cost of the
GNN is the triplet bilinear contraction).  ``_bundle`` takes ``rules``
and ``mesh`` as the reference's does; its variants ``n_layers`` and
``unroll`` (the reference's roofline's unrolled probes) are left out: the
dry run counts every block.
"""
from __future__ import annotations

import functools

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.models.dimenet import DimeNetConfig

_BASE = dict(n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
             n_radial=6)

# shape -> (dims, per-shape config overrides)
GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train",
        dict(n_nodes=2816, n_edges=10752, n_triplets=86016,
             d_feat=1433, n_classes=7,
             real_nodes=2708, real_edges=10556),
        note="Cora-scale full-batch (padded to 256-divisible shards)"),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train",
        dict(n_nodes=169_984, n_edges=168_960, n_triplets=4 * 168_960,
             d_feat=602, n_classes=41,
             full_nodes=232_965, full_edges=114_615_892,
             batch_nodes=1024, fanout=(15, 10)),
        note="Reddit-scale sampled block: 1024 seeds x fanout 15-10 "
             "(host NeighborSampler feeds fixed-shape blocks)"),
    "ogb_products": ShapeSpec(
        "ogb_products", "train",
        dict(n_nodes=2_449_152, n_edges=61_859_840,
             n_triplets=2 * 61_859_840, d_feat=100, n_classes=47,
             real_nodes=2_449_029, real_edges=61_859_140),
        note="full-batch-large; triplet cap 2/edge; padded to 256-divisible"),
    "molecule": ShapeSpec(
        "molecule", "train",
        dict(n_nodes=30 * 128, n_edges=64 * 128, n_triplets=4 * 64 * 128,
             d_feat=32, n_graphs=128),
        note="batched small graphs, energy regression"),
}


def _cfg_for(shape_name: str) -> DimeNetConfig:
    d = GNN_SHAPES[shape_name].dims
    if shape_name == "molecule":
        return DimeNetConfig(task="regression", n_targets=1,
                             d_feat=d["d_feat"], **_BASE)
    return DimeNetConfig(task="classification", n_targets=d["n_classes"],
                         d_feat=d["d_feat"], **_BASE)


def _bundle(shape_name: str, rules=None, mesh=None):
    """One AdamW step at the shape's block dims (``launch/dryrun.py``)."""
    from repro_torch.configs.families import gnn_bundle
    return gnn_bundle(_cfg_for(shape_name), GNN_SHAPES[shape_name], rules,
                      mesh)


SMOKE_CONFIG = DimeNetConfig(n_blocks=2, d_hidden=32, n_bilinear=4,
                             n_spherical=4, n_radial=4, d_feat=16,
                             n_targets=5, task="classification")


def smoke_batch() -> dict:
    """The smoke's graph batch as the reference draws it (numpy)."""
    from repro_torch.data.graph import make_graph_batch
    return make_graph_batch(n_nodes=40, n_edges=120, d_feat=16, n_classes=5,
                            cap_per_edge=4, seed=0)


def _smoke(device=None):
    """-> ``(cfg, params, opt_state, step, batch)`` on ``device`` (default
    CUDA): the reference's reduced config, the port's torch draws, AdamW
    and the reference's graph draw."""
    from repro_torch.configs.families import adamw_step, to_device
    from repro_torch.models import dimenet as dn
    from repro_torch.training.optimizer import opt_init

    cfg = SMOKE_CONFIG
    params = dn.init_params(cfg, seed=0, device=device)
    opt_cfg, step = adamw_step(functools.partial(dn.loss_fn, cfg=cfg))
    opt_state = opt_init(opt_cfg, params)
    return cfg, params, opt_state, step, to_device(smoke_batch(), device)


ArchSpec(
    name="dimenet", family="gnn", source="arXiv:2003.03123",
    shapes=GNN_SHAPES,
    make_bundle=_bundle,
    make_smoke=_smoke,
    config=DimeNetConfig(**_BASE),
).register()
