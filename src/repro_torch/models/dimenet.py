"""DimeNet (Directional Message Passing, arXiv:2003.03123) in PyTorch.

Twin of ``src/repro/models/dimenet.py``:
  * Message passing sums over fixed-shape padded edge / triplet index
    lists with ``index_add`` (the reference's ``jax.ops.segment_sum``).  On
    CUDA it adds with atomics, in an order that changes from run to run,
    so card results agree with the CPU's to a tolerance, never bit for
    bit.  The gathers that need a gradient go through ``F.embedding``,
    whose backward sums a row's duplicates in parallel: the padded
    triplets all point at edge 0, and advanced indexing's backward adds
    such duplicates one after another (2.2 s of a 2.3 s step at
    minibatch_lg on an H100).
  * Triplets (k->j->i) are capped per edge by the data pipeline, so the
    triplet tensors have a static shape even on power-law graphs.
  * Spherical Bessel radial/angular bases use the closed-form upward
    recurrence j_{l+1}(x) = (2l+1)/x * j_l(x) - j_{l-1}(x), which loses
    precision at small x (the reference clamps x at 1e-4, as the port does).
  * The blocks' leaves stay stacked ``[n_blocks, ...]`` as the reference
    stacks them for ``lax.scan``; the forward loops over their slices.
    ``scan_unroll`` is kept as a field and has no effect here.
  * The bilinear contraction ``einsum("tb,td,bdf->tf")`` is one product of
    the ``[T, b*d]`` outer product with ``w_bil`` as ``[b*d, f]``; the
    ``[T, d, d]`` tensor is never built.

Left out: ``params_logical`` (sharding only) and ``rules``.

Inputs (all fixed-shape, masked):
  x          [N, d_feat]   node features
  pos        [N, 3]        node positions
  edge_src   [E] int32     j  (message source)
  edge_dst   [E] int32     i  (message target)
  edge_mask  [E] bool
  tri_edge_in  [T] int32   index of edge (k->j)
  tri_edge_out [T] int32   index of edge (j->i)
  tri_mask   [T] bool
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.utils import resolve_device, seeded_generator


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_feat: int = 128          # input node-feature dim
    n_targets: int = 1         # regression targets or classes
    cutoff: float = 5.0
    param_dtype: Any = torch.float32
    task: str = "regression"   # or "classification"
    scan_unroll: int = 1       # the reference's roofline probes; unused

    def param_count(self) -> int:
        d, nb = self.d_hidden, self.n_bilinear
        emb = self.d_feat * d + self.n_radial * d + 3 * d * d
        per_block = (2 * d * d                       # msg in/out proj
                     + self.n_spherical * self.n_radial * nb   # sbf proj
                     + nb * d * d                    # bilinear tensor
                     + 2 * d * d                     # update MLP
                     + d * d + d * self.n_targets)   # output block
        return emb + self.n_blocks * per_block


# ---------------------------------------------------------------------------
# Basis functions
# ---------------------------------------------------------------------------

def bessel_rbf(d: torch.Tensor, n_radial: int, cutoff: float) -> torch.Tensor:
    """Radial Bessel basis: sin(n pi d/c) / d, n = 1..n_radial.  [..., R]."""
    d = torch.clamp_min(d, 1e-6)
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    x = d[..., None] / cutoff
    return math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * x) / d[..., None]


def spherical_bessel(x: torch.Tensor, l_max: int) -> torch.Tensor:
    """j_l(x) for l = 0..l_max-1 via upward recurrence.  [..., L]."""
    x = torch.clamp_min(x, 1e-4)
    j0 = torch.sin(x) / x
    if l_max == 1:
        return j0[..., None]
    j1 = torch.sin(x) / x ** 2 - torch.cos(x) / x
    js = [j0, j1]
    for l in range(1, l_max - 1):
        js.append((2 * l + 1) / x * js[-1] - js[-2])
    return torch.stack(js, dim=-1)


def legendre(cos_t: torch.Tensor, l_max: int) -> torch.Tensor:
    """P_l(cos) for l = 0..l_max-1 via Bonnet recurrence.  [..., L]."""
    p0 = torch.ones_like(cos_t)
    if l_max == 1:
        return p0[..., None]
    ps = [p0, cos_t]
    for l in range(1, l_max - 1):
        ps.append(((2 * l + 1) * cos_t * ps[-1] - l * ps[-2]) / (l + 1))
    return torch.stack(ps, dim=-1)


def sbf_basis(d_kj: torch.Tensor, angle_cos: torch.Tensor, n_spherical: int,
              n_radial: int, cutoff: float) -> torch.Tensor:
    """2-D spherical Fourier-Bessel basis.  [T, n_spherical * n_radial]."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32,
                     device=d_kj.device)
    x = (d_kj[..., None] / cutoff) * n * math.pi            # [T, R]
    jl = spherical_bessel(x.reshape(-1), n_spherical)       # [T*R, L]
    jl = jl.reshape(*x.shape, n_spherical)                  # [T, R, L]
    pl = legendre(angle_cos, n_spherical)                   # [T, L]
    out = jl * pl[..., None, :]                             # [T, R, L]
    return out.reshape(*d_kj.shape, n_radial * n_spherical)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

BLOCK_LEAVES = ("w_msg", "w_sbf", "w_bil", "w_upd1", "w_upd2", "w_out_edge",
                "w_out")


def init_params(cfg: DimeNetConfig, seed: int = 0, device=None) -> dict:
    """Random parameters of the reference's shapes and scales (normal
    draws from a ``torch.Generator`` seeded with ``seed``, on ``device``,
    default CUDA), the blocks' leaves stacked ``[n_blocks, ...]``."""
    dev = resolve_device(device)
    g = seeded_generator(dev, seed)
    d, dt = cfg.d_hidden, cfg.param_dtype

    def dense(shape, scale):
        x = torch.randn(shape, generator=g, dtype=torch.float32, device=dev)
        return x.mul_(scale).to(dt)

    sr, nb = cfg.n_spherical * cfg.n_radial, cfg.n_bilinear
    shapes = {"w_msg": ((d, d), d ** -0.5), "w_sbf": ((sr, nb), sr ** -0.5),
              "w_bil": ((nb, d, d), 1.0 / d),
              "w_upd1": ((d, d), d ** -0.5), "w_upd2": ((d, d), d ** -0.5),
              "w_out_edge": ((d, d), d ** -0.5),
              "w_out": ((d, cfg.n_targets), d ** -0.5)}
    return {
        "feat_proj": dense((cfg.d_feat, d), cfg.d_feat ** -0.5),
        "rbf_proj": dense((cfg.n_radial, d), cfg.n_radial ** -0.5),
        "msg_init": dense((3 * d, d), (3 * d) ** -0.5),
        "blocks": {name: dense((cfg.n_blocks,) + shape, scale)
                   for name, (shape, scale) in shapes.items()},
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_zeros((n,) + x.shape[1:]).index_add(0, seg, x)


def _block(bp: dict, m, acc, sbf, t_in, t_out, tmask, emask, dst, n):
    e = m.shape[0]
    # directional message: gather m over incoming triplet edges
    m_kj = F.embedding(t_in, m) @ bp["w_msg"]                # [T, d]
    s = sbf @ bp["w_sbf"]                                    # [T, b]
    nb, d, f = bp["w_bil"].shape
    inter = (s[:, :, None] * m_kj[:, None, :]).reshape(-1, nb * d) \
        @ bp["w_bil"].reshape(nb * d, f)                     # [T, f]
    inter = inter * tmask[:, None]
    agg = _segment_sum(inter, t_out, e)                      # [E, d]
    m_new = F.silu((m + agg) @ bp["w_upd1"])
    m_new = F.silu(m_new @ bp["w_upd2"]) + m                 # residual
    m_new = m_new * emask[:, None]
    # output block: edges -> nodes
    eo = F.silu(m_new @ bp["w_out_edge"]) * emask[:, None]
    node = _segment_sum(eo, dst, n)                          # [N, d]
    return m_new, acc + node @ bp["w_out"]


def forward(params, batch, cfg: DimeNetConfig) -> torch.Tensor:
    """Returns per-node outputs [N, n_targets] (sum over output blocks),
    f32 throughout, as the reference's only callers run it."""
    x = batch["x"]
    pos = batch["pos"]
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch["edge_mask"].float()
    t_in, t_out = batch["tri_edge_in"].long(), batch["tri_edge_out"].long()
    tmask = batch["tri_mask"].float()
    n = x.shape[0]

    # geometry
    vec = pos[dst] - pos[src]                                # [E,3]
    dist = torch.linalg.norm(vec + 1e-9, dim=-1)             # [E]
    rbf = bessel_rbf(dist, cfg.n_radial, cfg.cutoff)
    # triplet angle between edge (k->j) and (j->i)
    v_in, v_out = -vec[t_in], vec[t_out]
    cos_a = (v_in * v_out).sum(-1) / (
        torch.linalg.norm(v_in, dim=-1) * torch.linalg.norm(v_out, dim=-1)
        + 1e-9)
    sbf = sbf_basis(dist[t_in], cos_a, cfg.n_spherical, cfg.n_radial,
                    cfg.cutoff)                              # [T, SR]

    h = x @ params["feat_proj"]                              # [N, d]
    r = rbf @ params["rbf_proj"]                             # [E, d]
    m = torch.cat([F.embedding(src, h), F.embedding(dst, h), r], dim=-1)
    m = F.silu(m @ params["msg_init"])                       # [E, d]
    m = m * emask[:, None]

    acc = x.new_zeros((n, cfg.n_targets))
    blocks = params["blocks"]
    for i in range(blocks["w_msg"].shape[0]):
        bp = {k: blocks[k][i] for k in BLOCK_LEAVES}
        m, acc = _block(bp, m, acc, sbf, t_in, t_out, tmask, emask, dst, n)
    return acc


def loss_fn(params, batch, cfg: DimeNetConfig):
    """Classification: masked node cross-entropy; regression: the mean
    squared error of graph energies pooled by ``graph_ids`` ->
    ``(loss, {"loss": loss})``."""
    out = forward(params, batch, cfg)
    mask = batch["node_mask"].float()
    if cfg.task == "classification":
        logz = torch.logsumexp(out, dim=-1)
        gold = out.gather(-1, batch["labels"].long()[:, None])[:, 0]
        loss = ((logz - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    else:
        # molecule energy: graph-pooled regression via graph_ids
        n_graphs = batch["targets"].shape[0]
        energy = _segment_sum(out[:, 0] * mask, batch["graph_ids"].long(),
                              n_graphs)
        loss = torch.mean((energy - batch["targets"]) ** 2)
    return loss, {"loss": loss}
