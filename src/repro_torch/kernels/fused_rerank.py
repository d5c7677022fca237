"""RRF fusion + near-duplicate diversification + rerank of a hybrid pool.

``fused_rerank`` replaces the Pallas kernel
``src/repro/kernels/fused_rerank.py::_fused_kernel`` and the final sort
``_final_topk`` the reference runs after it; ``fused_scores`` is the
kernel's per-slot scores alone.  Per query, over a
pool of ``kd`` dense slots then ``kl`` lexical slots (``-1`` = invalid,
zero vector):

1. RRF mass ``1 / (rrf_k + rank)`` (rank within the slot's channel), with
   all of an id's mass summed, slot by slot in order, onto its first
   occurrence; later occurrences and invalid slots get 0;
2. ``rscore = vec . q``, the dense rerank score;
3. with ``diversify_sim``: cosine similarities of the pool (norms floored
   at 1e-12), then P greedy rounds: the slot of largest remaining mass (the
   lowest on ties) is kept if its mass is positive and its cosine to every
   kept slot stays below ``diversify_sim``; ``None`` keeps every slot of
   positive mass.

It returns ``(mass, rscore)`` [B, P]: kept slots carry their mass, dropped
ones ``-inf``.  :func:`final_topk` then sorts by (mass desc, rscore desc,
slot asc) and slices the top-k, as the reference does outside its kernel
with two stable argsorts.  The masses are bit-equal across versions; the
rscores and cosines are f32 sums of d products taken in another order.

On a CUDA tensor ``fused_rerank`` and ``fused_scores`` launch the kernel of
``csrc/fused_rerank.cu`` once (one CTA per query, the final top-k in the
same launch: ``fused_rerank`` returns its ``vals, ids`` with no sort or
gather after it) and raise if that fails; on a CPU tensor they run the
plain versions.  ``fused_scores.launches`` counts the kernel's launches,
one per call of either.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.utils import first_argmax

MAX_POOL = 64          # the greedy pass holds two slots per lane of a warp
# dynamic shared memory a block may opt into, less the kernel's static
# arrays (1,792 bytes)
SMEM_LIMIT = 227 * 1024 - 2048


def _check_pool(pool_ids, kd: int) -> None:
    p = pool_ids.shape[1]
    if not 0 <= kd <= p:
        raise ValueError(f"fused_rerank: kd={kd} outside the pool of {p}")


def fused_scores_plain(queries: torch.Tensor, pool_ids: torch.Tensor,
                       pool_vecs: torch.Tensor, kd: int, rrf_k: float = 60.0,
                       diversify_sim: float | None = None):
    """queries [B,d], pool_ids [B,P], pool_vecs [B,P,d] -> (mass [B,P],
    rscore [B,P]) f32 (module docstring)."""
    _check_pool(pool_ids, kd)
    b, p = pool_ids.shape
    dev = pool_ids.device
    ids = pool_ids.to(torch.int32)
    rank = torch.cat([torch.arange(kd, device=dev),
                      torch.arange(p - kd, device=dev)]).to(torch.float32)
    pos = torch.arange(p, device=dev)
    valid = ids >= 0
    raw = torch.where(valid, 1.0 / (rrf_k + rank), 0.0)            # [B,P]
    same = ((ids[:, :, None] == ids[:, None, :])
            & valid[:, :, None] & valid[:, None, :])              # [B,P,P]
    first = ~(same & (pos[None, :] < pos[:, None])).any(dim=2)
    mass = torch.zeros((b, p), dtype=torch.float32, device=dev)
    for j in range(p):                        # in slot order, as the kernel
        mass = mass + torch.where(same[:, :, j], raw[:, j:j + 1], 0.0)
    mass = torch.where(first & valid, mass, 0.0)

    vecs = pool_vecs.float()
    rscore = torch.bmm(vecs, queries.float()[:, :, None])[..., 0]
    if diversify_sim is None:
        selected = mass > 0.0
    else:
        norm = torch.sqrt((vecs * vecs).sum(dim=2))
        vn = vecs / torch.clamp_min(norm, 1e-12)[..., None]
        sims = torch.bmm(vn, vn.transpose(1, 2))                  # cosine
        selected = torch.zeros((b, p), dtype=torch.bool, device=dev)
        rem = mass
        rows = torch.arange(b, device=dev)
        for _ in range(p):
            c = first_argmax(rem)                                 # [B]
            eligible = rem[rows, c] > 0.0
            msim = torch.where(selected, sims[rows, c], -torch.inf) \
                .max(dim=1).values
            at_c = pos[None, :] == c[:, None]
            keep = eligible & (msim < diversify_sim)
            selected = selected | (at_c & keep[:, None])
            rem = torch.where(at_c, 0.0, rem)
    return torch.where(selected, mass, -torch.inf), rscore


def final_topk(sel_mass: torch.Tensor, rscore: torch.Tensor,
               pool_ids: torch.Tensor, k: int):
    """Order by (mass desc, rscore desc, slot asc), keep k: -> (vals [B,k],
    ids [B,k] int32, ``-1`` where the mass is ``-inf``)."""
    o2 = torch.sort(rscore, dim=1, descending=True, stable=True).indices
    m2 = torch.gather(sel_mass, 1, o2)
    o1 = torch.sort(m2, dim=1, descending=True, stable=True).indices
    order = torch.gather(o2, 1, o1)[:, :k]
    vals = torch.gather(sel_mass, 1, order)
    ids = torch.gather(pool_ids.to(torch.int32), 1, order)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


@functools.lru_cache(maxsize=256)
def _smem(p: int, d: int) -> int:
    """Dynamic shared memory of the kernel's block for P slots of width d."""
    return _build.library("fused_rerank").has_fused_rerank_smem(p, d)


def _launch(queries, pool_ids, pool_vecs, kd: int, k: int | None,
            rrf_k: float, diversify_sim: float | None):
    """One kernel launch: -> (mass, rscore) when ``k`` is None, else
    (vals [B, min(k, P)], ids)."""
    _check_pool(pool_ids, kd)
    b, p = pool_ids.shape
    d = queries.shape[1]
    if queries.shape[0] != b or pool_vecs.shape != (b, p, d):
        raise ValueError(
            f"fused_rerank: queries {tuple(queries.shape)}, pool_ids "
            f"{tuple(pool_ids.shape)}, pool_vecs {tuple(pool_vecs.shape)}")
    if k is not None and k < 1 or d < 1:
        raise ValueError(f"fused_rerank: k and d must be >= 1, got k={k}, "
                         f"d={d}")
    lib = _build.library("fused_rerank")
    if p > MAX_POOL or (p and _smem(p, d) > SMEM_LIMIT):
        raise ValueError(f"fused_rerank: a pool of {p} x d={d} does not fit "
                         f"one block (at most {MAX_POOL} slots)")
    q = queries.float().contiguous()
    ids = pool_ids.to(torch.int32).contiguous()
    vecs = pool_vecs.float().contiguous()
    dev = _build.check_operands("fused_rerank", q, ids, vecs)
    if k is None:
        outs = (torch.empty((b, p), dtype=torch.float32, device=dev),
                torch.empty((b, p), dtype=torch.float32, device=dev))
        mass, rscore, vals, out_ids = *outs, None, None
        kk = 0
    else:
        kk = min(k, p)
        outs = (torch.empty((b, kk), dtype=torch.float32, device=dev),
                torch.empty((b, kk), dtype=torch.int32, device=dev))
        mass, rscore, (vals, out_ids) = None, None, outs
    if b == 0 or p == 0:
        return outs
    div = diversify_sim is not None
    _build.check(lib.has_fused_rerank(
        _build.ptr(q), _build.ptr(ids), _build.ptr(vecs), _build.ptr(mass),
        _build.ptr(rscore), _build.ptr(vals), _build.ptr(out_ids), b, p, kd,
        d, kk, float(rrf_k), int(div), float(diversify_sim) if div else 0.0,
        _build.stream(dev)), "fused_rerank")
    fused_scores.launches += 1
    return outs


def fused_scores(queries: torch.Tensor, pool_ids: torch.Tensor,
                 pool_vecs: torch.Tensor, kd: int, rrf_k: float = 60.0,
                 diversify_sim: float | None = None):
    """Same contract as :func:`fused_scores_plain`; the kernel on CUDA."""
    if queries.device.type != "cuda":
        return fused_scores_plain(queries, pool_ids, pool_vecs, kd, rrf_k,
                                  diversify_sim)
    return _launch(queries, pool_ids, pool_vecs, kd, None, rrf_k,
                   diversify_sim)


fused_scores.launches = 0


def fused_rerank_plain(queries, pool_ids, pool_vecs, kd: int, k: int,
                       rrf_k: float = 60.0,
                       diversify_sim: float | None = None):
    """queries [B,d], pool_ids [B,P], pool_vecs [B,P,d] -> (fused masses
    [B,k] desc, ids [B,k]); dropped slots come back ``-inf`` / ``-1``."""
    return final_topk(*fused_scores_plain(queries, pool_ids, pool_vecs, kd,
                                          rrf_k, diversify_sim),
                      pool_ids, k)


def fused_rerank(queries, pool_ids, pool_vecs, kd: int, k: int,
                 rrf_k: float = 60.0, diversify_sim: float | None = None):
    """Same contract as :func:`fused_rerank_plain`; on CUDA one launch that
    also makes the final top-k."""
    if queries.device.type != "cuda":
        return fused_rerank_plain(queries, pool_ids, pool_vecs, kd, k, rrf_k,
                                  diversify_sim)
    return _launch(queries, pool_ids, pool_vecs, kd, k, rrf_k, diversify_sim)
