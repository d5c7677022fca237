"""The algorithms of the one-launch ``fused_rerank`` and
``homology_validate`` kernels, held against the reference on the CPU.

The CUDA kernels run only on the card (``test_torch_cuda_kernels.py``).
What they compute differently from the reference's code is checked here:

* ``fused_rerank`` sorts the slots once by (mass desc, slot asc) and walks
  the slots of positive mass with a running largest cosine to the kept
  set, instead of the reference's argmax rounds; its cosines come from one
  Gram of [q; vecs] (``dot / (n_i * n_j)``), and its final order is one
  sort by (mass desc, rscore desc, slot asc) instead of two stable
  argsorts.  ``_kernel_walk`` below is that algorithm in plain torch;
  masses, vals and ids must equal the reference's ``_fuse_scores`` and
  ``_final_topk`` exactly.
* ``homology_validate_plain`` (scores, first maximal row, its score) must
  equal ``jnp.argmax`` and ``take_along_axis`` over the Pallas
  ``homology_score`` in interpret mode exactly.  Weighted cases use
  weights that are multiples of 1/64, so the sums are exact in any order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_rerank import _final_topk, _fuse_scores
from repro.kernels.homology_score import homology_score as ref_homology
from repro_torch.kernels import ops
from repro_torch.kernels.fused_rerank import (fused_rerank,
                                              fused_scores_plain)
from repro_torch.kernels.homology_score import (homology_score,
                                                homology_validate,
                                                homology_validate_plain)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- fused_rerank: the kernel's greedy walk -----------------------------------

def _kernel_walk(q, ids, vecs, kd: int, k: int, rrf_k: float,
                 dsim: float | None):
    """fused_rerank as the CUDA kernel computes it, one query at a time ->
    (sel_mass [B,P], vals [B,min(k,P)], ids [B,min(k,P)])."""
    sel0, _ = fused_scores_plain(q, ids, vecs, kd, rrf_k, None)
    mass = torch.where(torch.isfinite(sel0), sel0, 0.0)     # >= 0
    b, p = ids.shape
    sel = torch.full((b, p), -torch.inf)
    out_v, out_i = [], []
    for r in range(b):
        x = torch.cat([q[r:r + 1], vecs[r]])                 # [q; vecs]
        gram = x @ x.T
        rscore = gram[0, 1:]
        norm = torch.sqrt(torch.diagonal(gram)[1:]).clamp_min(1e-12)
        cos = gram[1:, 1:] / (norm[:, None] * norm[None, :])
        m = mass[r].tolist()
        kept = [False] * p
        running = torch.full((p,), -torch.inf)     # largest cosine to kept
        for c in sorted(range(p), key=lambda i: (-m[i], i)):
            if m[c] <= 0.0:
                break
            if dsim is None or float(running[c]) < np.float32(dsim):
                kept[c] = True
                running = torch.maximum(running, cos[c])
        sel[r] = torch.where(torch.tensor(kept), mass[r], -torch.inf)
        s, rs = sel[r].tolist(), rscore.tolist()
        order = sorted(range(p), key=lambda i: (-s[i], -rs[i], i))[:k]
        v = sel[r, order]
        out_v.append(v)
        out_i.append(torch.where(torch.isfinite(v), ids[r, order], -1))
    return sel, torch.stack(out_v), torch.stack(out_i).to(torch.int32)


def _pool(rng, b, p, kd, d=24):
    """Ids drawn so that some repeat within and across channels; every
    other row has distinct ids, so dense slot i and lexical slot i carry
    exactly equal mass; slots 2 and 3 near-duplicates, and so slots 2 and
    kd + 2 (equal masses: the lower slot is visited first); -1 slots
    zero."""
    q = rng.normal(size=(b, d)).astype(np.float32)
    ids = rng.integers(0, 3 * p, size=(b, p)).astype(np.int32)
    ids[::2] = np.stack([rng.permutation(10 * p)[:p] for _ in ids[::2]])
    ids[rng.random((b, p)) < 0.1] = -1
    vecs = rng.normal(size=(b, p, d)).astype(np.float32)
    if p > 3:
        vecs[:, 3] = vecs[:, 2] + 0.02 * rng.normal(size=(b, d))
    if 2 < kd < p - 2:      # equal masses, near-duplicates: the tie decides
        vecs[:, kd + 2] = vecs[:, 2] + 0.02 * rng.normal(size=(b, d))
    vecs[ids < 0] = 0.0
    return q, ids, vecs


FUSED_CASES = {
    "P=20 kd=10": (8, 20, 10, 10, None),
    "cross-channel duplicates": (6, 20, 10, 10, "dups"),
    "all-invalid pools": (3, 20, 10, 10, "empty"),
    "P=1 kd=0": (4, 1, 0, 10, None),
    "P=1 kd=1": (4, 1, 1, 1, None),
    "P=64 kd=32": (4, 64, 32, 10, None),
    "kd=0": (5, 12, 0, 5, None),
    "kd=P": (5, 12, 12, 5, None),
    "k > P": (5, 12, 6, 30, None),
}


@pytest.mark.parametrize("dsim", [None, 0.5, 0.98])
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_kernel_walk_matches_reference(case, dsim):
    b, p, kd, k, tweak = FUSED_CASES[case]
    rng = np.random.default_rng(p * 100 + kd + k)
    q, ids, vecs = _pool(rng, b, p, kd)
    if tweak == "dups":                      # lexical repeats dense ids
        ids[:, kd:kd + 4] = ids[:, 1:5]
        ids[1, kd:] = ids[1, :p - kd]
    elif tweak == "empty":
        ids[:] = -1
    vecs[ids < 0] = 0.0
    jargs = tuple(map(jnp.asarray, (q, ids, vecs)))
    ref_mass, ref_rs = jax.vmap(functools.partial(
        _fuse_scores, kd=kd, kl=p - kd, rrf_k=60.0, diversify_sim=dsim))(
        *jargs)
    rv, ri = _final_topk(ref_mass, ref_rs, jargs[1], k)
    sel, vals, out_ids = _kernel_walk(*map(_t, (q, ids, vecs)), kd, k, 60.0,
                                      dsim)
    np.testing.assert_array_equal(np.asarray(ref_mass), sel.numpy())
    np.testing.assert_array_equal(np.asarray(rv), vals.numpy())
    np.testing.assert_array_equal(np.asarray(ri), out_ids.numpy())
    # the port's CPU entry (the plain version) gives the same
    pv, pi = fused_rerank(*map(_t, (q, ids, vecs)), kd, k, 60.0, dsim)
    assert torch.equal(pv, vals) and torch.equal(pi, out_ids)
    if tweak == "empty":
        assert (out_ids == -1).all()
    if case == "P=20 kd=10" and dsim == 0.98:   # the near-duplicate dropped
        assert bool(torch.isneginf(sel[:, 2:4]).any(dim=1).all())


# -- homology_validate: scores, first maximal row, its score ------------------

def _reference_validate(draft, cache, valid, w=None, rg=None, qg=None):
    kw = {} if rg is None else dict(row_group=jnp.asarray(rg),
                                    q_group=jnp.asarray(qg))
    scores = ref_homology(jnp.asarray(draft), jnp.asarray(cache),
                          jnp.asarray(valid), tile_h=32, interpret=True,
                          draft_weights=None if w is None else
                          jnp.asarray(w), **kw)
    slot = jnp.argmax(scores, axis=1)
    best = jnp.take_along_axis(scores, slot[:, None], axis=1)[:, 0]
    return np.asarray(scores), np.asarray(best), np.asarray(slot)


@pytest.mark.parametrize("case", ["ties far apart", "all invalid",
                                  "weighted", "groups", "weighted groups",
                                  "k=1"])
def test_homology_validate_plain_matches_reference(case):
    rng = np.random.default_rng(len(case))
    b, h, k = 6, 150, 1 if case == "k=1" else 10
    draft = rng.integers(-1, 40, (b, k)).astype(np.int32)
    cache = rng.integers(-1, 40, (h, k)).astype(np.int32)
    valid = rng.random(h) < 0.8
    w = rg = qg = None
    if case == "ties far apart":       # the best twice, rows 3 and 149
        cache[[3, 149]] = draft[0]
        cache[[140, 7]] = draft[1]
        valid[[3, 149, 140, 7]] = True
    if case == "all invalid":
        valid[:] = False
    if "weighted" in case:
        w = rng.integers(0, 9, (b, k)).astype(np.float32) / 64
    if "groups" in case:
        rg = rng.integers(0, 2, h).astype(np.int32)
        qg = rng.integers(0, 2, b).astype(np.int32)
    want = _reference_validate(draft, cache, valid, w, rg, qg)
    tkw = {} if rg is None else dict(row_group=_t(rg), q_group=_t(qg))
    for backend in (None, "torch"):
        n0 = homology_score.launches
        scores, best, slot = ops.homology_validate_op(
            _t(draft), _t(cache), _t(valid),
            draft_weights=None if w is None else _t(w), backend=backend,
            **tkw)
        assert homology_score.launches == n0       # the CPU runs the plain
        assert slot.dtype == torch.int32 and best.dtype == torch.float32
        np.testing.assert_array_equal(want[0], scores.numpy())
        np.testing.assert_array_equal(want[1], best.numpy())
        np.testing.assert_array_equal(want[2], slot.numpy())
    if case == "ties far apart":
        assert slot[:2].tolist() == [3, 7]
    if case == "all invalid":
        assert not slot.any() and not best.any()
    assert all(torch.equal(x, y) for x, y in zip(
        homology_validate(_t(draft), _t(cache), _t(valid),
                          draft_weights=None if w is None else _t(w),
                          **tkw),
        homology_validate_plain(_t(draft), _t(cache), _t(valid),
                                draft_weights=None if w is None else _t(w),
                                **tkw)))
