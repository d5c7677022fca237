"""Port parity of the Mixture-of-Experts layer and the MoE generators.

The same numpy inputs (and the reference's own random weights, carried
across as numpy arrays, through ``repro_torch.convert`` for whole models)
go through ``repro.models.layers.moe`` / ``repro.models.transformer`` and
the port on the CPU.

Exact: the top-k expert ids, the dispatch's sorted slots, tokens and keep
mask, and the expert buffers (row copies, with the reference's slot-0
quirk: an expert that drops an entry also zeroes the token it kept at
position 0).  Tolerances: outputs and aux 1e-5 in f32 (the expert
products sum in another order); bf16 outputs within 2^-8 (rtol and atol:
measured bit-equal on the CPU at these widths, since the experts compute
``jax.nn.silu``'s own form and the combine adds in the reference's order);
whole-model logits 2e-4 in f32, as ``test_torch_lm.py`` holds the dense
models, and ``BF16_LOGIT_TOL`` in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lm_archs import LM_CONFIGS as REF_CONFIGS
from repro.models import layers as RL
from repro.models import transformer as rtf
from repro_torch import convert
from repro_torch.configs.lm_archs import LM_CONFIGS
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
D, FF, TOKENS = 16, 32, (4, 16)          # x [B, S, D]
TINY_MOE = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                vocab_size=256, d_head=8, moe_experts=4, moe_top_k=2)
MOE_VARIANTS = {"moe": TINY_MOE,
                "moe-residual": dict(TINY_MOE, moe_dense_residual=True),
                "moe-top1-drops": dict(TINY_MOE, moe_top_k=1,
                                       capacity_factor=0.5),
                "moe-groups": dict(TINY_MOE, moe_dp_groups=2)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pt(a, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _layer_params(e, dt, seed=0):
    """The reference's ``init_moe`` draws (router f32, experts in ``dt``)
    and the port's copy of them."""
    jdt, tdt = DTYPES[dt]
    rp = RL.init_moe(jax.random.key(seed), D, FF, e, jdt)
    pp = {k: _pt(_np(v), torch.float32 if k == "router" else tdt)
          for k, v in rp.items()}
    return rp, pp


def _x(dt, seed=1):
    jdt, tdt = DTYPES[dt]
    x = np.random.default_rng(seed).normal(size=(*TOKENS, D))
    return jnp.asarray(x, jdt), _pt(x, tdt)


def _ref_dispatch(rp, jx, top_k, cf, groups):
    """The reference's ``_moe_dispatch`` on each token group, as ``moe``
    runs it (``vmap`` over the groups)."""
    e = rp["router"].shape[-1]
    t = TOKENS[0] * TOKENS[1]
    cap = int(cf * (t // groups) * top_k / e) + 1
    xg = jx.reshape(groups, t // groups, D)
    bufs, infos, _ = jax.vmap(
        lambda xt: RL._moe_dispatch(xt, rp["router"], top_k, cap, e))(xg)
    gate = jax.vmap(lambda xt: jax.lax.top_k(jax.nn.softmax(
        xt.astype(jnp.float32) @ rp["router"], -1), top_k)[1])(xg)
    return cap, bufs, infos, gate


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("e", [4, 8])
def test_moe_matches_reference(e, top_k, cf, groups, dt):
    rp, pp = _layer_params(e, dt)
    jx, tx = _x(dt)
    cap, bufs, infos, gate = _ref_dispatch(rp, jx, top_k, cf, groups)
    t_g = TOKENS[0] * TOKENS[1] // groups
    for i, xt in enumerate(tx.reshape(groups, t_g, D)):
        buf, r, _ = L._moe_dispatch(xt, pp["router"], top_k, cap, e)
        slot, src, sw, keep = (np.asarray(a[i]) for a in infos)
        assert r.capacity == cap
        np.testing.assert_array_equal(r.gate_idx.numpy(), np.asarray(gate[i]))
        np.testing.assert_array_equal(r.keep.numpy(), keep)
        np.testing.assert_array_equal(r.slot.numpy(), slot)
        np.testing.assert_array_equal(r.src.numpy(), src)
        np.testing.assert_allclose(r.sw.numpy(), sw, rtol=1e-6, atol=1e-7)
        # the buffer, slot-0 zeroing included, is a copy of rows
        np.testing.assert_array_equal(_np(buf), _np(bufs[i]))
        overflow = np.bincount(slot[~keep] // cap, minlength=e) > 0
        np.testing.assert_array_equal(r.overflow.numpy(), overflow)
    ro, ra = RL.moe(rp, jx, top_k=top_k, capacity_factor=cf,
                    dp_groups=groups)
    po, pa = L.moe(pp, tx, top_k=top_k, capacity_factor=cf,
                   dp_groups=groups)
    assert po.dtype == DTYPES[dt][1] and po.shape == (*TOKENS, D)
    tol = 1e-5 if dt == "f32" else 2 ** -8
    np.testing.assert_allclose(_np(po), _np(ro), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(pa), float(ra), rtol=1e-5, atol=1e-6)
    # rows the reference zeroes (every entry dropped, or kept at slot 0 of
    # an expert that overflowed) are the port's zero rows
    np.testing.assert_array_equal(np.all(_np(po) == 0, -1),
                                  np.all(_np(ro) == 0, -1))


def test_slot0_quirk_at_the_reference_drop_setting():
    """``tests/test_models.py::test_moe_capacity_drops_tokens``'s setting:
    d=8, 2 experts, top-1, capacity factor 0.25, 32 tokens (capacity 5).
    10 tokens are kept and 22 dropped; both experts overflow, so each also
    loses the token at its position 0: 24 of 32 rows are zero."""
    rp = RL.init_moe(jax.random.key(0), 8, 16, 2)
    jx = jax.random.normal(jax.random.key(1), (1, 32, 8))
    pp = {k: _pt(_np(v)) for k, v in rp.items()}
    tx = _pt(_np(jx))
    ro, _ = RL.moe(rp, jx, top_k=1, capacity_factor=0.25)
    po, _ = L.moe(pp, tx, top_k=1, capacity_factor=0.25)
    np.testing.assert_allclose(_np(po), _np(ro), rtol=1e-5, atol=1e-5)
    zero = np.all(_np(po) == 0, -1)[0]
    assert zero.sum() == 24 and np.all(_np(ro) == 0, -1).sum() == 24
    buf, r, _ = L._moe_dispatch(tx[0], pp["router"], 1, 5, 2)
    assert r.capacity == 5
    assert int(r.keep.sum()) == 10 and int((~r.keep).sum()) == 22
    assert r.overflow.tolist() == [True, True]
    assert not buf[:, 0].any() and buf[:, 1:].abs().sum(-1).gt(0).all()
    # the tokens kept at position 0 are among the zero rows
    kept0 = r.src[r.keep & (r.slot % 5 == 0)]
    assert zero[kept0.numpy()].all()
    # with no drops, no row and no slot 0 is zero
    hi, r8, _ = L._moe_dispatch(tx[0], pp["router"], 1, 129, 2)
    assert r8.keep.all() and not r8.overflow.any()
    assert hi[:, 0].abs().sum(-1).gt(0).all()
    out8, _ = L.moe(pp, tx, top_k=1, capacity_factor=8.0)
    assert not np.all(_np(out8) == 0, -1).any()


def test_moe_matches_a_plain_expert_loop():
    """The reference's own check (``tests/test_models.py:75-98``), with the
    drop and slot-0 rule: each token through its routed experts, one at a
    time, kept entries only, slot 0 of an overflowing expert zero."""
    e, top_k = 4, 2
    _, pp = _layer_params(e, "f32")
    _, tx = _x("f32")
    for cf in (8.0, 0.5):
        out, _ = L.moe(pp, tx, top_k=top_k, capacity_factor=cf)
        xt = tx.reshape(-1, D)
        t = len(xt)
        cap = int(cf * t * top_k / e) + 1
        probs = torch.softmax(xt @ pp["router"], -1).numpy()
        seen = np.zeros(e, int)
        owner = {}
        entries = []
        for tok in range(t):
            ids = sorted(range(e), key=lambda j: (-probs[tok, j], j))[:top_k]
            w = probs[tok, ids] / probs[tok, ids].sum()
            entries += [(x, tok, wi) for x, wi in zip(ids, w)]
        naive = torch.zeros_like(xt)
        overflow = set()
        for x, tok, w in sorted(entries, key=lambda en: (en[0], en[1])):
            if seen[x] >= cap:
                overflow.add(x)
                continue
            if seen[x] == 0:
                owner[x] = tok
            seen[x] += 1
            h = L.silu(xt[tok] @ pp["w_gate"][x]) * (xt[tok] @ pp["w_in"][x])
            naive[tok] += float(w) * (h @ pp["w_out"][x])
        for x in overflow:
            # the owner's contribution through x is zero
            h = L.silu(xt[owner[x]] @ pp["w_gate"][x]) * (
                xt[owner[x]] @ pp["w_in"][x])
            w = [wi for ex, tok, wi in entries
                 if ex == x and tok == owner[x]][0]
            naive[owner[x]] -= float(w) * (h @ pp["w_out"][x])
        assert bool(overflow) == (cf < 1)
        np.testing.assert_allclose(out.reshape(-1, D).numpy(),
                                   naive.numpy(), rtol=2e-5, atol=2e-5)


def test_moe_rejects_uneven_groups():
    _, pp = _layer_params(4, "f32")
    with pytest.raises(ValueError, match="groups"):
        L.moe(pp, torch.zeros(1, 5, D), top_k=2, dp_groups=2)


# ---------------------------------------------------------------------------
# the MoE transformer
# ---------------------------------------------------------------------------

def _models(variant, seed=0):
    spec = MOE_VARIANTS[variant]
    rcfg = rtf.TransformerConfig(name=variant, remat=False, **spec)
    pcfg = tf.TransformerConfig(name=variant, **spec)
    rparams = rtf.init_params(rcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, rparams, pcfg, tree


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
def test_moe_transformer_matches_reference(variant):
    """forward_hidden / forward with aux, prefill and 8 decode steps' logits
    (f32), and greedy tokens equal; decode dispatches flat, as the
    reference's does, whatever ``moe_dp_groups``."""
    rcfg, rparams, pcfg, tree = _models(variant)
    pp = convert.transformer_params_from_numpy(tree, pcfg, device="cpu",
                                               dtype=torch.float32)
    toks = np.random.default_rng(7).integers(0, 256, (2, 8)).astype(np.int32)
    jt, pt = jnp.asarray(toks), torch.tensor(toks)
    rh, raux = rtf.forward_hidden(rparams, jt, rcfg,
                                  compute_dtype=jnp.float32)
    ph, paux = tf.forward_hidden(pp, pt, pcfg)
    np.testing.assert_allclose(ph.numpy(), np.asarray(rh), rtol=2e-4,
                               atol=2e-4)
    assert paux.dtype == torch.float32 and paux.shape == ()
    np.testing.assert_allclose(float(paux), float(raux), rtol=1e-5,
                               atol=1e-5)
    rl, raux2 = rtf.forward(rparams, jt, rcfg, compute_dtype=jnp.float32)
    pl_, paux2 = tf.forward(pp, pt, pcfg)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(rl), rtol=2e-4,
                               atol=2e-4)
    assert float(paux2) == float(paux) and float(raux2) > 0
    rpre = rtf.prefill(rparams, jt, rcfg, compute_dtype=jnp.float32)
    ppre = tf.prefill(pp, pt, pcfg)
    np.testing.assert_allclose(ppre.numpy(), np.asarray(rpre), rtol=2e-4,
                               atol=2e-4)
    # greedy decode from the prefill's token, 8 steps
    rcache = rtf.init_kv_cache(rcfg, 2, 16, jnp.float32)
    pcache = tf.init_kv_cache(pcfg, 2, 16, torch.float32, device="cpu")
    rtok = jnp.argmax(rpre, -1).astype(jnp.int32)
    ptok = ppre.argmax(-1).int()
    for i in range(8):
        rlg, rcache = rtf.decode_step(rparams, rcache, rtok, jnp.int32(8 + i),
                                      rcfg, compute_dtype=jnp.float32)
        plg, pcache = tf.decode_step(pp, pcache, ptok, 8 + i, pcfg)
        np.testing.assert_allclose(plg.numpy(), np.asarray(rlg), rtol=2e-4,
                                   atol=2e-4, err_msg=f"step {i}")
        rtok = jnp.argmax(rlg, -1).astype(jnp.int32)
        ptok = plg.argmax(-1).int()
        np.testing.assert_array_equal(ptok.numpy(), np.asarray(rtok))


# Measured on the CPU over the four MOE_VARIANTS: the bf16 prefill's
# logits differ from the reference's by at most 0.039 and the first decode
# step's by at most 0.070, with |logits| up to 3.7 (one bf16 ulp: 0.0156).
# The MoE layer is bit-equal (test above); the rest is the dense path's
# difference, held by test_torch_lm.py to the same bound: the reference's
# decode keeps scores and probs @ v in bf16, decode_attention works in f32.
BF16_LOGIT_TOL = 0.125


@pytest.mark.parametrize("variant", list(MOE_VARIANTS))
def test_moe_transformer_bf16_first_step(variant):
    rcfg, rparams, pcfg, tree = _models(variant)
    pb = convert.transformer_params_from_numpy(tree, pcfg, device="cpu",
                                               dtype=torch.bfloat16)
    assert pb["layers"][0]["moe"]["router"].dtype == torch.bfloat16
    toks = np.random.default_rng(8).integers(0, 256, (2, 8)).astype(np.int32)
    rpre = rtf.prefill(rparams, jnp.asarray(toks), rcfg)            # bf16
    ppre = tf.prefill(pb, torch.tensor(toks), pcfg)
    assert ppre.dtype == torch.bfloat16
    assert np.abs(_np(ppre) - _np(rpre)).max() <= BF16_LOGIT_TOL
    rlg, _ = rtf.decode_step(rparams, rtf.init_kv_cache(rcfg, 2, 12),
                             jnp.asarray(toks[:, 0]), jnp.int32(8), rcfg)
    plg, _ = tf.decode_step(pb, tf.init_kv_cache(pcfg, 2, 12, device="cpu"),
                            torch.tensor(toks[:, 0]), 8, pcfg)
    assert np.abs(_np(plg) - _np(rlg)).max() <= BF16_LOGIT_TOL


@pytest.mark.parametrize("variant", ["moe", "moe-residual"])
def test_moe_params_roundtrip_and_init_shapes(variant):
    """``convert`` carries the ``moe`` subtree (and Arctic's residual
    ``mlp``) both ways; the port's own draws have the reference's shapes
    and scales, the router in the compute dtype."""
    _, _, pcfg, tree = _models(variant)
    pp = convert.transformer_params_from_numpy(tree, pcfg, device="cpu",
                                               dtype=torch.float32)
    back = convert.transformer_params_to_numpy(pp)
    flat_ref = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, a in flat_ref:
        np.testing.assert_array_equal(flat_back[path], a)
    assert ("mlp" in pp["layers"][0]) == (variant == "moe-residual")
    own = tf.init_params(pcfg, seed=1, device="cpu", dtype=torch.bfloat16)
    assert own["layers"][0]["moe"]["router"].dtype == torch.bfloat16
    own_tree = dict(jax.tree_util.tree_leaves_with_path(
        convert.transformer_params_to_numpy(own)))
    for path, a in flat_ref:
        b = own_tree[path]
        assert b.shape == a.shape, path
        if a.size > 1000:
            assert abs(b.std() / a.std() - 1) < 0.1, path
    # experts are drawn one at a time: distinct draws per expert
    w = own["layers"][0]["moe"]["w_in"]
    assert not torch.equal(w[0], w[1])


def test_moe_configs_match_reference():
    for name in ("arctic-480b", "dbrx-132b"):
        cfg, ref = LM_CONFIGS[name], REF_CONFIGS[name]
        assert cfg.is_moe and ref.is_moe
        for f in dataclasses.fields(cfg):
            want = getattr(ref, f.name)
            if f.name == "param_dtype":       # a torch dtype, a jnp one
                want = getattr(torch, jnp.dtype(want).name)
            assert getattr(cfg, f.name) == want, (name, f.name)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
    # dense configs: every token touches every parameter
    for name in ("starcoder2-7b", "phi3-medium-14b", "chatglm3-6b"):
        cfg = LM_CONFIGS[name]
        assert cfg.active_param_count() == cfg.param_count() \
            == REF_CONFIGS[name].active_param_count()
    # decode capacity at the RAG batch of 8 tokens: arctic 1, dbrx 3
    for name, want in (("arctic-480b", 1), ("dbrx-132b", 3)):
        cfg = LM_CONFIGS[name]
        assert int(cfg.capacity_factor * 8 * cfg.moe_top_k
                   / cfg.moe_experts) + 1 == want
