"""Port parity of the LM generator: decode_attention, layers, transformer.

The same numpy inputs (and the reference's own random weights, carried
across with ``repro_torch.convert``) go through the JAX package and the
port on the CPU.  Tolerances: decode attention f32 2e-5 and bf16 3e-2 (the
reference's own kernel tests); layers f32 1e-5; whole-model logits f32
2e-4 (f32 sums taken in another order through every layer, as the
reference's decode-vs-prefill test allows).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.lm_archs import LM_CONFIGS as REF_CONFIGS
from repro.kernels import ops as ref_ops
from repro.kernels.decode_attention import decode_attention_ref
from repro.models import layers as RL
from repro.models import transformer as rtf
from repro_torch import convert
from repro_torch.configs.lm_archs import LM_CONFIGS
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=256, d_head=16)
VARIANTS = {"tiny": TINY,
            "chatglm-like": dict(TINY, n_kv_heads=1, rope_fraction=0.5),
            "gelu": dict(TINY, gated_mlp=False)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pt(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _models(variant, seed=0):
    spec = VARIANTS[variant]
    rcfg = rtf.TransformerConfig(name=variant, remat=False, **spec)
    pcfg = tf.TransformerConfig(name=variant, **spec)
    rparams = rtf.init_params(rcfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, rparams)
    pparams = convert.transformer_params_from_numpy(
        tree, pcfg, device="cpu", dtype=torch.float32)
    return rcfg, rparams, pcfg, pparams


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,d,s,blk,clen", [
    (2, 4, 16, 128, 32, 100), (1, 8, 32, 300, 64, 299), (3, 2, 8, 64, 64, 0),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_plain_vs_reference(b, h, d, s, blk, clen, dt):
    rng = np.random.default_rng(s + clen)
    jdt, tdt = DTYPES[dt]
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, h, d), (b, s, h, d), (b, s, h, d)))
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    pal = ref_ops.decode_attention(jq, jk, jv, jnp.int32(clen), block_s=blk,
                                   interpret=True)
    ref = decode_attention_ref(jq, jk, jv, jnp.int32(clen))
    tq, tk, tv = (_pt(x, tdt) for x in (q, k, v))
    tol = 2e-5 if dt == "f32" else 3e-2
    for out in (decode_attention_plain(tq, tk, tv, clen),
                decode_attention(tq, tk, tv, clen),            # CPU: plain
                ops.decode_attention_op(tq, tk, tv, torch.tensor(clen),
                                        backend="torch")):
        assert out.dtype == torch.float32 and out.shape == (b, h, d)
        np.testing.assert_allclose(out.numpy(), np.asarray(pal), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("h,hkv,clen", [(32, 2, 70), (8, 1, 0), (6, 2, 99),
                                        (40, 10, 64), (36, 4, 99)])
def test_decode_attention_gqa_vs_repeat_kv(h, hkv, clen):
    """The cache in GQA layout == the reference's oracle over the cache
    repeated to the query heads (``layers._repeat_kv``)."""
    rng = np.random.default_rng(h)
    b, s, d = 2, 100, 16
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, s, hkv, d)).astype(np.float32)
            for _ in range(2))
    ref = decode_attention_ref(jnp.asarray(q),
                               RL._repeat_kv(jnp.asarray(k), h),
                               RL._repeat_kv(jnp.asarray(v), h),
                               jnp.int32(clen))
    out = decode_attention_plain(_pt(q), _pt(k), _pt(v), clen)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        L.rmsnorm({"scale": _pt(scale)}, _pt(x), 1e-5).numpy(),
        np.asarray(RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                              1e-5)), rtol=1e-5, atol=1e-5)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    for frac in (1.0, 0.5):
        ref = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0, frac)
        out = L.apply_rope(_pt(x), torch.tensor(pos), 10000.0, frac)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    # half rotation passes the upper half through untouched
    half = L.apply_rope(_pt(x), torch.tensor(pos), 10000.0, 0.5)
    assert torch.equal(half[..., 8:], _pt(x)[..., 8:])


@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    rng = np.random.default_rng(1)
    p = RL.init_mlp(jax.random.key(3), 32, 64, gated=gated)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    ref = RL.mlp(p, jnp.asarray(x))
    out = L.mlp({k: _pt(v) for k, v in p.items()}, _pt(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["causal", "block_q", "mask", "bidir",
                                  "head_pad"])
def test_attention(case):
    rng = np.random.default_rng(2)
    n_heads, n_kv, s = (6, 2, 12) if case == "head_pad" else (4, 2, 16)
    p = RL.init_attention(jax.random.key(4), 32, n_heads, n_kv, 8)
    x = rng.normal(size=(2, s, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (2, s)).astype(np.int32)
    mask = rng.random((2, s)) < 0.7
    mask[:, 0] = True
    kw = dict(causal=case != "bidir", rope_theta=10000.0,
              rope_fraction=0.5 if case == "mask" else 1.0,
              block_q=4 if case == "block_q" else 0)
    rkw = dict(kw, mask=jnp.asarray(mask) if case == "mask" else None)
    if case == "head_pad":                      # the reference pads 6 -> 8
        rkw.update(head_tp=False, head_pad_to=8)
    ref, _ = RL.attention(p, jnp.asarray(x), jnp.asarray(pos), **rkw)
    out, cache = L.attention({k: _pt(v) for k, v in p.items()}, _pt(x),
                             torch.tensor(pos), **kw,
                             mask=torch.tensor(mask) if case == "mask"
                             else None)
    assert cache is None
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_attention_kv_cache_branch():
    """Decode: K/V written at cache_index, attention over positions <= it
    through decode_attention; output and cache as the reference's."""
    rng = np.random.default_rng(3)
    p = RL.init_attention(jax.random.key(5), 32, 4, 2, 8)
    x = rng.normal(size=(3, 1, 32)).astype(np.float32)
    ck, cv = (rng.normal(size=(3, 10, 2, 8)).astype(np.float32)
              for _ in range(2))
    idx = 6
    ref, (rk, rv) = RL.attention(
        p, jnp.asarray(x), jnp.full((3, 1), idx, jnp.int32), causal=True,
        rope_theta=10000.0, kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_index=jnp.int32(idx))
    tk, tv = _pt(ck), _pt(cv)
    out, (nk, nv) = L.attention(
        {k: _pt(v) for k, v in p.items()}, _pt(x),
        torch.full((3, 1), idx, dtype=torch.int32), causal=True,
        rope_theta=10000.0, kv_cache=(tk, tv), cache_index=idx)
    assert nk is tk and nv is tv                 # written in place
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nk.numpy(), np.asarray(rk), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(nv.numpy(), np.asarray(rv), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_prefill_decode(variant):
    rcfg, rparams, pcfg, pparams = _models(variant)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 256, (2, 6)).astype(np.int32)
    jt, pt = jnp.asarray(toks), torch.tensor(toks)
    full, _ = rtf.forward(rparams, jt, rcfg, compute_dtype=jnp.float32)
    np.testing.assert_allclose(tf.forward(pparams, pt, pcfg)[0].numpy(),
                               np.asarray(full), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        tf.prefill(pparams, pt, pcfg).numpy(),
        np.asarray(rtf.prefill(rparams, jt, rcfg,
                               compute_dtype=jnp.float32)),
        rtol=2e-4, atol=2e-4)
    rcache = rtf.init_kv_cache(rcfg, 2, 8, jnp.float32)
    pcache = tf.init_kv_cache(pcfg, 2, 8, torch.float32, device="cpu")
    for i in range(6):
        rl, rcache = rtf.decode_step(rparams, rcache, jt[:, i], jnp.int32(i),
                                     rcfg, compute_dtype=jnp.float32)
        pl_, pcache = tf.decode_step(pparams, pcache, pt[:, i], i, pcfg)
        np.testing.assert_allclose(pl_.numpy(), np.asarray(rl), rtol=2e-4,
                                   atol=2e-4, err_msg=f"step {i}")
    for f in ("k", "v"):
        np.testing.assert_allclose(pcache[f].numpy(), np.asarray(rcache[f]),
                                   rtol=2e-4, atol=2e-4)
    # and the port's own decode reaches the prefill's last logits
    np.testing.assert_allclose(pl_.numpy(),
                               tf.forward(pparams, pt, pcfg)[0][:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_blocked_prefill_matches_unblocked():
    rcfg, rparams, pcfg, pparams = _models("chatglm-like")
    blocked = dataclasses.replace(pcfg, attn_block_q=4)
    toks = torch.tensor(np.random.default_rng(5).integers(0, 256, (2, 16)))
    np.testing.assert_allclose(tf.forward(pparams, toks, blocked)[0].numpy(),
                               tf.forward(pparams, toks, pcfg)[0].numpy(),
                               rtol=1e-5, atol=1e-5)


# Measured on the CPU over the three TINY variants x 5 token draws: the
# bf16 decode's first-step logits differ from the reference's by at most
# 0.078 and the prefill's by at most 0.035, with |logits| up to 4.2, where
# one bf16 ulp is 0.0156 (so at most 5 ulps).  The reference computes the
# decode scores and probs @ v in bf16 (layers.py:167-172); decode_attention
# does both in f32 from the same bf16 cache.
BF16_LOGIT_TOL = 0.125


def test_bf16_first_step():
    rcfg, rparams, pcfg, _ = _models("chatglm-like")
    tree = jax.tree.map(np.asarray, rparams)
    pb = convert.transformer_params_from_numpy(tree, pcfg, device="cpu",
                                               dtype=torch.bfloat16)
    assert pb["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert pb["final_norm"]["scale"].dtype == torch.float32
    toks = np.random.default_rng(6).integers(0, 256, (2, 8)).astype(np.int32)
    rpre = rtf.prefill(rparams, jnp.asarray(toks), rcfg)          # bf16
    ppre = tf.prefill(pb, torch.tensor(toks), pcfg)
    assert ppre.dtype == torch.bfloat16
    assert np.abs(_np(ppre) - _np(rpre)).max() <= BF16_LOGIT_TOL
    rlg, _ = rtf.decode_step(rparams, rtf.init_kv_cache(rcfg, 2, 12),
                             jnp.asarray(toks[:, 0]), jnp.int32(8), rcfg)
    plg, _ = tf.decode_step(pb, tf.init_kv_cache(pcfg, 2, 12, device="cpu"),
                            torch.tensor(toks[:, 0]), 8, pcfg)
    assert plg.dtype == torch.bfloat16
    assert np.abs(_np(plg) - _np(rlg)).max() <= BF16_LOGIT_TOL


def test_params_roundtrip_and_init_shapes():
    _, rparams, pcfg, pparams = _models("gelu")
    tree = jax.tree.map(np.asarray, rparams)
    back = convert.transformer_params_to_numpy(pparams)
    flat_ref = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, a in flat_ref:
        np.testing.assert_array_equal(flat_back[path], a)
    own = tf.init_params(pcfg, seed=1, device="cpu", dtype=torch.float32)
    own_tree = convert.transformer_params_to_numpy(own)
    for path, a in flat_ref:
        b = dict(jax.tree_util.tree_leaves_with_path(own_tree))[path]
        assert b.shape == a.shape, path
        # same scales: the std of a random leaf matches the reference's
        if a.size > 1000:
            assert abs(b.std() / a.std() - 1) < 0.1, path


def test_dense_configs_match_reference():
    for name, cfg in LM_CONFIGS.items():
        ref = REF_CONFIGS[name]
        for f in dataclasses.fields(cfg):
            want = getattr(ref, f.name)
            if f.name == "param_dtype":       # a torch dtype, a jnp one
                want = getattr(torch, jnp.dtype(want).name)
            assert getattr(cfg, f.name) == want, (name, f.name)
        assert cfg.param_count() == ref.param_count()
    assert LM_CONFIGS["chatglm3-6b"].param_count() == 6_243_454_976
    # an MoE config builds (the port served dense configs only before)
    moe = tf.TransformerConfig(name="moe", moe_experts=4, **TINY)
    assert moe.is_moe and moe.param_count() > moe.active_param_count()
