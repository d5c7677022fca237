"""Port parity of the recsys models (``repro_torch.models.recsys``), their
configs and data against the JAX package on the CPU.

The reference's smoke configs and draws go through both packages: the
reference's parameters are carried across with ``repro_torch.convert``,
the batches are the reference's numpy draws (which the port draws too).

Tolerances (f32):
- forward logits: ``FWD_TOL`` (rtol and atol; f32 sums of products in
  another order);
- loss: ``LOSS_RTOL``; gradients: each leaf within ``GRAD_TOL`` of its
  largest element (sums over the batch and the fields in another order);
- one AdamW step: parameters and both moments within ``STEP_TOL`` of
  each leaf's largest.  The step runs with ``eps = 1e-4``: at the
  default 1e-8 a gradient within eps of zero (the embedding rows touched
  once) has its last-bit differences magnified up to the learning rate;
- ``_dot_interaction`` on integer-valued vectors (exact sums): bit-equal,
  which holds the strict upper triangle's row-major order exactly;
- ``retrieval_score``: ids exact (planted ties to the lower index),
  scores ``FWD_TOL``;
- data draws: ints exact, floats bit-equal; the md5 digests pinned in
  ``repro_torch/data/digests.py`` (computed with the reference under
  numpy 2.0.2).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import recsys_archs as rarchs
from repro.configs.families import recsys_shapes as ref_recsys_shapes
from repro.data import recsys as rdata
from repro.models import recsys as rrs
from repro.training import optimizer as ropt
from repro.training import train as rtrain
from repro_torch import convert
from repro_torch.configs import recsys_archs as parchs
from repro_torch.configs.families import recsys_shapes, to_device
from repro_torch.data import digests
from repro_torch.data import recsys as pdata
from repro_torch.models import recsys as prs
from repro_torch.training.optimizer import OptConfig, leaves, opt_init
from repro_torch.training.train import _grads, make_train_step

FWD_TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5
STEP_TOL = 1e-5
ARCHS = sorted(rarchs.RECSYS_CONFIGS)


def _ref_smoke(arch):
    """The reference's smoke: (cfg, params, batch as numpy)."""
    cfg, params, _, _, batch = ref_get_arch(arch).make_smoke()
    return cfg, params, {k: np.asarray(v) for k, v in batch.items()}


def _port(arch, params):
    cfg = parchs.smoke_config(parchs.RECSYS_CONFIGS[arch])
    tree = jax.tree.map(np.asarray, params)
    return cfg, convert.float_tree_from_numpy(tree, "cpu")


def _leaf_close(got, want, tol, what):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, what
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= tol * scale, what


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_batch_is_the_reference_draw(arch):
    _, _, want = _ref_smoke(arch)
    got = parchs.smoke_batch(parchs.smoke_config(
        parchs.RECSYS_CONFIGS[arch]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    rcfg, rparams, batch = _ref_smoke(arch)
    cfg, params = _port(arch, rparams)
    want = np.asarray(rrs.forward(rparams, jax.tree.map(jnp.asarray, batch),
                                  rcfg))
    got = prs.forward(params, to_device(batch, "cpu"), cfg)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    rl, _ = rrs.loss_fn(rparams, jax.tree.map(jnp.asarray, batch), rcfg)
    pl, metrics = prs.loss_fn(params, to_device(batch, "cpu"), cfg)
    np.testing.assert_allclose(float(pl), float(rl), rtol=LOSS_RTOL)
    assert float(metrics["loss"]) == float(pl)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    rcfg, rparams, batch = _ref_smoke(arch)
    cfg, params = _port(arch, rparams)
    jb = jax.tree.map(jnp.asarray, batch)
    rg = jax.grad(lambda p: rrs.loss_fn(p, jb, rcfg)[0])(rparams)
    for _, parts in leaves(params):
        for t in parts:
            t.requires_grad_(True)
    loss, _ = prs.loss_fn(params, to_device(batch, "cpu"), cfg)
    loss.backward()
    got = convert.float_tree_to_numpy(_grads(params))
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, rg))
    _leaf_close(got, rg, GRAD_TOL, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches_reference(arch):
    rcfg, rparams, batch = _ref_smoke(arch)
    cfg, params = _port(arch, rparams)
    rcfg_opt = ropt.OptConfig(name="adamw", eps=1e-4)
    rstate = ropt.opt_init(rcfg_opt, rparams)
    rstep = rtrain.make_train_step(
        functools.partial(rrs.loss_fn, cfg=rcfg), rcfg_opt,
        compute_dtype=jnp.float32)
    rp2, rs2, rm = rstep(rparams, rstate, jax.tree.map(jnp.asarray, batch))
    opt_cfg = OptConfig(name="adamw", eps=1e-4)
    state = opt_init(opt_cfg, params)
    step = make_train_step(functools.partial(prs.loss_fn, cfg=cfg), opt_cfg)
    params, state, metrics = step(params, state, to_device(batch, "cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), float(rm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(rm["grad_norm"]), rtol=GRAD_TOL)
    _leaf_close(convert.float_tree_to_numpy(params), rp2, STEP_TOL,
                f"{arch} params")
    for mom in ("m", "v"):
        _leaf_close(convert.float_tree_to_numpy(state[mom]), rs2[mom],
                    STEP_TOL, f"{arch} {mom}")
    assert int(state["step"]) == int(rs2["step"]) == 1


@pytest.mark.parametrize("f,d", [(27, 64), (5, 3), (2, 8)])
def test_dot_interaction_order_exact(f, d):
    """Integer-valued vectors: every dot is exact in f32, so the order of
    the pairs is held bit for bit."""
    rng = np.random.default_rng(f * d)
    v = rng.integers(-8, 8, (3, f, d)).astype(np.float32)
    want = np.asarray(rrs._dot_interaction(jnp.asarray(v)))
    got = prs._dot_interaction(torch.tensor(v)).numpy()
    assert got.shape == (3, f * (f - 1) // 2)
    np.testing.assert_array_equal(got, want)


def test_dot_interaction_random():
    v = np.random.default_rng(1).normal(size=(4, 27, 64)).astype(np.float32)
    np.testing.assert_allclose(
        prs._dot_interaction(torch.tensor(v)).numpy(),
        np.asarray(rrs._dot_interaction(jnp.asarray(v))), rtol=FWD_TOL,
        atol=FWD_TOL)


@pytest.mark.parametrize("top_k", [1, 10, 100])
def test_retrieval_score_ties_to_lower_index(top_k):
    """Candidates repeated in blocks, so every score is tied with its
    copies: the ids must be the reference's, the lower copy first."""
    rng = np.random.default_rng(top_k)
    base = rng.integers(-4, 4, (40, 8)).astype(np.float32)
    cands = np.concatenate([base, base[::-1], base[:20], base])  # 140 rows
    q = rng.integers(-3, 3, (2, 8)).astype(np.float32)
    cfg = parchs.RECSYS_CONFIGS["dlrm-rm2"]
    rv, ri = rrs.retrieval_score({}, {"query": jnp.asarray(q),
                                      "candidates": jnp.asarray(cands)},
                                 rarchs.RECSYS_CONFIGS["dlrm-rm2"],
                                 top_k=top_k)
    pv, pi = prs.retrieval_score({}, {"query": torch.tensor(q),
                                      "candidates": torch.tensor(cands)},
                                 cfg, top_k=top_k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_and_param_counts_match_reference(arch):
    """Field for field, and the counts, without allocating a parameter."""
    want = rarchs.RECSYS_CONFIGS[arch]
    got = parchs.RECSYS_CONFIGS[arch]
    for f in dataclasses.fields(want):
        if f.name == "param_dtype":
            assert got.param_dtype == torch.float32
            assert want.param_dtype == jnp.float32
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()
    assert prs.padded_vocab(got) == rrs.padded_vocab(want)
    np.testing.assert_array_equal(got.field_offsets("cpu").numpy(),
                                  np.asarray(want.field_offsets()))
    assert prs.CRITEO_VOCABS == rrs.CRITEO_VOCABS


def test_shapes_match_reference():
    want = ref_recsys_shapes()
    got = recsys_shapes()
    assert {k: (v.name, v.kind, dict(v.dims), v.note)
            for k, v in got.items()} == \
        {k: (v.name, v.kind, dict(v.dims), v.note) for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_match_reference(arch):
    """The port's own draws have the reference's tree, shapes and scales
    (the smoke configs)."""
    rcfg, rparams, _ = _ref_smoke(arch)
    cfg = parchs.smoke_config(parchs.RECSYS_CONFIGS[arch])
    got = convert.float_tree_to_numpy(prs.init_params(cfg, 0, "cpu"))
    want = jax.tree.map(np.asarray, rparams)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if b.std() > 0:        # the same scale, within sampling noise
            assert 0.5 < a.std() / b.std() < 2.0
        else:
            np.testing.assert_array_equal(a, b)    # zeros or ones


@pytest.mark.parametrize("size", sorted(digests.RECSYS_SIZES))
def test_recsys_sources_match_pinned_digests(size):
    assert digests.recsys_digests(rdata.ClickLog, rdata.SessionLog,
                                  size) == digests.RECSYS_PINNED[size]
    assert digests.recsys_digests(pdata.ClickLog, pdata.SessionLog,
                                  size) == digests.RECSYS_PINNED[size]


@pytest.mark.parametrize("n_dense,batch", [(13, 300), (0, 1000)])
def test_click_log_draws_equal_reference(n_dense, batch):
    vocabs = (5, 70, 100_000, 3, 4097)
    r = rdata.ClickLog(vocabs, n_dense=n_dense, seed=7)
    p = pdata.ClickLog(vocabs, n_dense=n_dense, seed=7)
    for _ in range(2):                 # the second draw continues the stream
        want, got = r.sample(batch), p.sample(batch)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_session_log_draws_equal_reference():
    r, p = rdata.SessionLog(300, seed=3), pdata.SessionLog(300, seed=3)
    for _ in range(2):
        want, got = r.sample(5, 12), p.sample(5, 12)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        # item 0 is both an item and [MASK]
        assert (got["items"][got["label_mask"]] == 0).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_trains_on_cpu(arch):
    cfg, params, opt_state, step, batch = \
        parchs._smoke_factory(parchs.RECSYS_CONFIGS[arch])("cpu")
    before = params["table"].clone()
    params, _, metrics = step(params, opt_state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(before, params["table"])
