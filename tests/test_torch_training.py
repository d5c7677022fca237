"""Port parity of the training path: the optimizers, the loss and its
gradients, remat, the train steps and accumulation.

The same numpy trees go through ``repro.training`` / ``repro.models`` and
``repro_torch`` on the CPU: the stacked layout for the reference, the
per-layer layout (a list of layer dicts) for the port, with
``repro_torch.convert`` carrying weights and optimizer states across.

Tolerances (f32 unless a test says bf16):
- optimizer updates, op by op against op by op: ``OPT_TOL`` (rtol and
  atol; the same f32 operations, the means and sums reduced in another
  order);
- loss, ce and aux: 1e-5; gradients: ``GRAD_TOL`` (f32 sums over tokens
  and heads in another order);
- parameters and optimizer state after jitted reference steps:
  ``STEP_TOL`` (XLA fuses the jitted step's products into FMAs).  These
  steps run with ``eps = 1e-4``: at the default 1e-8, where a gradient
  lies within ``eps`` of zero AdamW's update ``m / (sqrt(v) + eps)``
  magnifies its last-bit differences up to the learning rate, and a
  parameter comparison would say nothing;
- a step on bf16 masters: each bf16 leaf within one ulp of its top
  binade and at most ``BF16_FLIP_FRAC`` of the bf16 elements not
  bit-equal; the f32 Adafactor state within 2^-7 of each leaf's largest
  (``_bf16_step_faults`` and ``test_accum_step_matches_reference``);
- remat none / ``"full"`` / ``"dots"``: bit-equal (the CPU recomputes the
  same values);
- bf16 compute: the loss within ``BF16_LOSS_TOL``, the gradient norm
  within ``BF16_NORM_RTOL`` and AdamW's first moment after one step (0.1
  x the clipped gradient) within ``BF16_MOMENT_TOL`` of each leaf's
  largest, against the reference's bf16 step (measured 4.2e-4, 3.4e-3
  and 0.024 on the CPU).
Routing ints (each MoE layer's slots, tokens and keep mask) are exact, in
the forward and where remat recomputes them in the backward.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.models import transformer as rtf
from repro.training import optimizer as ropt
from repro.training import train as rtrain
from repro_torch import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as tf
from repro_torch.training import optimizer as opt
from repro_torch.training.train import make_train_step, make_train_step_accum

OPT_TOL = 2e-6
GRAD_TOL = 2e-5
STEP_TOL = 2e-6
BF16_LOSS_TOL = 5e-3
BF16_NORM_RTOL = 2e-2
BF16_MOMENT_TOL = 0.1
BF16_FLIP_FRAC = 0.01

TINY = dict(n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
            vocab_size=128, d_head=8)
MODELS = {
    "dense-gated": TINY,
    "dense-gelu": dict(TINY, gated_mlp=False),
    "chatglm-style": dict(TINY, n_kv_heads=1, rope_fraction=0.5),
    "moe-top2-drops": dict(TINY, moe_experts=4, moe_top_k=2,
                           capacity_factor=0.5),
    "arctic-style": dict(TINY, moe_experts=4, moe_top_k=2,
                         moe_dense_residual=True, capacity_factor=0.75),
}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tmap(fn, v) for v in tree]
    return fn(tree)


def _unstack(tree):
    """A stacked numpy tree -> the port's layout: ``layers`` (stacked
    leaves) becomes a list of per-layer dicts of tensors."""
    out = {}
    for k, v in tree.items():
        if k == "layers":
            n = len(jax.tree.leaves(v)[0])
            out[k] = [_tmap(lambda a, i=i: torch.tensor(np.asarray(a)[i]), v)
                      for i in range(n)]
        elif isinstance(v, dict):
            out[k] = _unstack(v)
        else:
            out[k] = torch.tensor(np.asarray(v))
    return out


def _stack(tree):
    """The port's layout -> a stacked numpy tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, list):
            out[k] = jax.tree.map(lambda *a: np.stack(a),
                                  *[_tmap(lambda t: t.float().numpy(), x)
                                    for x in v])
        elif isinstance(v, dict):
            out[k] = _stack(v)
        else:
            out[k] = v.float().numpy()
    return out


def _close(got, want, tol, what=""):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), rtol=tol,
                                   atol=tol, err_msg=what)


def _opt_tree(seed=0, n_layers=3, scales=(1.0, 1.0, 1.0)):
    """A stacked tree with ``[L, d]`` norm scales, an ``[L, E, d, f]``
    expert leaf, an ``[L, d, f]`` matrix, a plain matrix and a plain
    vector; each layer's values times ``scales[i]``."""
    rng = np.random.default_rng(seed)
    s = np.asarray(scales, np.float32)

    def lay(*shape):
        x = rng.normal(size=(n_layers, *shape)).astype(np.float32)
        return x * s.reshape(-1, *([1] * len(shape)))

    return {"embed": rng.normal(size=(16, 8)).astype(np.float32),
            "final_norm": {"scale": rng.normal(size=(8,)).astype(np.float32)},
            "layers": {"attn_norm": {"scale": lay(8)},
                       "moe": {"w_in": lay(2, 8, 6)},
                       "mlp": {"w_out": lay(6, 8)}}}


# ---------------------------------------------------------------------------
# optimizers against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(name):
    """Steps 1 to 5 (Adafactor's beta = 0 at step 1), nonzero weight
    decay, the global-norm clip active, per-layer gradient scales apart:
    parameters and the stacked state after each step."""
    cfg = ropt.OptConfig(name=name, lr=1e-2, weight_decay=0.01,
                         grad_clip=1.0)
    pcfg = opt.OptConfig(name=name, lr=1e-2, weight_decay=0.01,
                         grad_clip=1.0)
    p_np = _opt_tree(0)
    rp = jax.tree.map(jnp.asarray, p_np)
    rs = ropt.opt_init(cfg, rp)
    pp = _unstack(p_np)
    ps = opt.opt_init(pcfg, pp)
    assert jax.tree.map(np.shape, convert.opt_state_to_numpy(ps)) == \
        jax.tree.map(np.shape, jax.tree.map(np.asarray, rs))
    for step in range(1, 6):
        g_np = _opt_tree(step, scales=(1.0, 5.0, 0.2))
        rp, rs = ropt.opt_update(cfg, jax.tree.map(jnp.asarray, g_np), rs,
                                 rp)
        pp, ps = opt.opt_update(pcfg, _unstack(g_np), ps, pp)
        _close(_stack(pp), rp, OPT_TOL, f"{name} params, step {step}")
        got = convert.opt_state_to_numpy(ps)
        assert int(got["step"]) == int(rs["step"]) == step
        _close(got, jax.tree.map(np.asarray, rs), OPT_TOL,
               f"{name} state, step {step}")


def test_global_norm_and_clip_match_reference():
    g_np = _opt_tree(3, scales=(10.0, 1.0, 0.5))
    rn = ropt.global_norm(jax.tree.map(jnp.asarray, g_np))
    pn = opt.global_norm(_unstack(g_np))
    np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)
    rc, rn2 = ropt.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np), 1.0)
    pc, pn2 = opt.clip_by_global_norm(_unstack(g_np), 1.0)
    np.testing.assert_allclose(float(pn2), float(rn2), rtol=1e-6)
    _close(_stack(pc), rc, OPT_TOL, "clipped")


def test_adafactor_state_has_reference_stacked_shapes():
    """The norm scales factored over layers, the expert leaf's vr / vc
    stacked, the plain vector unfactored."""
    p_np = _opt_tree(0)
    st = convert.opt_state_to_numpy(
        opt.adafactor_init(_unstack(p_np)))["v"]
    want = jax.tree.map(np.shape,
                        ropt.adafactor_init(jax.tree.map(jnp.asarray, p_np)
                                            )["v"])
    assert jax.tree.map(np.shape, st) == want
    assert st["layers"]["attn_norm"]["scale"]["vr"].shape == (3,)
    assert st["layers"]["attn_norm"]["scale"]["vc"].shape == (8,)
    assert st["layers"]["moe"]["w_in"]["vr"].shape == (3, 2, 8)
    assert st["layers"]["moe"]["w_in"]["vc"].shape == (3, 2, 6)
    assert set(st["final_norm"]["scale"]) == {"v"}


def test_adafactor_clip_runs_over_the_stacked_leaf():
    """Layer 1's gradients 100x layer 0's: the RMS clip over the stacked
    leaf (the reference's) scales layer 0's small update down with layer
    1's; a clip of each layer alone would not.  The port equals the
    reference and differs from the per-layer clip."""
    cfg = ropt.OptConfig(name="adafactor", lr=1.0, weight_decay=0.0,
                         grad_clip=0.0)
    pcfg = opt.OptConfig(name="adafactor", lr=1.0, weight_decay=0.0,
                         grad_clip=0.0)
    rng = np.random.default_rng(5)
    w = np.zeros((2, 8, 6), np.float32)
    g = rng.normal(size=(2, 8, 6)).astype(np.float32)
    g[0] *= 0.01
    g[0, 0, 0] = 3.0          # one outlier: layer 0's own RMS exceeds 1
    rp, _ = ropt.opt_update(cfg, {"w": jnp.asarray(g)},
                            ropt.opt_init(cfg, {"w": jnp.asarray(w)}),
                            {"w": jnp.asarray(w)})
    pp = {"layers": [{"w": torch.tensor(w[i])} for i in range(2)]}
    pg = {"layers": [{"w": torch.tensor(g[i])} for i in range(2)]}
    opt.opt_update(pcfg, pg, opt.opt_init(pcfg, pp), pp)
    stacked = np.stack([lp["w"].numpy() for lp in pp["layers"]])
    np.testing.assert_allclose(stacked, np.asarray(rp["w"]), rtol=OPT_TOL,
                               atol=OPT_TOL)
    alone = []
    for i in range(2):                  # each layer a leaf of its own
        p1 = {"w": torch.tensor(w[i])}
        opt.opt_update(pcfg, {"w": torch.tensor(g[i])},
                       opt.opt_init(pcfg, p1), p1)
        alone.append(p1["w"].numpy())
    assert np.abs(np.stack(alone) - stacked).max() > 0.1


# ---------------------------------------------------------------------------
# twins of tests/test_training.py
# ---------------------------------------------------------------------------

def _quadratic(params, batch):
    loss = sum(((x - 1.5) ** 2).sum() for x in params.values())
    loss = loss + 0.0 * batch["x"].sum()
    return loss, {"l": loss}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_converges(name):
    cfg = opt.OptConfig(name=name, lr=0.05, weight_decay=0.0)
    params = {"a": torch.zeros(4, 8), "b": torch.zeros(3)}
    state = opt.opt_init(cfg, params)
    step = make_train_step(_quadratic, cfg)
    batch = {"x": torch.zeros(2)}
    for _ in range(300):
        params, state, m = step(params, state, batch)
    assert float(m["loss"]) < 0.05


def test_grad_clip():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = opt.clip_by_global_norm(g, 1.0)
    assert float(opt.global_norm(clipped)) <= 1.0 + 1e-5
    assert float(norm) > 100.0


def test_accumulation_matches_full_batch():
    cfg = opt.OptConfig(name="adamw", lr=0.1, weight_decay=0.0, grad_clip=0.0)

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"]
        return ((pred - batch["y"]) ** 2).mean(), {}

    rng = np.random.default_rng(0)
    batch = {"x": torch.tensor(rng.normal(size=(8, 4)), dtype=torch.float32),
             "y": torch.tensor(rng.normal(size=(8,)), dtype=torch.float32)}
    p1 = {"w": torch.zeros(4)}
    make_train_step(loss_fn, cfg)(p1, opt.opt_init(cfg, p1), batch)
    p2 = {"w": torch.zeros(4)}
    make_train_step_accum(loss_fn, cfg, n_micro=4)(
        p2, opt.opt_init(cfg, p2), batch)
    np.testing.assert_allclose(p1["w"].numpy(), p2["w"].numpy(), rtol=1e-5,
                               atol=1e-6)


def test_adafactor_state_is_factored():
    params = {"w": torch.zeros(64, 128)}
    st = opt.adafactor_init(params)
    assert st["v"]["w"]["vr"].shape == (64,)
    assert st["v"]["w"]["vc"].shape == (128,)
    factored = sum(x.numel() for _, ps in opt.leaves(st) for x in ps)
    full = sum(x.numel() for _, ps in opt.leaves(opt.adamw_init(params))
               for x in ps)
    assert factored < full / 20


# ---------------------------------------------------------------------------
# the loss and its gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def _models(variant, seed=0, **over):
    spec = dict(MODELS[variant], **over)
    rcfg = rtf.TransformerConfig(name=variant, remat=False, **spec)
    pcfg = tf.TransformerConfig(name=variant, **spec)
    rparams = rtf.init_params(rcfg, jax.random.key(seed))
    return rcfg, rparams, pcfg, jax.tree.map(np.asarray, rparams)


def _batch(b=4, s=16, vocab=128, seed=7):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _pt_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _masters(tree, pcfg):
    return convert.transformer_master_params_from_numpy(tree, pcfg,
                                                        device="cpu")


def _port_loss_grads(pp, pcfg, batch, compute_dtype=torch.float32):
    for _, parts in opt.leaves(pp):
        for t in parts:
            t.requires_grad_(True)
            t.grad = None
    loss, m = tf.loss_fn(pp, _pt_batch(batch), pcfg,
                         compute_dtype=compute_dtype)
    loss.backward()
    grads = _tmap(lambda t: t.grad, pp)
    return loss.detach(), {k: v.detach() for k, v in m.items()}, grads


@pytest.fixture
def routing_taps(monkeypatch):
    """Each MoE layer's (slot, src, keep) in call order, from both
    packages' ``_moe_dispatch`` (the reference's through a debug callback,
    since its layers run inside a scan)."""
    ref, port = [], []
    r_orig, p_orig = RL._moe_dispatch, L._moe_dispatch

    def r_tap(xt, router, top_k, capacity, e):
        buf, info, aux = r_orig(xt, router, top_k, capacity, e)
        slot, src, _, keep = info
        jax.debug.callback(lambda *a: ref.append([np.asarray(x) for x in a]),
                           slot, src, keep)
        return buf, info, aux

    def p_tap(xt, router, top_k, capacity, e):
        buf, r, aux = p_orig(xt, router, top_k, capacity, e)
        port.append([r.slot.numpy(), r.src.numpy(), r.keep.numpy()])
        return buf, r, aux

    monkeypatch.setattr(RL, "_moe_dispatch", r_tap)
    monkeypatch.setattr(L, "_moe_dispatch", p_tap)
    return ref, port


@pytest.mark.parametrize("variant", list(MODELS))
def test_loss_and_grads_match_reference(variant, routing_taps):
    rcfg, rparams, pcfg, tree = _models(variant)
    batch = _batch()
    jb = jax.tree.map(jnp.asarray, batch)
    ref, port = routing_taps
    jax.jit(functools.partial(rtf.loss_fn, cfg=rcfg,
                              compute_dtype=jnp.float32))(rparams, jb)
    jax.effects_barrier()
    ref_routing = list(ref)              # the forward's, one call a layer
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p: rtf.loss_fn(p, jb, rcfg, compute_dtype=jnp.float32),
        has_aux=True))(rparams)
    pp = _masters(tree, pcfg)
    pl, pm, pg = _port_loss_grads(pp, pcfg, batch)
    np.testing.assert_allclose(float(pl), float(rl), rtol=1e-5, atol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=1e-5,
                                   atol=1e-5)
    _close(convert.transformer_params_to_numpy(pg),
           jax.tree.map(np.asarray, rg), GRAD_TOL, variant)
    # the port's config remats: its backward recomputes every layer's
    # routing (last layer first), which must equal the forward's
    n = rcfg.n_layers if rcfg.is_moe else 0
    assert pcfg.remat and len(ref_routing) == n and len(port) == 2 * n
    for r, p, rc in zip(ref_routing, port, port[n:][::-1]):
        for a, b, c in zip(r, p, rc):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(c, a)
    if variant == "moe-top2-drops":
        assert any((~p[2]).any() for p in port)        # entries dropped


def test_moe_dropped_rows_get_zero_gradient():
    """``tests/test_models.py:100``'s setting (d=8, 2 experts, top-1,
    capacity factor 0.25, 32 tokens): the 24 all-zero output rows (22
    drops, 2 slot-0 tokens zeroed) have an all-zero Jacobian in both
    packages, the Jacobians agree, and the router's gradient through the
    gate weights agrees."""
    rp = RL.init_moe(jax.random.key(0), 8, 16, 2)
    x = jax.random.normal(jax.random.key(1), (1, 32, 8))
    moe = functools.partial(RL.moe, top_k=1, capacity_factor=0.25)
    rjac = np.asarray(jax.jit(jax.jacrev(lambda x: moe(rp, x)[0]))(x))
    pp = {k: torch.tensor(np.asarray(v)) for k, v in rp.items()}
    px = torch.tensor(np.asarray(x))

    def pmoe(params, x):
        return L.moe(params, x, top_k=1, capacity_factor=0.25)[0]

    pjac = torch.autograd.functional.jacobian(lambda x: pmoe(pp, x),
                                              px).numpy()
    np.testing.assert_allclose(pjac, rjac, rtol=1e-5, atol=1e-6)
    out = pmoe(pp, px)[0].detach().numpy()
    zero_rows = np.flatnonzero((out == 0).all(-1))
    assert len(zero_rows) == 24
    assert not rjac[0, zero_rows].any() and not pjac[0, zero_rows].any()
    cot = np.random.default_rng(2).normal(size=(1, 32, 8)).astype(np.float32)
    rg = jax.jit(jax.grad(lambda p: (moe(p, x)[0] * cot).sum()))(rp)
    router = pp["router"].clone().requires_grad_(True)
    (pmoe(dict(pp, router=router), px) * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(router.grad.numpy(), np.asarray(rg["router"]),
                               rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(rg["router"])).max() > 0


@pytest.mark.parametrize("variant", ["dense-gated", "moe-top2-drops",
                                     "arctic-style"])
def test_remat_policies_give_equal_loss_and_grads(variant):
    _, _, pcfg, tree = _models(variant)
    batch = _batch()
    out = {}
    for name, kw in (("none", dict(remat=False)),
                     ("full", dict(remat=True, remat_policy="full")),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = dataclasses.replace(pcfg, **kw)
        loss, _, g = _port_loss_grads(_masters(tree, cfg), cfg, batch)
        out[name] = (loss, convert.transformer_params_to_numpy(g))
    for name in ("full", "dots"):
        assert float(out[name][0]) == float(out["none"][0])
        for a, b in zip(jax.tree.leaves(out[name][1]),
                        jax.tree.leaves(out["none"][1])):
            np.testing.assert_array_equal(a, b)


def test_remat_policy_is_validated():
    with pytest.raises(ValueError, match="remat_policy"):
        tf.TransformerConfig(name="t", remat_policy="offload", **TINY)


def test_master_params_keep_reference_dtypes():
    """bf16 masters: every weight and norm bf16, the router f32, as the
    reference's ``init_params`` holds them; the port's own init agrees."""
    spec = dict(MODELS["arctic-style"], param_dtype=jnp.bfloat16)
    rcfg = rtf.TransformerConfig(name="a", remat=False, **spec)
    pcfg = tf.TransformerConfig(name="a", **dict(spec,
                                                 param_dtype=torch.bfloat16))
    tree = jax.tree.map(np.asarray, rtf.init_params(rcfg, jax.random.key(0)))
    for pp in (_masters(tree, pcfg),
               tf.init_master_params(pcfg, device="cpu")):
        lp = pp["layers"][0]
        assert lp["moe"]["router"].dtype == torch.float32
        assert lp["moe"]["w_in"].dtype == torch.bfloat16
        assert lp["attn_norm"]["scale"].dtype == torch.bfloat16
        assert pp["final_norm"]["scale"].dtype == torch.bfloat16
        assert pp["embed"].dtype == torch.bfloat16
    got = convert.transformer_params_to_numpy(_masters(tree, pcfg))
    _close(got, jax.tree.map(lambda a: np.asarray(a, np.float32), tree), 0.0)


# ---------------------------------------------------------------------------
# train steps against the reference's
# ---------------------------------------------------------------------------

def _ref_opt(name):
    return (ropt.OptConfig(name=name, eps=1e-4),
            opt.OptConfig(name=name, eps=1e-4))


@pytest.mark.parametrize("variant,name", [("dense-gated", "adamw"),
                                          ("moe-top2-drops", "adafactor")])
def test_train_steps_match_reference(variant, name):
    """Five steps of ``make_train_step`` (jitted reference): loss, ce, aux
    and grad_norm each step, then parameters and optimizer state."""
    rcfg, rparams, pcfg, tree = _models(variant)
    rcfg_o, pcfg_o = _ref_opt(name)
    rstep = jax.jit(rtrain.make_train_step(
        functools.partial(rtf.loss_fn, cfg=rcfg, compute_dtype=jnp.float32),
        rcfg_o))
    pstep = make_train_step(
        functools.partial(tf.loss_fn, cfg=pcfg, compute_dtype=torch.float32),
        pcfg_o)
    rs = ropt.opt_init(rcfg_o, rparams)
    pp = _masters(tree, pcfg)
    ps = convert.opt_state_from_numpy(jax.tree.map(np.asarray, rs),
                                      device="cpu")
    for i in range(5):
        batch = _batch(seed=i)
        rparams, rs, rm = rstep(rparams, rs, jax.tree.map(jnp.asarray, batch))
        pp, ps, pm = pstep(pp, ps, _pt_batch(batch))
        for k in ("loss", "ce", "aux", "grad_norm"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{k} at step {i}")
    _close(convert.transformer_params_to_numpy(pp),
           jax.tree.map(np.asarray, rparams), STEP_TOL, "params")
    _close(convert.opt_state_to_numpy(ps), jax.tree.map(np.asarray, rs),
           STEP_TOL, "state")


def _bf16_step_faults(got, want, ref):
    """What a step on bf16 masters got wrong against the reference's
    (``got`` / ``want`` f32 numpy trees, ``ref`` the reference's own
    params for their dtypes), as messages: none when it holds.

    Both sides round to bf16 f32 values that differ in their last bits, so
    an element flips by one ulp where its value lies near a rounding
    boundary, and a flipped bf16 gradient moves its parameter's update by
    2^-8 of itself.  Each bf16 leaf is held to one ulp of its top binade
    (an element the update brings near zero keeps the absolute error of
    its inputs), and at most ``BF16_FLIP_FRAC`` of all bf16 elements may
    differ at all (measured 0.17%; a skipped update, a dropped weight decay
    or a cast that truncates in place of rounding differs in 50-99%).  f32
    leaves (the router) are held to ``STEP_TOL`` of their largest."""
    faults, flips, total = [], 0, 0
    for (path, a), b, r in zip(jax.tree_util.tree_leaves_with_path(got),
                               jax.tree.leaves(want), jax.tree.leaves(ref)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        d, top = np.abs(a - b), float(np.abs(b).max())
        key = jax.tree_util.keystr(path)
        if r.dtype == jnp.bfloat16:
            ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
            if d.max() > ulp:
                faults.append(f"{key}: {d.max():.3g} > one ulp {ulp:.3g}")
            flips, total = flips + int((d > 0).sum()), total + d.size
        elif d.max() > STEP_TOL * top:
            faults.append(f"{key}: {d.max():.3g} > {STEP_TOL * top:.3g}")
    if flips > BF16_FLIP_FRAC * total:
        faults.append(f"{flips} of {total} bf16 elements differ")
    return faults


@pytest.mark.parametrize("variant,name", [("dense-gated", "adamw"),
                                          ("arctic-style", "adafactor")])
def test_accum_step_matches_reference(variant, name):
    """``make_train_step_accum(n_micro=4)`` over 8 sequences, two steps,
    the port starting each from the reference's parameters and state:
    loss and norm, then parameters and optimizer state against the
    reference's.  The Adafactor case runs on bf16 masters (the port sums
    their gradients in f32 buffers, as the reference does) at a learning
    rate and weight decay that move each parameter by several bf16 ulps,
    and holds them at bf16 resolution (``_bf16_step_faults``); a skipped
    update and a step without the weight decay fail that check."""
    bf16 = name == "adafactor"
    over = {"param_dtype": jnp.bfloat16} if bf16 else {}
    rcfg, rparams, pcfg, _ = _models(variant, **over)
    if bf16:
        pcfg = dataclasses.replace(pcfg, param_dtype=torch.bfloat16)
    hyper = dict(lr=2 ** -5, weight_decay=0.5) if bf16 else {}
    rcfg_o = ropt.OptConfig(name=name, eps=1e-4, **hyper)
    pcfg_o = opt.OptConfig(name=name, eps=1e-4, **hyper)
    rstep = jax.jit(rtrain.make_train_step_accum(
        functools.partial(rtf.loss_fn, cfg=rcfg, compute_dtype=jnp.float32),
        rcfg_o, n_micro=4))

    def pstep(o):
        return make_train_step_accum(
            functools.partial(tf.loss_fn, cfg=pcfg,
                              compute_dtype=torch.float32), o, n_micro=4)

    def port_inputs():
        return (_masters(jax.tree.map(np.asarray, rparams), pcfg),
                convert.opt_state_from_numpy(jax.tree.map(np.asarray, rs),
                                             device="cpu"))

    as_f32 = functools.partial(jax.tree.map,
                               lambda a: np.asarray(a, np.float32))
    rs = ropt.opt_init(rcfg_o, rparams)
    for i in range(2):
        batch = _batch(b=8, seed=10 + i)
        pp, ps = port_inputs()
        before = convert.transformer_params_to_numpy(pp)
        mutant = port_inputs() if bf16 and i == 0 else None
        rparams, rs, rm = rstep(rparams, rs, jax.tree.map(jnp.asarray, batch))
        pp, ps, pm = pstep(pcfg_o)(pp, ps, _pt_batch(batch))
        for k in ("loss", "grad_norm"):       # bf16 masters: bf16 gradients
            np.testing.assert_allclose(float(pm[k]), float(rm[k]),
                                       rtol=1e-4 if bf16 else 1e-5)
        got = convert.transformer_params_to_numpy(pp)
        state = convert.opt_state_to_numpy(ps)
        assert int(state["step"]) == int(rs["step"]) == i + 1
        if not bf16:
            _close(got, as_f32(rparams), STEP_TOL, "params")
            _close(state, jax.tree.map(np.asarray, rs), STEP_TOL, "state")
            continue
        assert _bf16_step_faults(got, as_f32(rparams), rparams) == []
        # f32 vr / vc / v from bf16 gradients: a one-ulp flip of a gradient
        # (2^-8 of it) doubles in g*g; held to 2^-7 of each leaf's largest
        # (measured 2.1e-3 of it)
        for a, b in zip(jax.tree.leaves(state["v"]),
                        jax.tree.leaves(jax.tree.map(np.asarray, rs["v"]))):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= 2 ** -7 * np.abs(b).max()
        if mutant is not None:
            assert _bf16_step_faults(before, as_f32(rparams), rparams)
            no_wd = dataclasses.replace(pcfg_o, weight_decay=0.0)
            pm_, _, _ = pstep(no_wd)(*mutant, _pt_batch(batch))
            assert _bf16_step_faults(
                convert.transformer_params_to_numpy(pm_), as_f32(rparams),
                rparams)


def test_bf16_compute_step_matches_reference():
    """One AdamW step in bf16 compute on f32 masters: the loss, the norm
    and the first moment (the gradients) against the reference's."""
    rcfg, rparams, pcfg, tree = _models("chatglm-style")
    rcfg_o, pcfg_o = _ref_opt("adamw")
    batch = _batch()
    rstep = jax.jit(rtrain.make_train_step(
        functools.partial(rtf.loss_fn, cfg=rcfg, compute_dtype=jnp.bfloat16),
        rcfg_o))
    pstep = make_train_step(
        functools.partial(tf.loss_fn, cfg=pcfg,
                          compute_dtype=torch.bfloat16), pcfg_o)
    _, rs, rm = rstep(rparams, ropt.opt_init(rcfg_o, rparams),
                      jax.tree.map(jnp.asarray, batch))
    pp = _masters(tree, pcfg)
    _, ps, pm = pstep(pp, opt.opt_init(pcfg_o, pp), _pt_batch(batch))
    np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                               atol=BF16_LOSS_TOL)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=BF16_NORM_RTOL)
    got = jax.tree.leaves(convert.opt_state_to_numpy(ps)["m"])
    want = jax.tree.leaves(jax.tree.map(np.asarray, rs["m"]))
    for g, w in zip(got, want):
        assert np.abs(g - w).max() <= BF16_MOMENT_TOL * np.abs(w).max()
