"""Port parity of DimeNet (``repro_torch.models.dimenet``), its configs and
the graph data against the JAX package on the CPU.

The reference's parameters go across with ``repro_torch.convert`` (the
blocks stacked ``[n_blocks, ...]`` in both), the graph batches are the
reference's numpy draws, which the port draws too.

Tolerances (f32):
- the bases ``bessel_rbf``, ``legendre`` and ``sbf_basis``: ``BASIS_TOL``
  of each order's largest magnitude;
- ``spherical_bessel``: j_l where x >= l, the recurrence's stable side,
  within ``BASIS_TOL`` of the order's largest magnitude there; j_0 (no
  recurrence) within ``BASIS_TOL`` relative everywhere, the 1e-4 clamp
  included.  Below x = l the upward recurrence multiplies the
  cancellation error of j_1 (``sin x / x^2 - cos x / x``, two terms near
  1/x) by about (2l+1)/x an order: at the clamp j_6 reaches 1e21 in both
  packages and their sin/cos differ in the last bit, so nothing there is
  held but the clamp itself (values below 1e-4 equal the value at it);
- forward outputs: ``FWD_TOL`` of the largest output; the loss
  ``LOSS_RTOL``; gradients each leaf within ``GRAD_TOL`` of its largest
  (``index_add`` and ``segment_sum`` add in other orders);
- one AdamW step (``eps = 1e-4``, as in ``test_torch_training.py``):
  parameters and moments within ``STEP_TOL`` of each leaf's largest;
- graph data: ints and bools exact, floats bit-equal, md5 digests pinned
  in ``repro_torch/data/digests.py`` (the reference under numpy 2.0.2).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dimenet as rconf
from repro.configs import get_arch as ref_get_arch
from repro.data import graph as rgraph
from repro.models import dimenet as rdn
from repro.training import optimizer as ropt
from repro.training import train as rtrain
from repro_torch import convert
from repro_torch.configs import dimenet as pconf
from repro_torch.configs.families import adamw_step, to_device
from repro_torch.data import digests
from repro_torch.data import graph as pgraph
from repro_torch.models import dimenet as pdn
from repro_torch.training.optimizer import OptConfig, leaves, opt_init
from repro_torch.training.train import _grads, make_train_step

BASIS_TOL = 1e-5
FWD_TOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5
STEP_TOL = 1e-5


def _close(got, want, tol, what=""):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, what
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= tol * scale, what


def _regression_case(seed=0):
    """A regression config and batch: the smoke graph, 4 graphs of 10
    nodes, targets from ``default_rng(3)``."""
    cfg = dataclasses.replace(pconf.SMOKE_CONFIG, task="regression",
                              n_targets=1)
    batch = pconf.smoke_batch()
    batch["graph_ids"] = (np.arange(40) // 10).astype(np.int32)
    batch["targets"] = np.random.default_rng(3).normal(
        size=4).astype(np.float32)
    rcfg = rconf.DimeNetConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name != "param_dtype"})
    rparams = rdn.init_params(rcfg, jax.random.key(seed))
    return rcfg, rparams, cfg, batch


def _case(task):
    if task == "classification":
        rcfg, rparams, _, _, rbatch = ref_get_arch("dimenet").make_smoke()
        batch = {k: np.asarray(v) for k, v in rbatch.items()}
        cfg = pconf.SMOKE_CONFIG
    else:
        rcfg, rparams, cfg, batch = _regression_case()
    params = convert.float_tree_from_numpy(
        jax.tree.map(np.asarray, rparams), "cpu")
    return rcfg, rparams, cfg, params, batch


# ---------------------------------------------------------------------------
# bases
# ---------------------------------------------------------------------------

X = np.concatenate([np.geomspace(1e-6, 40, 3000), [0.0, 1e-4, 5e-5]]) \
    .astype(np.float32)


def test_bessel_rbf_and_legendre_match_reference():
    got = pdn.bessel_rbf(torch.tensor(X), 6, 5.0).numpy()
    want = np.asarray(rdn.bessel_rbf(jnp.asarray(X), 6, 5.0))
    _close([got], [want], BASIS_TOL)
    c = np.linspace(-1, 1, 501).astype(np.float32)
    for l_max in (1, 2, 7):
        _close([pdn.legendre(torch.tensor(c), l_max).numpy()],
               [np.asarray(rdn.legendre(jnp.asarray(c), l_max))], BASIS_TOL)


@pytest.mark.parametrize("l_max", [1, 2, 4, 7])
def test_spherical_bessel_stable_side_and_clamp(l_max):
    got = pdn.spherical_bessel(torch.tensor(X), l_max).numpy()
    want = np.asarray(rdn.spherical_bessel(jnp.asarray(X), l_max))
    assert got.shape == want.shape == (len(X), l_max)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=BASIS_TOL)
    for l in range(1, l_max):
        side = X >= l
        _close([got[side, l]], [want[side, l]], BASIS_TOL, f"j_{l}")
    # below the clamp every order takes its value at 1e-4
    at = got[X == np.float32(1e-4)][0]
    for x in (0.0, 5e-5, 1e-6):
        np.testing.assert_array_equal(got[X == np.float32(x)][0], at)


def test_sbf_basis_matches_reference():
    rng = np.random.default_rng(0)
    d = rng.uniform(0.5, 5.0, 300).astype(np.float32)
    c = rng.uniform(-1, 1, 300).astype(np.float32)
    got = pdn.sbf_basis(torch.tensor(d), torch.tensor(c), 7, 6, 5.0).numpy()
    want = np.asarray(rdn.sbf_basis(jnp.asarray(d), jnp.asarray(c), 7, 6,
                                    5.0))
    assert got.shape == (300, 42)
    # the stable side only: x = d / 5 * n * pi >= l for every basis used
    x = d[:, None] / 5.0 * np.arange(1, 7) * np.pi            # [T, R]
    ok = (x[:, :, None] >= np.arange(7)).reshape(300, 42)
    _close([got[ok]], [want[ok]], BASIS_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", ["classification", "regression"])
def test_forward_and_loss_match_reference(task):
    rcfg, rparams, cfg, params, batch = _case(task)
    jb = jax.tree.map(jnp.asarray, batch)
    want = np.asarray(rdn.forward(rparams, jb, rcfg))
    got = pdn.forward(params, to_device(batch, "cpu"), cfg).numpy()
    assert got.shape == want.shape == (40, cfg.n_targets)
    _close([got], [want], FWD_TOL)
    rl, _ = rdn.loss_fn(rparams, jb, rcfg)
    pl, m = pdn.loss_fn(params, to_device(batch, "cpu"), cfg)
    np.testing.assert_allclose(float(pl), float(rl), rtol=LOSS_RTOL)
    assert float(m["loss"]) == float(pl)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_gradients_match_reference(task):
    rcfg, rparams, cfg, params, batch = _case(task)
    jb = jax.tree.map(jnp.asarray, batch)
    rg = jax.grad(lambda p: rdn.loss_fn(p, jb, rcfg)[0])(rparams)
    for _, parts in leaves(params):
        for t in parts:
            t.requires_grad_(True)
    loss, _ = pdn.loss_fn(params, to_device(batch, "cpu"), cfg)
    loss.backward()
    got = convert.float_tree_to_numpy(_grads(params))
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, rg))
    _close(got, rg, GRAD_TOL, task)


def test_adamw_step_matches_reference():
    rcfg, rparams, cfg, params, batch = _case("classification")
    ocfg = ropt.OptConfig(name="adamw", eps=1e-4)
    rstep = rtrain.make_train_step(
        functools.partial(rdn.loss_fn, cfg=rcfg), ocfg,
        compute_dtype=jnp.float32)
    rp2, rs2, rm = rstep(rparams, ropt.opt_init(ocfg, rparams),
                         jax.tree.map(jnp.asarray, batch))
    opt_cfg = OptConfig(name="adamw", eps=1e-4)
    state = opt_init(opt_cfg, params)
    step = make_train_step(functools.partial(pdn.loss_fn, cfg=cfg), opt_cfg)
    params, state, m = step(params, state, to_device(batch, "cpu"))
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=LOSS_RTOL)
    _close(convert.float_tree_to_numpy(params), rp2, STEP_TOL, "params")
    for mom in ("m", "v"):
        _close(convert.float_tree_to_numpy(state[mom]), rs2[mom],
               STEP_TOL, mom)
    # the state keeps the reference's stacked shapes
    assert tuple(state["m"]["blocks"]["w_bil"].shape) == (2, 4, 32, 32)


def test_triplet_masking():
    """Masked triplets contribute nothing (the twin of the reference's
    ``test_dimenet_triplet_masking``)."""
    cfg = pdn.DimeNetConfig(n_blocks=1, d_hidden=16, n_bilinear=2,
                            n_spherical=3, n_radial=3, d_feat=8, n_targets=3,
                            task="classification")
    b = to_device(pgraph.make_graph_batch(20, 50, 8, 3, cap_per_edge=2,
                                          seed=0), "cpu")
    p = pdn.init_params(cfg, 0, "cpu")
    out1 = pdn.forward(p, b, cfg)
    b2 = dict(b)
    b2["tri_edge_in"] = torch.cat([b["tri_edge_in"],
                                   torch.zeros(10, dtype=torch.int32)])
    b2["tri_edge_out"] = torch.cat([b["tri_edge_out"],
                                    torch.zeros(10, dtype=torch.int32)])
    b2["tri_mask"] = torch.cat([b["tri_mask"],
                                torch.zeros(10, dtype=torch.bool)])
    out2 = pdn.forward(p, b2, cfg)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_self_loop_edges_blow_up_in_both_packages():
    """A fault of the reference, held as it is: ``random_graph`` draws
    self-loop edges, and a triplet whose in-edge k->j has zero length
    takes ``spherical_bessel`` at its 1e-4 clamp, where the upward
    recurrence is ~1e21 at order 6.  At the published bases (7 x 6) both
    packages give the same huge loss on the unmasked batch (about 1.85e18
    here, within LOSS_RTOL of each other), and the same small one once the
    loop edges are masked, which is what the card run does at full
    width."""
    b = pgraph.make_graph_batch(40, 160, 16, 5, cap_per_edge=4, seed=0)
    loops = b["edge_src"] == b["edge_dst"]
    assert loops.sum() == 2 and (loops[b["tri_edge_in"]] & b["tri_mask"]).any()
    clamp = pdn.spherical_bessel(torch.zeros(1), 7)[0]
    rclamp = np.asarray(rdn.spherical_bessel(jnp.zeros(1), 7))[0]
    assert abs(float(clamp[6])) > 1e20 and abs(float(rclamp[6])) > 1e20
    cfg = pdn.DimeNetConfig(n_blocks=2, d_hidden=32, n_bilinear=4,
                            n_spherical=7, n_radial=6, d_feat=16,
                            n_targets=5, task="classification")
    rcfg = rdn.DimeNetConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if f.name != "param_dtype"})
    rparams = rdn.init_params(rcfg, jax.random.key(0))
    params = convert.float_tree_from_numpy(
        jax.tree.map(np.asarray, rparams), "cpu")
    masked = dict(b, edge_mask=b["edge_mask"] & ~loops)
    for batch, lo, hi in ((b, 1e15, np.inf), (masked, 0.0, 10.0)):
        rl = float(rdn.loss_fn(rparams, jax.tree.map(jnp.asarray, batch),
                               rcfg)[0])
        pl = float(pdn.loss_fn(params, to_device(batch, "cpu"), cfg)[0])
        assert lo < rl < hi and lo < pl < hi, (rl, pl)
        np.testing.assert_allclose(pl, rl, rtol=LOSS_RTOL)


def test_init_params_match_reference_tree():
    cfg = pconf._cfg_for("minibatch_lg")
    want = jax.eval_shape(functools.partial(
        rdn.init_params, rconf._cfg_for("minibatch_lg")), jax.random.key(0))
    got = convert.float_tree_to_numpy(
        pdn.init_params(dataclasses.replace(cfg, d_feat=8), 0, "cpu"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        want_shape = (8, 128) if b.shape == (602, 128) else b.shape
        assert a.shape == want_shape and a.dtype == b.dtype


def test_smoke_trains_on_cpu():
    cfg, params, opt_state, step, batch = pconf._smoke("cpu")
    before = params["blocks"]["w_bil"].clone()
    params, _, m = step(params, opt_state, batch)
    assert np.isfinite(float(m["loss"]))
    assert not torch.equal(before, params["blocks"]["w_bil"])
    opt_cfg, _ = adamw_step(functools.partial(pdn.loss_fn, cfg=cfg))
    assert opt_cfg.name == "adamw"


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(rconf.GNN_SHAPES))
def test_shape_configs_match_reference(shape):
    want, got = rconf.GNN_SHAPES[shape], pconf.GNN_SHAPES[shape]
    assert (got.name, got.kind, dict(got.dims), got.note) == \
        (want.name, want.kind, dict(want.dims), want.note)
    rc, pc = rconf._cfg_for(shape), pconf._cfg_for(shape)
    for f in dataclasses.fields(rc):
        if f.name != "param_dtype":
            assert getattr(pc, f.name) == getattr(rc, f.name), f.name
    assert pc.param_count() == rc.param_count()
    assert pc.param_dtype == torch.float32


# ---------------------------------------------------------------------------
# graph data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_nodes=40, n_edges=120, d_feat=16, n_classes=5, cap_per_edge=4),
    dict(n_nodes=300, n_edges=2000, d_feat=8, n_classes=3, cap_per_edge=2,
         t_max=1500, seed=5),
    dict(n_nodes=60, n_edges=180, d_feat=4, n_classes=2, seed=2,
         radius_graph=True),
])
def test_graph_batch_equals_reference(kw):
    want = rgraph.make_graph_batch(**kw)
    got = pgraph.make_graph_batch(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("size", sorted(digests.GRAPH_SIZES))
def test_graph_batch_matches_pinned_digests(size):
    assert digests.graph_digests(rgraph.make_graph_batch, size) == \
        digests.GRAPH_PINNED[size]
    assert digests.graph_digests(pgraph.make_graph_batch, size) == \
        digests.GRAPH_PINNED[size]


def test_neighbor_sampler_equals_reference():
    g = rgraph.random_graph(500, 6000, 4, 3, seed=1)
    rs = rgraph.NeighborSampler(g["edge_src"], g["edge_dst"], 500, seed=4)
    ps = pgraph.NeighborSampler(g["edge_src"], g["edge_dst"], 500, seed=4)
    for seeds, fanouts, e_max in (((np.arange(16) * 7), (15, 10), 3000),
                                  (np.array([3, 9, 400]), (4,), 8),
                                  (np.arange(50), (5, 3, 2), 600)):
        want = rs.sample_block(seeds, fanouts, e_max)
        got = ps.sample_block(seeds, fanouts, e_max)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
