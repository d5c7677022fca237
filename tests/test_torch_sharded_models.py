"""The models on a 2x2 ``(data, model)`` mesh in four gloo processes,
against the unsharded port and, for the dense LM's loss, the reference.

Each group of cases runs once in four spawned ranks
(``_torch_mesh_worker.py``, joined with a deadline): parameters, optimizer
state and batches are ``DTensor`` leaves placed by their logical axes
under the production rules (``rules_for_mesh``), and every result is
gathered whole.  The same case functions with ``mesh=None`` run here, on
plain tensors.

* The tiny dense LM (head-sharded weights, remat) and the tiny MoE LM (3
  heads padded to 4, 4 experts in 2 dispatch groups, one a data rank,
  Adafactor): loss, every gradient and the parameters after one step.
* One decode step (the new K/V written into the rank holding the
  position, the cache gathered over its sequence): logits and cache.
* dlrm-rm2, deepfm, autoint and bert4rec at the smoke size (row-sharded
  tables: each rank's own rows gathered, the table's gradient reduced to
  its shard; the per-row steps on each rank's rows; bert4rec's scores on
  each rank's vocab block, also with 251 items, whose padded table's real
  rows split unevenly over the ranks): the forward, loss, gradients and an
  AdamW step; DimeNet's the same (gathers and segment sums on each rank's
  edges and triplets).
* The has-rag step: ids, accepts exact, homology scores; and
  ``chunked_flat_search`` over a corpus sharded over ``corpus``, with
  rows planted in three ranks' blocks so that scores tie across ranks:
  ids exact.

Floats are held with ``rtol 1e-5, atol 1e-6``: f32 sums of other orders
(a shard's partial sums, the sharded cross-entropy's max-exp-sum form).
Integers are exact.  The dense LM's loss on the mesh is also held to the
reference's ``loss_fn`` under its rules on a 4-device CPU mesh, run in a
subprocess with the same weights (``convert.transformer_params_to_numpy``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_mesh_worker as W

TOL = dict(rtol=1e-5, atol=1e-6)
GROUPS = {"lm": ("dense_lm", "decode", "has_rag", "dlrm", "flat"),
          "moe": ("moe_lm", "bert4rec", "bert4rec_uneven"),
          "graph": ("dimenet", "deepfm", "autoint")}
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """group -> rank 0's results of that group's cases on the mesh."""
    def run(group):
        root = tmp_path_factory.mktemp(f"mesh_{group}")
        (root / "cases.txt").write_text("\n".join(GROUPS[group]))
        return W.run(str(root), "models")[0]
    cache = {}

    def get(group):
        if group not in cache:
            cache[group] = run(group)
        return cache[group]
    return get


def _held(sharded: dict, case: str, plain: dict) -> None:
    for key, want in plain.items():
        got = sharded[f"{case}/{key}"]
        assert got.shape == want.shape, key
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, err_msg=key, **TOL)


@pytest.mark.parametrize("group,case", [(g, c) for g, cs in GROUPS.items()
                                        for c in cs])
def test_sharded_equals_unsharded(sharded, group, case):
    _held(sharded(group), case, W.CASES[case](None))


def test_moe_groups_are_data_ranks(sharded):
    """The MoE cell's gradients reach every expert and the router (the
    router's gradient is the sum of the two data ranks' groups)."""
    got = sharded("moe")
    grads = [v for k, v in got.items() if k.startswith("moe_lm/grad/")]
    assert len(grads) > 10 and all(np.isfinite(g).all() for g in grads)


REF_LOSS = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.launch.dryrun import rules_for_mesh
from repro.models import transformer as rtf
from repro.utils import tree_specs
tree = np.load(sys.argv[1], allow_pickle=True).item()
kw = tree.pop("cfg")
cfg = rtf.TransformerConfig(**kw)
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
rules = rules_for_mesh(mesh)
batch = {k: jnp.asarray(tree.pop(k)) for k in ("tokens", "labels")}
params = jax.tree.map(jnp.asarray, tree)
shard = lambda lg: jax.tree.map(lambda s: NamedSharding(mesh, s),
                                tree_specs(lg, rules),
                                is_leaf=lambda x: isinstance(x, P))
fn = jax.jit(lambda p, b: rtf.loss_fn(p, b, cfg, rules=rules,
                                      compute_dtype=jnp.float32)[0],
             in_shardings=(shard(rtf.params_logical(cfg)),
                           shard({"tokens": ("batch", None),
                                  "labels": ("batch", None)})))
with mesh:
    print("LOSS", repr(float(fn(params, batch))))
"""


def test_dense_lm_loss_against_reference_on_mesh(sharded, tmp_path):
    from repro_torch.convert import transformer_params_to_numpy
    from repro_torch.models import transformer as tf
    cfg = W.lm_config(False)
    tree = transformer_params_to_numpy(
        tf.init_master_params(cfg, seed=0, device="cpu"))
    tree.update({k: v.numpy() for k, v in W.lm_batch(cfg).items()})
    tree["cfg"] = dict(name=cfg.name, n_layers=cfg.n_layers,
                       d_model=cfg.d_model, n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff,
                       vocab_size=cfg.vocab_size, d_head=cfg.d_head,
                       rope_fraction=cfg.rope_fraction, remat=cfg.remat)
    np.save(tmp_path / "tree.npy", tree, allow_pickle=True)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", REF_LOSS,
                          str(tmp_path / "tree.npy")], capture_output=True,
                         text=True, env=env, timeout=240)
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("LOSS")]
    assert line, out.stdout + out.stderr[-3000:]
    ref = float(line[0].split()[1])
    np.testing.assert_allclose(sharded("lm")["dense_lm/loss"], ref, **TOL)
