"""The int8 error-feedback all-reduce (``training/compression.py``) in
spawned gloo worlds, against the reference's on a 4-device ``pod`` mesh.

Rank r reduces row block r of the gradients (``_torch_mesh_worker.py``'s
``compression`` job, joined with a deadline); the reference shards the
same rows over its mesh's ``pod`` axis in a subprocess with four host
devices.  Each rank's new error is held exactly to the reference's block
(the codes and scales behind it are the same), the codes exactly to the
reference's ``quantize_int8`` of each block, and the sums within f32
reassociation (rtol 1e-6: the port adds the ranks' dequantized tensors in
rank order, the reference's psum in an order of its own).  World 1
mirrors ``tests/test_perf_paths.py::test_compressed_allreduce_local_mesh``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worker as W
from repro.training.compression import quantize_int8 as ref_quantize
from repro_torch.training.compression import (compressed_psum,
                                              dequantize_int8, quantize_int8)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
SHAPES = {"w": (64,), "b": (3, 5)}

REF = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.training.compression import make_compressed_allreduce
d = np.load(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:4]), ("pod",))
fn = make_compressed_allreduce(mesh, dp_axes=("pod",))
g = {k: jnp.asarray(d[k].reshape((-1,) + d[k].shape[2:])) for k in ("w", "b")}
e = {k: jnp.asarray(d["e_" + k].reshape((-1,) + d[k].shape[2:]))
     for k in ("w", "b")}
red, err = fn(g, e)
out = {f"red_{k}": np.asarray(v) for k, v in red.items()}
out.update({f"err_{k}": np.asarray(v) for k, v in err.items()})
np.savez(sys.argv[2], **out)
"""


def _grads(world: int) -> dict:
    rng = np.random.default_rng(3)
    out = {}
    for k, shape in SHAPES.items():
        out[k] = rng.normal(size=(world,) + shape).astype(np.float32)
        out[f"e_{k}"] = (rng.normal(size=(world,) + shape) * 1e-3).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    root = tmp_path_factory.mktemp("compress4")
    data = _grads(4)
    np.savez(root / "grads.npz", **data)
    ranks = W.run(str(root), "compression", world=4)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", REF, str(root / "grads.npz"),
                          str(root / "ref.npz")], capture_output=True,
                         text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return data, ranks, dict(np.load(root / "ref.npz"))


@pytest.mark.parametrize("leaf", sorted(SHAPES))
def test_world4_against_reference(four, leaf):
    data, ranks, ref = four
    ref_err = ref[f"err_{leaf}"].reshape((4,) + SHAPES[leaf])
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got[f"err/{leaf}"], ref_err[r])
        np.testing.assert_allclose(got[f"red/{leaf}"], ref[f"red_{leaf}"],
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got[f"red/{leaf}"],
                                      ranks[0][f"red/{leaf}"])


@pytest.mark.parametrize("leaf", sorted(SHAPES))
def test_codes_equal_reference_blocks(four, leaf):
    """Each rank's int8 codes and scale, as its error implies them, equal
    the reference's ``quantize_int8`` of that rank's corrected block."""
    data, _, _ = four
    quant = jax.jit(ref_quantize)
    for r in range(4):
        corrected = data[leaf][r] + data[f"e_{leaf}"][r]
        q, s = quantize_int8(torch.from_numpy(corrected))
        rq, rs = quant(jnp.asarray(corrected))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


def test_world4_sum_is_rank_order_dequant_sum(four):
    data, ranks, _ = four
    for leaf in SHAPES:
        want = None
        for r in range(4):
            corrected = torch.from_numpy(data[leaf][r]
                                         + data[f"e_{leaf}"][r])
            deq = dequantize_int8(*quantize_int8(corrected))
            want = deq if want is None else want + deq
        np.testing.assert_array_equal(ranks[0][f"red/{leaf}"], want.numpy())


def test_world1_local_mesh(tmp_path):
    """One rank: the reduction is the dequantized value and the error the
    quantization residual (``test_perf_paths.py:94``)."""
    data = _grads(1)
    np.savez(tmp_path / "grads.npz", **data)
    got = W.run(str(tmp_path), "compression", world=1)[0]
    for leaf in SHAPES:
        g, e = data[leaf][0], data[f"e_{leaf}"][0]
        np.testing.assert_allclose(got[f"red/{leaf}"] + got[f"err/{leaf}"],
                                   g + e, atol=1e-6)
        red, err = compressed_psum(torch.from_numpy(g), None,
                                   torch.from_numpy(e))
        np.testing.assert_array_equal(got[f"red/{leaf}"], red.numpy())
        np.testing.assert_array_equal(got[f"err/{leaf}"], err.numpy())
