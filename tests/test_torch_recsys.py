"""Port parity of the EmbeddingBag: the kernel's plain version and the
models' segment-sum substrate, against the JAX package on the CPU.

The plain version sums slot by slot in the table's dtype, as the Pallas
kernel accumulates into its output block.  XLA on the CPU contracts the
reference kernel's ``acc + row * w * scale`` into a fused multiply-add, so
where the product is inexact (weights, or the 1/n of "mean") the two
differ in the last bits: they are held to the reference's own kernel-test
tolerance (rtol 1e-4, atol 1e-5), and are bit-equal for an unweighted sum,
where the product is exact.  The CUDA kernel follows the plain version's
rounded, uncontracted order and is held to it bit for bit on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import embedding_bag_ref
from repro.models.recsys import embedding_bag as ref_substrate
from repro_torch.kernels import ops
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_plain)
from repro_torch.models.recsys import embedding_bag as substrate


def _inputs(seed, v, d, b, n, weighted):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, n)).astype(np.int32)
    w = rng.normal(size=(b, n)).astype(np.float32) if weighted else None
    return t, ids, w


@pytest.mark.parametrize("v,d,b,n", [(100, 32, 8, 4), (33, 8, 2, 9),
                                     (500, 64, 16, 2)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_plain_vs_reference(v, d, b, n, mode, weighted):
    t, ids, w = _inputs(v + n, v, d, b, n, weighted)
    jw = None if w is None else jnp.asarray(w)
    pal = ref_ops.embedding_bag(jnp.asarray(t), jnp.asarray(ids), jw, mode,
                                interpret=True)
    ref = embedding_bag_ref(jnp.asarray(t), jnp.asarray(ids), jw, mode)
    tw = None if w is None else torch.tensor(w)
    for out in (embedding_bag_plain(torch.tensor(t), torch.tensor(ids), tw,
                                    mode),
                embedding_bag(torch.tensor(t), torch.tensor(ids), tw, mode),
                ops.embedding_bag_op(torch.tensor(t), torch.tensor(ids), tw,
                                     mode, backend="torch")):
        assert out.dtype == torch.float32
        if mode == "sum" and not weighted:
            np.testing.assert_array_equal(out.numpy(), np.asarray(pal))
        for want in (pal, ref):
            np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", True)])
def test_embedding_bag_bf16_table(mode, weighted):
    """A bf16 table: each term and each partial sum is rounded to bf16, as
    the TPU kernel's bf16 output block is."""
    t, ids, w = _inputs(7, 64, 16, 6, 5, weighted)
    jw = None if w is None else jnp.asarray(w)
    pal = ref_ops.embedding_bag(jnp.asarray(t, jnp.bfloat16),
                                jnp.asarray(ids), jw, mode, interpret=True)
    out = embedding_bag_plain(torch.tensor(t).to(torch.bfloat16),
                              torch.tensor(ids),
                              None if w is None else torch.tensor(w), mode)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(pal.astype(jnp.float32)))


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("sum", True),
                                           ("mean", False)])
def test_substrate_matches_reference(mode, weighted):
    """The multi-hot gather + segment sum, ragged bags and an empty one."""
    rng = np.random.default_rng(3)
    t = rng.normal(size=(64, 16)).astype(np.float32)
    sizes = [3, 1, 0, 5, 2]
    seg = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    ids = rng.integers(0, 64, len(seg)).astype(np.int32)
    w = rng.normal(size=len(seg)).astype(np.float32) if weighted else None
    ref = ref_substrate(jnp.asarray(t), jnp.asarray(ids), jnp.asarray(seg),
                        len(sizes), mode=mode,
                        weights=None if w is None else jnp.asarray(w))
    out = substrate(torch.tensor(t), torch.tensor(ids), torch.tensor(seg),
                    len(sizes), mode=mode,
                    weights=None if w is None else torch.tensor(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert not out[2].any()                       # the empty bag


def test_fixed_bag_matches_substrate():
    """The fixed-arity bag == the substrate over consecutive segments (the
    reference's ``test_embedding_bag_matches_segment_sum_substrate``)."""
    t, ids, _ = _inputs(9, 64, 16, 6, 5, False)
    seg = torch.arange(6).repeat_interleave(5)
    a = embedding_bag_plain(torch.tensor(t), torch.tensor(ids), mode="sum")
    b = substrate(torch.tensor(t), torch.tensor(ids).reshape(-1), seg, 6)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        embedding_bag_plain(torch.tensor(t), torch.tensor(ids), mode="max")


def test_bag_probe_cuts_the_shipped_kernel():
    """``kernels/embedding_bag_probe.py`` cuts ``csrc/embedding_bag.cu``
    after each stage: every cut version is the shipped source with one
    early return inserted at the line it names, and the last is the source
    itself."""
    from repro_torch.kernels import embedding_bag_probe as probe
    v = probe.variants()
    assert list(v) == ["launch", "ids", "rows", "whole"]
    src = v["whole"][0]
    for stage, (after, text) in probe.CUTS.items():
        assert src.count(after) == 1
        assert v[stage][0] == src.replace(after, after + text)
        assert v[stage][0].count("return;") == src.count("return;") + 1
