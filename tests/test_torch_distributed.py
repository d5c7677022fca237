"""``distributed_flat_search`` and ``ShardedMeshBackend(mesh=...)`` in four
gloo processes on the CPU, against the reference.

The four ranks run once for the whole module (``_torch_dist_worker.py``,
spawned, joined with a deadline); each test reads their results.  Ids are
held exactly to the reference's ``sharded_topk_reference`` (four shards)
and ``chunked_flat_search``, scores with ``allclose`` (atol 1e-6: products
of other widths), and every rank must return the same result.  The
``ties`` case plants the same rows in three ranks' blocks, with entries whose
products and sums are exact in f32, so the scores tie exactly everywhere
and the ids must go to the lower rank, as the reference's ``lax.top_k``
gives ties to the lower column.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker
from repro.retrieval.distributed import \
    sharded_topk_reference as ref_sharded
from repro.retrieval.flat import chunked_flat_search as ref_chunked
from repro_torch.retrieval.service import LocalFlatBackend, ShardedMeshBackend
from repro_torch.serving.latency import LatencyModel

WORLD = 4
TOL = dict(rtol=0, atol=1e-6)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _cases() -> dict:
    """name -> (corpus [N, d], queries [B, d], k); N divides over WORLD."""
    rng = np.random.default_rng(0)
    q = _unit(rng, 6, 16)
    # quarter-integer entries: every product and sum is exact in f32
    block = rng.integers(-4, 5, (16, 16)).astype(np.float32) / 4
    other = rng.integers(-4, 5, (32, 16)).astype(np.float32) / 4
    tq = rng.integers(-4, 5, (6, 16)).astype(np.float32) / 4
    ties = np.concatenate([block, block, other[:16], block])
    return {
        "plain": (_unit(rng, 1024, 16), q, 10),
        "k1": (_unit(rng, 1024, 16), q, 1),
        "shard_lt_k": (_unit(rng, 32, 16), q, 10),     # 8 rows a rank
        "corpus_lt_k": (_unit(rng, 8, 16), q, 10),     # -1 padded tail
        "ties": (ties, tq, 10),
    }


CASES = _cases()
MESH = (_unit(np.random.default_rng(1), 512, 16),
        _unit(np.random.default_rng(2), 5, 16), 10)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("gloo")
    arrays = {"mesh_corpus": MESH[0], "mesh_q": MESH[1], "mesh_k": MESH[2]}
    for name, (c, q, k) in CASES.items():
        arrays.update({f"{name}_c": c, f"{name}_q": q, f"{name}_k": k})
    np.savez(root / "cases.npz", **arrays)
    return _torch_dist_worker.run(str(root), WORLD)


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(ranks[0][key], r[key])


def _held_to(ref_s, ref_i, s, i):
    np.testing.assert_array_equal(np.asarray(ref_i), i)
    live = np.asarray(ref_i) >= 0
    np.testing.assert_allclose(np.asarray(ref_s)[live], s[live], **TOL)
    assert np.isneginf(s[~live]).all()


@pytest.mark.parametrize("name", sorted(CASES))
def test_distributed_flat_search_matches_reference(ranks, name):
    c, q, k = CASES[name]
    _same_on_every_rank(ranks, f"{name}_s")
    _same_on_every_rank(ranks, f"{name}_i")
    s, i = ranks[0][f"{name}_s"], ranks[0][f"{name}_i"]
    assert s.shape == i.shape == (q.shape[0], k) and i.dtype == np.int32
    _held_to(*ref_sharded(jnp.asarray(c), jnp.asarray(q), k,
                          n_shards=WORLD), s, i)
    _held_to(*ref_chunked(jnp.asarray(c), jnp.asarray(q), k, chunk=64), s,
             i)


def test_distributed_ties_go_to_the_lower_rank(ranks):
    # rows 16-31 and 48-63 repeat rows 0-15 (ranks 1 and 3 repeat rank 0):
    # a repeated row comes after its twins of lower ranks, its score equal
    c, q, _ = CASES["ties"]
    scores = q @ c.T
    i = ranks[0]["ties_i"]
    planted = 0
    for b in range(q.shape[0]):
        pos = {int(x): p for p, x in enumerate(i[b])}
        for j, p in pos.items():
            if 16 <= j < 32 or j >= 48:
                twin = j % 16
                assert pos.get(twin, p) < p and \
                    scores[b, twin] == scores[b, j]
                assert twin + 16 in pos or j < 32
                planted += 1
    assert planted > 0


def test_mesh_backend_matches_local_flat(ranks):
    c, q, k = MESH
    _same_on_every_rank(ranks, "mesh_i")
    _same_on_every_rank(ranks, "mesh_s")
    r = ranks[0]
    assert int(r["mesh_n_shards"]) == WORLD and int(r["mesh_n_workers"]) == 2
    s, i = LocalFlatBackend(torch.from_numpy(c), k, LatencyModel(),
                            chunk=64).search(torch.from_numpy(q))
    np.testing.assert_array_equal(r["mesh_i"], i.numpy())
    np.testing.assert_allclose(r["mesh_s"], s.numpy(), **TOL)
    _held_to(*ref_sharded(jnp.asarray(c), jnp.asarray(q), k,
                          n_shards=WORLD), r["mesh_s"], r["mesh_i"])


def test_mesh_backend_uneven_corpus_raises(ranks):
    for r in ranks:
        assert str(r["uneven_error"]) == (
            "corpus rows 511 must divide evenly over 4 mesh shards")


def test_mesh_of_one_rank_takes_the_no_mesh_path():
    c, q, k = MESH
    one = types.SimpleNamespace(size=lambda: 1)
    be = ShardedMeshBackend(torch.from_numpy(c), k, LatencyModel(),
                            n_shards=3, mesh=one)
    assert be.n_shards == 3
    s, i = be.search(torch.from_numpy(q))
    _held_to(*ref_sharded(jnp.asarray(c), jnp.asarray(q), k, n_shards=3),
             s.numpy(), i.numpy())
    assert ShardedMeshBackend(torch.from_numpy(c), k, LatencyModel(),
                              n_shards=0).n_shards == 1
