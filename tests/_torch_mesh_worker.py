"""The rank side of the mesh tests: one gloo process a rank.

``run(root, job, world)`` starts ``world`` spawned processes that join one
gloo group through ``file://{root}/rdzv`` and run ``JOBS[job]`` on every
rank; rank r writes what it returns to ``{root}/rank{r}.npz``.  A rank
that hangs is killed at the deadline, so a hang fails its test in about
four minutes.

The ``models`` job runs each ``CASES`` function on a 2x2 ``(data, model)``
mesh with the production rules: parameters, optimizer state and batches
are ``DTensor`` leaves placed by their logical axes, and every result is
gathered whole.  The same functions with ``mesh=None`` are the unsharded
port, which the tests run in their own process.  This module imports no
JAX: the reference's side runs in the test processes.
"""
from __future__ import annotations

import functools
import time
from datetime import timedelta

import numpy as np

from repro_torch.training.optimizer import OptConfig

DEADLINE_S = 240          # a hang guard: xdist runs several worlds at once
WORLD = 4


# ---------------------------------------------------------------------------
# Helpers shared by both sides
# ---------------------------------------------------------------------------

def _np(t) -> np.ndarray:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().cpu().numpy()


def _place(tree, logical, mesh):
    """``tree`` on ``mesh`` by ``logical`` (production rules) -> (tree,
    rules); as it is, with rules None, when ``mesh`` is None."""
    if mesh is None:
        return tree, None
    from repro_torch.launch.dryrun import rules_for_mesh
    from repro_torch.utils import tree_distribute
    rules = rules_for_mesh(mesh)
    return tree_distribute(tree, logical, rules, mesh), rules


def _flat(prefix: str, tree) -> dict:
    from repro_torch.training.optimizer import leaves
    return {prefix + "/".join(map(str, path)) + (f"#{i}" if len(ps) > 1
                                                 else ""): _np(p)
            for path, ps in leaves(tree) for i, p in enumerate(ps)}


def _grads(loss_fn, params, batch) -> dict:
    """The loss and every floating leaf's gradient, gathered."""
    from repro_torch.training.optimizer import leaves, like_param
    from repro_torch.utils import mesh_scope
    ps = [t for _, parts in leaves(params) for t in parts
          if t.is_floating_point()]
    for t in ps:
        t.requires_grad_(True)
    with mesh_scope(params):
        loss, _ = loss_fn(params, batch)
        loss.backward()
    out = {"loss": _np(loss)}
    for i, t in enumerate(ps):
        out[f"grad/{i}"] = _np(like_param(t.grad, t))
        t.grad = None
        t.requires_grad_(False)
    return out


def _train(make, loss_fn, opt_cfg, plog, batch, blog, mesh) -> dict:
    """Loss and gradients on fresh parameters, then one optimizer step on
    fresh parameters and state (``opt_init`` on the whole tensors, placed
    by ``opt_state_logical``), all gathered."""
    from repro_torch.training.optimizer import opt_init, opt_state_logical
    from repro_torch.training.train import make_train_step
    b, rules = _place(batch, blog, mesh)
    params, _ = _place(make(), plog, mesh)
    lossf = functools.partial(loss_fn, rules=rules)
    out = _grads(lossf, params, b)
    plain = make()
    state, _ = _place(opt_init(opt_cfg, plain), opt_state_logical(
        opt_cfg, plog), mesh)
    params, _ = _place(plain, plog, mesh)
    params, state, metrics = make_train_step(lossf, opt_cfg)(params, state, b)
    out.update(_flat("step/", params))
    out["grad_norm"] = _np(metrics["grad_norm"])
    return out


# ---------------------------------------------------------------------------
# Cases: fn(mesh) -> {name: array}, mesh None for the unsharded port
# ---------------------------------------------------------------------------

def lm_config(moe: bool):
    """A tiny dense LM (4 heads, head-sharded weights) or a tiny MoE LM (3
    heads padded to 4 on the mesh, 4 experts top-2 in 2 dispatch groups,
    Adafactor)."""
    import torch

    from repro_torch.models.transformer import TransformerConfig
    if moe:
        return TransformerConfig(
            name="tiny-moe", n_layers=2, d_model=32, n_heads=3, n_kv_heads=1,
            d_ff=32, vocab_size=64, d_head=8, moe_experts=4, moe_top_k=2,
            moe_dp_groups=2, head_tp=False, head_pad_to=4, remat=False,
            param_dtype=torch.float32)
    return TransformerConfig(name="tiny", n_layers=2, d_model=32, n_heads=4,
                             n_kv_heads=2, d_ff=64, vocab_size=64, d_head=8,
                             rope_fraction=0.5, remat=True,
                             param_dtype=torch.float32)


def lm_batch(cfg) -> dict:
    import torch
    rng = np.random.default_rng(1)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 8)),
                               dtype=torch.int32)
            for k in ("tokens", "labels")}


def lm_case(mesh, moe: bool) -> dict:
    import torch

    from repro_torch.configs.families import lm_opt_config
    from repro_torch.models import transformer as tf
    cfg = lm_config(moe)
    make = functools.partial(tf.init_master_params, cfg, 0, "cpu")
    lossf = functools.partial(tf.loss_fn, cfg=cfg,
                              compute_dtype=torch.float32)
    blog = {"tokens": ("batch", None), "labels": ("batch", None)}
    return _train(make, lossf, lm_opt_config(cfg), tf.params_logical(cfg),
                  lm_batch(cfg), blog, mesh)


def decode_case(mesh) -> dict:
    """One decode step of the dense LM (f32 weights) at cache index 5 of a
    cache of 8 positions holding random K/V: the new K/V land in the
    model rank that holds position 5, and the cache is gathered over its
    sequence for the attention."""
    import torch

    from repro_torch.models import transformer as tf
    cfg = lm_config(False)
    params = tf.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(2)
    shape = (cfg.n_layers, 4, 8, cfg.n_kv_heads, cfg.d_head)
    cache = {k: torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
             for k in ("k", "v")}
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, 4),
                             dtype=torch.int32)
    args, rules = _place((params, cache, tokens),
                         (tf.params_logical(cfg), tf.kv_cache_logical(8),
                          ("batch",)), mesh)
    with torch.no_grad():
        logits, cache = tf.decode_step(*args, 5, cfg, rules=rules)
    return {"logits": _np(logits), "k": _np(cache["k"]),
            "v": _np(cache["v"])}


def recsys_case(mesh, kind: str, vocab: int | None = None) -> dict:
    """One recsys kind at the smoke size; ``vocab`` (bert4rec) replaces the
    item count, so that the padded table's real rows split unevenly over
    the ``model`` ranks (the last vocab block short)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.families import (recsys_abstract_batch,
                                              to_device)
    from repro_torch.configs.recsys_archs import smoke_batch, smoke_config
    from repro_torch.data.recsys import SessionLog
    from repro_torch.models import recsys as rs
    cfg = smoke_config(get_arch(kind).config)
    if vocab is None:
        batch = to_device(smoke_batch(cfg), "cpu")
    else:
        cfg = dataclasses.replace(cfg, vocab_sizes=(vocab,))
        batch = to_device(SessionLog(vocab, seed=0).sample(4, cfg.seq_len),
                          "cpu")
    blog = recsys_abstract_batch(cfg, next(iter(batch.values())).shape[0],
                                 mesh)[1]
    opt_cfg = OptConfig(name="adamw")
    make = functools.partial(rs.init_params, cfg, 0, "cpu")
    out = _train(make, functools.partial(rs.loss_fn, cfg=cfg), opt_cfg,
                 rs.params_logical(cfg), batch, blog, mesh)
    import torch
    params, rules = _place(make(), rs.params_logical(cfg), mesh)
    b, _ = _place(batch, blog, mesh)
    with torch.no_grad():
        out["forward"] = _np(rs.forward(params, b, cfg, rules=rules))
    return out


def dimenet_case(mesh) -> dict:
    from repro_torch.configs.dimenet import SMOKE_CONFIG, smoke_batch
    from repro_torch.configs.families import gnn_abstract_batch, to_device
    from repro_torch.models import dimenet as dn
    cfg = SMOKE_CONFIG
    batch = to_device(smoke_batch(), "cpu")
    blog = gnn_abstract_batch(40, 120, batch["tri_mask"].shape[0], 16,
                              cfg.task)[1]
    opt_cfg = OptConfig(name="adamw")
    make = functools.partial(dn.init_params, cfg, 0, "cpu")
    return _train(make, functools.partial(dn.loss_fn, cfg=cfg), opt_cfg,
                  dn.params_logical(cfg), batch, blog, mesh)


def has_rag_case(mesh) -> dict:
    """The batched HaS step on the reference's smoke inputs, at one chunk
    a rank (``merge_chunks`` 4 unsharded)."""
    import torch

    from repro_torch.configs.has_rag import has_retrieval_step, smoke_args
    cfg, args = smoke_args("cpu")
    logical = (("corpus", None), ("corpus", None), ("corpus",),
               (None, None), (None,), (None, None), (None,), (None, None))
    args, rules = _place(args, logical, mesh)
    with torch.no_grad():
        ids, accept, best = has_retrieval_step(
            *args, k=cfg.k, tau=0.2, merge_chunks=WORLD, rules=rules)
    return {"ids": _np(ids), "accept": _np(accept), "best": _np(best)}


def flat_case(mesh) -> dict:
    """``chunked_flat_search`` over a corpus sharded over ``corpus`` (the
    four ranks' row blocks), with the same rows planted in three blocks
    so that scores tie exactly across ranks (quarter-integer entries:
    every product and sum is exact in f32): ids exact, ties to the lower
    row."""
    import torch

    from repro_torch.retrieval.flat import chunked_flat_search
    rng = np.random.default_rng(3)
    block = rng.integers(-4, 5, (16, 8)).astype(np.float32) / 4
    other = rng.integers(-4, 5, (16, 8)).astype(np.float32) / 4
    corpus = torch.from_numpy(np.concatenate([block, other, block, block]))
    queries = torch.from_numpy(
        rng.integers(-4, 5, (5, 8)).astype(np.float32) / 4)
    (corpus, queries), rules = _place((corpus, queries),
                                      (("corpus", None), (None, None)), mesh)
    with torch.no_grad():
        s, i = chunked_flat_search(corpus, queries, 10, chunk=24,
                                   rules=rules)
    return {"scores": _np(s), "ids": _np(i)}


CASES = {
    "dense_lm": functools.partial(lm_case, moe=False),
    "moe_lm": functools.partial(lm_case, moe=True),
    "decode": decode_case,
    "dlrm": functools.partial(recsys_case, kind="dlrm-rm2"),
    "deepfm": functools.partial(recsys_case, kind="deepfm"),
    "autoint": functools.partial(recsys_case, kind="autoint"),
    "bert4rec": functools.partial(recsys_case, kind="bert4rec"),
    "bert4rec_uneven": functools.partial(recsys_case, kind="bert4rec",
                                         vocab=251),
    "dimenet": dimenet_case,
    "has_rag": has_rag_case,
    "flat": flat_case,
}


# ---------------------------------------------------------------------------
# Jobs: fn(rank, world, root) -> {name: array}, run on every rank
# ---------------------------------------------------------------------------

def _mesh_2x2():
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def models_job(rank: int, world: int, root: str) -> dict:
    """The ``CASES`` named in ``{root}/cases.txt``, one per line."""
    with open(f"{root}/cases.txt") as f:
        names = f.read().split()
    mesh = _mesh_2x2()
    out = {}
    for name in names:
        t0 = time.perf_counter()
        out.update({f"{name}/{k}": v for k, v in CASES[name](mesh).items()})
        out[f"{name}/seconds"] = np.float64(time.perf_counter() - t0)
    return out


def compression_job(rank: int, world: int, root: str) -> dict:
    """``make_compressed_allreduce`` over a 4-rank ``pod`` mesh: rank r
    reduces row block r of ``{root}/grads.npz``."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.training.compression import make_compressed_allreduce
    data = np.load(f"{root}/grads.npz")
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
    fn = make_compressed_allreduce(mesh, dp_axes=("pod",))
    g = {k: torch.from_numpy(data[k][rank]) for k in ("w", "b")}
    e = {k: torch.from_numpy(data[f"e_{k}"][rank]) for k in ("w", "b")}
    red, err = fn(g, e)
    out = {f"red/{k}": v.numpy() for k, v in red.items()}
    out.update({f"err/{k}": v.numpy() for k, v in err.items()})
    return out


def reshard_job(rank: int, world: int, root: str) -> dict:
    """``reshard_tree`` of the tree in ``{root}/tree.npz`` onto the 2x2
    mesh: this rank's local shards."""
    from repro_torch.checkpoint.manager import reshard_tree
    from repro_torch.launch.dryrun import rules_for_mesh
    data = np.load(f"{root}/tree.npz")
    tree = {k: data[k] for k in data.files}
    logical = {"w": ("fsdp", "d_ff"), "e": ("emb_vocab", None),
               "c": ("corpus", None), "v": ("batch",)}
    mesh = _mesh_2x2()
    placed = reshard_tree(tree, logical, rules_for_mesh(mesh), mesh)
    return {k: v.to_local().numpy() for k, v in placed.items()}


JOBS = {"models": models_job, "compression": compression_job,
        "reshard": reshard_job}


def _rank(rank: int, world: int, root: str, job: str) -> None:
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        np.savez(f"{root}/rank{rank}.npz", **JOBS[job](rank, world, root))
        dist.barrier()      # no rank tears the group down under another
    finally:
        dist.destroy_process_group()


def run(root: str, job: str, world: int = WORLD) -> list[dict]:
    """Every rank's results, rank 0 first; raises if a rank fails or the
    group is not done within DEADLINE_S."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank, args=(world, root, job), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} gloo ranks not done in "
                               f"{DEADLINE_S} s")
    return [dict(np.load(f"{root}/rank{r}.npz")) for r in range(world)]
