"""The rank side of ``test_torch_distributed.py``: one gloo process a rank.

``run(root, world)`` starts ``world`` spawned processes that join one
gloo group through ``file://{root}/rdzv``, each read the cases that the
test wrote to ``{root}/cases.npz``, search their own row block with
``distributed_flat_search`` and through ``ShardedMeshBackend`` on a
``DeviceMesh`` of every rank, and write what they got to
``{root}/rank{r}.npz``.  A rank that hangs is killed at the deadline, so a
hang fails the test in about two minutes.  This module imports no JAX.
"""
from __future__ import annotations

import time
from datetime import timedelta

import numpy as np

DEADLINE_S = 100


def _rank(rank: int, world: int, root: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.retrieval.distributed import distributed_flat_search
    from repro_torch.retrieval.service import ShardedMeshBackend
    from repro_torch.serving.latency import LatencyModel

    dist.init_process_group("gloo", init_method=f"file://{root}/rdzv",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        data = np.load(f"{root}/cases.npz")
        names = [k[:-2] for k in data.files if k.endswith("_c")]
        search = distributed_flat_search()
        out = {}
        for name in names:
            corpus = torch.from_numpy(data[f"{name}_c"])
            rows = corpus.shape[0] // world
            s, i = search(corpus[rank * rows:(rank + 1) * rows],
                          torch.from_numpy(data[f"{name}_q"]),
                          int(data[f"{name}_k"]))
            out[f"{name}_s"], out[f"{name}_i"] = s.numpy(), i.numpy()
        mesh = DeviceMesh("cpu", list(range(world)))
        corpus = torch.from_numpy(data["mesh_corpus"])
        be = ShardedMeshBackend(corpus, int(data["mesh_k"]), LatencyModel(),
                                n_workers=2, mesh=mesh)
        s, i = be.search(torch.from_numpy(data["mesh_q"]))
        out.update(mesh_s=s.numpy(), mesh_i=i.numpy(),
                   mesh_n_shards=be.n_shards, mesh_n_workers=be.n_workers)
        try:
            ShardedMeshBackend(corpus[:-1], 4, LatencyModel(), mesh=mesh)
            out["uneven_error"] = ""
        except ValueError as e:
            out["uneven_error"] = str(e)
        np.savez(f"{root}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run(root: str, world: int) -> list[dict]:
    """Every rank's results, rank 0 first; raises if a rank fails or the
    group is not done within DEADLINE_S."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank, args=(world, root), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + DEADLINE_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} gloo ranks not done in "
                               f"{DEADLINE_S} s")
    return [dict(np.load(f"{root}/rank{r}.npz")) for r in range(world)]
