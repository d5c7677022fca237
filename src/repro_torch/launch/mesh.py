"""Production meshes (single-pod 16x16, multi-pod 2x16x16) on
``torch.distributed``.

Twin of ``src/repro/launch/mesh.py``.  Functions, not module constants:
importing this module starts no process group.  A mesh is a named
``DeviceMesh`` over the default process group, on the card
(``device_type="cuda"``) unless the caller asks for the CPU.

:func:`start_fake_world` starts a world of N ranks in one process on the
``fake`` backend, whose collectives move nothing: the multi-rank dry run
runs one rank's share of a step over ``meta`` tensors in it, as the
reference's dry run compiles for 512 virtual devices.  A process group is
process-global, so the dry run starts it in a process of its own.
"""
from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_world(device_type: str = "cuda") -> None:
    """A process group of one rank (NCCL on the card, gloo on the CPU)
    when none is running."""
    if dist.is_initialized():
        return
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)


def start_fake_world(world_size: int, rank: int = 0) -> None:
    """A ``fake`` process group of ``world_size`` ranks in this process,
    seen from ``rank``: collectives return tensors of the right shapes and
    move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The 16x16 ``(data, model)`` or 2x16x16 ``(pod, data, model)`` mesh
    over the default process group, whose size must be 256 or 512."""
    shape, names = MULTI_POD if multi_pod else SINGLE_POD
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise ValueError(f"the {'x'.join(map(str, shape))} mesh needs a "
                         f"world of {math.prod(shape)} ranks, not {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_local_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A 1x1 mesh with the production axis names (one card, or the CPU),
    over a one-rank process group started if none is running."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' for a CPU mesh")
    start_world(device_type)
    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def mesh_axis_size(mesh, names) -> int:
    """The product of the sizes of the mesh axes ``names`` the mesh has."""
    if isinstance(names, str):
        names = (names,)
    have = tuple(mesh.mesh_dim_names or ())
    return math.prod(mesh.size(have.index(a)) for a in names if a in have)


def mesh_label(mesh) -> str:
    """``"16x16"``: the mesh's shape, as the dry run's records name it."""
    return "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
