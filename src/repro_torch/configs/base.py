"""Config registry: ``ArchSpec``, the shape specs and the cell bundles.

Twin of ``src/repro/configs/base.py``.  Every registered architecture
maps its input shapes to a :class:`ShapeSpec` and a :class:`LoweringBundle`
(``make_bundle(shape, **variant)``): the step a cell runs and its
arguments as ``meta`` tensors with the reference's shapes and dtypes,
which ``launch/dryrun.py`` runs once without allocating, and their
logical axes (``arg_logical``), which place them on a mesh
(``make_bundle(shape, rules, mesh, **variant)``; default one card).  It
also carries a reduced smoke config (``make_smoke(device=None)``, CUDA
unless the caller asks for the CPU) and its full config.

``LoweringBundle`` has no ``static_argnums`` (a Python call has no static
arguments to mark).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

META = torch.device("meta")

REGISTRY: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str               # train | prefill | decode | serve | retrieval
    dims: Mapping[str, int]
    note: str = ""


@dataclasses.dataclass
class LoweringBundle:
    """What the dry run needs: ``fn(*abstract_args)``, the arguments
    ``meta`` tensors (nested dicts and lists of them, or host ints); the
    ``donate_argnums`` arguments are updated in place.  ``arg_logical``
    is the arguments' tree of logical axes (``()`` for a host int)."""
    fn: Callable
    abstract_args: tuple
    donate_argnums: tuple = ()
    arg_logical: tuple = ()


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str             # lm | gnn | recsys | rag
    source: str             # citation tag from the assignment
    shapes: dict[str, ShapeSpec]
    # the cell's bundle: (shape_name, rules=None, mesh=None, **variant)
    # -> LoweringBundle
    make_bundle: Callable[..., LoweringBundle]
    # reduced config smoke: (device=None) -> (cfg, params, opt_state, step,
    # batch), or (cfg, fn, args) for the retrieval step
    make_smoke: Callable[..., tuple]
    config: Any = None

    def register(self):
        REGISTRY[self.name] = self
        return self


def get_arch(name: str) -> ArchSpec:
    if name not in REGISTRY:
        # import side-effect registration
        import repro_torch.configs  # noqa: F401
    return REGISTRY[name]


def all_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(REGISTRY)


def abstract_init(fn, *args, **kwargs):
    """``fn(*args, device=meta, **kwargs)``: parameters or optimizer state
    as ``meta`` tensors, nothing allocated (the reference's
    ``jax.eval_shape``)."""
    return fn(*args, device=META, **kwargs)
