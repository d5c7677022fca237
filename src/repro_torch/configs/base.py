"""Config registry: ``ArchSpec`` and the shape specs.

Twin of ``src/repro/configs/base.py``.  Every registered architecture
maps its input shapes to a :class:`ShapeSpec` and carries a reduced
smoke config (``make_smoke(device=None)``, CUDA unless the caller asks
for the CPU) and its full config.

Left out: ``LoweringBundle``, ``ArchSpec.make_bundle`` and
``abstract_init``.  They build the abstract arguments and logical
shardings that ``launch/dryrun.py`` lowers on a TPU mesh, and one card
has no mesh to lower for.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

REGISTRY: dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str               # train | prefill | decode | serve | retrieval
    dims: Mapping[str, int]
    note: str = ""


@dataclasses.dataclass
class ArchSpec:
    name: str
    family: str             # lm | gnn | recsys | rag
    source: str             # citation tag from the assignment
    shapes: dict[str, ShapeSpec]
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
