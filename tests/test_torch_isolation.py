"""The port stands alone, and its entry points run on CUDA unless asked.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the reference package ``repro``.
* Without a card, entry points called without ``device=`` raise instead of
  running on the CPU, and a missing ``nvcc`` makes the kernel build raise.
* ``chip_smoke.py`` fails, and prints no result, where CUDA is missing.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.has import HasConfig, init_has_state
from repro_torch.data.synthetic import SyntheticWorld, WorldConfig
from repro_torch.kernels import _build
from repro_torch.retrieval.ivf import build_ivf
from repro_torch.retrieval.service import RetrievalService
from repro_torch.serving.latency import LatencyModel

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    world = SyntheticWorld(WorldConfig(n_entities=20, d=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RetrievalService(world, LatencyModel())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_ivf(world.doc_emb, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_has_state(HasConfig(h_max=4, d=8))
    # asked for explicitly, the CPU works
    service = RetrievalService(world, LatencyModel(), device="cpu")
    assert service.corpus.device.type == "cpu"
    assert service.corpus.dtype == torch.float32


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "CUDA" in proc.stderr
