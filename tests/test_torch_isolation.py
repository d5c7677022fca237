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
from repro_torch.models import transformer as tf
from repro_torch.retrieval.ivf import build_ivf
from repro_torch.retrieval.service import RetrievalService
from repro_torch.serving.engine import HasEngine
from repro_torch.serving.latency import LatencyModel
from repro_torch.serving.rag import serve_rag

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "examples" / "quickstart_torch.py",
       ROOT / "examples" / "async_serving_torch.py"]


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
    cfg = tf.TransformerConfig(name="t", n_layers=1, d_model=16, n_heads=2,
                               n_kv_heads=1, d_ff=32, vocab_size=4096,
                               d_head=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(cfg)
    # asked for explicitly, the CPU works
    service = RetrievalService(world, LatencyModel(), device="cpu")
    assert service.corpus.device.type == "cpu"
    assert service.corpus.dtype == torch.float32
    params = tf.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    engine = HasEngine(service, HasConfig(h_max=4, d=8, n_buckets=4,
                                          nprobe=2))
    queries = world.sample_queries(2, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_rag(engine, queries, params, cfg, batch=2)
    res = serve_rag(engine, queries, params, cfg, batch=2, prompt_len=16,
                    gen_len=2, device="cpu")
    assert res.tokens.shape == (2, 3)


def test_tenant_reuse_and_quickstart_entry_points_refuse_cpu_fallback(
        monkeypatch):
    import importlib.util

    from repro_torch.core.baselines import init_reuse_state
    from repro_torch.core.has import init_tenant_states
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_tenant_states(HasConfig(h_max=4, d=8), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_reuse_state(4, 2, 8)
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    qs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qs.run(2, n_entities=20)
    assert init_tenant_states(HasConfig(h_max=4, d=8), 2,
                              device="cpu").q_ptr.shape == (2,)
    assert init_reuse_state(4, 2, 8, device="cpu").valid.device.type == "cpu"


def test_scheduler_slice_entry_points_refuse_cpu_fallback(monkeypatch,
                                                         tmp_path):
    import importlib.util

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.serving.edge_pool import EdgeReplicaPool
    from repro_torch.serving.replication import WarmStandby, restore
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = HasConfig(h_max=4, d=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EdgeReplicaPool(cfg, 2)
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore(mgr, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WarmStandby(cfg, mgr).failover()
    spec = importlib.util.spec_from_file_location(
        "async_serving_torch", ROOT / "examples" / "async_serving_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.run(4, 10.0, n_entities=20)
    assert EdgeReplicaPool(cfg, 2, device="cpu").states[1].q_ptr.device \
        .type == "cpu"
    assert restore(mgr, cfg, device="cpu") is None


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
