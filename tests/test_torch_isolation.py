"""The port stands alone, and its entry points run on CUDA unless asked.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the reference package ``repro``.
* Without a card, entry points called without ``device=`` raise instead of
  running on the CPU, and a missing ``nvcc`` makes the kernel build raise.
* ``chip_smoke.py`` fails, and prints no result, where CUDA is missing.
* The meshes go on the card unless asked for the CPU: without a card
  ``make_local_mesh()`` raises, and a production mesh needs its world.
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
       ROOT / "examples" / "async_serving_torch.py",
       ROOT / "examples" / "agentic_multihop_torch.py",
       ROOT / "examples" / "rag_serving_torch.py",
       ROOT / "examples" / "train_lm_torch.py"]


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


def test_cloud_backend_and_agentic_entry_points_refuse_cpu_fallback(
        monkeypatch):
    import importlib.util

    import numpy as np

    from repro_torch.launch import serve
    from repro_torch.retrieval.service import HybridBackend, IVFBackend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    world = SyntheticWorld(WorldConfig(n_entities=40, d=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IVFBackend(world.doc_emb, 4, LatencyModel(), n_clusters=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridBackend(world.doc_emb, 4, LatencyModel(), world.doc_terms,
                      world.doc_term_weights, dense="sharded")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--queries", "4", "--entities", "40"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--queries", "4", "--entities", "40", "--engine",
                    "sched", "--agentic-frac", "0.5"])
    for name, call in (
            ("agentic_multihop_torch", lambda m: m.run(2, n_entities=40)),
            ("async_serving_torch",
             lambda m: m.run(4, 10.0, "sharded", n_entities=40))):
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(mod)
    # asked for explicitly, the CPU works
    be = IVFBackend(world.doc_emb, 4, LatencyModel(), n_clusters=4,
                    device="cpu")
    be.ingest_docs(np.ones((1, 8), np.float32))
    assert be.index.bucket_ids.device.type == "cpu"
    assert len(serve.main(["--queries", "4", "--entities", "40",
                           "--device", "cpu"]).accepts) == 4


def test_moe_generator_and_rag_twin_refuse_cpu_fallback(monkeypatch):
    import importlib.util

    from repro_torch.configs.lm_archs import LM_CONFIGS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tf.TransformerConfig(name="t", n_layers=1, d_model=16, n_heads=2,
                               n_kv_heads=1, d_ff=32, vocab_size=64,
                               d_head=8, moe_experts=4, moe_dense_residual=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(LM_CONFIGS["dbrx-132b"])      # before any draw
    spec = importlib.util.spec_from_file_location(
        "rag_serving_torch", ROOT / "examples" / "rag_serving_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.run(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(["8"])
    # asked for explicitly, the CPU works
    params = tf.init_params(cfg, device="cpu")
    assert params["layers"][0]["moe"]["w_in"].device.type == "cpu"
    logits, _ = tf.decode_step(params,
                               tf.init_kv_cache(cfg, 2, 4, device="cpu"),
                               torch.zeros(2, dtype=torch.int32), 0, cfg)
    assert logits.shape == (2, 64)


def test_training_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    import importlib.util

    from repro_torch.configs.families import lm_smoke
    from repro_torch.configs.lm_archs import LM_CONFIGS
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tf.TransformerConfig(name="t", n_layers=1, d_model=16, n_heads=2,
                               n_kv_heads=1, d_ff=32, vocab_size=64,
                               d_head=8, remat=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_master_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train_lm(cfg, 1, 2, 8, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--preset", "lm100m", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "chatglm3-6b", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm_smoke(LM_CONFIGS["dbrx-132b"])
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    # asked for explicitly, the CPU works
    assert tf.init_master_params(cfg, device="cpu")["embed"].device.type \
        == "cpu"
    assert len(train.train_lm(cfg, 1, 2, 8, None, device="cpu")) == 1


def test_model_family_entry_points_refuse_cpu_fallback(monkeypatch):
    """The recsys models, DimeNet, the has-rag step and their registry
    smokes and CLI runs default to CUDA and raise without a card."""
    from repro_torch.configs import all_archs, get_arch
    from repro_torch.configs.recsys_archs import RECSYS_CONFIGS
    from repro_torch.launch import train
    from repro_torch.models import dimenet as dn
    from repro_torch.models import recsys as rs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = dict(vocab_sizes=(8, 8), embed_dim=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.init_params(rs.RecsysConfig(name="t", kind="deepfm", mlp=(4,),
                                       **small))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RECSYS_CONFIGS["dlrm-rm2"].field_offsets()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dn.init_params(dn.DimeNetConfig(n_blocks=1, d_hidden=8, d_feat=4))
    for arch in all_archs():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_arch(arch).make_smoke()
    for arch in ("dlrm-rm2", "bert4rec", "dimenet"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", arch, "--steps", "1"])
    # asked for explicitly, the CPU works
    assert rs.init_params(rs.RecsysConfig(name="t", kind="deepfm",
                                          mlp=(4,), **small),
                          device="cpu")["w1"].device.type == "cpu"
    assert len(train.main(["--arch", "dimenet", "--steps", "1",
                           "--device", "cpu"])) == 1


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


def test_meshes_refuse_cpu_fallback(monkeypatch):
    from repro_torch.launch import mesh as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_local_mesh()
    with pytest.raises(ValueError, match="needs a world of 256"):
        M.make_production_mesh(device_type="cpu")
