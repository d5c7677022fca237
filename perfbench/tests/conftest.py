"""Shared helpers of the benchmark's tests: the repository root and the
program on ``sys.path``, and a throwaway benchmark at a tiny size."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(d=32, h_max=100, doc_cap=1000, batch=16, n_buckets=64, nprobe=8,
            corpus_rows=10000)
TINY_MIX = dict(batch=16, fill_rejects=100, fill_queries=2000, max_qps=4000)


def make_tiny_bench(dst: Path, mix: str = "granola"):
    """A copy of the benchmark under ``dst`` with one more configuration,
    mix and cell, added as files and entries alone -> the cell's name."""
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "perfbench/configs/has-flat.json").read_text())
    cfg.update(TINY)
    cfg["world"]["n_entities"] = TINY["corpus_rows"] // 5
    cfg["cloud"]["chunk"] = 2048
    name = "tiny-flat"
    (dst / f"perfbench/configs/{name}.json").write_text(json.dumps(cfg))
    m = json.loads((ROOT / f"perfbench/traffic/{mix}.json").read_text())
    m.update(TINY_MIX)
    (dst / f"perfbench/traffic/tiny-{mix}.json").write_text(json.dumps(m))
    cell = f"{name}.tiny-{mix}"
    spec["configs"].append({"name": name, "source": "test",
                            "file": f"perfbench/configs/{name}.json",
                            "reduced": [], "why": "a CPU test"})
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": f"tiny-{mix}", "chips": 1,
                              "why": "a CPU test"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in metric:
            metric["workloads"].append(cell)
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return cell


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the chip)")
    return torch.device("cuda")
