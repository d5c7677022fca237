"""The harness finds a configuration, a mix, a cloud stage and every metric
by name, and a cell added as files and entries alone runs."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT, make_tiny_bench
from perfbench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_name_in_the_benchmark_resolves_to_a_file():
    bench = harness.Bench(ROOT)
    for c in SPEC["configs"]:
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"]
        bench.stage(cfg["cloud"]["kind"])
    for w in SPEC["workloads"]:
        bench.traffic(w["traffic"])
        assert bench.metrics(w["name"], False)
        assert bench.metrics(w["name"], True)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_a_throwaway_cell_from_files_alone(tmp_path):
    before = {p: p.read_bytes() for p in (ROOT / "perfbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    cell = make_tiny_bench(tmp_path, "squad")
    bench = harness.Bench(tmp_path)
    assert bench.cell(cell)["config"] == "tiny-flat"
    assert bench.traffic("tiny-squad")["zipf_a"] == 1.01
    out = harness.run_cell(bench, cell, 2 ** 31 + 99, 0.3, False,
                           device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"qps", "p95_ms", "setup_s"}
    assert list(out)[-1] == "checks"
    after = {p: p.read_bytes() for p in (ROOT / "perfbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


def test_a_traced_cpu_run_reads_what_the_cpu_has(tmp_path):
    cell = make_tiny_bench(tmp_path)
    out = harness.run_cell(harness.Bench(tmp_path), cell, 3, 0.3, True,
                           device="cpu")
    assert out["correct"], out["checks"]
    # no device: only the host's metrics, and no device metric at all
    assert {"engine.step_ms", "spec.accept_share",
            "step_roofline"} <= set(out["metrics"])
    assert "device.idle_share" not in out["metrics"]
    assert out["device"]["busy_s"] == 0.0
