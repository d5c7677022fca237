"""``correct`` comes out false when the timed path is broken underneath:
the rest of a run, on the CPU at a tiny size, with one fault planted in
the program.  And ``run.py`` refuses to run without its program or its
card."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, make_tiny_bench
from perfbench import harness


def _state_unchanged(monkeypatch):
    import repro_torch.serving.batched as batched
    monkeypatch.setattr(batched, "cache_update_chunked",
                        lambda cfg, state, *a, **kw: state)


def _half_the_batch(monkeypatch):
    from repro_torch.serving.batched import BatchedHasEngine
    step = BatchedHasEngine._step_batch
    monkeypatch.setattr(BatchedHasEngine, "_step_batch",
                        lambda self, g, r, d: step(self, g[:len(g) // 2],
                                                   r, d))


def _cloud_answer_altered(monkeypatch):
    from repro_torch.retrieval.service import RetrievalService
    search = RetrievalService.full_search_batch

    def altered(self, q, *a, **kw):
        ids, t = search(self, q, *a, **kw)
        ids = ids.copy()
        ids[0, 0] = (ids[0, 0] + 7) % self.corpus.shape[0]
        return ids, t
    monkeypatch.setattr(RetrievalService, "full_search_batch", altered)


def _draft_altered(monkeypatch):
    import repro_torch.serving.batched as batched
    spec = batched.speculate_batch

    def altered(*a, **kw):
        out = spec(*a, **kw)
        ids = out["val_ids"]
        ids[:, 0] = (ids[:, 0] + 7) % 10000
        return out
    monkeypatch.setattr(batched, "speculate_batch", altered)


FAULTS = {"state_unchanged": (_state_unchanged, "state_miss"),
          "half_the_batch": (_half_the_batch, "unanswered"),
          "cloud_answer_altered": (_cloud_answer_altered, "cloud_gap"),
          "draft_altered": (_draft_altered, "draft_gap")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(tmp_path, monkeypatch,
                                                 fault):
    plant, number = FAULTS[fault]
    cell = make_tiny_bench(tmp_path)
    plant(monkeypatch)
    out = harness.run_cell(harness.Bench(tmp_path), cell, 21, 0.3, False,
                           device="cpu")
    assert not out["correct"]
    c = out["checks"][number]
    assert c["value"] == "inf" or c["value"] > c["limit"]


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "has-flat.granola",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra], cwd=cwd,
        capture_output=True, text=True, timeout=120)


def test_run_py_without_its_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = _run_py(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_py_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_result_line_keeps_checks_last(tmp_path):
    cell = make_tiny_bench(tmp_path)
    out = harness.run_cell(harness.Bench(tmp_path), cell, 4, 0.2, False,
                           device="cpu")
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
