"""On the card: the control (the reference in the program's place, its
products in TF32) comes out not correct, and the program correct, at a
size a test run holds: d 768, 200,000 rows, the paper's cache."""
from __future__ import annotations

import json

import pytest

from conftest import make_tiny_bench
from perfbench import harness

MID = dict(d=768, h_max=5000, doc_cap=50000, batch=64, n_buckets=1024,
           nprobe=64, corpus_rows=200000)


def _mid_bench(tmp_path):
    cell = make_tiny_bench(tmp_path, "squad")
    name = cell.split(".")[0]
    p = tmp_path / f"perfbench/configs/{name}.json"
    cfg = json.loads(p.read_text())
    cfg.update(MID)
    cfg["world"]["n_entities"] = MID["corpus_rows"] // 5
    p.write_text(json.dumps(cfg))
    m = tmp_path / "perfbench/traffic/tiny-squad.json"
    mix = json.loads(m.read_text())
    mix.update(batch=64, fill_rejects=5000, fill_queries=60000)
    m.write_text(json.dumps(mix))
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_tf32_control_fails_where_the_program_passes(cuda, tmp_path,
                                                         seed):
    cell = _mid_bench(tmp_path)
    out = harness.run_cell(harness.Bench(tmp_path), cell, seed, 2.0, False,
                           device=cuda, control=True)
    assert out["correct"], out["checks"]
    lim = {k: c["limit"] for k, c in out["checks"].items()}
    ctl = out["control"]
    assert any(v == "inf" or v > lim[k] for k, v in ctl.items()), ctl
