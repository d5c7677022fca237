"""The port's serving entry point (``repro_torch.launch.serve``) against the
reference's ``repro.launch.serve``.

* Every invalid flag set the reference's tests name exits 2 in both, with
  the same message, before anything is built.
* ``main`` runs on the CPU (``--device cpu``) for each
  ``--retrieval-backend`` and engine at a few dozen queries.  The
  full-retrieval engine needs no k-means index, so its printed summary
  must equal the reference's line for line; the engines that build an
  index (the port's k-means cannot repeat the reference's draws) are held
  to finite, complete results.
* Without a card and without ``--device cpu``, ``main`` refuses to run.
"""
import contextlib
import io

import numpy as np
import pytest
import torch

from _torch_sched_util import one_torch_thread  # noqa: F401 (autouse)
from repro.launch import serve as ref_serve
from repro_torch.launch import serve as pt_serve

SMALL = ["--queries", "40", "--entities", "300", "--h-max", "200"]

INVALID = [
    # tests/test_agentic_sched.py:319
    ["--engine", "sched", "--agentic-frac", "1.5"],
    ["--engine", "sched", "--agentic-frac", "0.3", "--hops", "0"],
    ["--engine", "has", "--agentic-frac", "0.3"],
    # tests/test_ann_backend.py
    ["--nprobe", "0"],
    ["--nprobe", "-4", "--retrieval-backend", "ann"],
    ["--ann-clusters", "0", "--retrieval-backend", "ann"],
    ["--nprobe", "64", "--ann-clusters", "32", "--retrieval-backend", "ann"],
    ["--compressed-corpus"],
    ["--compressed-corpus", "--retrieval-backend", "sharded"],
    ["--compressed-corpus", "--retrieval-backend", "replica"],
    # tests/test_hybrid_fusion.py
    ["--retrieval-backend", "hybrid", "--rrf-k", "0.5"],
    ["--retrieval-backend", "hybrid", "--diversify-sim", "0"],
    ["--retrieval-backend", "hybrid", "--diversify-sim", "1.5"],
    ["--retrieval-backend", "hybrid", "--lexical-terms", "0"],
    ["--rrf-k", "60"],
    ["--diversify-sim", "0.9", "--retrieval-backend", "ann"],
    ["--lexical-terms", "2", "--retrieval-backend", "sharded"],
    ["--hybrid-dense", "ann"],
    ["--compressed-corpus", "--retrieval-backend", "hybrid"],
    # tests/test_edge_pool.py
    ["--edge-replicas", "0"],
    ["--edge-sync-every", "0", "--engine", "sched"],
    ["--edge-replicas", "2", "--engine", "has"],
    ["--edge-sync-every", "16", "--engine", "has"],
    ["--qps", "10", "--engine", "has"],
    ["--qps", "-1", "--engine", "sched"],
    # tests/test_faults.py
    ["--engine", "sched", "--fault-plan", "worker_crash"],
    ["--engine", "has", "--fault-plan", "worker_crash@1"],
    ["--engine", "sched", "--retry-max", "2"],
    ["--engine", "sched", "--hedge-after", "2.5"],
    ["--engine", "sched", "--fault-plan", "worker_crash@1",
     "--retry-max", "-1"],
    ["--engine", "sched", "--fault-plan", "worker_crash@1",
     "--hedge-after", "1.0"],
    # the rest of the reference's checks
    ["--shards", "0"],
    ["--workers", "0", "--retrieval-backend", "sharded"],
    ["--workers", "2"],
    ["--tenants", "0"],
    ["--tenant-zipf", "-1"],
    ["--tenants", "2", "--engine", "full"],
    ["--slo-deadline", "0", "--engine", "sched"],
    ["--slo-deadline", "2", "--engine", "has"],
    ["--engine", "sched", "--overload-policy", "shed"],
    ["--engine", "teleport"],
]


def _exit(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code, capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", INVALID, ids=[" ".join(a) for a in INVALID])
def test_invalid_flags_exit_2_as_in_reference(argv, capsys):
    want = _exit(ref_serve.main, argv, capsys)
    got = _exit(pt_serve.main, argv + ["--device", "cpu"], capsys)
    assert got == want and got[0] == 2


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue().splitlines()


FULL_BACKENDS = [
    ["--retrieval-backend", "flat"],
    ["--retrieval-backend", "sharded", "--shards", "3", "--workers", "3"],
    ["--retrieval-backend", "replica"],
    ["--retrieval-backend", "hybrid"],
    ["--retrieval-backend", "hybrid", "--hybrid-dense", "sharded",
     "--rrf-k", "30", "--diversify-sim", "0.95", "--lexical-terms", "2"],
]


@pytest.mark.parametrize("backend", FULL_BACKENDS,
                         ids=[" ".join(b) for b in FULL_BACKENDS])
def test_full_engine_printout_equals_reference(backend):
    argv = SMALL + ["--engine", "full"] + backend
    _, want = _run(ref_serve.main, argv)
    res, got = _run(pt_serve.main, argv + ["--device", "cpu"])
    assert got == want
    assert len(res.doc_hits) == 40


SCHED = [
    ["--retrieval-backend", "flat", "--agentic-frac", "0.25"],
    ["--retrieval-backend", "sharded", "--agentic-frac", "0.25",
     "--hops", "3"],
    ["--retrieval-backend", "replica", "--tenants", "2"],
    ["--retrieval-backend", "ann", "--ann-clusters", "16", "--nprobe", "4",
     "--compressed-corpus", "--qps", "20"],
    ["--retrieval-backend", "hybrid", "--hybrid-dense", "sharded",
     "--agentic-frac", "0.25"],
    ["--retrieval-backend", "hybrid", "--hybrid-dense", "ann",
     "--ann-clusters", "16", "--nprobe", "4", "--edge-replicas", "2"],
]


@pytest.mark.parametrize("extra", SCHED, ids=[" ".join(b) for b in SCHED])
def test_scheduler_engine_runs_each_backend(extra):
    res, out = _run(pt_serve.main, SMALL + ["--engine", "sched", "--device",
                                            "cpu"] + extra)
    assert (res.t_done >= 0).all() and (res.channels != "pending").all()
    np.testing.assert_allclose(res.trace.conservation_residual(), 0.0,
                               atol=1e-9)
    assert any("per-stage breakdown" in line for line in out)
    s = res.summary()
    if "--agentic-frac" in extra:
        assert s["complex_n"] == 10 and "agentic=10/40" in out[0]
        assert res.trace.spans["reason"].sum() > 0
    assert np.isfinite(s["dar"]) and s["full_retrievals"] > 0


@pytest.mark.parametrize("engine", ["has", "proximity", "saferadius",
                                    "mincache", "crag", "ivf", "scann"])
def test_sequential_engines_run(engine):
    res, out = _run(pt_serve.main, SMALL + ["--engine", engine,
                                            "--device", "cpu"])
    assert len(res.accepts) == 40 and out[0].startswith(
        f"[serve] engine={engine}")


def test_main_refuses_cpu_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_serve.main(SMALL)
