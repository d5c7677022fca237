"""The port's recorder of spans and counters (``core/dispatch.py``) and the
spans of the serving step.

On the CPU: nesting, parent ids and the micro-batch id a step's spans
inherit; a span's own time; counts in the innermost span and in the
global tally; the ring's bound; one ``BatchedHasEngine._step_batch`` on a
small world opening its eight spans in order; the spans as nested
``user_annotation`` events of a profiler trace; the
benchmark harness still capturing the drafts it judges.  On the card (marked
``cuda``, skips without one): the ``host_syncs`` counted in one step
against the synchronizing operations that PyTorch's sync debug mode warns
of.  This file imports nothing of JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_tracing.py
"""
import collections
import json
import sys
import threading
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import dispatch
from repro_torch.core.has import HasConfig
from repro_torch.data.synthetic import SyntheticWorld, WorldConfig
from repro_torch.retrieval.service import RetrievalService
from repro_torch.serving.batched import BatchedHasEngine
from repro_torch.serving.latency import LatencyModel

ROOT = Path(__file__).resolve().parents[1]
STEP_SPANS = ("engine.step", "spec", "spec.readback", "cloud", "cloud.scan",
              "cloud.readback", "ingest", "engine.respond")
PARENT = {"spec": "engine.step", "spec.readback": "engine.step",
          "cloud": "engine.step", "cloud.scan": "cloud",
          "cloud.readback": "cloud", "ingest": "engine.step",
          "engine.respond": "engine.step"}
BATCH = 16


def _engine(device):
    world = SyntheticWorld(WorldConfig(n_entities=300, d=32, seed=0))
    service = RetrievalService(world, LatencyModel(), k=10, device=device)
    cfg = HasConfig(k=10, tau=0.2, h_max=64, nprobe=4, n_buckets=32, d=32)
    engine = BatchedHasEngine(service, cfg, batch_size=BATCH)
    queries = world.sample_queries(4 * BATCH, pattern="zipf", zipf_a=1.12,
                                   p_uncovered=0.42, seed=1)
    return engine, queries


def _step_spans(step_span):
    return [s for s in dispatch.snapshot() if s.step == step_span.step]


def _made(name, start, end, parent=None, sid=None):
    s = dispatch.Span(name)
    s.start_ns, s.end_ns, s.parent, s.id = start, end, parent, sid
    return s


def test_spans_nest_with_parent_ids_and_inherit_the_step():
    with dispatch.span("outside") as out:
        with dispatch.span("batch", step=True) as b:
            with dispatch.span("inner") as i1:
                with dispatch.span("leaf") as leaf:
                    pass
            with dispatch.span("inner2") as i2:
                pass
        with dispatch.span("batch", step=True) as b2:
            pass
    assert out.parent is None and out.step is None
    assert b.parent == out.id and b.step is not None
    assert (i1.parent, i2.parent, leaf.parent) == (b.id, b.id, i1.id)
    assert i1.step == i2.step == leaf.step == b.step
    assert b2.step > b.step and b2.parent == out.id
    assert len({s.id for s in (out, b, i1, leaf, i2, b2)}) == 6
    # closed spans enter the ring as they close, each within its parent
    assert dispatch.snapshot()[-6:] == [leaf, i1, i2, b, b2, out]
    for kid, up in ((b, out), (i1, b), (leaf, i1), (i2, b)):
        assert up.start_ns <= kid.start_ns <= kid.end_ns <= up.end_ns
    assert out.seconds == pytest.approx(out.ns * 1e-9)
    # another thread keeps its own stack: no parent, no step
    got = {}

    def other():
        with dispatch.span("other") as o:
            got["o"] = o
    with dispatch.span("here", step=True):
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert got["o"].parent is None and got["o"].step is None


def test_self_time_is_the_span_less_the_union_of_its_children():
    top = _made("top", 100, 200, sid=1)
    spans = [top,
             _made("a", 110, 130, 1, 2), _made("b", 120, 150, 1, 3),
             _made("c", 170, 230, 1, 4),       # runs past the parent's end
             _made("x", 115, 125, 2, 5),       # a grandchild: not a child
             _made("y", 90, 180, 9, 6)]        # another span's child
    # children cover 110-150 and 170-200: 70 of 100
    assert dispatch.self_ns(top, spans) == 30
    assert dispatch.self_ns(top, [top]) == 100
    assert dispatch.self_ns(spans[1], spans) == 10


def test_counts_attach_to_the_innermost_span_and_the_global_tally():
    base = dispatch.counters().get("t.rows", 0)
    with dispatch.capture() as probe:
        with dispatch.span("outer") as outer:
            dispatch.count("t.rows")
            with dispatch.span("inner") as inner:
                dispatch.count("t.rows", 5)
                dispatch.count("t.other", 2)
                dispatch.record("t.entry")
            dispatch.count("t.rows", 2)
        dispatch.count("t.rows", 7)                 # no span open
    assert outer.counts == {"t.rows": 3}
    assert inner.counts == {"t.rows": 5, "t.other": 2}
    assert dispatch.counters()["t.rows"] - base == 15
    # counters keep a tally of their own, apart from the dispatches
    assert probe.counts() == {"t.entry": 1}
    assert "t.rows" not in dispatch.counts()
    assert "t.entry" not in dispatch.counters()
    # host syncs are counted on CUDA only
    with dispatch.span("s") as s:
        dispatch.count_syncs(torch.device("cpu"), 3)
        dispatch.count_syncs(torch.device("cuda"), 4)
    assert s.counts == {"host_syncs": 4}


def test_the_ring_keeps_the_last_ring_spans():
    first = None
    for i in range(dispatch.RING + 5):
        with dispatch.span(f"r{i}") as s:
            first = first or s
    snap = dispatch.snapshot()
    assert len(snap) == dispatch.RING
    assert first not in snap
    assert snap[0].name == "r5" and snap[-1] is s


def test_a_step_opens_the_eight_spans_in_order():
    engine, queries = _engine("cpu")
    group = queries[:BATCH]
    results = engine._step_batch(group, None, None)
    step = next(s for s in reversed(dispatch.snapshot())
                if s.name == "engine.step")
    spans = sorted(_step_spans(step), key=lambda s: s.start_ns)
    assert tuple(s.name for s in spans) == STEP_SPANS
    by_name = {s.name: s for s in spans}
    for name, up in PARENT.items():
        assert by_name[name].parent == by_name[up].id, name
    for a, b in zip(spans[1:], spans[2:]):
        if a.parent == b.parent:                # siblings do not overlap
            assert a.end_ns <= b.start_ns
    # the first step meets an empty cache: every query is rejected
    rejects = sum(not acc for _, acc, _ in results)
    assert rejects == BATCH
    # nothing syncs on the CPU
    assert not any(s.counts for s in spans)
    # the same queries again: accepts (no cloud stage and no ingest where
    # all are accepted)
    results = engine._step_batch(group, None, None)
    again = next(s for s in reversed(dispatch.snapshot())
                 if s.name == "engine.step")
    assert again.step == step.step + 1
    rejects = sum(not acc for _, acc, _ in results)
    assert rejects < BATCH
    names = [s.name for s in _step_spans(again)]
    for name in ("cloud", "cloud.scan", "cloud.readback", "ingest"):
        assert names.count(name) == (1 if rejects else 0), name


def test_spans_appear_in_a_profiler_trace(tmp_path):
    engine, queries = _engine("cpu")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine._step_batch(queries[:BATCH], None, None)
    step = next(s for s in reversed(dispatch.snapshot())
                if s.name == "engine.step")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    events = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            events.setdefault(e["name"], []).append(e)
    spans = _step_spans(step)
    assert sorted(s.name for s in spans) == sorted(STEP_SPANS)
    by_id = {s.id: s for s in spans}
    for s in spans:
        (e,) = events[s.name]
        assert abs(float(e["dur"]) - s.ns / 1000) < 1000, s.name
        if s.parent in by_id:            # a child's range lies in its parent's
            (up,) = events[by_id[s.parent].name]
            assert float(up["ts"]) <= float(e["ts"])
            assert float(e["ts"]) + float(e["dur"]) \
                <= float(up["ts"]) + float(up["dur"]), s.name


def test_the_benchmark_harness_still_captures_the_drafts():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from perfbench.harness import Driver
    engine, queries = _engine("cpu")
    stream = SimpleNamespace(emb=np.stack([q["emb"] for q in queries]))
    drv = Driver(engine, stream, BATCH, 10, torch.device("cpu"))
    try:
        logs = [drv.step("window") for _ in range(3)]
    finally:
        drv.close()
    assert logs[-1].accept.any()
    for log in logs:
        assert log.val_ids is not None
        assert tuple(log.val_ids.shape) == (BATCH, 10)
        acc = log.accept
        # an accepted query is served its validated draft
        np.testing.assert_array_equal(log.served[acc],
                                      log.val_ids.numpy()[acc])
    steps = [s for s in dispatch.snapshot() if s.name == "engine.step"][-3:]
    for log, s in zip(logs, steps):
        assert log.t_admit <= s.start_ns * 1e-9 <= s.end_ns * 1e-9 \
            <= log.t_done


@pytest.mark.cuda
def test_host_syncs_match_the_sync_debug_warnings():
    """Every synchronizing operation of a step on the card is counted, and
    nothing else: each warning of PyTorch's sync debug mode, and each call
    of ``torch.cuda.synchronize``, is one ``host_syncs``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    engine, queries = _engine("cuda")
    for i in range(2):                       # warm the kernels and the cache
        engine._step_batch(queries[i * BATCH:(i + 1) * BATCH], None, None)
    calls = {"n": 0}
    real = torch.cuda.synchronize

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    torch.cuda.synchronize = counted
    before = dispatch.counters().get("host_syncs", 0)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                results = engine._step_batch(queries[2 * BATCH:3 * BATCH],
                                             None, None)
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.cuda.synchronize = real
    # the sync debug mode warns of a device-wide synchronize once a
    # process, so those calls are counted apart
    synced = [w for w in caught if "synchroniz" in str(w.message)
              and not w.filename.endswith("torch/cuda/__init__.py")]
    counted_here = dispatch.counters()["host_syncs"] - before
    step = next(s for s in reversed(dispatch.snapshot())
                if s.name == "engine.step")
    in_spans = sum(s.counts.get("host_syncs", 0) for s in _step_spans(step))
    rejects = sum(not acc for _, acc, _ in results)
    assert rejects > 0
    where = collections.Counter(f"{w.filename}:{w.lineno}" for w in synced)
    assert counted_here == in_spans
    assert calls["n"] == 2
    assert len(synced) + calls["n"] == counted_here, where
    # the ingest: one upload of the chunk, and the fold's launches, which
    # the host does not wait for
    (ingest,) = [s for s in _step_spans(step) if s.name == "ingest"]
    assert ingest.counts["host_syncs"] == 1
    assert ingest.counts["fold_rows"] == rejects
