"""The readers of the program's own spans and counters
(``metrics/engine.self_ms.py`` and the six beside it) on hand-built spans
against a synthetic run: the window's micro-batches are read, the fill's
and the traced ones are not, and a program that records no spans (the
parent of the recorder) reads as nothing."""
from __future__ import annotations

import itertools

import numpy as np
import pytest

from conftest import ROOT
from perfbench import harness
from repro_torch.core import dispatch

MS = 1_000_000                      # ns
T0 = 5_000 * 10**9                  # the run's first stamp, ns
NAMES = ("engine.self_ms", "engine.ready_p95_ms", "spec.wall_ms",
         "cloud.wall_ms", "cloud.launch_ms", "ingest.wall_ms",
         "ingest.host_syncs")


def _reader(name):
    return harness.Bench(ROOT).reader(name)


class _Run:
    """Spans laid out micro-batch by micro-batch, and the window's logs."""

    def __init__(self):
        self.spans, self.window = [], []
        self.ids, self.steps = itertools.count(1), itertools.count(1)
        self.t = T0

    def _span(self, name, start, end, parent, step, **counts):
        s = dispatch.Span(name)
        s.start_ns, s.end_ns = start, end
        s.id, s.parent, s.step, s.counts = next(self.ids), parent, step, counts
        self.spans.append(s)
        return s

    def step(self, window, accept, spec, cloud=None, ingest=None, own=1,
             syncs=0):
        """One micro-batch: ``own`` ms of the step's own time first, then
        ``spec`` ms of speculation and 1 ms of readback, ``cloud`` (scan,
        readback) ms where it has rejects, ``ingest`` ms holding a span of
        1 ms inside it (``syncs`` split 4 : 1 between them), 2 ms of
        results."""
        step = next(self.steps)
        t_admit = self.t
        t = start = t_admit + MS // 2
        kids = []

        def after(name, ms, **counts):
            nonlocal t
            kids.append((name, t, t + int(ms * MS), counts))
            t += int(ms * MS)
            return kids[-1]
        t += int(own * MS)
        after("spec", spec)
        after("spec.readback", 1)
        if cloud:
            after("cloud", sum(cloud))
        if ingest:
            after("ingest", ingest)
        after("engine.respond", 2)
        top = self._span("engine.step", start, t, None, step)
        for name, a, b, counts in kids:
            s = self._span(name, a, b, top.id, step, **counts)
            if name == "cloud":
                scan = a + int(cloud[0] * MS)
                self._span("cloud.scan", a, scan, s.id, step)
                self._span("cloud.readback", scan, b, s.id, step)
            if name == "ingest":
                s.counts = {"host_syncs": syncs * 4 // 5, "other": 3}
                self._span("ingest.inner", a + MS, a + 2 * MS, s.id, step,
                           host_syncs=syncs - syncs * 4 // 5)
        self.t = t + MS // 2
        if window:
            acc = np.asarray(accept, bool)
            self.window.append(harness.StepLog(
                first=0, t_admit=t_admit * 1e-9, t_done=self.t * 1e-9,
                accept=acc, served=np.zeros((len(acc), 10), np.int32),
                answered=len(acc), val_ids=None, phase="window"))
        return top

    def record(self):
        return harness.RunRecord(cell={}, config={}, traffic={},
                                 window=self.window,
                                 window_s=(self.t - T0) * 1e-9, setup_s=0.0,
                                 peak_bytes=0)


def _read_all(monkeypatch, run):
    monkeypatch.setattr(dispatch, "snapshot", lambda: list(run.spans))
    rec = run.record()
    return {name: _reader(name)(rec) for name in NAMES}


def test_the_readers_read_the_window_alone(monkeypatch):
    run = _Run()
    far = dict(spec=90, cloud=(70, 90), ingest=80, own=60, syncs=900)
    run.step(False, [0, 0, 0, 0], **far)                  # the fill
    run.step(True, [1, 1, 0, 0], spec=4, cloud=(10, 30), ingest=8, own=1,
             syncs=100)
    run.step(True, [1, 1, 1, 1], spec=5, own=2)           # no rejects
    run.step(True, [1, 0, 0, 0], spec=6, cloud=(12, 40), ingest=10, own=3,
             syncs=140)
    run.step(True, [1, 1, 1, 0], spec=3, cloud=(14, 20), ingest=6, own=4,
             syncs=120)
    run.step(False, [0, 0, 0, 0], **far)                  # traced
    got = _read_all(monkeypatch, run)
    assert got["spec.wall_ms"] == pytest.approx(4.5)       # 3, 4, 5, 6
    assert got["cloud.wall_ms"] == pytest.approx(40)       # 34, 40, 52
    assert got["cloud.launch_ms"] == pytest.approx(12)     # 10, 12, 14
    assert got["ingest.wall_ms"] == pytest.approx(8)       # 6, 8, 10
    assert got["ingest.host_syncs"] == 120                 # the ingest and
    #                                                        the span inside
    assert got["engine.self_ms"] == pytest.approx(2.5)     # 1, 2, 3, 4
    # ready stamps from admission: 0.5 ms ahead of the step, its own time,
    # speculation and readback; a reject adds its cloud stage
    ready = ([0.5 + 1 + 4 + 1] * 2 + [0.5 + 1 + 4 + 1 + 40] * 2
             + [0.5 + 2 + 5 + 1] * 4
             + [0.5 + 3 + 6 + 1] + [0.5 + 3 + 6 + 1 + 52] * 3
             + [0.5 + 4 + 3 + 1] * 3 + [0.5 + 4 + 3 + 1 + 34])
    assert got["engine.ready_p95_ms"] == pytest.approx(
        float(np.percentile(ready, 95)))
    # the stamps lie inside each step, so under the step's own p95
    p95 = _reader("p95_ms")(run.record())
    assert got["engine.ready_p95_ms"] < p95


def test_a_window_without_rejects_reads_no_cloud_or_ingest(monkeypatch):
    run = _Run()
    run.step(True, [1, 1], spec=4)
    run.step(True, [1, 1], spec=6)
    got = _read_all(monkeypatch, run)
    assert got["spec.wall_ms"] == pytest.approx(5)
    assert got["engine.ready_p95_ms"] is not None
    for name in ("cloud.wall_ms", "cloud.launch_ms", "ingest.wall_ms",
                 "ingest.host_syncs"):
        assert got[name] is None, name


def test_no_spans_read_as_nothing(monkeypatch):
    run = _Run()
    run.step(False, [0, 1], spec=4, cloud=(1, 2), ingest=3, syncs=5)
    run.step(True, [0, 1], spec=4, cloud=(1, 2), ingest=3, syncs=5)
    rec = run.record()
    # spans of no window micro-batch
    monkeypatch.setattr(dispatch, "snapshot", lambda: run.spans[:9])
    assert all(_reader(n)(rec) is None for n in NAMES)
    # a program that records none
    monkeypatch.setattr(dispatch, "snapshot", lambda: [])
    assert all(_reader(n)(rec) is None for n in NAMES)
    # a program without the recorder
    monkeypatch.delattr(dispatch, "snapshot")
    assert all(_reader(n)(rec) is None for n in NAMES)
