"""Spans around the program's layer entries, and the reading of a profiler
trace into device time by span.

In a traced run only, ``spans`` wraps, from the benchmark's side, each
entry that a micro-batch reaches in a ``torch.profiler.record_function``
range (``RANGES``; the service's ``full_search_batch`` is ``pb.cloud``, and
the harness puts ``pb.step`` around each micro-batch).  A device operation
belongs to every range whose host interval holds the runtime call that
launched it (matched by the trace's correlation id); an operation whose
launch the trace lacks belongs to the ranges whose device projection holds
its start.  Nothing here edits the program.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import importlib
import json
import os
import tempfile
import time

import torch

RANGES = {
    "pb.spec": ("repro_torch.serving.batched", "speculate_batch"),
    "pb.ingest": ("repro_torch.serving.batched", "cache_update_chunked"),
    "pb.cache_topk": ("repro_torch.core.has", "topk_search_op"),
    "pb.fuzzy_scan": ("repro_torch.core.has", "ivf_scan_op"),
    "pb.validate": ("repro_torch.core.has", "homology_validate_op"),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARGIN_S = 0.02      # host time at each end of a traced window (Kineto drops
                     # device records that fall outside its capture window)


def _ranged(name, fn):
    def wrapper(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)
    return wrapper


@contextlib.contextmanager
def spans(service):
    """Install the ranges, and the cloud range on ``service``."""
    saved = []
    try:
        for name, (mod, attr) in RANGES.items():
            m = importlib.import_module(mod)
            saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, _ranged(name, getattr(m, attr)))
        service.full_search_batch = _ranged("pb.cloud",
                                            service.full_search_batch)
        yield
    finally:
        for m, attr, fn in reversed(saved):
            setattr(m, attr, fn)
        service.__dict__.pop("full_search_batch", None)


@dataclasses.dataclass
class TraceSummary:
    steps: int
    window_s: float                 # host clock over the traced steps
    busy_s: float                   # union of device operations
    range_s: dict                   # device seconds by range
    range_ops: dict                 # device operations by range
    device_ops: list                # [[name, seconds]] largest first
    idle_gaps: list                 # [[host range, seconds]] largest first


def profile_steps(step, n_steps: int, service) -> TraceSummary:
    """Run ``step()`` ``n_steps`` times under the profiler with the spans
    on, each in a ``pb.step`` range, and read the trace."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with spans(service), profile(activities=acts) as prof:
        time.sleep(MARGIN_S)
        t0 = time.perf_counter()
        for _ in range(n_steps):
            with torch.profiler.record_function("pb.step"):
                step()
        t1 = time.perf_counter()
        time.sleep(MARGIN_S)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return summarize(events, n_steps, t1 - t0)


def _spans_of(events, cat):
    out = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
            e["name"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == cat
           and str(e.get("name", "")).startswith("pb.")]
    return sorted(out)


class _Index:
    """Nested ranges, looked up by time through the ``pb.step`` ranges."""

    def __init__(self, ranges):
        self.steps = [r for r in ranges if r[2] == "pb.step"]
        self.starts = [r[0] for r in self.steps]
        self.inner = [[r for r in ranges if s[0] <= r[0] and r[1] <= s[1]]
                      for s in self.steps]

    def holding(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0 or t > self.steps[i][1]:
            return []
        return [r for r in self.inner[i] if r[0] <= t <= r[1]]


def summarize(events, n_steps: int, window_s: float) -> TraceSummary:
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch.setdefault(corr, float(e["ts"]))
    host = _Index(_spans_of(events, "user_annotation"))
    gpu = _Index(_spans_of(events, "gpu_user_annotation"))
    range_s = collections.Counter()
    range_ops = collections.Counter()
    by_name = collections.Counter()
    intervals = []
    for e in dev:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        intervals.append((ts, ts + dur))
        by_name[str(e.get("name", ""))[:90]] += dur
        t = launch.get((e.get("args") or {}).get("correlation"))
        held = host.holding(t) if t is not None else gpu.holding(ts)
        for name in {r[2] for r in held}:
            range_s[name] += dur * 1e-6
            range_ops[name] += 1
    gaps = collections.Counter()
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    edges = ([(host.steps[0][0], host.steps[0][0])] if host.steps else []) \
        + [tuple(m) for m in merged] \
        + ([(host.steps[-1][1], host.steps[-1][1])] if host.steps else [])
    for (_, end), (start, _) in zip(edges, edges[1:]):
        if start > end:
            held = host.holding((start + end) / 2)
            inner = min(held, key=lambda r: r[1] - r[0])[2] if held \
                else "between steps"
            gaps[inner] += (start - end) * 1e-6
    return TraceSummary(
        steps=n_steps, window_s=window_s, busy_s=busy,
        range_s=dict(range_s), range_ops=dict(range_ops),
        device_ops=[[n, t * 1e-6] for n, t in by_name.most_common(10)],
        idle_gaps=[[n, t] for n, t in gaps.most_common(10)])
