"""Where a ``lexical_score`` call's device time goes, and how its grid
changes it.

    PYTHONPATH=src python -m repro_torch.kernels.lexical_score_probe

Needs an NVIDIA card and nvcc.  The shape is the hybrid cloud stage's:
world postings of 500,000 rows (100,000 entities of 5 passages, 5 terms a
row), world queries (T=2), k=10, 512-row tiles, data from a seed.  It
prints the card's name and power limit, then:

1. ``device``: at B=1 and B=64, the median call time (CUDA events, host
   gaps included), the kernel's device time per call (``torch.profiler``)
   with the L2 cache warm and with it cleared before each call (as on the
   hybrid path), and the launches per call;
2. ``grid``: the device time of a call with no query terms (the stream,
   an empty table and the ticket alone), then at other persistent grids
   (CTAs) than :func:`~repro_torch.kernels.lexical_score.plan_grid` picks;
3. ``trace`` (L2 warm, then cleared before each call): the kernel rebuilt
   with ``-DLEXICAL_TRACE``; thread 0 of
   each CTA stamps %globaltimer (see ``csrc/lexical_score.cu``), and each
   figure is the median over 30 calls of: the CTAs' last start, the table
   build and thread 0's first probe loop (medians over the CTAs), the sum
   of a CTA's probes, the CTAs that took the slow path and their
   selection, the CTAs' loop end (median and last), the ticket after the
   last one, the last CTA's scoring and ordering of the list, query 0's
   replay, all queries' replay, and the end, all in us from the first
   CTA's start.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import lexical_score as ls
from repro_torch.retrieval.lexical import build_doc_terms, query_terms

K, ENTITIES, TRACE_CALLS = 10, 100_000, 30
MARKS = 14


def world(dev, seed: int = 1):
    """(doc_terms, doc_weights) [500,000, 5] and a query maker, on dev."""
    rng = np.random.default_rng(seed)
    doc_entity = np.repeat(np.arange(ENTITIES), 5)
    mask = np.zeros((5 * ENTITIES, 12), bool)
    for _ in range(4):
        mask[np.arange(5 * ENTITIES), rng.integers(0, 12, 5 * ENTITIES)] = \
            True
    dt, dw = build_doc_terms(doc_entity, mask, width=5)

    def queries(b):
        qs = [query_terms(int(e), int(a)) for e, a in
              zip(rng.integers(0, ENTITIES, b), rng.integers(0, 12, b))]
        return (torch.as_tensor(np.stack([t for t, _ in qs]), device=dev),
                torch.as_tensor(np.stack([w for _, w in qs]), device=dev))

    return (torch.as_tensor(dt, device=dev), torch.as_tensor(dw, device=dev),
            queries)


def device_per_call(fn, reps: int = 20,
                    flush: torch.Tensor | None = None) -> tuple[float, float]:
    """(the kernel's device us per call, its launches per call) from the
    profiler, after one warm call; with ``flush``, that buffer is cleared
    before each call, so the call finds the L2 cache cold (as on the
    hybrid path, where other kernels run between two calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = launches = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "lexical_kernel" in e.key:
            t = getattr(e, "self_device_time_total", None)
            us += (e.self_cuda_time_total if t is None else t) / reps
            launches += e.count / reps
    return us, launches


def call_ms(fn, reps: int = 50) -> float:
    """Median time of one call between CUDA events (host gaps included)."""
    for _ in range(3):
        fn()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def with_grid(ctas: int):
    """A plan_grid that returns ``ctas`` CTAs, for the sweep."""
    def planned(n_tiles, tile_n, sms):
        return min(ctas, n_tiles)
    return planned


def build_traced() -> ctypes.CDLL:
    """lexical_score.cu built with -DLEXICAL_TRACE."""
    src = (_build.CSRC / "lexical_score.cu").read_text()
    lib, _ = _build.build_variants(
        "lexical_score", {"traced": (src, ["-DLEXICAL_TRACE"])},
        _build.BUILD_ROOT / "probe")["traced"]
    lib.has_lexical_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.has_lexical_trace.restype = ctypes.c_int
    return lib


def trace(lib: ctypes.CDLL, call, ctas: int,
          flush: torch.Tensor | None = None) -> dict[str, float]:
    """The traced phases of ``call`` (module docstring), us; with
    ``flush``, that buffer is cleared before each call."""
    saved = dict(_build._libs), dict(_build._entries)
    _build._libs["lexical_score"] = lib
    _build._entries.pop(("lexical_score", "has_lexical_score"), None)
    per: dict[str, list[float]] = {}
    n = min(ctas, 1024)
    try:
        for i in range(TRACE_CALLS + 3):
            if flush is not None:
                flush.zero_()
            call()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (n * MARKS))()
            _build.check(lib.has_lexical_trace(buf, n * MARKS),
                         "lexical_score trace")
            if i < 3:
                continue
            t = torch.tensor(list(buf), dtype=torch.float64) \
                .reshape(n, MARKS)
            t0 = t[:, 0].min()
            last = int(t[:, 4].argmax())           # the CTA that merged
            slow = t[:, 6] > 0                     # took the slow path
            row = {
                "start skew (last)": (t[:, 0] - t0).max() / 1e3,
                "table": (t[:, 1] - t[:, 0]).median() / 1e3,
                "thread 0's probe loop": (t[:, 9] - t[:, 1]).median() / 1e3,
                "probes (sum)": t[:, 5].median() / 1e3,
                "CTAs on the slow path": float(slow.sum()),
                "their selection": t[slow, 6].median() / 1e3
                if slow.any() else 0.0,
                "loop end (median)": (t[:, 3] - t0).median() / 1e3,
                "loop end (last)": (t[:, 3] - t0).max() / 1e3,
                "ticket": (t[last, 4] - t[:, 3].max()) / 1e3,
                "list scored": (t[last, 11] - t[last, 4]) / 1e3,
                "groups": (t[last, 12] - t[last, 11]) / 1e3,
                "query 0 replayed": (t[last, 13] - t[last, 12]) / 1e3,
                "replay": (t[last, 8] - t[last, 12]) / 1e3,
                "end": (t[last, 8] - t0) / 1e3}
            for key, v in row.items():
                per.setdefault(key, []).append(float(v))
    finally:
        _build._libs.clear()
        _build._libs.update(saved[0])
        _build._entries.clear()
        _build._entries.update(saved[1])
    return {key: statistics.median(v) for key, v in per.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("lexical_score_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dt, dw, queries = world(dev)
    sms = _build.sm_count(dev)
    n_tiles = -(-dt.shape[0] // 512)
    batches = {b: queries(b) for b in (1, 64)}
    flush = torch.empty(32 * 1024 * 1024, device=dev)       # 128 MB
    for b, (qt, qw) in batches.items():
        def call():
            return ls.lexical_score(qt, qw, dt, dw, K)
        us, launches = device_per_call(call)
        cold, _ = device_per_call(call, flush=flush)
        print(f"device B={b}: call {call_ms(call):.4f} ms; {launches:.0f} "
              f"launches per call; device {us:.2f} us per call, {cold:.2f} "
              f"us with the L2 cache cleared before each; "
              f"{ls.plan_grid(n_tiles, 512, sms)} CTAs", flush=True)
    # no query terms: the stream, an empty table and the ticket alone
    qt0 = torch.empty((1, 0), dtype=torch.int32, device=dev)
    us0, _ = device_per_call(lambda: ls.lexical_score(
        qt0, qt0.float(), dt, dw, K))
    cold0, _ = device_per_call(lambda: ls.lexical_score(
        qt0, qt0.float(), dt, dw, K), flush=flush)
    print(f"device, no query terms (the stream and the ticket): {us0:.2f} "
          f"us per call, {cold0:.2f} us with the L2 cache cleared",
          flush=True)
    plan = ls.plan_grid
    try:
        for ctas in (132, 196, 264, 489, 977):
            ls.plan_grid = with_grid(ctas)
            us = [device_per_call(lambda: ls.lexical_score(
                qt, qw, dt, dw, K))[0] for qt, qw in batches.values()]
            print(f"grid {ctas} CTAs: device B=1 {us[0]:.2f} us, B=64 "
                  f"{us[1]:.2f} us", flush=True)
        ls.plan_grid = plan
        lib = build_traced()
        batches[0] = (qt0, qt0.float())
        for b, (qt, qw) in batches.items():
            for tag, fl in (("", None), (", L2 cleared", flush)):
                ph = trace(lib, lambda: ls.lexical_score(qt, qw, dt, dw, K),
                           plan(n_tiles, 512, sms), fl)
                print(f"trace B={b}{tag}, N=500000, L=5, T={qt.shape[1]}, "
                      f"k={K}, us: " + "; ".join(f"{k} {v:.3f}"
                                                for k, v in ph.items()),
                      flush=True)
    finally:
        ls.plan_grid = plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
