"""Where a ``fused_rerank`` call's device time goes, phase by phase.

    PYTHONPATH=src python -m repro_torch.kernels.fused_rerank_probe

Needs an NVIDIA card and nvcc.  The shape is the hybrid cloud stage's:
a pool of P = 20 slots (10 dense, 10 lexical; three cross-channel
duplicates, two empty lexical slots, one near-duplicate pair), d = 768,
RRF k = 60, diversify 0.98, data from a seed.  It prints the card's name
and power limit, then:

1. ``device``: at B=1 and B=64, the median call time (CUDA events, host
   gaps included), the device time of every kernel the call launches
   (``torch.profiler``, L2 warm) and the launches per call;
2. ``trace``: the kernel rebuilt with ``-DFUSED_RERANK_TRACE``; thread 0
   of each CTA stamps %globaltimer after a barrier at the end of each
   phase (the phases are named by the source), so each phase's median
   time over 50 calls at B=1 (and over the CTAs at B=64).  The barriers
   and stamps add a little to each phase; %globaltimer ticks in steps of
   tens of nanoseconds.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fused_rerank as fr

K, POOL, D, DSIM = 10, 20, 768, 0.98
TRACE_CALLS = 50


def pools(b: int, dev, g: torch.Generator, p: int = POOL, d: int = D):
    """(q [B,d], ids [B,p], vecs [B,p,d]) of the cloud stage's shape: a
    dense list of p/2, a lexical list of p/2 with three ids of the dense
    list and two empty slots, unit vectors, slots 6 and 7 near-duplicates
    (each where p allows)."""
    kd = p // 2

    def unit(*shape):
        x = torch.randn(*shape, d, device=dev, generator=g)
        return x / x.norm(dim=-1, keepdim=True)

    ids = torch.stack([torch.randperm(3000, device=dev, generator=g)[:p]
                       for _ in range(b)]).int()
    if kd >= 5:
        ids[:, kd:kd + 3] = ids[:, 2:5]            # cross-channel duplicates
    if p >= 4:
        ids[:, -2:] = -1                           # lexical found fewer
    vecs = unit(b, p)
    if p >= 8:
        vecs[:, 7] = vecs[:, 6] + 0.02 * unit(b)   # near-duplicates
        vecs[:, 7] /= vecs[:, 7].norm(dim=-1, keepdim=True)
    vecs[ids < 0] = 0.0
    return unit(b), ids, vecs


def device_per_call(fn, reps: int = 20) -> tuple[dict[str, float], float]:
    """({kernel: device us per call}, launches per call) from the
    profiler, after one warm call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times, launches = {}, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        t = e.self_cuda_time_total if t is None else t
        if t > 0:
            times[e.key[:60]] = t / reps
            launches += e.count / reps
    return times, launches


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


def build_traced() -> ctypes.CDLL:
    """fused_rerank.cu built with -DFUSED_RERANK_TRACE."""
    src = (_build.CSRC / "fused_rerank.cu").read_text()
    lib, _ = _build.build_variants(
        "fused_rerank", {"traced": (src, ["-DFUSED_RERANK_TRACE"])},
        _build.BUILD_ROOT / "probe")["traced"]
    lib.has_fused_rerank_trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.has_fused_rerank_trace.restype = ctypes.c_int
    lib.has_fused_rerank_trace_phases.restype = ctypes.c_char_p
    return lib


def trace_phases(lib: ctypes.CDLL, dev, b: int = 1) -> dict[str, float]:
    """Median us of each traced phase of ``lib``'s kernel at batch ``b``
    (over TRACE_CALLS calls and, at b > 1, over the CTAs), and "end": the
    median time from the first stamp to the last."""
    phases = lib.has_fused_rerank_trace_phases().decode().split(",")
    marks = len(phases) + 1
    q, ids, vecs = pools(b, dev, torch.Generator(device=dev).manual_seed(0))
    saved = _build._libs.get("fused_rerank")
    _build._libs["fused_rerank"] = lib
    per = {name: [] for name in (*phases, "end")}
    try:
        for _ in range(TRACE_CALLS + 3):
            fr.fused_rerank(q, ids, vecs, K, K, 60.0, DSIM)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (b * marks))()
            _build.check(lib.has_fused_rerank_trace(buf, b * marks),
                         "fused_rerank trace")
            t = torch.tensor(list(buf), dtype=torch.float64) \
                .reshape(b, marks) / 1e3
            for m, name in enumerate(phases):
                per[name].extend((t[:, m + 1] - t[:, m]).tolist())
            per["end"].extend((t[:, -1] - t[:, 0]).tolist())
    finally:
        if saved is None:
            _build._libs.pop("fused_rerank", None)
        else:
            _build._libs["fused_rerank"] = saved
    skip = 3 * b                                   # the warm-up calls
    return {name: statistics.median(v[skip:]) for name, v in per.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_rerank_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device=dev).manual_seed(1)
    for b in (1, 64):
        q, ids, vecs = pools(b, dev, g)

        def call():
            return fr.fused_rerank(q, ids, vecs, K, K, 60.0, DSIM)

        times, launches = device_per_call(call)
        print(f"device B={b}: call {call_ms(call):.4f} ms; {launches:.0f} "
              f"launches per call; device us per call "
              f"{ {k: round(v, 2) for k, v in times.items()} }", flush=True)
    lib = build_traced()
    for b in (1, 64):
        ph = trace_phases(lib, dev, b)
        print(f"trace B={b}, P={POOL}, d={D}, diversify {DSIM}, us: "
              + "; ".join(f"{k} {v:.3f}" for k, v in ph.items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
