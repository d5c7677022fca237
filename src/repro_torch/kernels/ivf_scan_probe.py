"""Where an ``ivf_scan`` call's device time goes, and the measurements
behind its plan and register limits.

    PYTHONPATH=src python -m repro_torch.kernels.ivf_scan_probe

Needs an NVIDIA card and nvcc.  The shapes are the main paths': f32 8192
buckets of 123 slots probed 64 at a time (the fuzzy channel), int8 1024
buckets of 977 probed 32 at a time (the hybrid cloud stage), d=768, k=10,
half the slots pads, data from a seed.  Device times are the profiler's,
the L2 warm (the calls repeat).  It prints the card's name and power limit,
then:

1. ``plan``: B=1 and B=64 in both modes with ``CTAS_PER_SM`` at 8, 16, 32
   and 64 (``plan_ranges``' rule);
2. ``bounds``: the kernel rebuilt with every route held to 1 (no limit), 3
   and 4 CTAs per SM by ``__launch_bounds__``, beside the source as it is:
   registers by route and the four times;
3. ``trace``: the kernel rebuilt with ``-DIVF_SCAN_TRACE``; each CTA's
   %globaltimer stamps (about 0.26 us apart at the finest) give every
   phase's time at B=1, k=10 and k=1.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ivf_scan as ivf

BOUNDS_LINE = "__launch_bounds__(kThreads, kRoute >= kI8Wide ? 4 : 1)"
PHASES = ("init", "phase A (ids, q)", "phase B (rows)", "select",
          "list write", "arrive", "stage lists", "merge level 1",
          "merge level 2", "id lookup")


def _device_us(fn, reps: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if "ivf_range_kernel" in e.key) / reps


def _cases(dev):
    """(name, call) at B=1 and B=64 in both modes, data from seed 0."""
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for mode, (c, cap, p) in (("f32", (8192, 123, 64)),
                              ("int8", (1024, 977, 32))):
        ids = torch.randperm(c * cap, device=dev, generator=g).int() \
            .reshape(c, cap)
        ids[torch.rand(c, cap, device=dev, generator=g) < 0.5] = -1
        if mode == "f32":
            vecs = torch.randn(c, cap, 768, device=dev, generator=g)
            vecs /= vecs.norm(dim=-1, keepdim=True)
            scales = None
        else:
            vecs = torch.randint(-127, 128, (c, cap, 768), device=dev,
                                 generator=g, dtype=torch.int8)
            scales = torch.rand(c, cap, 2, device=dev, generator=g) * 1e-3
        for b in (1, 64):
            q = torch.randn(b, 768, device=dev, generator=g)
            q /= q.norm(dim=-1, keepdim=True)
            pr = torch.stack([torch.randperm(c, device=dev, generator=g)[:p]
                              for _ in range(b)]).int()
            bias = (torch.randn(b, p, device=dev, generator=g)
                    if scales is not None else None)
            cases.append((f"{mode} B={b}", q, pr, vecs, ids, scales, bias))
    return cases


def _times(cases, k: int = 10) -> str:
    return "; ".join(
        f"{name} {_device_us(lambda: ivf.ivf_scan(q, pr, v, i, k, s, bs)):.2f}"
        for name, q, pr, v, i, s, bs in cases)


def _trace(lib, cases, k: int) -> None:
    for name, q, pr, v, i, s, bs in cases:
        if "B=1" not in name:
            continue
        for _ in range(3):
            ivf.ivf_scan(q, pr, v, i, k, s, bs)
        torch.cuda.synchronize()
        n_ranges = ivf.plan_ranges(1, pr.shape[1], v.shape[1], k,
                                   _build.sm_count(q.device))
        marks = len(PHASES) + 1
        buf = (ctypes.c_ulonglong * (n_ranges * marks))()
        _build.check(lib.has_ivf_scan_trace(buf, n_ranges * marks), "trace")
        t = torch.tensor(list(buf), dtype=torch.float64) \
            .reshape(n_ranges, marks) / 1e3
        t -= t[:, 0].min()
        last = int(t[:, 6].argmax())
        row = []
        for m in range(1, marks):
            if m <= 5:                       # every CTA: median of its phase
                d = float((t[:, m] - t[:, m - 1]).median())
                row.append(f"{PHASES[m - 1]} {d:.2f} (all by "
                           f"{float(t[:, m].max()):.2f})")
            else:                            # the last CTA's merge
                row.append(f"{PHASES[m - 1]} "
                           f"{float(t[last, m] - t[last, m - 1]):.2f}")
        print(f"trace {name} k={k}, L={n_ranges}, us: " + "; ".join(row)
              + f"; end {float(t[last, marks - 1]):.2f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ivf_scan_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = (_build.CSRC / "ivf_scan.cu").read_text()
    if src.count(BOUNDS_LINE) != 1:
        raise RuntimeError(f"ivf_scan.cu no longer has {BOUNDS_LINE!r}")
    variants = {"as is": (src, []), "traced": (src, ["-DIVF_SCAN_TRACE"])}
    for n in (1, 3, 4):
        variants[f"every route {n} CTA(s) per SM"] = (src.replace(
            BOUNDS_LINE, f"__launch_bounds__(kThreads, {n})"), [])
    libs = _build.build_variants("ivf_scan", variants,
                                 _build.BUILD_ROOT / "probe")
    cases = _cases(dev)
    saved = ivf.CTAS_PER_SM
    try:
        _build._libs["ivf_scan"] = libs["as is"][0]
        for cps in (8, 16, 32, 64):
            ivf.CTAS_PER_SM = cps
            ivf.plan_ranges.cache_clear()
            print(f"plan CTAS_PER_SM={cps}: device us: {_times(cases)}",
                  flush=True)
        ivf.CTAS_PER_SM = saved
        ivf.plan_ranges.cache_clear()
        for name, (lib, log) in libs.items():
            if name == "traced":
                continue
            regs = [ln.split("Used ")[1].split(" registers")[0]
                    for ln in log.splitlines() if "registers" in ln]
            _build._libs["ivf_scan"] = lib
            print(f"bounds {name}: registers by route (last to first) "
                  f"{regs}; device us: {_times(cases)}", flush=True)
        lib = libs["traced"][0]
        _build._libs["ivf_scan"] = lib
        for k in (10, 1):
            _trace(lib, cases, k)
    finally:
        ivf.CTAS_PER_SM = saved
        ivf.plan_ranges.cache_clear()
        _build._libs.pop("ivf_scan", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
