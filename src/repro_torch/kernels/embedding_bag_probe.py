"""Where an ``embedding_bag`` call's device time goes, stage by stage.

    PYTHONPATH=src python -m repro_torch.kernels.embedding_bag_probe

Needs an NVIDIA card and nvcc.  The shapes are the repo's Criteo tables
(deepfm: 39 fields of 35,062,784 x 10 f32 rows; dlrm-rm2: 26 fields of
33,762,816 x 64), B=512, int32 ids uniform within each field, data from a
seed.  It prints the card's name and power limit, then for each table the
device time per call (``torch.profiler``, median of 5 windows of 20
calls), with the L2 cache warm and with it cleared before each call (as on
the lookup path, where each batch names fresh rows), of
``csrc/embedding_bag.cu`` built whole and cut short after each stage:

- ``launch``: the kernel returns at once (same grid, same shared memory);
- ``ids``: the bag's ids and weights loaded and staged;
- ``rows``: every row gather of the bag landed in shared memory;
- ``whole``: the slot-order sum and the store too (the shipped kernel).

Each cut version stores one value that depends on what it loaded, so the
loads are not optimised away.  The difference between two stages is what
that stage adds to a call.
"""
from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from repro_torch.kernels import _build

CRITEO_VOCABS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145,
                 5683, 8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4,
                 7046547, 18, 15, 286181, 105, 142572)
TABLES = {"deepfm": (CRITEO_VOCABS + (100_000,) * 13, 10),
          "dlrm-rm2": (CRITEO_VOCABS, 64)}
BATCH = 512

# Text inserted into the kernel's source to cut it short after a stage:
# (the line it follows, what is inserted).
_AFTER_SMEM = "  extern __shared__ __align__(16) unsigned char smem[];\n"
_AFTER_IDS = "      w_s[j] = bw ? bw[j0 + j] : 1.0f;\n    }\n    __syncwarp();\n"
_AFTER_ROWS = ('    if constexpr (W != 2) asm volatile("cp.async.wait_all;\\n" '
               '::);\n    __syncwarp();\n')
CUTS = {
    "launch": (_AFTER_SMEM, "  if (B >= 0) return;\n"),
    "ids": (_AFTER_IDS,
            "    if (lane == 0) store(out + static_cast<size_t>(b) * d, "
            "w_s[m - 1] + static_cast<float>(reinterpret_cast<uintptr_t>("
            "src[m - 1]) & 1));\n    return;\n"),
    "rows": (_AFTER_ROWS,
             "    if (lane == 0) store(out + static_cast<size_t>(b) * d, "
             "to_f32(reinterpret_cast<const T*>(rows)[m * cols - 1]));\n"
             "    return;\n"),
}


def variants() -> dict[str, tuple[str, list[str]]]:
    """{stage: (source text, extra nvcc flags)} for build_variants."""
    src = (_build.CSRC / "embedding_bag.cu").read_text()
    out = {}
    for stage, (after, text) in CUTS.items():
        if src.count(after) != 1:
            raise RuntimeError(f"embedding_bag_probe: the source no longer "
                               f"has the line after which {stage!r} cuts")
        out[stage] = (src.replace(after, after + text), [])
    out["whole"] = (src, [])
    return out


def criteo_ids(vocabs, b: int, gen: torch.Generator,
               dev: torch.device) -> torch.Tensor:
    """[b, fields] int32 global row ids, uniform within each field."""
    v = torch.tensor(vocabs, dtype=torch.float64, device=dev)
    off = torch.cumsum(v, 0) - v
    u = torch.rand(b, len(vocabs), dtype=torch.float64, device=dev,
                   generator=gen)
    return (off + torch.minimum((u * v).floor(), v - 1)).to(torch.int32)


def device_us(fn, flush: torch.Tensor | None = None, reps: int = 20,
              windows: int = 5) -> float:
    """Median over ``windows`` profiler windows of the ``bag_kernel``
    device time per call; with ``flush``, that buffer is cleared before
    each call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    per = []
    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = n = 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and \
                    "bag_kernel" in e.key:
                t = getattr(e, "self_device_time_total", None)
                us += e.self_cuda_time_total if t is None else t
                n += e.count
        if n:
            per.append(us / n)                  # a launch a call
    return statistics.median(per) if per else float("nan")


def main() -> int:
    if not torch.cuda.is_available():
        print("embedding_bag_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = _build.build_variants("embedding_bag", variants(),
                                 _build.BUILD_ROOT / "probe")
    g = torch.Generator(device=dev).manual_seed(3)
    flush = torch.empty(32 * 1024 * 1024, device=dev)       # 128 MB
    for name, (vocabs, dim) in TABLES.items():
        rows = (sum(vocabs) + 255) // 256 * 256
        table = torch.randn(rows, dim, device=dev, generator=g) * 0.05
        ids = criteo_ids(vocabs, BATCH, g, dev)
        out = torch.empty(BATCH, dim, device=dev)
        stream = _build.stream(dev)
        for stage, (lib, _) in libs.items():
            def call(lib=lib):
                _build.check(lib.has_embedding_bag(
                    table.data_ptr(), ids.data_ptr(), None, out.data_ptr(),
                    BATCH, ids.shape[1], dim, 1.0, 0, 0, stream),
                    f"embedding_bag_probe ({stage})")
            warm, cold = device_us(call), device_us(call, flush)
            print(f"{name} B={BATCH}, {len(vocabs)} fields, d={dim}: "
                  f"{stage}: device {warm:.3f} us per call, {cold:.3f} us "
                  f"with the L2 cache cleared before each", flush=True)
        del table
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
