"""Readings of the correctness numbers over many seeds, with the control.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file.jsonl>]

For each seed, in one process: a run of the cell as ``run.py`` makes it
(a short window at the cell's own load), the reference's readings of the
program, and the control's: the reference in the program's place with its
products in TF32, the nearest precision below the configuration's float32
(TF32 off), judged by the same numbers.  The limits in a configuration's
``limits`` are set from these readings: above the program's largest, below
the control's smallest.  One JSON line a seed on standard output (and in
``--out``).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness
    if not torch.cuda.is_available():
        print("perfbench: calibrate needs a CUDA device", file=sys.stderr)
        return 3
    bench = harness.Bench(ROOT)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            r = harness.run_cell(bench, args.workload, seed, args.seconds,
                                 False, control=True, t_start=t0)
            line = json.dumps({
                "workload": args.workload, "seed": seed,
                "correct": r["correct"], "checks": r["checks"],
                "control": r["control"], "metrics": r["metrics"],
                "peak_bytes": r["device"]["memory_peak_bytes"],
                "seconds": time.time() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del r
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
