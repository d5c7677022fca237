"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a run of its
own.  The last lines on standard error, and the result's ``checks``, give
each number the correctness check compared beside its limit.  Exits
non-zero without a result when the cell's cards are missing, when the
program (``src/repro_torch``) is not in the checkout, or when JAX or the
JAX package is loaded in this process.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "perfbench" / ".cache"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"perfbench: the program is missing ({src / 'repro_torch'})",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(src)]
    import torch

    from perfbench import harness
    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s)", file=sys.stderr)
        return 3
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace))
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(f"perfbench: {json.dumps(result['info'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
