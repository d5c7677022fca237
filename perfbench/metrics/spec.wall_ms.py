"""spec.wall_ms: the median ``spec`` span of an untraced window
micro-batch (``core/dispatch.py``), in ms: speculation's host wall from
its upload to the synchronize after its kernels."""
import statistics
from pathlib import Path

from perfbench import harness

# the window's micro-batches and their spans, read alike by every reader
_steps = harness.load_module(Path(__file__).with_name("engine.self_ms.py"),
                             "perfbench_metric_")._steps


def read(run):
    walls = [by["spec"][0].ns for _, by in _steps(run) if by["spec"]]
    return statistics.median(walls) * 1e-6 if walls else None
