"""cloud.wall_ms: the median ``cloud`` span of an untraced window
micro-batch that has rejects (``core/dispatch.py``), in ms: the cloud
stage's host wall, from the rejects' upload to their ids on the host."""
import statistics
from pathlib import Path

from perfbench import harness

# the window's micro-batches and their spans, read alike by every reader
_steps = harness.load_module(Path(__file__).with_name("engine.self_ms.py"),
                             "perfbench_metric_")._steps


def read(run):
    walls = [by["cloud"][0].ns for _, by in _steps(run) if by["cloud"]]
    return statistics.median(walls) * 1e-6 if walls else None
