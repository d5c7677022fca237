"""ingest.wall_ms: the median ``ingest`` span of an untraced window
micro-batch that has rejects (``core/dispatch.py``), in ms: the host
wall of folding the rejects into the cache, its host syncs included."""
import statistics
from pathlib import Path

from perfbench import harness

# the window's micro-batches and their spans, read alike by every reader
_steps = harness.load_module(Path(__file__).with_name("engine.self_ms.py"),
                             "perfbench_metric_")._steps


def read(run):
    walls = [by["ingest"][0].ns for _, by in _steps(run) if by["ingest"]]
    return statistics.median(walls) * 1e-6 if walls else None
