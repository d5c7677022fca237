"""ingest.host_syncs: the median ``host_syncs`` counted under the
``ingest`` span (itself and the spans inside it) of an untraced window
micro-batch that has rejects (``core/dispatch.py``): the times the
ingest makes the host wait for the card."""
import statistics
from pathlib import Path

from perfbench import harness

# the window's micro-batches and their spans, read alike by every reader
_steps = harness.load_module(Path(__file__).with_name("engine.self_ms.py"),
                             "perfbench_metric_")._steps


def read(run):
    syncs = []
    for _, by in _steps(run):
        if not by["ingest"]:
            continue
        under = {by["ingest"][0].id}
        n = 0
        for s in sorted((s for group in by.values() for s in group),
                        key=lambda s: s.id):
            if s.id in under or s.parent in under:
                under.add(s.id)
                n += s.counts.get("host_syncs", 0)
        syncs.append(n)
    return float(statistics.median(syncs)) if syncs else None
