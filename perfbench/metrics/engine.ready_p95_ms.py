"""engine.ready_p95_ms: the 95th percentile over the untraced window's
queries of admission to the stamp at which its answer is on the host
(``core/dispatch.py``), in ms: an accepted query's at the end of its
step's ``spec.readback``, a rejected one's at the end of
``cloud.readback``.  A query still returns with its micro-batch; this is
how soon it could."""
from pathlib import Path

import numpy as np

from perfbench import harness

# the window's micro-batches and their spans, read alike by every reader
_steps = harness.load_module(Path(__file__).with_name("engine.self_ms.py"),
                             "perfbench_metric_")._steps


def read(run):
    lat = []
    for log, by in _steps(run):
        acc = np.asarray(log.accept, bool)
        if acc.any():
            ready = by["spec.readback"][0].end_ns * 1e-9
            lat += [ready - log.t_admit] * int(acc.sum())
        if (~acc).any():
            ready = by["cloud.readback"][0].end_ns * 1e-9
            lat += [ready - log.t_admit] * int((~acc).sum())
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
