"""device.idle_share: the share of a micro-batch's wall with no operation
on the device: 1 - (busy time of a traced micro-batch) / ``engine.step_ms``,
the median wall of the untraced window's micro-batches in the same run.
The traced steps give only the busy time, since the profiler's host cost
stretches their wall."""
import statistics


def read(run):
    t = run.trace
    if t is None or not t.busy_s or not run.window:
        return None
    step_s = statistics.median(w.t_done - w.t_admit for w in run.window)
    return 1.0 - t.busy_s / t.steps / step_s
