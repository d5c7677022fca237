"""engine.step_ms: the median wall of a window micro-batch, in ms."""
import statistics


def read(run):
    return statistics.median(w.t_done - w.t_admit for w in run.window) * 1e3
