"""p95_ms: the 95th percentile over the window's queries of admission to
return (a query returns when its micro-batch does), in ms."""
import numpy as np


def read(run):
    lat = np.repeat([w.t_done - w.t_admit for w in run.window],
                    [len(w.accept) for w in run.window])
    return float(np.percentile(lat, 95)) * 1e3
