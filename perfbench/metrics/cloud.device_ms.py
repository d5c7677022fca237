"""cloud.device_ms: device time a traced micro-batch spends in ``pb.cloud``
(the service's full_search_batch), in ms."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s or "pb.cloud" not in t.range_s:
        return None
    return t.range_s["pb.cloud"] / t.steps * 1e3
