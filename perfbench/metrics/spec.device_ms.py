"""spec.device_ms: device time a traced micro-batch spends in ``pb.spec``
(speculate_batch), in ms."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s or "pb.spec" not in t.range_s:
        return None
    return t.range_s["pb.spec"] / t.steps * 1e3
