"""ingest.device_ms: device time a traced micro-batch spends in ``pb.ingest``
(cache_update_chunked), in ms."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s or "pb.ingest" not in t.range_s:
        return None
    return t.range_s["pb.ingest"] / t.steps * 1e3
