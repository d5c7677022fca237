"""ingest.ops: device operations a traced micro-batch runs in
``pb.ingest`` (cache_update_chunked)."""


def read(run):
    t = run.trace
    if t is None or not t.busy_s or "pb.ingest" not in t.range_ops:
        return None
    return t.range_ops["pb.ingest"] / t.steps
