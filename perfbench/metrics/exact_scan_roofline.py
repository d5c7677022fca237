"""exact_scan_roofline: the least time of the exact cloud scan (chunked_flat_search) over the traced micro-batches over the
device time of their ``pb.cloud`` calls, in %."""


def read(run):
    t, work = run.trace, run.work
    if t is None or not work or not work["trace"].get("exact_scan") \
            or not t.range_s.get("pb.cloud"):
        return None
    return 100.0 * work["trace"]["exact_scan"] / t.range_s["pb.cloud"]
