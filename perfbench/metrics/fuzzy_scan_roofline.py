"""fuzzy_scan_roofline: the least time of the fuzzy channel's bucket scan (ivf_scan, f32) over the traced micro-batches over the
device time of their ``pb.fuzzy_scan`` calls, in %."""


def read(run):
    t, work = run.trace, run.work
    if t is None or not work or not work["trace"].get("fuzzy_scan") \
            or not t.range_s.get("pb.fuzzy_scan"):
        return None
    return 100.0 * work["trace"]["fuzzy_scan"] / t.range_s["pb.fuzzy_scan"]
