"""cache_topk_roofline: the least time of the cache channel (topk_search) over the traced micro-batches over the
device time of their ``pb.cache_topk`` calls, in %."""


def read(run):
    t, work = run.trace, run.work
    if t is None or not work or not work["trace"].get("cache_topk") \
            or not t.range_s.get("pb.cache_topk"):
        return None
    return 100.0 * work["trace"]["cache_topk"] / t.range_s["pb.cache_topk"]
