"""engine.self_ms: the median own time of an untraced window micro-batch's
``engine.step`` span (``core/dispatch.py``), in ms: its wall less the
union of the spans directly inside it, so the host work outside the
layers (stacking and padding the queries, the results)."""
import collections
import statistics

from repro_torch.core import dispatch


def _steps(run):
    """[(window micro-batch, its spans by name)] for each window
    micro-batch whose ``engine.step`` span lies inside its [t_admit,
    t_done]: the untraced steps.  Empty where the program records no
    spans.  The readers of the program's other spans share it."""
    snap = getattr(dispatch, "snapshot", None)
    spans = snap() if snap is not None else []
    named = collections.defaultdict(lambda: collections.defaultdict(list))
    for s in spans:
        if s.step is not None:
            named[s.step][s.name].append(s)
    tops = [s for s in spans if s.name == "engine.step"]
    out = []
    for log in run.window:
        a, b = log.t_admit * 1e9, log.t_done * 1e9
        out += [(log, named[s.step]) for s in tops
                if a <= s.start_ns and s.end_ns <= b]
    return out


def read(run):
    own = []
    for _, by in _steps(run):
        top = by["engine.step"][0]
        spans = [s for group in by.values() for s in group]
        own.append(dispatch.self_ns(top, spans))
    return statistics.median(own) * 1e-6 if own else None
