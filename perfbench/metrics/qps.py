"""qps: queries whose micro-batch returned in the window, over the window's
seconds (first admission to last return, host clock after a synchronize)."""


def read(run):
    return sum(len(w.accept) for w in run.window) / run.window_s
