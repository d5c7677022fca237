"""spec.accept_share: the window's accepted drafts over its queries."""


def read(run):
    n = sum(len(w.accept) for w in run.window)
    return sum(int(w.accept.sum()) for w in run.window) / n
