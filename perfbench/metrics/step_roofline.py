"""step_roofline: the window's least time on the card (every operation of
every micro-batch at its bound, ``roofline.py``) over the window's wall,
in %."""


def read(run):
    if not run.work or not run.work["window"].get("step"):
        return None
    return 100.0 * run.work["window"]["step"] / run.window_s
