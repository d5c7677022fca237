"""setup_s: process start to the first timed micro-batch: the world, the
program's indexes, warm-up and the cache fill."""


def read(run):
    return run.setup_s
