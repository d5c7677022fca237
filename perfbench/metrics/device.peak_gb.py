"""device.peak_gb: the run's ``torch.cuda.max_memory_allocated``, in GB."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
