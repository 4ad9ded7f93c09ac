"""Peak device memory of the window (GiB):
``torch.cuda.max_memory_allocated`` after a reset at the window's start."""


def read(run):
    peak = run.counters.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
