"""Mean host time (ms) inside the step's call (``Test._device_step``),
which returns before the device has finished: the host's share of an
episode.  The benchmark's host clock around each call."""

import statistics


def read(run):
    values = run.counters.get("dispatch_ms")
    return statistics.fmean(values) if values else None
