"""Median latency of the window's episodes (ms), request to accuracy on
the host; the benchmark's host clock around each (``closed_episodes``)."""

import statistics


def read(run):
    values = run.counters.get("episode_ms")
    return statistics.median(values) if values else None
