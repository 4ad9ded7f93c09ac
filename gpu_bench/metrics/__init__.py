"""One reader per per-layer metric: ``read(run)`` gives its value, or None
where the run holds nothing to read."""
