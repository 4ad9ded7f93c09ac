"""The BDC pool kernel's share of its roofline (%): the least time of each
launch at its shape (``peaks.bdc_bound_ms``), over the kernel's device time
in the traced stretch."""

from ..peaks import bdc_bound_ms


def read(run):
    shapes = run.trace_counters.get("bdc_shapes") if run.trace is not None else None
    if not shapes:
        return None
    us, launches = run.trace.device_us(("bdc_pool_kernel",))
    if launches != len(shapes) or us <= 0:
        return None
    bound_ms = sum(bdc_bound_ms(*shape, run.peaks)[0] for shape in shapes)
    return 100.0 * bound_ms * 1e3 / us
