"""A profiled stretch of steady steps, read in memory.

``traced(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) inside one ``bench.window`` span, synchronises, and returns a
``Trace``: every device operation's interval, the benchmark's host spans
(``record_function`` labels starting ``bench.``), the device time by kernel
category, and the traced window.  Busy time is the union of the device
operations' intervals, so operations that overlap (a copy on a side stream
beside a kernel) count once.  Nothing is written to disk.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench.window"

# first matching substring of the lower-cased kernel name decides its category
CATEGORIES = (
    ("bdc_pool kernel", ("bdc_pool_kernel",)),
    ("bdc_pool_backward kernel", ("bdc_pool_backward_kernel", "sum_log_t_kernel")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("layout transpose", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("convolution", ("conv", "xmma", "fprop", "implicit", "wgrad", "dgrad", "cudnn")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("max pool", ("max_pool",)),
    ("top-k / sort", ("topk", "sort", "radix", "bitonic")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("memcpy / memset", ("memcpy", "memset")),
    ("gather / copy", ("index", "gather", "copy", "cat")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Total length covered by ``intervals``."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Trace:
    """The device operations (``name, start_us, end_us``) and host spans of
    one traced window, in the profiler's clock (µs)."""

    ops: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    window: Tuple[float, float]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def _clipped(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        return [(max(a, lo), min(b, hi)) for _, a, b in self.ops if b > lo and a < hi]

    @property
    def busy_s(self) -> float:
        return union_length(self._clipped()) * 1e-6

    def device_us(self, keys: Tuple[str, ...]) -> Tuple[float, int]:
        """Summed device µs and count of the operations whose lower-cased name
        holds one of ``keys``."""
        hits = [(b - a) for n, a, b in self.ops if any(k in n.lower() for k in keys)]
        return sum(hits), len(hits)

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the longest idle
        stretches summed by the innermost benchmark span the host was in."""
        by_name: Dict[str, float] = defaultdict(float)
        for n, a, b in self.ops:
            by_name[f"{category(n)}: {n[:100]}"] += (b - a) * 1e-6
        idle: Dict[str, float] = defaultdict(float)
        spans = sorted(self.spans, key=lambda s: s[1])
        for a, b in gaps(self._clipped(), *self.window):
            inside = [s for s in spans if s[1] <= a < s[2] and s[0] != WINDOW]
            label = min(inside, key=lambda s: s[2] - s[1])[0] if inside else "bench.window (no span)"
            idle[label] += (b - a) * 1e-6
        ordered = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ordered(by_name), "idle_gaps": ordered(idle)}


def traced(fn: Callable[[], None], device: torch.device) -> Trace:
    """Run ``fn`` under the profiler and read its events."""
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    ops, spans, window = [], [], None
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if evt.device_type == DeviceType.CUDA:
            # a user annotation's device-side twin spans kernels: not an operation
            if not getattr(evt, "is_user_annotation", False) and not evt.name.startswith("bench."):
                ops.append((evt.name, start, end))
        elif evt.name == WINDOW:
            window = (start, end)
        elif evt.name.startswith("bench."):
            spans.append((evt.name, start, end))
    if window is None:
        raise RuntimeError("the profiler recorded no benchmark window")
    return Trace(ops=ops, spans=spans, window=window)
