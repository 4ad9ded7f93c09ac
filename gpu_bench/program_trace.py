"""The program's own spans and row counters over a cell's traced stretch.

    python3 -m gpu_bench.program_trace --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``run.run_cell`` does up to the end of its traced
stretch: set-up, the window (``--seconds``), then ``profile_steps`` under
``trace.traced`` with the profiler's events kept beside the ``Trace`` they
make; the comparison is not run.  Prints one JSON line: the window's
end-to-end metric and median episode, the traced stretch's ms a step,
``device_idle_pct`` as its reader reads the ``Trace``, the breakdown, and
from the program's ``afs.*`` spans (``audio_fewshot_tpu_torch/utils/
spans.py``) and row counters:

- ``idle_data_pct``, ``idle_step_pct``, ``idle_other_pct``: the traced
  window's idle stretches cut by overlap with the spans of the thread that
  launches the steps (the one that runs ``afs.step``), each piece given to
  ``step`` where that thread is anywhere inside ``afs.step``, to ``data``
  where its innermost span is ``afs.data``, ``afs.data.build`` or
  ``afs.transfer``, to ``other`` elsewhere (outside every ``afs.*`` span);
  the three sum to ``device_idle_pct``;
- ``idle_pct_by_span``: the same pieces by the innermost span (``none``:
  outside them);
- ``backbone_ms``: device ms a step of the operations launched inside
  ``afs.backbone``, matched by the profiler's launch-to-kernel correlation
  (an operation launched inside the span counts wherever it runs);
- ``device_ms_by_span``: every device operation's ms given to the innermost
  ``afs.*`` span it was launched in (``none``: launched outside them);
- ``pad_rows_pct``: padded over computed backbone rows of the steps the
  stretch dispatched (``rows_real``, ``rows_computed``).

Each is None where the program has no spans or counters.  The readers that
``BENCHMARK.json`` names read a ``Trace``, which keeps only the benchmark's
own spans; this prints what a ``Trace`` that kept the program's would give.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import statistics
import sys
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

#: a program span: name, start µs, end µs, thread
Span = Tuple[str, float, float, int]
#: a host op that launched device work: thread, start µs, device µs launched
Launch = Tuple[int, float, float]

DATA = ("afs.data", "afs.data.build", "afs.transfer")
STEP = "afs.step"


def program_spans(events) -> List[Span]:
    """The ``afs.*`` host spans among a profiler's events."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in events
            if e.device_type == DeviceType.CPU and e.name.startswith("afs.")]


def launches(events) -> List[Launch]:
    """The device time each host op launched, with the op's thread and
    start: the profiler links each device operation to the op that
    launched it (``FunctionEvent.kernels``).  Only torch ops and host spans
    count: the CUDA runtime's own host events (``cudaEventRecord``,
    ``Command Buffer Full``) number their correlation ids apart, and one
    whose id equals an op's is handed a copy of that op's kernels.  The
    host spans' device-side twins, linked the same way, are left out."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        if e.device_type != DeviceType.CPU or not (e.is_user_annotation or "::" in e.name):
            continue
        us = sum(k.duration for k in e.kernels if not k.name.startswith(("afs.", "bench.")))
        if us:
            out.append((e.thread, e.time_range.start, us))
    return out


def launching_thread(spans: Iterable[Span]) -> Optional[int]:
    """The thread that runs the steps (``afs.step``)."""
    threads = [t for n, _, _, t in spans if n == STEP]
    return statistics.mode(threads) if threads else None


class Timeline:
    """One thread's spans as elementary stretches between their edges, each
    with the spans open over it, innermost last."""

    def __init__(self, spans: Iterable[Span], thread: int):
        mine = sorted((s for s in spans if s[3] == thread), key=lambda s: (s[1], -s[2]))
        self.edges = sorted({x for _, a, b, _ in mine for x in (a, b)})
        self.open: List[Tuple[str, ...]] = []
        for a, b in zip(self.edges, self.edges[1:]):
            mid = (a + b) / 2
            self.open.append(tuple(n for n, s, e, _ in mine if s <= mid < e))

    def at(self, t: float) -> Tuple[str, ...]:
        """The spans open at ``t``, innermost last."""
        i = bisect.bisect_right(self.edges, t) - 1
        return self.open[i] if 0 <= i < len(self.open) else ()

    def pieces(self, a: float, b: float):
        """``[a, b)`` cut at the edges: ``(length, open spans)``."""
        inner = self.edges[bisect.bisect_right(self.edges, a):bisect.bisect_left(self.edges, b)]
        cuts = [a] + inner + [b]
        for u, v in zip(cuts, cuts[1:]):
            yield v - u, self.at((u + v) / 2)


def part(open_spans: Tuple[str, ...]) -> str:
    if STEP in open_spans:
        return "step"
    if open_spans and open_spans[-1] in DATA:
        return "data"
    return "other"


def idle_split(trace, spans: List[Span]) -> Optional[Tuple[Dict[str, float], Dict[str, float]]]:
    """Seconds of the trace window's idle stretches by ``part`` of the
    launching thread's spans, and by its innermost span (``none``: outside
    them); None without ``afs.step`` or without device operations."""
    from .trace import gaps

    thread = launching_thread(spans)
    if thread is None or not trace.ops:
        return None
    timeline = Timeline(spans, thread)
    parts = {"data": 0.0, "step": 0.0, "other": 0.0}
    by_span: Dict[str, float] = defaultdict(float)
    for a, b in gaps(trace._clipped(), *trace.window):
        for length, open_spans in timeline.pieces(a, b):
            parts[part(open_spans)] += length * 1e-6
            by_span[open_spans[-1] if open_spans else "none"] += length * 1e-6
    return parts, dict(by_span)


def device_us_by_span(spans: List[Span], launched: List[Launch]) -> Dict[str, float]:
    """Device µs by the innermost ``afs.*`` span each operation was launched
    in, on its launching thread (``none``: outside every span)."""
    timelines = {t: Timeline(spans, t) for t in {s[3] for s in spans}}
    out: Dict[str, float] = defaultdict(float)
    for thread, at, us in launched:
        open_spans = timelines[thread].at(at) if thread in timelines else ()
        out[open_spans[-1] if open_spans else "none"] += us
    return dict(out)


def launched_in_us(spans: List[Span], launched: List[Launch], name: str) -> float:
    """Device µs of the operations launched anywhere inside a span ``name``."""
    timelines = {t: Timeline(spans, t) for t in {s[3] for s in spans}}
    return sum(us for thread, at, us in launched
               if thread in timelines and name in timelines[thread].at(at))


def readings(trace, events, rows: Optional[Tuple[int, int]]) -> Dict[str, Optional[float]]:
    """The program's readings of one traced stretch; ``rows``: the real and
    computed rows its steps counted."""
    spans = program_spans(events)
    split = idle_split(trace, spans)
    window = trace.window_s
    out: Dict[str, Optional[float]] = {f"idle_{k}_pct": None for k in ("data", "step", "other")}
    out["idle_pct_by_span"] = None
    if split:
        out.update({f"idle_{k}_pct": 100.0 * v / window for k, v in split[0].items()})
        out["idle_pct_by_span"] = {k: 100.0 * v / window for k, v in split[1].items()}
    launched = launches(events)
    thread = launching_thread(spans)
    steps = sum(1 for n, _, _, t in spans if n == STEP and t == thread)
    backbone = launched_in_us(spans, launched, "afs.backbone")
    out["backbone_ms"] = backbone / 1e3 / steps if steps and backbone else None
    out["device_ms_by_span"] = ({k: v / 1e3 for k, v in device_us_by_span(spans, launched).items()}
                                if spans else None)
    real, computed = rows or (0, 0)
    out["pad_rows_pct"] = 100.0 * (computed - real) / computed if computed else None
    return out


@contextlib.contextmanager
def kept_profiler():
    """``trace.traced`` with its profiler kept: yields a list that holds the
    profiler once ``traced`` has returned."""
    from torch.profiler import profile

    from . import trace

    kept = []

    class Keep(profile):
        def __exit__(self, *exc):
            kept.append(self)
            return super().__exit__(*exc)

    trace.profile = Keep
    try:
        yield kept
    finally:
        trace.profile = profile


def counted_rows() -> Optional[Tuple[int, int]]:
    """The program's row counters, where it has them."""
    try:
        from audio_fewshot_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.rows_real, spans.rows_computed


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    args = parser.parse_args(argv)
    from . import run

    run.prepare_environment()
    import torch

    from . import manifest
    from .trace import traced

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available():
        print(f"gpu_bench: {args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    session = manifest.driver(cell).Session(cell, args.seed, device)
    session.warm_up()
    torch.cuda.synchronize(device)
    setup_s = time.time() - run.PROCESS_START
    e2e, counters = session.measure(args.seconds)
    before = counted_rows()
    with kept_profiler() as kept:
        trace = traced(session.profile_steps, device)
    after = counted_rows()
    rows = (after[0] - before[0], after[1] - before[1]) if before else None
    traced_run = run.Run(window_s=0.0, counters={}, peaks={}, trace=trace)
    steps = int(cell.traffic["trace_steps"])
    out = {"workload": cell.name, "seed": args.seed, "torch": torch.__version__,
           "kind": torch.cuda.get_device_name(device), "power_limit_w": run.power_limit_w(),
           "setup_s": setup_s, **e2e,
           "episode_ms_p50": (statistics.median(counters["episode_ms"])
                              if "episode_ms" in counters else None),
           "trace_ms_per_step": trace.window_s * 1e3 / steps,
           "device_idle_pct": manifest.reader("device_idle_pct").read(traced_run),
           "afs_ops": sum(n.startswith("afs.") for n, _, _ in trace.ops),
           **readings(trace, kept[0].events(), rows),
           "breakdown": trace.breakdown()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
