"""Run one cell of the benchmark and print its result line.

    python3 -m gpu_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's program object from its configuration and traffic
files, loads the weights drawn from ``--seed`` on the card, and warms up
the cell's own shapes (the first run of a checkout also builds the BDC
kernels into ``build/kernels/``); ``setup_s`` runs from the start of the
process to the window.  The window measures for ``--seconds``.  With
``--trace 1`` a fixed stretch of steady steps then runs under the profiler,
and the per-layer metrics are read.  Then the program is freed and the
comparison with the plain reference decides ``correct``: each number
compared is printed beside its limit as the last lines of standard error,
and under ``checks``, the last key of the result.  The last line of
standard output is the result, one JSON object.

Exits non-zero without a result where there is no CUDA device (or fewer
than the cell asks for), and where JAX, flax, optax or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "audio_fewshot_tpu")


@dataclass
class Run:
    """What a per-layer metric's reader reads (``metrics/<name>.py``)."""

    window_s: float
    counters: Dict[str, Any]
    peaks: Dict[str, float]
    trace: Any = None
    trace_counters: Dict[str, List] = field(default_factory=dict)


def prepare_environment() -> None:
    """Caches at fixed paths inside the checkout, and the program's
    TensorBoard writer kept off: importing it loads TensorFlow, which loads
    JAX, and it would write every step to disk."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    sys.modules.setdefault("torch.utils.tensorboard", None)


def forbidden_modules() -> List[str]:
    """The top-level names in ``sys.modules`` that ``FORBIDDEN`` lists,
    compared whole (``audio_fewshot_tpu_torch`` is not ``audio_fewshot_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    """The card's power limit, as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
                              "nounits", "-i", "0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             overrides: Optional[Dict[str, Any]] = None,
             start: float = PROCESS_START, control: bool = False) -> Dict[str, Any]:
    """One run of ``cell``: set-up, window, (traced stretch), comparison.
    Returns the result object (``checks`` last); ``control`` adds every
    reading under ``readings``, and under ``control`` the control's
    numbers on the same inputs held to the same limits, with its own
    ``correct``."""
    import torch

    from . import manifest
    from .peaks import card_peaks
    from .trace import traced

    cuda = device.type == "cuda"
    t_build = time.time()
    session = manifest.driver(cell).Session(cell, seed, device, overrides)
    t_warm = time.time()
    session.warm_up()
    if cuda:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - start
    print(f"gpu_bench: set-up {setup_s:.2f} s: imports and start {t_build - start:.2f}, program "
          f"built {t_warm - t_build:.2f}, warm-up {time.time() - t_warm:.2f}", file=sys.stderr)
    e2e, counters = session.measure(seconds)
    if cuda:
        torch.cuda.synchronize(device)
        counters["window_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = Run(window_s=counters["window_s"], counters=counters, peaks=card_peaks(kind))
    if trace:
        run.trace = traced(session.profile_steps, device)
        run.trace_counters = session.trace_counters
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device)) if cuda else 0
    readings = session.check(control)

    limits = manifest.reference(cell).LIMITS[session.KIND]
    checks = {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}
    checks["failed_attempts"] = {"value": float(session.failed), "limit": 0.0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = manifest.reader(m["name"], cell.here).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {**e2e, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(session.attempted),
              "failed": int(session.failed), "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": int(peak)}}
    if cuda:
        result["device"]["power_limit_w"] = power_limit_w()
    if trace:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    if control:
        result["readings"] = readings
        low = {name: {"value": readings["control_" + name], "limit": limit}
               for name, limit in limits.items() if "control_" + name in readings}
        result["control"] = {"correct": all(c["value"] <= c["limit"] for c in low.values()),
                             "checks": low}
    result["checks"] = checks
    return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    prepare_environment()
    import torch

    from . import manifest

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpu_bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"gpu_bench: the process holds {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
