"""Readings for the limits of the comparison: the program's numbers on
many seeds, the control's, and each planted fault's, in one process on the
card.

    python3 -m gpu_bench.calibrate --workload <cell> --seeds 1,2,3 [--seconds 3]
        [--control 3] [--faults 3] [--out readings.jsonl]

For each seed a run of the cell with a short window (its set-up, its own
sizes, the comparison), printed as one JSON line: the numbers compared and
``correct``.  The first ``--control`` seeds also read the control (the
reference in the lower precision, against the reference, on the same
inputs), held to the cell's limits as ``control_correct``, which has to
come out false; the first ``--faults`` seeds each fault of ``faults.py``
planted in the program.  The benchmark's own runs never run these.  Exits
non-zero, as a run does, without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--faults", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    from . import run

    run.prepare_environment()
    import torch

    from . import manifest
    from .faults import FAULTS, planted

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpu_bench: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = manifest.driver(cell).Session.KIND
    out = open(args.out, "a", encoding="utf-8") if args.out else None
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        plans = [(None, i < args.control)]
        if i < args.faults:
            plans += [(fault, False) for fault in FAULTS[kind]]
        for fault, control in plans:
            t0 = time.time()
            with planted(fault, cell.config["config"]["classifier"]["name"]) if fault else \
                    contextlib.nullcontext():
                res = run.run_cell(cell, seed, args.seconds, False, device, start=t0,
                                   control=control)
            line = json.dumps({"workload": cell.name, "seed": seed, "fault": fault,
                               "correct": res["correct"],
                               "checks": {k: v["value"] for k, v in res["checks"].items()},
                               "control_correct": res.get("control", {}).get("correct"),
                               "control_checks": {k: v["value"] for k, v in
                                                  res.get("control", {}).get("checks", {}).items()},
                               "readings": res.get("readings"), "metrics": res["metrics"],
                               "memory_peak_bytes": res["device"]["memory_peak_bytes"],
                               "kind": res["device"]["kind"],
                               "power_limit_w": res["device"].get("power_limit_w"),
                               "wall_s": time.time() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
