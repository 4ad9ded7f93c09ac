"""Where the time of the ``bdc_pool`` kernel goes on the card.

    python -m audio_fewshot_tpu_torch.profile_bdc_pool [--batch 4496] [--dim 64] [--positions 304]

Builds ``csrc/bdc_pool.cu`` a second time with ``-DBDC_POOL_PROFILE``, which
compiles per-warp phase clocks into the kernel (``clock64`` around the waits
for loads, the block barriers, the requests for loads, the k-steps, the k-split
reduction, the dcov pass and the output pass), launches it at the given
shape, and prints the SM cycles each phase takes per batch element and
block.  It also prints the kernel's time with and without the clocks, the
rate the tensor cores reach through ``mma.sync`` TF32 (a loop of independent
``m16n8k8``), and from it the least time the kernel's three-pass gram needs on
that pipe.  Needs a CUDA device; nothing on the main path imports this.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys

import numpy as np
import torch

from .ops import bdc_cuda
from .ops.build import build_library

PHASES = ("wait for loads", "block barrier", "request loads", "k-steps (mma)",
          "k-split reduce", "dcov + row means", "centre + write")


def time_ms(fn, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=4496)
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--positions", type=int, default=304)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_bdc_pool: no CUDA device is available", file=sys.stderr)
        return 1
    b, d, m = args.batch, args.dim, args.positions
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    prof = ctypes.CDLL(str(build_library(
        "bdc_pool_profile", [bdc_cuda.SOURCE], extra_flags=("-DBDC_POOL_PROFILE",))))
    prof.bdc_pool_launch.argtypes = bdc_cuda.library().bdc_pool_launch.argtypes
    prof.bdc_pool_launch.restype = ctypes.c_int
    prof.bdc_pool_read_phases.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    prof.bdc_pool_read_phases.restype = ctypes.c_int
    prof.bdc_pool_mma_rate.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    prof.bdc_pool_mma_rate.restype = ctypes.c_int
    # the shape of the clocks comes from the build that counts them
    shape = [ctypes.c_int(0) for _ in range(3)]
    prof.bdc_pool_phase_shape.restype = None
    prof.bdc_pool_phase_shape(*map(ctypes.byref, shape))
    n_phases, profiled_blocks, warps = (v.value for v in shape)
    if n_phases != len(PHASES):
        raise RuntimeError(f"the kernel counts {n_phases} phases, {len(PHASES)} are named here")

    gen = torch.Generator(device="cuda").manual_seed(0)
    # enough buffers in turn that no launch finds its input in the 50 MB L2
    n_buf = max(1, math.ceil(100 * 2 ** 20 / (4 * b * d * m)))
    xs = [torch.randn((b, d, m), device="cuda", generator=gen) for _ in range(n_buf)]
    log_t = torch.full((1, 1), math.log(1.0 / (2.0 * m)), device="cuda")
    tri = torch.empty((b, d * (d + 1) // 2), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    turn = [0]

    def launch_profiled():
        turn[0] += 1
        err = prof.bdc_pool_launch(xs[turn[0] % n_buf].data_ptr(), log_t.data_ptr(),
                                   tri.data_ptr(), None, b, d, m, stream)
        if err != 0:
            raise RuntimeError(f"profiled bdc_pool launch failed with CUDA error {err}")

    def launch_plain():
        turn[0] += 1
        bdc_cuda.bdc_pool_triu(xs[turn[0] % n_buf], log_t)

    ms_plain = time_ms(launch_plain)
    ms_prof = time_ms(launch_profiled)
    print(f"shape {(b, d, m)}: kernel {ms_plain:.4f} ms, with phase clocks {ms_prof:.4f} ms")

    launch_profiled()
    torch.cuda.synchronize()
    cycles = np.zeros((n_phases, profiled_blocks * warps), dtype=np.int64)
    grid_out = ctypes.c_int(0)
    err = prof.bdc_pool_read_phases(cycles.ctypes.data, ctypes.byref(grid_out))
    if err != 0:
        raise RuntimeError(f"reading the phase clocks failed with CUDA error {err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = grid_out.value
    blocks = min(grid, profiled_blocks)
    elems = np.array([(b - i + grid - 1) // grid for i in range(blocks)], dtype=np.float64)
    per_elem = cycles[:, : blocks * warps].reshape(n_phases, blocks, warps) / elems[None, :, None]
    total = per_elem.sum(0).mean()
    print(f"grid {grid} blocks, {elems.mean():.2f} elements a block; SM cycles per "
          f"element and block (mean over warps; range over warps):")
    for name, phase in zip(PHASES, per_elem):
        by_warp = phase.mean(0)
        print(f"  {name:18s} {phase.mean():9.0f}  {100 * phase.mean() / total:5.1f} %   "
              f"({by_warp.min():.0f} .. {by_warp.max():.0f})")
    print(f"  {'all':18s} {total:9.0f}")

    # the tensor pipe's own bound for this kernel
    iters = 20000
    out = torch.zeros(1, device="cuda")
    for blocks_per_sm in (1, 2):
        ms = time_ms(lambda: prof.bdc_pool_mma_rate(
            out.data_ptr(), sms * blocks_per_sm, iters, stream), reps=3)
        n_mma = iters * 8 * warps * sms * blocks_per_sm
        tflops = n_mma * 2 * 16 * 8 * 8 / ms * 1e-9
        print(f"mma.sync m16n8k8 TF32, {warps * blocks_per_sm} warps an SM: "
              f"{tflops:.1f} TFLOP/s ({ms * 1e6 / (n_mma / sms):.3f} ns per mma and SM)")
    nb = (d + 15) // 16
    mma_per_elem = 3 * nb * (nb + 1) * math.ceil(m / 8)  # 3 passes over the upper units
    pipe_ms = mma_per_elem * b / sms * (ms * 1e6 / (n_mma / sms)) * 1e-6
    print(f"the kernel runs {mma_per_elem} mma per element: at that rate the tensor "
          f"pipe alone needs {pipe_ms:.4f} ms for this shape")
    return 0


if __name__ == "__main__":
    sys.exit(main())
