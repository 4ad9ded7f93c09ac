"""Where the time of the ``bdc_pool`` kernels goes on the card.

    python -m audio_fewshot_tpu_torch.profile_bdc_pool [--batch 4496] [--dim 64] [--positions 304]
    python -m audio_fewshot_tpu_torch.profile_bdc_pool --backward [--batch 75] [--dim 64] \
        [--positions 304] [--cluster C] [--compare SOURCE ...]

Builds ``csrc/bdc_pool.cu`` (with ``--backward``, ``csrc/bdc_pool_backward.cu``)
a second time with ``-DBDC_POOL_PROFILE``, which compiles per-warp phase
clocks into the kernel (``clock64``; the shape of the clocks comes from the
library), launches it at the given shape, and prints the SM cycles each
phase takes per batch element and block.  The forward's phases are the
waits for loads, the block barriers, the requests for loads, the k-steps,
the k-split reduction, the dcov pass and the output pass; it also prints
the rate the tensor cores reach through ``mma.sync`` TF32 (a loop of
independent ``m16n8k8``) and from it the least time the kernel's three-pass
gram needs on that pipe.  The backward's phases are the gradient's row sums
with the wait for x, the partial distances, the cluster reduction, S and
its stores into the cluster's blocks, the product and the store; it prints
the device time of a CUDA graph of launches beside the eager per-call time
of the wrapper and how many blocks each SM ran.  ``--cluster`` launches it
with C blocks a cluster instead of the library's choice; ``--compare``
times other versions of ``bdc_pool_backward.cu`` with the same C entry (a
parent commit's, unpacked with ``git archive``) on the same inputs, in
turns.  Needs a CUDA device; nothing on the main path imports this.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .ops import bdc_cuda
from .ops.build import build_library

PHASES = ("wait for loads", "block barrier", "request loads", "k-steps (mma)",
          "k-split reduce", "dcov + row means", "centre + write")
BACKWARD_PHASES = ("row sums + wait for x", "distances", "cluster reduce",
                   "S + push S", "product", "store")


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


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device time per call of ``fn`` from a CUDA graph of ``calls`` calls,
    replayed ``reps`` times: what the card takes without the host's launch
    overhead between calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, reps=reps) / calls


def read_phases(prof, prefix: str):
    """The phase clocks of the last launch of a clocked library:
    [phases, profiled blocks, warps] cycles and the launch's grid."""
    shape = [ctypes.c_int(0) for _ in range(3)]
    getattr(prof, f"{prefix}_phase_shape").restype = None
    getattr(prof, f"{prefix}_phase_shape")(*map(ctypes.byref, shape))
    n_phases, profiled_blocks, warps = (v.value for v in shape)
    cycles = np.zeros((n_phases, profiled_blocks * warps), dtype=np.int64)
    grid = ctypes.c_int(0)
    read = getattr(prof, f"{prefix}_read_phases")
    read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    err = read(cycles.ctypes.data, ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"reading the phase clocks failed with CUDA error {err}")
    return cycles.reshape(n_phases, profiled_blocks, warps), grid.value


def print_phases(names, per_block) -> None:
    """Cycles by phase, ``per_block`` [phases, blocks, warps]: mean over
    blocks and warps, and the range of the warps' means."""
    total = per_block.sum(0).mean()
    for name, phase in zip(names, per_block):
        by_warp = phase.mean(0)
        print(f"  {name:22s} {phase.mean():9.0f}  {100 * phase.mean() / total:5.1f} %   "
              f"({by_warp.min():.0f} .. {by_warp.max():.0f})")
    print(f"  {'all':22s} {total:9.0f}")


def backward(b: int, d: int, m: int, cluster=None, sources=()) -> int:
    """Phase clocks and times of ``bdc_pool_backward`` at (b, d, m), with
    the library's cluster size or ``cluster`` blocks a cluster; then the
    time of the kernel of each of ``sources`` (another version of the
    source with the same ``bdc_pool_backward_launch``, e.g. a parent
    commit's), built and launched the same way."""
    prof = ctypes.CDLL(str(build_library(
        "bdc_pool_backward_profile", [bdc_cuda.BACKWARD_SOURCE],
        extra_flags=("-DBDC_POOL_PROFILE",))))
    lib = bdc_cuda.backward_library()
    prof.bdc_pool_backward_launch.argtypes = lib.bdc_pool_backward_launch.argtypes
    prof.bdc_pool_backward_launch.restype = ctypes.c_int
    prof.bdc_pool_backward_launch_cluster.argtypes = [
        *lib.bdc_pool_backward_launch.argtypes[:-1], ctypes.c_int, ctypes.c_void_p]
    prof.bdc_pool_backward_launch_cluster.restype = ctypes.c_int
    n_cluster = cluster or lib.bdc_pool_backward_cluster(b, m)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_buf = max(1, math.ceil(100 * 2 ** 20 / (4 * b * d * m * 2)))
    xs = [torch.randn((b, d, m), device="cuda", generator=gen) for _ in range(n_buf)]
    gys = [torch.randn((b, d * (d + 1) // 2), device="cuda", generator=gen)
           for _ in range(n_buf)]
    log_t = torch.full((1, 1), math.log(1.0 / (2.0 * m)), device="cuda")
    grad_x = torch.empty((b, d, m), device="cuda")
    parts = torch.empty((b * n_cluster,), dtype=torch.float64, device="cuda")
    turn = [0]

    def launch(which):
        turn[0] += 1
        k = turn[0] % n_buf
        args = (xs[k].data_ptr(), log_t.data_ptr(), gys[k].data_ptr(), grad_x.data_ptr(),
                parts.data_ptr(), b, d, m)
        stream = torch.cuda.current_stream().cuda_stream
        err = (which.bdc_pool_backward_launch_cluster(*args, n_cluster, stream)
               if which is prof else which.bdc_pool_backward_launch(*args, stream))
        if err != 0:
            raise RuntimeError(f"bdc_pool_backward launch failed with CUDA error {err}")

    def wrapper():
        turn[0] += 1
        k = turn[0] % n_buf
        bdc_cuda.bdc_pool_triu_backward(xs[k], log_t, gys[k])

    print(f"shape {(b, d, m)}: clusters of {n_cluster} blocks, grid {b * n_cluster}, "
          f"{n_buf} input buffers in turn")
    print(f"  with phase clocks, CUDA graph of launches: {graph_ms(lambda: launch(prof)):.4f} ms")
    if not cluster:
        print(f"  kernel alone, CUDA graph of launches: {graph_ms(lambda: launch(lib)):.4f} ms")
        print(f"  wrapper (kernel + the log_t sum), CUDA graph: {graph_ms(wrapper):.4f} ms; "
              f"eager, one call after another: {time_ms(wrapper):.4f} ms")
    launch(prof)
    torch.cuda.synchronize()
    cycles, grid = read_phases(prof, "bdc_pool_backward")
    n_phases, profiled_blocks, _ = cycles.shape
    if n_phases != len(BACKWARD_PHASES):
        raise RuntimeError(f"the kernel counts {n_phases} phases, "
                           f"{len(BACKWARD_PHASES)} are named here")
    blocks = min(grid, profiled_blocks)
    print(f"grid {grid} blocks, one column slice of one element a block; SM cycles a "
          f"block over the first {blocks} (mean over warps; range over warps):")
    print_phases(BACKWARD_PHASES, cycles[:, :blocks])
    sm = np.zeros(4096, dtype=np.uint32)  # kMaxProfiledGrid
    err = prof.bdc_pool_backward_read_block_sms(sm.ctypes.data)
    if err != 0:
        raise RuntimeError(f"reading the blocks' SMs failed with CUDA error {err}")
    per_sm = np.bincount(sm[:min(grid, sm.size)].astype(np.int64))
    per_sm = per_sm[per_sm > 0]
    counts = {int(k): int((per_sm == k).sum()) for k in np.unique(per_sm)}
    print(f"  blocks an SM: {counts} (blocks: SMs), {per_sm.size} SMs used")
    for k, source in enumerate(sources):
        other = ctypes.CDLL(str(build_library(f"bdc_pool_backward_other{k}", [Path(source)])))
        other.bdc_pool_backward_launch.argtypes = lib.bdc_pool_backward_launch.argtypes
        other.bdc_pool_backward_launch.restype = ctypes.c_int
        # the same inputs; its log_t partials fit in this kernel's buffer
        mine, theirs = graph_ms(lambda: launch(lib)), graph_ms(lambda: launch(other))
        print(f"  CUDA graph of launches, in turn: this kernel {mine:.4f} ms, {source} "
              f"{theirs:.4f} ms, {graph_ms(lambda: launch(other)):.4f} ms, this kernel "
              f"{graph_ms(lambda: launch(lib)):.4f} ms")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--backward", action="store_true",
                        help="the backward kernel (default: the forward)")
    parser.add_argument("--batch", type=int, default=None,
                        help="default 4496 (forward) or 75 (backward)")
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--positions", type=int, default=304)
    parser.add_argument("--cluster", type=int, default=None,
                        help="backward: blocks a cluster (1-8) instead of the library's choice")
    parser.add_argument("--compare", nargs="*", default=(), metavar="SOURCE",
                        help="backward: also time these versions of bdc_pool_backward.cu")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_bdc_pool: no CUDA device is available", file=sys.stderr)
        return 1
    b = args.batch if args.batch is not None else (75 if args.backward else 4496)
    d, m = args.dim, args.positions
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    if args.backward:
        return backward(b, d, m, args.cluster, args.compare)

    prof = ctypes.CDLL(str(build_library(
        "bdc_pool_profile", [bdc_cuda.SOURCE], extra_flags=("-DBDC_POOL_PROFILE",))))
    prof.bdc_pool_launch.argtypes = bdc_cuda.library().bdc_pool_launch.argtypes
    prof.bdc_pool_launch.restype = ctypes.c_int
    prof.bdc_pool_mma_rate.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    prof.bdc_pool_mma_rate.restype = ctypes.c_int

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
    # the shape of the clocks comes from the build that counts them
    cycles, grid = read_phases(prof, "bdc_pool")
    n_phases, profiled_blocks, warps = cycles.shape
    if n_phases != len(PHASES):
        raise RuntimeError(f"the kernel counts {n_phases} phases, {len(PHASES)} are named here")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = min(grid, profiled_blocks)
    elems = np.array([(b - i + grid - 1) // grid for i in range(blocks)], dtype=np.float64)
    print(f"grid {grid} blocks, {elems.mean():.2f} elements a block; SM cycles per "
          f"element and block (mean over warps; range over warps):")
    print_phases(PHASES, cycles[:, :blocks] / elems[None, :, None])

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
