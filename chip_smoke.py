"""Chip smoke test of the PyTorch/CUDA port (``audio_fewshot_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure ends the script with a non-zero exit code):

1. versions, and the card's name and power limit from ``nvidia-smi``;
2. build the CUDA kernels from ``audio_fewshot_tpu_torch/csrc``; a kernel
   that spills registers fails the run;
3. each kernel against its plain PyTorch version on the card, in float32
   with TF32 off, at the main-path shape and at odd shapes (every padded
   width of the kernel on both of its load paths), and on three
   adversarial inputs (post-ReLU, near-duplicate rows, scaled by 30) where
   both are also held against a float64 evaluation (max abs error limit
   5e-4 each) beside a plain emulation of the kernel's arithmetic, with the
   kernel's, the plain version's and the bound's time;
   a timed call rotates over input buffers larger than the L2 cache together;
4. the slice: DeepBDC + resnet12Bdc episodic evaluation at full width
   (``deepbdc_5shot_iid_seed0`` as a dict, on a ``synthetic`` root of
   ``[1, 128, 157]`` log-mel segments, ragged query clips of up to 6
   segments, 16 episodes per step), through the port's ``Test``: the val
   calibration pass, one warm-up step and the test epochs, at the default
   bf16.  Kernel launch counts are reset just before it and read just after;
5. one float32 batch: segment logits on the card against the same model on
   the CPU;
6. a JSON line with each kernel's launches, error and times, then the card's
   ``nvidia-smi`` line, then ``{"ok": true, "device": {...}}`` as the last line.

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import copy
import json
import math
import re
import subprocess
import sys
import tempfile
import time

# peak rates of the variant the run names (NVIDIA data sheets, dense, without
# sparsity): float32 on the CUDA cores, and device-memory bandwidth
PEAKS = {
    "H100 SXM": {"fp32_flops": 67e12, "bytes": 3.35e12},
    "H100 PCIe": {"fp32_flops": 51e12, "bytes": 2.0e12},
}
ERR_LIMIT = 5e-4
# float32 segment logits, card vs CPU: the convolutions sum in another order
# (cuDNN vs oneDNN) through 13 layers, and -|q-p|^2 = 2qp - |q|^2 - |p|^2
# cancels, so the limit is relative to the logits' scale
LOGIT_REL_LIMIT = 1e-3
# Recorded, not measured by this script: the kernel's time before its redesign
# for Hopper, at the main-path shape (4496, 64, 304) on an NVIDIA H100 80GB
# HBM3 at 700 W.  Printed as context only, never in the `kernels` line.
BDC_POOL_MS_FIRST_DESIGN = 0.5667
L2_BYTES = 50 * 2 ** 20


def card_peaks(name: str):
    return PEAKS["H100 PCIe"] if "PCIe" in name else PEAKS["H100 SXM"]


def time_ms(fn, reps: int = 20) -> float:
    import torch

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


def ptxas_report(log: str) -> tuple:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: the template
    arguments of ``bdc_pool_kernel<NB, TMA>`` (d padded to 16·NB; loads by
    tensor map or by 4-byte copies), registers, spills, shared memory.
    Returns the lines and those among them that report a spill."""
    lines, spilled, name = [], [], None
    for line in log.splitlines():
        found = re.search(r"bdc_pool_kernelILi(\d+)ELb([01])EE", line)
        if "Compiling entry function" in line and found:
            name = f"d <= {16 * int(found[1])}, {'tensor map' if found[2] == '1' else 'scalar'} loads"
        elif "spill" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", spills)):
                spilled.append(lines[-1])
            name = None
    return lines, spilled


def bdc_pool_smem_bytes(d: int) -> int:
    """Dynamic shared memory a ``bdc_pool`` launch asks for at this d (padded
    to Dp = 16·ceil(d/16)), as ``smem_bytes`` of the source lays it out: 1024
    bytes to align the ring, 3 stages of [Dp][64] floats, the gram
    [Dp][Dp + 8], the diagonal and the row means [Dp] each, 3 mbarriers."""
    dp = 16 * ((d + 15) // 16)
    return 1024 + 4 * (3 * dp * 64 + dp * (dp + 8) + 2 * dp) + 3 * 8


def rotating(xs):
    """Yield the buffers in turn, forever: no timed launch finds its input
    in the L2 cache that the launch before it filled."""
    i = 0
    while True:
        yield xs[i % len(xs)]
        i += 1


def adversarial_inputs(x, gen):
    """Inputs on which the rounding of the gram shows most: what the pool
    sees behind a ReLU, channel rows that (nearly) coincide, and a large
    scale."""
    import torch

    dup = x.clone()
    dup[:, 1] = dup[:, 0]
    dup[:, 3] = dup[:, 2] * (1.0 + 1e-4)
    dup[:, 5] = dup[:, 4] + 1e-3 * torch.randn(
        dup[:, 4].shape, device=x.device, generator=gen)
    dup[:, -1] = dup[:, 7]
    return {"post_relu": torch.relu(x - 0.5), "near_duplicate_rows": dup,
            "times_30": x * 30.0}


def bdc_bound_ms(b: int, d: int, m: int, peaks) -> tuple:
    """Least time for the fused BDC pool: the fp32 FLOPs of the gram's upper
    triangle, B·d(d+1)·M (the gram is symmetric and only the upper triangle
    is written; the epilogue's O(B·d²) is under 1 % at M = 304), against x
    read once and the upper triangle written once."""
    flops = 1.0 * b * d * (d + 1) * m
    nbytes = 4.0 * (b * d * m + 1 + b * d * (d + 1) // 2)
    t_ops = flops / peaks["fp32_flops"]
    t_bytes = nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from audio_fewshot_tpu_torch.data import get_dataloader
    from audio_fewshot_tpu_torch.episode import EpisodeBatch
    from audio_fewshot_tpu_torch.eval import Test, slice_config
    from audio_fewshot_tpu_torch.models import build_method, eval_setting
    from audio_fewshot_tpu_torch.ops import bdc_cuda
    from audio_fewshot_tpu_torch.ops.bdc import (
        bdc_from_gram, bdc_pool, gram_split_tf32, triuvec)
    from audio_fewshot_tpu_torch.utils.checkpoint import save_model_best
    from audio_fewshot_tpu_torch.utils.seed import init_seed

    # -- 1. versions and card -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peaks = card_peaks(kind)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {kind}")
    print(f"nvidia-smi: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build -------------------------------------------------------------
    t0 = time.time()
    bdc_cuda.library()
    print(f"[build] bdc_pool built and loaded in {time.time() - t0:.2f} s")
    report, spilled = ptxas_report(
        bdc_cuda.library_path().with_suffix(".log").read_text())
    for line in report:
        print("[build]", line)
    print("[build] dynamic shared memory asked at launch: " + ", ".join(
        f"d = {d}: {bdc_pool_smem_bytes(d)} B" for d in (16, 64, 128)))
    if spilled or not report:
        raise AssertionError(f"bdc_pool spills registers (or ptxas reported nothing): {spilled}")
    print(flush=True)

    # -- 3. kernel vs plain ---------------------------------------------------
    cfg = slice_config()
    setting = eval_setting(cfg)
    probe = next(iter(get_dataloader(cfg, "test")[0].epoch(0)))
    b_main = probe.support.shape[0] * (probe.support.shape[1] + probe.query.shape[1])
    m_main = (128 // 8) * (157 // 8)  # stage-4 map of a [1, 128, 157] segment
    del probe
    gen = torch.Generator(device="cuda").manual_seed(0)
    log_t = torch.full((1, 1), math.log(1.0 / (2.0 * m_main)), device="cuda")
    max_err = 0.0
    times = {}
    # (B, d, M, floats the base pointer is off a 16-byte boundary): an M that
    # is no multiple of 4 and the shifted pointer take the kernel's scalar
    # loads, the others its tensor-map loads; each path runs at every padded
    # d = 16, 32, ..., 128
    for b, d, m, shift in [
            (1200, 64, m_main, 0), (b_main, 64, m_main, 0), (2, 16, 45, 0),
            (3, 100, 77, 0), (5, 128, 33, 0), (3, 128, 40, 0), (2, 100, 76, 0),
            (2, 96, 300, 0), (2, 80, 64, 0), (3, 48, 8, 0), (4, 32, 12, 0),
            (2, 16, 8, 0), (2, 64, m_main, 1), (2, 32, 13, 0), (2, 48, 9, 0),
            (2, 80, 65, 0), (2, 96, 301, 0)]:
        x = torch.randn((b * d * m + shift,), device="cuda", generator=gen)
        x = x[shift:].view(b, d, m)
        tri, full = bdc_cuda.bdc_pool_triu(x, log_t, return_full=True)
        ref = bdc_pool(x, log_t)
        torch.cuda.synchronize()
        err_tri = (tri - triuvec(ref)).abs().max().item()
        err_full = (full - ref).abs().max().item()
        print(f"[kernel] bdc_pool {(b, d, m)}{' off 16-byte alignment' if shift else ''}: "
              f"max_abs_err triu {err_tri:.3e} "
              f"full {err_full:.3e} (limit {ERR_LIMIT:g})")
        if not (err_tri <= ERR_LIMIT and err_full <= ERR_LIMIT):
            raise AssertionError(f"bdc_pool kernel disagrees with plain at {(b, d, m)}")
        max_err = max(max_err, err_tri, err_full)
        del tri, full, ref
        if d == 64 and b >= 1200:
            # enough buffers that together they exceed the L2 cache twice over
            n_buf = max(1, math.ceil(2 * L2_BYTES / (4 * x.numel())))
            xs = [x] + [torch.randn((b, d, m), device="cuda", generator=gen)
                        for _ in range(n_buf - 1)]
            feed = rotating(xs)
            ms = time_ms(lambda: bdc_cuda.bdc_pool_triu(next(feed), log_t))
            plain_ms = time_ms(lambda: triuvec(bdc_pool(next(feed), log_t)))
            gram_ms = time_ms(lambda: torch.bmm(y := next(feed), y.mT))
            bound_ms, bound_by = bdc_bound_ms(b, d, m, peaks)
            times[b] = (ms, plain_ms, bound_ms, bound_by)
            print(f"[kernel] bdc_pool {(b, d, m)}: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"over {n_buf} input buffer(s) in turn; "
                  "library: none (no single PyTorch call computes the BDC pool)")
            print(f"[kernel] context: torch.bmm(x, x.mT) alone, the gram and not "
                  f"the function, {gram_ms:.4f} ms")
            if b == b_main:
                print(f"[kernel] context: a recorded constant, not measured in this "
                      f"run: before its redesign for Hopper the kernel took "
                      f"{BDC_POOL_MS_FIRST_DESIGN} ms at this shape on an NVIDIA "
                      f"H100 80GB HBM3 at 700 W")
            del xs, feed
        del x
    # the three adversarial inputs, both routes against float64 on the card
    base = torch.randn((64, 64, m_main), device="cuda", generator=gen)
    for case, x in adversarial_inputs(base, gen).items():
        tri, full = bdc_cuda.bdc_pool_triu(x, log_t, return_full=True)
        ref = bdc_pool(x, log_t)
        x64 = x.double()
        truth = bdc_from_gram(torch.bmm(x64, x64.mT), log_t)
        err_plain = max((tri - triuvec(ref)).abs().max().item(),
                        (full - ref).abs().max().item())
        err_kernel64 = (full.double() - truth).abs().max().item()
        err_plain64 = (ref.double() - truth).abs().max().item()
        # diagnosis only: the kernel's arithmetic in plain PyTorch.  If this
        # is off too the split is too coarse, if only the kernel is, it has a bug
        split = bdc_from_gram(gram_split_tf32(x), log_t)
        err_split64 = (split.double() - truth).abs().max().item()
        print(f"[kernel] bdc_pool {case} {tuple(x.shape)}: kernel vs plain "
              f"{err_plain:.3e}; vs float64: kernel {err_kernel64:.3e}, plain "
              f"{err_plain64:.3e}, split-TF32 emulation {err_split64:.3e} "
              f"(limit {ERR_LIMIT:g})")
        if not (err_plain <= ERR_LIMIT and err_kernel64 <= ERR_LIMIT):
            raise AssertionError(f"bdc_pool kernel is off on the {case} input")
        max_err = max(max_err, err_plain)
        del x, tri, full, ref, x64, truth, split
    del base
    print(flush=True)

    # -- 4. the slice ---------------------------------------------------------
    with tempfile.TemporaryDirectory() as result_path:
        init_seed(int(cfg["seed"]))
        save_model_best(result_path, build_method(cfg))  # random weights from the seed
        torch.cuda.reset_peak_memory_stats()
        bdc_cuda.launches = 0
        t0 = time.time()
        test = Test(0, cfg, result_path, device="cuda")
        acc, ci = test.test_loop()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = bdc_cuda.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    th = test.method.uncertain_global_threshold
    n_epochs = int(cfg["test_epoch"])
    backbone_calls = len(test.val_loader[0]) + 1 + n_epochs * len(test.test_loader[0])
    print(f"[slice] accuracy {acc:.3f} ± {ci:.3f}, threshold {th}, "
          f"{wall:.1f} s wall (setup + calibration + warm-up + {n_epochs} epochs)")
    print(f"[slice] eps/s per epoch {[round(r, 2) for r in test.epoch_eps]}, "
          f"peak memory {peak_gib:.2f} GiB, bdc_pool launches {launches} "
          f"(backbone calls {backbone_calls}), batch of {b_main} segments")
    if not (math.isfinite(acc) and th is not None and math.isfinite(th)):
        raise AssertionError(f"non-finite slice result: acc {acc}, threshold {th}")
    if launches != backbone_calls:
        raise AssertionError(f"bdc_pool launched {launches} times, expected {backbone_calls}")
    del test
    torch.cuda.empty_cache()
    print(flush=True)

    # -- 5. one float32 batch: card vs CPU -------------------------------------
    cfg32 = slice_config(precision="fp32")
    init_seed(int(cfg32["seed"]))
    method_cpu = build_method(cfg32).eval()
    method_gpu = copy.deepcopy(method_cpu).cuda()
    full_batch = next(iter(get_dataloader(cfg32, "test")[0].epoch(0)))
    g = 64  # episode 0 and its first 64 query segments (each scored alone)
    batch = EpisodeBatch(
        support=full_batch.support[:1], query=full_batch.query[:1, :g],
        query_clip=full_batch.query_clip[:1, :g], query_mask=full_batch.query_mask[:1, :g],
        support_target=full_batch.support_target[:1],
        query_target=full_batch.query_target[:1],
    )
    with torch.no_grad():
        on_gpu = method_gpu(batch.to("cuda"), setting).cpu()
        on_cpu = method_cpu(batch.to("cpu"), setting)
    rel = ((on_gpu - on_cpu).abs().max() / on_cpu.abs().max()).item()
    print(f"[fp32] segment logits {tuple(on_gpu.shape)}: card vs CPU max|Δ|/max|logit| "
          f"{rel:.3e} (limit {LOGIT_REL_LIMIT:g}), argmax agreement "
          f"{(on_gpu.argmax(-1) == on_cpu.argmax(-1)).float().mean().item():.4f}")
    if not (torch.isfinite(on_gpu).all() and rel <= LOGIT_REL_LIMIT):
        raise AssertionError("float32 card logits disagree with the CPU")
    print(flush=True)

    # -- 6. report --------------------------------------------------------------
    ms, plain_ms, bound_ms, bound_by = times[b_main]
    print(json.dumps({"kernels": [{
        "name": "bdc_pool",
        "route": "cuda",
        "source": "audio_fewshot_tpu_torch/csrc/bdc_pool.cu",
        "replaces": "audio_fewshot_tpu/ops/bdc_pallas.py:23",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
