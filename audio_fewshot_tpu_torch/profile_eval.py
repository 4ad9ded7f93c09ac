"""Where the time of the eval step goes on the card.

    python -m audio_fewshot_tpu_torch.profile_eval [--steps 4] [--classifier ProtoNet]

Builds an eval cell of ``eval.slice_config`` (``--classifier DeepBDC``, the
default: DeepBDC + resnet12Bdc; ``ProtoNet``: ProtoNet + Conv64F; a Conv64F
metric head such as ``MCL`` or ``DN4``; ``ProtoNet:WRN`` and the other cells
of a backbone swapped in; each at [1, 128, 157] segments, 16 episodes per
step or the cell's own count, bf16) through ``Test``, warms
up, times ``--steps`` eval steps without the profiler, then runs them again
under ``torch.profiler`` and prints the device time by kernel category and
the top kernels, the device-busy share of the window, and the step times
with and without the profiler.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .eval import SLICE_MODELS, Test, slice_config

# first matching substring of the kernel name decides its category
CATEGORIES = (
    ("bdc_pool kernel", ("bdc_pool_kernel",)),
    ("bdc_pool_backward kernel", ("bdc_pool_backward_kernel",)),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("layout transpose", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("convolution", ("conv", "xmma", "fprop", "implicit", "wgrad", "dgrad", "cudnn")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_fw")),
    ("max pool", ("max_pool",)),
    ("linear algebra (LU, solve)", ("getrf", "getrs", "getri", "trsm", "laswp", "magma",
                                    "cusolver", "lu_")),
    ("top-k / sort", ("topk", "sort", "radix", "bitonic")),
    ("softmax / logsumexp", ("softmax", "logsumexp")),
    ("matmul", ("gemm", "cutlass", "cublas")),
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


def report(prof, wall_us: float, header: str) -> None:
    """Print the device time of a ``torch.profiler`` window by category,
    the top kernels, and the device-busy share of the wall time."""
    by_cat = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        # a user annotation (``Optimizer.step#Adam.step``) spans kernels: not kernel time
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        us = evt.self_device_time_total
        kernels.append((us, evt.count, evt.key))
        by_cat[category(evt.key)] += us
    busy = sum(by_cat.values())
    print(f"device {torch.cuda.get_device_name(0)}; {header}; wall {wall_us / 1e3:.1f} ms; "
          f"device busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f} % of wall)")
    for cat, us in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat:24s} {us / 1e3:10.2f} ms  {100 * us / max(busy, 1e-9):5.1f} %")
    print("top kernels (device ms, calls, name):")
    for us, count, name in sorted(kernels, reverse=True)[:15]:
        print(f"  {us / 1e3:10.2f} {count:6d}  {name[:110]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--classifier", choices=sorted(SLICE_MODELS), default="DeepBDC")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_eval: no CUDA device is available", file=sys.stderr)
        return 1
    size = slice_config(classifier=args.classifier)["test_episode_size"]
    cfg = slice_config(test_episode=size * args.steps, test_epoch=1, classifier=args.classifier)
    test = Test(0, cfg, None, device="cuda")
    batches = list(test.test_loader[0].epoch(0))
    torch.set_grad_enabled(False)  # as ``Test.test_loop`` runs its steps
    test._eval_step(batches[0]).cpu()  # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    for batch in batches:
        test._eval_step(batch)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3 / len(batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for batch in batches:
            test._eval_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    report(prof, wall_us, f"{args.classifier}: {len(batches)} eval steps of "
           f"{cfg['test_episode_size']} episodes "
           f"({wall_us / 1e3 / len(batches):.1f} ms/step; {plain_ms:.1f} without the profiler)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
