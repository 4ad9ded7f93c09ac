"""Where the time of the train step goes on the card.

    python -m audio_fewshot_tpu_torch.profile_train [--steps 8]

Builds the training cell of ``train.slice_config`` (DeepBDC + resnet12Bdc,
[1, 128, 157] segments, one 5-way 5-shot 10-query episode a step, bf16,
Adam, augmentation on) through ``Trainer``, runs a few warm-up steps, then
``--steps`` train steps under ``torch.profiler`` (each as the train loop
runs it: batch to the device, augmentation, loss, backward, optimizer step,
the loss read back) and prints the device time by kernel category, the top
kernels, the device-busy share of the window, and the step time.  Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .profile_eval import report
from .train import Trainer, slice_config

WARMUP_STEPS = 3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device is available", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as result_root:
        cfg = slice_config(result_root)
        cfg["train_episode"] = WARMUP_STEPS + args.steps
        trainer = Trainer(0, cfg, device="cuda")
        trainer.method.train()
        gen = torch.Generator().manual_seed(0)

        def step(host_batch) -> float:
            batch = trainer._augment_batch(
                trainer._device_batch(host_batch, trainer.train_bank), gen)
            return float(trainer._train_step(batch)["loss"])

        batches = list(trainer.train_loader[0].epoch(0))
        for host_batch in batches[:WARMUP_STEPS]:
            step(host_batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            for host_batch in batches[WARMUP_STEPS:]:
                step(host_batch)
            torch.cuda.synchronize()
            wall_us = (time.time() - t0) * 1e6
    n = len(batches) - WARMUP_STEPS
    report(prof, wall_us, f"{n} train steps of 75 segments ({wall_us / 1e3 / n:.1f} ms/step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
