"""The program's evaluation entry as the eval drivers run it.

``EvalSession`` builds ``eval.Test`` for a cell (its loaders, the device
segment bank, the method), loads the benchmark's weights into the method,
and keeps, for every step the window runs, the step's clip ids, mask,
targets, segment logits (read by a forward hook on the method, as the
timed path produces them) and per-episode accuracies, on the device.  After
the window a sample of those steps, drawn from the seed, goes to the host
and the program is freed before the reference runs.
"""

from __future__ import annotations

import gc
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import manifest, program
from .manifest import Cell
from .reference import judge


class EvalSession:
    KIND = "eval"

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 overrides: Optional[Dict[str, Any]] = None):
        from audio_fewshot_tpu_torch.eval import Test

        self.cell, self.seed, self.device, self.overrides = cell, int(seed), device, overrides
        self.cfg = program.config(cell, seed, overrides)
        self.test = Test(0, self.cfg, None, device=device)
        self.method = self.test.method
        self.weights = program.load_weights(self.method, cell, seed, device, overrides)
        self.loader = self.test.test_loader[0]
        self.size = int(self.cfg["test_episode_size"])
        self.segment_flops = manifest.flops(cell).segment_flops(
            program.model_config(cell, overrides))
        self._logits: Optional[torch.Tensor] = None
        self._hook = self.method.register_forward_hook(self._keep_logits)
        #: every step the window ran: (epoch, step, device batch, logits, accuracies)
        self.steps: List[tuple] = []
        self.attempted = self.failed = 0

    def _keep_logits(self, module, args, output) -> None:
        self._logits = output

    def device_step(self, batch) -> torch.Tensor:
        """``Test._device_step`` of a batch already on the device, under
        ``no_grad`` as ``Test.test_loop`` runs it."""
        with torch.no_grad():
            return self.test._device_step(batch, None)

    def keep(self, epoch: int, step: int, batch, acc: torch.Tensor) -> None:
        self.steps.append((epoch, step, batch, self._logits, acc))

    def bdc_shape(self, batch) -> Optional[tuple]:
        """``(B, d, M)`` of the BDC pool launch a step makes, where the
        backbone has one."""
        rows = batch.support_idx.shape[0] * (batch.support_idx.shape[1] + batch.query_idx.shape[1])
        return program.bdc_shape(self.cell, self.cfg, rows)

    def segments(self, batch) -> int:
        """Real (unpadded) segments of a host batch: its support rows and the
        valid query rows."""
        return int(np.asarray(batch.support_idx).size + np.asarray(batch.query_mask).sum())

    def check(self, control: bool = False) -> Dict[str, float]:
        """Free the program, then hold a sample of the window's steps
        against the reference; with ``control`` also the reference in the
        control's lower precision on the same episodes."""
        k = int(self.cell.traffic["check_steps"])
        picked = [self.steps[i] for i in program.sample_indices(self.seed, len(self.steps), k)]
        samples = [{"epoch": e, "step": s, "size": self.size,
                    "clip": b.query_clip.cpu().numpy(), "mask": b.query_mask.cpu().numpy(),
                    "target": b.query_target.cpu().numpy(), "logits": lg.float().cpu().numpy(),
                    "acc": acc.double().cpu().numpy()} for e, s, b, lg, acc in picked]
        self.release()
        return judge.eval_readings(manifest.reference(self.cell), self.weights,
                                   program.model_config(self.cell, self.overrides), self.seed,
                                   samples, self.device,
                                   ("fp32", "fp8") if control else ("fp32",))

    def release(self) -> None:
        """Drop the program's state: the method, the loaders, the banks."""
        self._hook.remove()
        self.steps.clear()
        self.test = self.method = self.loader = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
