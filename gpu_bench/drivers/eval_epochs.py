"""Test epochs back to back, as ``Test._test_loop`` runs them.

Each epoch: ``parallel.transfer_ahead`` over ``test_loader[0].epoch(e)``
(each step's bank rows copied one step ahead), ``Test._device_step`` a
step, and the accuracies drained to the host every ``eval_queue_depth``
steps.  The energy calibration pass is not run: the plain forward does not
read its threshold.  The window dispatches steps until ``--seconds`` have
passed, then drains; ``eval_eps`` is every episode it completed over the
whole time, the drain included.

Traffic parameters (``traffic/<mix>.json``): ``config`` (the program's
``test_episode_size``, ``test_episode``, ``eval_queue_depth``),
``warmup_steps``, ``trace_steps`` (the profiled stretch), ``check_steps``
(the window's steps the comparison samples).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Tuple

import torch
from torch.profiler import record_function

from ..session import EvalSession


class Session(EvalSession):
    def _batches(self, epoch: int):
        from audio_fewshot_tpu_torch.parallel import transfer_ahead

        test = self.test
        return transfer_ahead(self._counted(self.loader.epoch(epoch)), test.step_world,
                              test.transfer_dtype)

    def _counted(self, host_batches):
        """The host batches, each one's query slots, real query segments and
        real segments queued for ``_count`` (``transfer_ahead`` reads a batch
        ahead of the step that runs it)."""
        for b in host_batches:
            self._sizes.append((int(b.query_mask.size), int(b.query_mask.sum()),
                                self.segments(b)))
            yield b

    def _count(self) -> None:
        """Count the sizes of the step just dispatched."""
        slots, real, segments = self._sizes.popleft()
        self.counters["query_slots"] += slots
        self.counters["query_real"] += real
        self.counters["segments"] += segments

    def _stream(self, epoch: int):
        """``(epoch, step, device batch)`` from ``epoch`` on, epoch after epoch."""
        while True:
            yield from ((epoch, step, b) for step, b in enumerate(self._batches(epoch)))
            epoch += 1

    def warm_up(self) -> None:
        self._sizes = collections.deque()
        batches = self._batches(0)
        for _ in range(int(self.cell.traffic["warmup_steps"])):
            acc = self.device_step(next(batches))
        batches.close()
        self._sizes.clear()
        acc.cpu()

    def measure(self, seconds: float) -> Tuple[Dict[str, float], Dict]:
        self.counters = {"query_slots": 0, "query_real": 0, "segments": 0}
        depth = max(1, int(self.cfg.get("eval_queue_depth") or 32))
        pending, done = [], 0

        def drain():
            nonlocal done
            if pending:
                accs = torch.cat(pending).cpu()
                done += accs.numel()
                self.failed += int((~torch.isfinite(accs)).sum())
                pending.clear()

        t0 = time.perf_counter()
        deadline = t0 + seconds
        stream = self._stream(0)
        epoch = 0
        while time.perf_counter() < deadline:
            epoch, step, batch = next(stream)
            acc = self.device_step(batch)
            self._count()
            self.keep(epoch, step, batch, acc)
            self.attempted += acc.shape[0]
            pending.append(acc)
            if len(pending) >= depth:
                drain()
        stream.close()
        self._sizes.clear()  # the batch read ahead of the last step
        drain()
        wall = time.perf_counter() - t0
        self.counters["window_s"] = wall
        self.counters["model_flops"] = self.counters["segments"] * self.segment_flops
        self.next_epoch = epoch + 1
        return {"eval_eps": done / wall}, self.counters

    def profile_steps(self) -> None:
        """A fixed stretch of steady steps for the profiler, from the epoch
        after the window's."""
        n = int(self.cell.traffic["trace_steps"])
        self.trace_counters = {"bdc_shapes": []}
        batches = self._stream(self.next_epoch)
        pending = []
        for _ in range(n):
            with record_function("bench.next_batch"):
                batch = next(batches)[2]
            with record_function("bench.device_step"):
                pending.append(self.device_step(batch))
            shape = self.bdc_shape(batch)
            if shape:
                self.trace_counters["bdc_shapes"].append(shape)
        with record_function("bench.drain"):
            torch.cat(pending).cpu()
        batches.close()
