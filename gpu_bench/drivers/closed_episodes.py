"""One client, one episode at a time: the online few-shot user, who enrols
a new class from its support clips and waits for the query clips' labels.

Each request takes the loader's next episode (``test_episode_size`` 1),
copies it to the device (``parallel.shard_batch``), runs
``Test._device_step`` and reads its accuracy back; the next request is sent
only then.  An episode's latency runs from the request to its accuracy on
the host.  ``episode_ms_p95`` is the 95th percentile over every episode of
the window.

Traffic parameters: ``config`` (``test_episode_size`` 1, ``test_episode``),
``warmup_steps``, ``trace_steps``, ``check_steps`` (episodes the comparison
samples).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, Tuple

from torch.profiler import record_function

from ..session import EvalSession


class Session(EvalSession):
    def _request(self, episodes, spans: bool = False):
        """One episode: the loader's next one, its copy to the device, the
        step, the accuracy on the host.  Returns its epoch and step, the
        host and device batches, the accuracy and the host ms spent inside
        the step's call."""
        from audio_fewshot_tpu_torch.parallel import shard_batch

        test = self.test
        span = record_function if spans else lambda name: contextlib.nullcontext()
        with span("bench.next_batch"):
            epoch, step, host = next(episodes)
        batch = shard_batch(host, test.step_world, test.transfer_dtype)
        t0 = time.perf_counter()
        with span("bench.device_step"):
            acc = self.device_step(batch)
        dispatch_ms = (time.perf_counter() - t0) * 1e3
        with span("bench.read_back"):
            acc = acc.cpu()
        return epoch, step, host, batch, acc, dispatch_ms

    def _episodes(self, epoch: int):
        """``(epoch, step, host batch)`` of the loader's episodes from
        ``epoch`` on, epoch after epoch."""
        while True:
            yield from ((epoch, step, b) for step, b in enumerate(self.loader.epoch(epoch)))
            epoch += 1

    def warm_up(self) -> None:
        episodes = self._episodes(0)
        for _ in range(int(self.cell.traffic["warmup_steps"])):
            self._request(episodes)
        episodes.close()

    def measure(self, seconds: float) -> Tuple[Dict[str, float], Dict]:
        latencies, dispatches, segments = [], [], 0
        episodes = self._episodes(0)
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            epoch, step, host, batch, acc, dispatch_ms = self._request(episodes)
            latencies.append((time.perf_counter() - t0) * 1e3)
            dispatches.append(dispatch_ms)
            segments += self.segments(host)
            self.attempted += 1
            self.failed += int(not bool(acc.isfinite().all()))
            self.keep(epoch, step, batch, acc)
        wall = time.perf_counter() - t_start
        episodes.close()
        self.next_epoch = epoch + 1
        p95 = (statistics.quantiles(latencies, n=100, method="inclusive")[94]
               if len(latencies) > 1 else latencies[0])
        return {"episode_ms_p95": p95}, {"episode_ms": latencies, "dispatch_ms": dispatches,
                                         "window_s": wall,
                                         "model_flops": segments * self.segment_flops}

    def profile_steps(self) -> None:
        n = int(self.cell.traffic["trace_steps"])
        self.trace_counters = {"bdc_shapes": []}
        episodes = self._episodes(self.next_epoch)
        for _ in range(n):
            batch = self._request(episodes, spans=True)[3]
            shape = self.bdc_shape(batch)
            if shape:
                self.trace_counters["bdc_shapes"].append(shape)
        episodes.close()
