"""Running meters and an optional TensorBoard writer (counterpart of
``audio_fewshot_tpu/utils/meters.py``).

``AverageMeter`` keeps sums, counts and last values per key and hands every
update to the writer; ``TensorboardWriter`` is a step-stamped proxy of
torch's ``SummaryWriter`` that does nothing where tensorboard is not
installed.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional


class AverageMeter:
    def __init__(self, name: str, keys: Iterable[str], writer: Optional["TensorboardWriter"] = None):
        self.name = name
        self.keys = list(keys)
        self.writer = writer
        self.reset()

    def reset(self) -> None:
        self._sum: Dict[str, float] = {k: 0.0 for k in self.keys}
        self._count: Dict[str, int] = {k: 0 for k in self.keys}
        self._last: Dict[str, float] = {k: 0.0 for k in self.keys}

    def update(self, key: str, value: float, n: int = 1) -> None:
        value = float(value)
        self._sum[key] += value * n
        self._count[key] += n
        self._last[key] = value
        if self.writer is not None:
            self.writer.add_scalar(f"{self.name}/{key}", value)

    def last(self, key: str) -> float:
        return self._last[key]

    def avg(self, key: str) -> float:
        c = self._count[key]
        return self._sum[key] / c if c else 0.0


class TensorboardWriter:
    """Step-stamped TensorBoard proxy, backed by torch's ``SummaryWriter``
    when tensorboard is installed and a no-op otherwise (and when not
    ``enabled``: the ranks but 0 of a run write nothing)."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.step = 0
        self._writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional
            pass
        else:
            self._writer = SummaryWriter(log_dir)

    def set_step(self, step: int) -> None:
        self.step = step

    def add_scalar(self, tag: str, value: float, step: Optional[int] = None) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, self.step if step is None else step)

    def add_histogram(self, tag: str, values, step: Optional[int] = None) -> None:
        if self._writer is not None:
            self._writer.add_histogram(tag, values, self.step if step is None else step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
