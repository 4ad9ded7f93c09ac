"""Device choice for the entry points: the card unless asked otherwise."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` or ``cuda``.  Raises when CUDA is asked for (explicitly or
    by default) and no CUDA device exists: a run never drifts to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU"
        )
    return dev
