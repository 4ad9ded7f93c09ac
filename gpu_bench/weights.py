"""The weights of a cell, made by the benchmark from the seed on the device.

The names and shapes come from the configuration's plain reference
(``reference/<config>.py``'s ``weight_spec``), so the program and the
reference are handed the same tensors and neither makes its own.  One
normal draw from a ``torch.Generator`` on the device covers every leaf;
each leaf then takes its slice, scaled by its kind:

- ``conv`` / ``linear``: He normal, √(2 / fan-in) / √(1 / fan-in);
- ``bias``: 0.1 · z;
- BatchNorm: scale 1 + 0.1 · z, shift 0.1 · z, running mean 0.1 · z,
  running variance exp(0.2 · z) (eval uses them, so they are drawn too);
- ``log_t``: the BDC head's log-temperature, log(1 / (2 · 16 · 19)) + 0.1 · z,
  the program's value at the ``[16, 19]`` map of a ``[1, 128, 157]`` segment;
- ``count``: BatchNorm's step counter, 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

LOG_T = math.log(1.0 / (2.0 * 16 * 19))


def draw(spec: List[Tuple[str, tuple, str]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` on ``device`` for every leaf of ``spec``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _ in spec]
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape, kind), n in zip(spec, sizes):
        v = z[at:at + n].reshape(shape)
        at += n
        if kind == "conv":
            fan_in = math.prod(shape[1:])
            v = v * math.sqrt(2.0 / fan_in)
        elif kind == "linear":
            v = v * math.sqrt(1.0 / shape[1])
        elif kind in ("bias", "bn_bias", "bn_mean"):
            v = 0.1 * v
        elif kind == "bn_weight":
            v = 1.0 + 0.1 * v
        elif kind == "bn_var":
            v = torch.exp(0.2 * v)
        elif kind == "log_t":
            v = LOG_T + 0.1 * v
        elif kind == "count":
            v = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
        out[name] = v.contiguous()
    return out
