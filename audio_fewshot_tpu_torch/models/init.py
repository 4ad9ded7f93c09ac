"""Weight re-initialisation keyed by ``init_type`` (counterpart of
``audio_fewshot_tpu/models/init.py``).

``init_weights`` redraws the weight of every Conv and Linear module (rank
≥ 2) of a built model in place; biases and norm scales are untouched.  The
distributions are the JAX package's flax initialisers: ``normal`` is
N(0, 0.02²); ``kaiming`` (``he_normal``) and ``xavier`` (``xavier_normal``)
are truncated normals at ±2 standard deviations whose variance is
2 / fan_in and 2 / (fan_in + fan_out) — the standard deviation before
truncation is divided by 0.8796…, the standard deviation of a unit normal
truncated at ±2; ``orthogonal`` is an orthogonal matrix over the weight
flattened to [out, in·k·k] (flax's [k·k·in, out], transposed).  Fans are the
same in both layouts.  The draws come from an explicit ``torch.Generator``,
so they differ from the JAX package's.
"""

from __future__ import annotations

import math

import torch
from torch import nn

INIT_TYPES = ("kaiming", "normal", "orthogonal", "xavier")
# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNCATED_STD = 0.87962566103423978


def _truncated(w: torch.Tensor, variance: float, gen: torch.Generator) -> None:
    std = math.sqrt(variance) / _TRUNCATED_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, generator: torch.Generator = None) -> None:
    """flax's ``lecun_normal`` in place: the truncated normal of variance
    1 / fan_in (heads whose JAX counterparts draw their kernels so)."""
    fan_in, _ = nn.init._calculate_fan_in_and_fan_out(w)
    _truncated(w, 1.0 / fan_in, generator)


@torch.no_grad()
def init_weights(model: nn.Module, init_type: str, generator: torch.Generator) -> None:
    """Redraw the weight of every Conv and Linear of ``model`` with the
    named initialiser."""
    if init_type not in INIT_TYPES:
        raise ValueError(f"unknown init_type {init_type!r}; choose from {sorted(INIT_TYPES)}")
    for module in model.modules():
        if not isinstance(module, (nn.modules.conv._ConvNd, nn.Linear)):
            continue
        w = module.weight
        fan_in, fan_out = nn.init._calculate_fan_in_and_fan_out(w)
        if init_type == "normal":
            nn.init.normal_(w, 0.0, 0.02, generator=generator)
        elif init_type == "kaiming":
            _truncated(w, 2.0 / fan_in, generator)
        elif init_type == "xavier":
            _truncated(w, 2.0 / (fan_in + fan_out), generator)
        else:
            nn.init.orthogonal_(w, generator=generator)
