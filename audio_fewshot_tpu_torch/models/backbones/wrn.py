"""WideResNet, WRN-28-10 by default (counterpart of ``WRNBlock`` /
``WideResNet`` in ``audio_fewshot_tpu/models/backbones/wrn.py``).

A 3×3 stem to 16 channels, three groups of (depth − 4)/6 pre-activation
blocks at 16/32/64 × ``widen_factor`` with strides 1/2/2, a final BN and
ReLU, then, under the flag named ``avg_pool``, a MAX over the map (as the
reference's ``adaptive_max_pool2d`` and the JAX package), in float32.
State-dict keys are the reference's: ``conv1``, ``block{g}.layer.{b}.{bn1,
conv1,bn2,conv2,convShortcut}``, ``bn1``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..init import lecun_normal_
from .layers import BatchNorm, Conv2d, Dropout, backbone_factory


class WRNBlock(nn.Module):
    """BN → ReLU (``pre``) → conv3×3 (stride on it, padded (1, 1)) → BN →
    ReLU → Dropout (``drop_rate`` > 0, train mode) → conv3×3, plus ``x``
    where the width stays, else a 1×1 conv of ``pre``."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, drop_rate: float = 0.0,
                 use_running_statistics: bool = True):
        super().__init__()
        self.bn1 = BatchNorm(inplanes, use_running_statistics)
        self.conv1 = Conv2d(inplanes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = BatchNorm(planes, use_running_statistics)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.drop = Dropout(drop_rate) if drop_rate > 0 else None
        self.convShortcut = (None if inplanes == planes
                             else Conv2d(inplanes, planes, 1, stride, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = F.relu(self.bn1(x))
        out = F.relu(self.bn2(self.conv1(pre)))
        if self.drop is not None:
            out = self.drop(out)
        out = self.conv2(out)
        return out + (x if self.convShortcut is None else self.convShortcut(pre))


class _Group(nn.Module):
    """The reference's ``NetworkBlock``: its blocks under ``layer``."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        self.layer = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class WideResNet(nn.Module):
    """WRN over ``[N, C, F, T]`` spectrograms: ``[N, 64·widen]`` with
    ``avg_pool`` and ``is_flatten``, the map ``[N, c, h, w]`` (or ``[N, c,
    1, 1]`` after the max) otherwise; flattened without the max, NHWC order.
    The weights are drawn as flax's defaults."""

    def __init__(self, depth: int = 28, widen_factor: int = 10, drop_rate: float = 0.0,
                 is_flatten: bool = True, avg_pool: bool = True, num_channels: int = 1,
                 use_running_statistics: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"WRN depth must be 6n + 4, got {depth}")
        n = (depth - 4) // 6
        self.widths = tuple(w * widen_factor for w in (16, 32, 64))
        self.dtype = dtype
        self.is_flatten = is_flatten
        self.avg_pool = avg_pool
        self.conv1 = Conv2d(num_channels, 16, 3, padding=1, bias=False)
        inplanes = 16
        for g, width in enumerate(self.widths):
            blocks = []
            for b in range(n):
                stride = (1 if g == 0 else 2) if b == 0 else 1
                blocks.append(WRNBlock(inplanes, width, stride, drop_rate, use_running_statistics))
                inplanes = width
            setattr(self, f"block{g + 1}", _Group(blocks))
        self.bn1 = BatchNorm(inplanes, use_running_statistics)
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight)

    def map_shape(self, spec_shape: Sequence[int]) -> Tuple[int, int, int]:
        """``(c, h, w)`` of the output for a ``spec_shape`` segment (1 × 1
        after the max): groups 2 and 3 halve each side, rounding up."""
        h, w = spec_shape[-2:]
        for _ in range(2):
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        return (self.widths[-1], 1, 1) if self.avg_pool else (self.widths[-1], h, w)

    def feature_dim(self, spec_shape: Sequence[int]) -> int:
        c, h, w = self.map_shape(spec_shape)
        return c * h * w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.to(self.dtype))
        x = self.block3(self.block2(self.block1(x)))
        x = F.relu(self.bn1(x)).float()
        if self.avg_pool:
            x = x.amax(dim=(2, 3), keepdim=True)
        if self.is_flatten:
            return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return x


wrn = BACKBONES.register("WRN")(backbone_factory(WideResNet))
