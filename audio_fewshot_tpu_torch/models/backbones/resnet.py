"""resnet12Bdc: ResNet-12 with a stride-1 stage 4 and a BDC pooling head
(counterpart of ``ResNet12BDC`` / ``BdcHead`` / ``BasicBlock3`` in
``audio_fewshot_tpu/models/backbones/resnet.py``).

State-dict keys are the reference torch names (``layer1.0.conv1.weight``,
``layer4.0.downsample.1.running_mean``, ``bdc_pool.conv_dr_block.0.weight``,
``bdc_pool.temperature``), so ``utils/convert.py`` maps the JAX package's
variables onto them.  The four stages compute in ``dtype`` (bf16 by
default); the BDC head always runs in float32.  Train mode uses batch
statistics and updates the running ones (``layers.BatchNorm``) and sends the
BDC gradient through the backward kernel on the card.  DropBlock
(``drop_rate > 0``, which no DeepBDC config sets) is not ported yet and
raises in train mode (ROADMAP Queue A).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.bdc_cuda import bdc_pool_triu
from ...registry import BACKBONES
from .layers import BatchNorm, Conv2d, clean_kwargs


class BasicBlock3(nn.Module):
    """Three conv3×3 + BN with a residual, LeakyReLU(0.1), then a 2×2 floor
    max-pool.  The residual is a 1×1 conv + BN when the width changes."""

    def __init__(self, inplanes: int, planes: int, use_pool: bool = True,
                 use_running_statistics: bool = True):
        super().__init__()
        conv = lambda cin: Conv2d(cin, planes, 3, padding=1, bias=False)
        bn = lambda: BatchNorm(planes, use_running_statistics)
        self.conv1, self.bn1 = conv(inplanes), bn()
        self.conv2, self.bn2 = conv(planes), bn()
        self.conv3, self.bn3 = conv(planes), bn()
        self.downsample = (
            nn.Sequential(Conv2d(inplanes, planes, 1, bias=False), bn())
            if inplanes != planes else None
        )
        self.use_pool = use_pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.bn1(self.conv1(x)), 0.1, inplace=True)
        out = F.leaky_relu(self.bn2(self.conv2(out)), 0.1, inplace=True)
        out = self.bn3(self.conv3(out))
        out += x if self.downsample is None else self.downsample(x)
        out = F.leaky_relu(out, 0.1, inplace=True)
        if self.use_pool:
            out = F.max_pool2d(out, 2, 2)
        return out


class BdcHead(nn.Module):
    """1×1 reduction conv + BN + ReLU, BDC pooling with a learnable
    log-temperature, upper-triangular vector of length d(d+1)/2.

    The pooling goes through ``ops.bdc_cuda.bdc_pool_triu``: the CUDA kernel
    on the card, its plain version on the CPU.  ``temperature`` is
    initialised to log(1 / (2·H·W)) for ``spatial`` (the stage-4 map of a
    [1, 128, 157] segment); checkpoints overwrite it."""

    def __init__(self, in_dim: int = 640, reduce_dim: int = 64,
                 activate: str = "relu", spatial: Tuple[int, int] = (16, 19)):
        super().__init__()
        self.conv_dr_block = None
        if reduce_dim and reduce_dim != in_dim:
            act = (nn.LeakyReLU(0.1, inplace=True) if activate == "leaky_relu"
                   else nn.ReLU(inplace=True))
            self.conv_dr_block = nn.Sequential(
                Conv2d(in_dim, reduce_dim, 1, bias=False), BatchNorm(reduce_dim), act,
            )
        h, w = spatial
        self.temperature = nn.Parameter(
            torch.full((1, 1), math.log(1.0 / (2.0 * h * w)))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.conv_dr_block is not None:
            x = self.conv_dr_block(x)
        n, d, h, w = x.shape
        return bdc_pool_triu(x.reshape(n, d, h * w).contiguous(), self.temperature)


class ResNet12BDC(nn.Module):
    """resnet12Bdc over ``[N, C, F, T]`` spectrograms → ``[N, d(d+1)/2]``.

    ``fused_bdc`` is accepted for config compatibility: the kernel runs on
    every CUDA tensor, and its plain version serves only the CPU."""

    def __init__(self, reduce_dim: int = 64, fused_bdc: bool = False,
                 drop_rate: float = 0.0, dropblock_size: int = 5,
                 num_channels: int = 1, use_running_statistics: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.drop_rate = drop_rate
        common = dict(use_running_statistics=use_running_statistics)
        self.layer1 = nn.Sequential(BasicBlock3(num_channels, 64, **common))
        self.layer2 = nn.Sequential(BasicBlock3(64, 160, **common))
        self.layer3 = nn.Sequential(BasicBlock3(160, 320, **common))
        self.layer4 = nn.Sequential(BasicBlock3(320, 640, use_pool=False, **common))
        self.bdc_pool = BdcHead(640, reduce_dim)
        # the reference resnet12Bdc's initialisation
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                nn.init.kaiming_normal_(mod.weight, mode="fan_out", nonlinearity="leaky_relu")
            elif isinstance(mod, nn.BatchNorm2d):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.drop_rate > 0:
            raise NotImplementedError(
                "resnet12Bdc DropBlock (drop_rate > 0) is not ported yet "
                "(ROADMAP Queue A); train with drop_rate 0"
            )
        x = x.to(self.dtype)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.bdc_pool(x)


@BACKBONES.register("resnet12Bdc")
def resnet12bdc(**kwargs):
    kwargs.pop("avg_pool", None)
    kwargs.pop("keep_prob", None)
    return ResNet12BDC(**clean_kwargs(kwargs))
