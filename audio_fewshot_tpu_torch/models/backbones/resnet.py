"""ResNet-12: the plain resnet12 / resnet12woLSC and resnet12Bdc with its
BDC pooling head (counterpart of ``BasicBlock3`` / ``ResNet12`` /
``BdcHead`` / ``ResNet12BDC`` in
``audio_fewshot_tpu/models/backbones/resnet.py``).

State-dict keys are the reference torch names (``layer1.0.conv1.weight``,
``layer4.0.downsample.1.running_mean``, ``bdc_pool.conv_dr_block.0.weight``,
``bdc_pool.temperature``), so ``utils/convert.py`` maps the JAX package's
variables onto them.  The four stages compute in ``dtype`` (bf16 by
default); the avg pool, the flatten and the BDC head run in float32.  Train
mode uses batch statistics and updates the running ones
(``layers.BatchNorm``).  With ``drop_rate > 0`` (the plain resnet12's
default, 0.1) train mode drops as the JAX package does: ``Dropout`` after
stages 1 and 2, ``DropBlock`` after stages 3 and 4 with a linear keep-rate
ramp over the block's ``num_batches_tracked`` counter (an int64 buffer,
saved in checkpoints).  resnet12Bdc sends the BDC gradient through the
backward kernel on the card.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.bdc_cuda import bdc_pool_triu
from ...registry import BACKBONES
from ..init import lecun_normal_
from .layers import BatchNorm, Conv2d, DropBlock, Dropout, backbone_factory


class BasicBlock3(nn.Module):
    """Three conv3×3 + BN with a residual, LeakyReLU(0.1), then a 2×2 floor
    max-pool.  The residual is a 1×1 conv + BN when the width changes;
    ``use_residual=False`` drops it (resnet12woLSC's stage 4).

    With ``drop_rate > 0``, in train mode only, after the pool: ``Dropout``,
    or with ``drop_block`` a ``DropBlock`` whose keep rate ramps linearly
    from 1 to 1 − ``drop_rate`` over ``drop_schedule_steps`` train-mode
    calls, counted in the ``num_batches_tracked`` buffer (incremented once a
    train-mode call, before it is read):

        keep = max(1 − drop_rate / drop_schedule_steps · count, 1 − drop_rate)
        γ    = (1 − keep) / bs² · feat² / max((feat − bs + 1)², 1)

    with feat the map's height and bs = min(``block_size``, feat).  γ stays
    a tensor on the counter's device: no host sync."""

    def __init__(self, inplanes: int, planes: int, use_pool: bool = True,
                 use_residual: bool = True, drop_rate: float = 0.0, drop_block: bool = False,
                 block_size: int = 5, drop_schedule_steps: int = 40000,
                 use_running_statistics: bool = True):
        super().__init__()
        conv = lambda cin: Conv2d(cin, planes, 3, padding=1, bias=False)
        bn = lambda: BatchNorm(planes, use_running_statistics)
        self.conv1, self.bn1 = conv(inplanes), bn()
        self.conv2, self.bn2 = conv(planes), bn()
        self.conv3, self.bn3 = conv(planes), bn()
        self.downsample = (
            nn.Sequential(Conv2d(inplanes, planes, 1, bias=False), bn())
            if use_residual and inplanes != planes else None
        )
        self.use_pool = use_pool
        self.use_residual = use_residual
        self.drop_rate = drop_rate
        self.drop_block = drop_block
        self.block_size = block_size
        self.drop_schedule_steps = drop_schedule_steps
        self.drop = None
        if drop_rate > 0 and drop_block:
            self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))
            self.drop = DropBlock(block_size)
        elif drop_rate > 0:
            self.drop = Dropout(drop_rate)

    def gamma(self, feat: int) -> torch.Tensor:
        """DropBlock's seed rate at the counter's current value."""
        steps = self.num_batches_tracked.to(torch.float32)
        keep = (1.0 - self.drop_rate / self.drop_schedule_steps * steps).clamp(
            min=1.0 - self.drop_rate)
        bs = min(self.block_size, feat)
        return (1.0 - keep) / (bs ** 2) * (feat ** 2) / max((feat - bs + 1) ** 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.bn1(self.conv1(x)), 0.1, inplace=True)
        out = F.leaky_relu(self.bn2(self.conv2(out)), 0.1, inplace=True)
        out = self.bn3(self.conv3(out))
        if self.use_residual:
            out += x if self.downsample is None else self.downsample(x)
        out = F.leaky_relu(out, 0.1, inplace=True)
        if self.use_pool:
            out = F.max_pool2d(out, 2, 2)
        if self.training and self.drop is not None:
            if self.drop_block:
                with torch.no_grad():
                    self.num_batches_tracked.add_(1)
                feat = out.shape[2]
                out = self.drop(out, self.gamma(feat))
            else:
                out = self.drop(out)
        return out


def _stages(planes: Sequence[int], num_channels: int, maxpool_last2: bool, last_pool: bool,
            last_residual: bool, **common) -> Tuple[nn.Sequential, ...]:
    """``layer1`` … ``layer4`` of one ``BasicBlock3`` each; stages 3 and 4
    carry DropBlock."""
    ins = (num_channels,) + tuple(planes[:3])
    return (
        nn.Sequential(BasicBlock3(ins[0], planes[0], **common)),
        nn.Sequential(BasicBlock3(ins[1], planes[1], **common)),
        nn.Sequential(BasicBlock3(ins[2], planes[2], use_pool=maxpool_last2, drop_block=True,
                                  **common)),
        nn.Sequential(BasicBlock3(ins[3], planes[3], use_pool=maxpool_last2 and last_pool,
                                  use_residual=last_residual, drop_block=True, **common)),
    )


class ResNet12(nn.Module):
    """The plain resnet12 over ``[N, C, F, T]`` spectrograms: four stages,
    then (``avg_pool``) a 5×5 stride-1 VALID average pool, clipped to the map,
    in float32; with ``is_flatten`` the map flattened in NHWC order to
    ``[N, h·w·c]`` (the JAX package's order; the reference flattens NCHW),
    else the ``[N, c, h, w]`` map.  At ``[1, 128, 157]`` the stages leave
    [64, 64, 78] → [160, 32, 39] → [320, 16, 19] → [640, 8, 9]; the pool
    [640, 4, 5], 12800 features flat.

    ``keep_prob`` is accepted for the configs and ignored, as in the JAX
    package.  The weights are drawn as flax's defaults (``lecun_normal``
    convolutions, BN scale 1 and bias 0)."""

    def __init__(self, planes: Sequence[int] = (64, 160, 320, 640), last_residual: bool = True,
                 avg_pool: bool = True, is_flatten: bool = True, maxpool_last2: bool = True,
                 drop_rate: float = 0.1, dropblock_size: int = 5, num_channels: int = 1,
                 use_running_statistics: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.avg_pool = avg_pool
        self.is_flatten = is_flatten
        self.maxpool_last2 = maxpool_last2
        self.layer1, self.layer2, self.layer3, self.layer4 = _stages(
            tuple(planes), num_channels, maxpool_last2=maxpool_last2, last_pool=True,
            last_residual=last_residual, drop_rate=drop_rate, block_size=dropblock_size,
            use_running_statistics=use_running_statistics)
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight)

    def map_shape(self, spec_shape: Sequence[int]) -> Tuple[int, int, int]:
        """``(c, h, w)`` of the map a ``spec_shape`` segment leaves (after the
        avg pool where it is on), for heads that size their layers from it
        (``build_method`` passes it): FEAT's width (c·h·w, flat), CAN's and
        FRN's h·w."""
        h, w = spec_shape[-2:]
        for _ in range(2 + 2 * self.maxpool_last2):  # the stages' 2 × 2 floor pools
            h, w = h // 2, w // 2
        if self.avg_pool:
            h, w = h - min(5, h) + 1, w - min(5, w) + 1
        return (self.layer4[0].conv3.out_channels, h, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x)))).float()
        if self.avg_pool:
            x = F.avg_pool2d(x, (min(5, x.shape[2]), min(5, x.shape[3])), stride=1)
        if self.is_flatten:
            return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return x


resnet12 = BACKBONES.register("resnet12")(backbone_factory(ResNet12, "keep_prob"))


# resnet12woLSC: planes 64/128/256/512, no residual in stage 4
resnet12wolsc = BACKBONES.register("resnet12woLSC")(backbone_factory(
    functools.partial(ResNet12, planes=(64, 128, 256, 512), last_residual=False), "keep_prob"))


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
    """resnet12Bdc over ``[N, C, F, T]`` spectrograms → ``[N, d(d+1)/2]``:
    the plain resnet12's stages with a stride-1 stage 4, then ``BdcHead``.

    ``fused_bdc`` is accepted for config compatibility: the kernel runs on
    every CUDA tensor, and its plain version serves only the CPU.  The
    weights are drawn as the reference resnet12Bdc's (kaiming, fan_out)."""

    def __init__(self, reduce_dim: int = 64, fused_bdc: bool = False,
                 drop_rate: float = 0.0, dropblock_size: int = 5,
                 num_channels: int = 1, use_running_statistics: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.layer1, self.layer2, self.layer3, self.layer4 = _stages(
            (64, 160, 320, 640), num_channels, maxpool_last2=True, last_pool=False,
            last_residual=True, drop_rate=drop_rate, block_size=dropblock_size,
            use_running_statistics=use_running_statistics)
        self.bdc_pool = BdcHead(640, reduce_dim)
        # the reference resnet12Bdc's initialisation
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                nn.init.kaiming_normal_(mod.weight, mode="fan_out", nonlinearity="leaky_relu")
            elif isinstance(mod, nn.BatchNorm2d):
                nn.init.ones_(mod.weight)
                nn.init.zeros_(mod.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self.bdc_pool(x)


resnet12bdc = BACKBONES.register("resnet12Bdc")(
    backbone_factory(ResNet12BDC, "avg_pool", "keep_prob"))
