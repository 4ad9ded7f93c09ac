"""ResNet-18 and resnet18Bdc (counterpart of ``BasicBlock2`` / ``ResNet18``
/ ``ResNet18BDC`` in ``audio_fewshot_tpu/models/backbones/resnet18.py``).

resnet18 is the few-shot ResNet-18: a 3×3 stride-1 stem (no 7×7, no stem
max pool), four stages of two ``BasicBlock2`` at 64/128/256/512 with
strides (1, 2, 2, ``last_block_stride``), then a mean pool and the flatten.
resnet18Bdc has the ImageNet stem (7×7/2, then a 3×3/2 max pool), strides
(1, 2, 2, 1) and resnet12Bdc's ``BdcHead``: a ``[1, 128, 157]`` segment
reaches the head as an 8 × 10 map, so the BDC pool runs at M = 80.

Every strided 3×3 convolution pads (1, 1) on both sides, as the JAX
package pads it explicitly (flax's "SAME" would pad only right and bottom
under stride 2); the 1×1 downsample pads nothing.  State-dict keys are the
reference's: resnet18's ``conv1`` / ``bn1`` / ``layer{i}.{b}.{conv,bn}{1,2}``
/ ``layer{i}.{b}.downsample.{0,1}``; resnet18Bdc's ``trunk.0`` / ``trunk.1``
(stem), ``trunk.{4 + 2·stage + b}.{C1,BN1,C2,BN2,shortcut,BNshortcut}`` and
``bdc_pool.*``.  The stages compute in ``dtype`` (bf16 by default), the pool
and the BDC head in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from ..init import lecun_normal_
from .layers import BatchNorm, Conv2d, backbone_factory
from .resnet import BdcHead

PLANES = (64, 128, 256, 512)


class BasicBlock2(nn.Module):
    """conv3×3 (stride on it) → BN → ReLU → conv3×3 → BN, plus the input or
    a 1×1 conv + BN of it when the stride or the width changes, then ReLU."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_running_statistics: bool = True):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes, use_running_statistics)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes, use_running_statistics)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(Conv2d(inplanes, planes, 1, stride, bias=False),
                                            BatchNorm(planes, use_running_statistics))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        return F.relu(out + (x if self.downsample is None else self.downsample(x)))


class SimpleBlock(nn.Module):
    """``BasicBlock2`` under resnet18Bdc's reference keys (``C1``, ``BN1``,
    ``C2``, ``BN2``, ``shortcut``, ``BNshortcut``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 use_running_statistics: bool = True):
        super().__init__()
        self.C1 = Conv2d(inplanes, planes, 3, stride, padding=1, bias=False)
        self.BN1 = BatchNorm(planes, use_running_statistics)
        self.C2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.BN2 = BatchNorm(planes, use_running_statistics)
        self.shortcut = self.BNshortcut = None
        if stride != 1 or inplanes != planes:
            self.shortcut = Conv2d(inplanes, planes, 1, stride, bias=False)
            self.BNshortcut = BatchNorm(planes, use_running_statistics)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.BN2(self.C2(F.relu(self.BN1(self.C1(x)))))
        return F.relu(out + (x if self.shortcut is None else self.BNshortcut(self.shortcut(x))))


def _strided(side: int, stride: int) -> int:
    """A side after a 3×3 conv padded (1, 1) at ``stride`` (or a 1×1 one
    padded 0: the same size)."""
    return (side - 1) // stride + 1


class ResNet18(nn.Module):
    """resnet18 over ``[N, C, F, T]`` spectrograms.  ``avg_pool``: the mean
    over the map in float32; ``is_flatten``: ``[N, 512]`` (the map flattened
    NHWC without the pool), else ``[N, 512, h, w]`` (``[N, 512, 1, 1]`` after
    the pool).  ``is_feature``: the maps after stages 1-3 (NCHW, float32)
    and the output.

    ``forward``'s ``mixup_lam`` / ``mixup_index`` / ``mixup_layer`` are the
    manifold-mixup hook: the hidden state after stage ``mixup_layer`` (0:
    the input) becomes λ·h + (1 − λ)·h[index].  The weights are drawn as
    flax's defaults (``lecun_normal`` convolutions, BN scale 1, bias 0)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), is_flatten: bool = True,
                 avg_pool: bool = True, is_feature: bool = False, last_block_stride: int = 2,
                 num_channels: int = 1, use_running_statistics: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.is_flatten = is_flatten
        self.avg_pool = avg_pool
        self.is_feature = is_feature
        self.strides = (1, 2, 2, last_block_stride)
        self.conv1 = Conv2d(num_channels, 64, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(64, use_running_statistics)
        inplanes = 64
        for stage, (n_blocks, planes) in enumerate(zip(layers, PLANES)):
            blocks = []
            for b in range(n_blocks):
                blocks.append(BasicBlock2(inplanes, planes, self.strides[stage] if b == 0 else 1,
                                          use_running_statistics))
                inplanes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                lecun_normal_(mod.weight)

    def map_shape(self, spec_shape: Sequence[int]) -> Tuple[int, int, int]:
        """``(c, h, w)`` of the output for a ``spec_shape`` segment (1 × 1
        after the pool)."""
        h, w = spec_shape[-2:]
        for s in self.strides:
            h, w = _strided(h, s), _strided(w, s)
        return (PLANES[-1], 1, 1) if self.avg_pool else (PLANES[-1], h, w)

    def feature_dim(self, spec_shape: Sequence[int]) -> int:
        c, h, w = self.map_shape(spec_shape)
        return c * h * w

    def forward(self, x: torch.Tensor, mixup_lam: Optional[torch.Tensor] = None,
                mixup_index: Optional[torch.Tensor] = None, mixup_layer: int = -1):
        def maybe_mix(h, k):
            if mixup_layer == k and mixup_lam is not None:
                lam = torch.as_tensor(mixup_lam, dtype=h.dtype, device=h.device)
                return lam * h + (1.0 - lam) * h[mixup_index]
            return h

        x = maybe_mix(x.to(self.dtype), 0)
        x = F.relu(self.bn1(self.conv1(x)))
        feats = []
        for stage in range(1, 5):
            x = maybe_mix(getattr(self, f"layer{stage}")(x), stage)
            feats.append(x)
        x = x.float()
        if self.avg_pool:
            x = x.mean(dim=(2, 3), keepdim=True)
        if self.is_flatten:
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        if self.is_feature:
            return tuple(f.float() for f in feats[:-1]) + (x,)
        return x


resnet18 = BACKBONES.register("resnet18")(backbone_factory(ResNet18))


class ResNet18BDC(nn.Module):
    """resnet18Bdc over ``[N, C, F, T]`` spectrograms → ``[N, d(d+1)/2]``:
    ``trunk`` (7×7/2 stem, BN, ReLU, 3×3/2 max pool padded 1, eight
    ``SimpleBlock`` at strides (1, 2, 2, 1) by stage), then ``BdcHead`` over
    the 512-wide map.  ``spec_shape`` sizes the head's initial temperature,
    log(1 / (2·h·w)) of the map (the JAX package reads it off the traced
    map).  ``fused_bdc`` is accepted for config compatibility: the kernel
    runs on every CUDA tensor.  The weights are drawn as resnet12Bdc's
    (kaiming, fan_out)."""

    def __init__(self, reduce_dim: int = 64, fused_bdc: bool = False, num_channels: int = 1,
                 use_running_statistics: bool = True, spec_shape: Sequence[int] = (1, 128, 157),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        trunk = [Conv2d(num_channels, 64, 7, 2, padding=3, bias=False),
                 BatchNorm(64, use_running_statistics), nn.ReLU(inplace=True),
                 nn.MaxPool2d(3, 2, padding=1)]
        inplanes = 64
        for stage, (planes, stride) in enumerate(zip(PLANES, (1, 2, 2, 1))):
            for b in range(2):
                trunk.append(SimpleBlock(inplanes, planes, stride if b == 0 else 1,
                                         use_running_statistics))
                inplanes = planes
        self.trunk = nn.Sequential(*trunk)
        _, h, w = self.trunk_shape(spec_shape)
        self.bdc_pool = BdcHead(PLANES[-1], reduce_dim, spatial=(h, w))
        self.reduce_dim = reduce_dim or PLANES[-1]
        for mod in self.modules():
            if isinstance(mod, nn.Conv2d):
                nn.init.kaiming_normal_(mod.weight, mode="fan_out", nonlinearity="leaky_relu")

    @staticmethod
    def trunk_shape(spec_shape: Sequence[int]) -> Tuple[int, int, int]:
        """``(c, h, w)`` of the trunk's map (the BDC head's input) for a
        ``spec_shape`` segment: the stem's two stride-2 steps, then stages 2
        and 3."""
        h, w = spec_shape[-2:]
        for _ in range(4):
            h, w = _strided(h, 2), _strided(w, 2)
        return (PLANES[-1], h, w)

    def feature_dim(self, spec_shape: Sequence[int]) -> int:
        """d(d + 1)/2 at ``reduce_dim`` d."""
        return self.reduce_dim * (self.reduce_dim + 1) // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bdc_pool(self.trunk(x.to(self.dtype)))


resnet18bdc = BACKBONES.register("resnet18Bdc")(backbone_factory(ResNet18BDC))
