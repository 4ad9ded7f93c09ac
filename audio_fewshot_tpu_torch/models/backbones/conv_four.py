"""Four-block convolutional backbones: Conv64F, Conv32F, R2D2Embedding and
Conv64F_MCL (counterpart of ``audio_fewshot_tpu/models/backbones/conv_four.py``).

State-dict keys are the reference torch names (``layer{i}.0.weight``,
``layer{i}.1.running_mean``, Conv64F's head ``logits.1.*`` (BN1d) and
``logits.2.*`` (Linear); R2D2's ``block{i}.0.*`` / ``block{i}.1.*``), so
``utils/convert.py`` maps the JAX package's variables onto them.

The blocks compute in ``dtype`` (bf16 by default); the outputs and
Conv64F's logits head are float32.  Where a backbone flattens its last map
(``is_flatten``), it flattens it in **NHWC** order, as the JAX package does;
the reference flattens NCHW.  At the shipped ``[1, 128, 157]`` input with all
four pools the last map is 1×1, where the two orders agree (ROADMAP
Queue C).  torch infers no shapes, so Conv64F sizes its logits head from
``spec_shape``, which ``build_method`` passes from the config.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONES
from .layers import (
    BatchNorm, BatchNorm1d, Conv2d, ConvBnAct, Dropout, backbone_factory, floor_power)


def _nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class ConvNF(nn.Module):
    """Shared 4-block conv net (Conv64F): conv3×3 + BN + ReLU blocks, 3×3
    stride-3 floor max pools after blocks 1, 2, 3 (``maxpool_last2``) and 4
    (``last_pool``); with ``is_flatten`` the logits head Dropout(0.3) →
    BN1d → Linear(``logits_dim``).

    ``logits_bn_running_statistics`` gives the head's BN1d other semantics
    than the conv BNs (None: follow ``use_running_statistics``).
    ``forward``'s ``sample_mask`` (``[N]`` bool) restricts the BN batch
    statistics to the valid rows (batch-statistics BN over bucket-padded
    batches)."""

    def __init__(self, features: int = 64, is_flatten: bool = False, is_feature: bool = False,
                 leaky_relu: bool = False, negative_slope: float = 0.2, last_pool: bool = True,
                 maxpool_last2: bool = True, use_running_statistics: bool = True,
                 logits_bn_running_statistics: Optional[bool] = None, num_channels: int = 1,
                 logits_dim: int = 1600, dtype: torch.dtype = torch.bfloat16,
                 spec_shape: Sequence[int] = (1, 128, 157)):
        super().__init__()
        self.dtype = dtype
        self.is_flatten = is_flatten
        self.is_feature = is_feature
        self.last_pool = last_pool
        self.maxpool_last2 = maxpool_last2
        blk = dict(use_running_statistics=use_running_statistics, leaky_relu=leaky_relu,
                   negative_slope=negative_slope)
        self.layer1 = ConvBnAct(num_channels, features, **blk)
        self.layer2 = ConvBnAct(features, features, **blk)
        self.layer3 = ConvBnAct(features, features, **blk)
        self.layer4 = ConvBnAct(features, features, **blk)
        if is_flatten:
            h, w = self.pooled_hw(*spec_shape[-2:])
            flat = features * h * w
            running = (use_running_statistics if logits_bn_running_statistics is None
                       else logits_bn_running_statistics)
            self.logits = nn.Sequential(Dropout(0.3), BatchNorm1d(flat, running),
                                        nn.Linear(flat, logits_dim))

    def pooled_hw(self, h: int, w: int):
        """The last map's side lengths for an ``h × w`` input."""
        n = 2 + int(self.maxpool_last2) + int(self.last_pool)
        return floor_power(h, 3, n), floor_power(w, 3, n)

    def map_shape(self, spec_shape: Sequence[int]):
        """``(c, h, w)`` of the map a ``spec_shape`` segment leaves, for heads
        that size their layers from it (``build_method`` passes it)."""
        if self.is_flatten:
            raise ValueError("Conv64F with is_flatten returns flat features, not a map; "
                             "a local-descriptor head needs is_flatten: false")
        return (self.layer4[0].out_channels,) + self.pooled_hw(*spec_shape[-2:])

    def feature_dim(self, spec_shape: Sequence[int]) -> int:
        """The width of a ``spec_shape`` segment's features flattened: the
        logits head's output with ``is_flatten``, else c·h·w of the map."""
        if self.is_flatten:
            return self.logits[2].out_features
        c, h, w = self.map_shape(spec_shape)
        return c * h * w

    def forward(self, x: torch.Tensor, sample_mask: Optional[torch.Tensor] = None):
        n = x.shape[0]
        h, w = self.pooled_hw(*x.shape[-2:])
        if 0 in (n, h, w):
            c = self.layer4[0].out_channels
            raise ValueError(
                f"Conv64F pooled the input to an empty tensor {(n, h, w, c)}; "
                "input spectrogram too small for the 3x stride-3 pool stack "
                "(disable last_pool/maxpool_last2 or use larger inputs)"
            )
        m = sample_mask
        x = x.to(self.dtype)
        out1 = F.max_pool2d(self.layer1(x, m), 3, 3)
        out2 = F.max_pool2d(self.layer2(out1, m), 3, 3)
        out3 = self.layer3(out2, m)
        if self.maxpool_last2:
            out3 = F.max_pool2d(out3, 3, 3)
        out4 = self.layer4(out3, m)
        if self.last_pool:
            out4 = F.max_pool2d(out4, 3, 3)
        out4 = out4.float()
        if self.is_flatten:
            flat = self.logits[0](_nhwc_flatten(out4))
            flat = self.logits[1](flat, m)
            out4 = self.logits[2](flat)
        if self.is_feature:
            return out1, out2, out3, out4
        return out4


# resnet-only kwargs that shipped configs carry through a stale include
conv64f = BACKBONES.register("Conv64F")(backbone_factory(
    functools.partial(ConvNF, features=64), "is_bdc", "keep_prob", "avg_pool"))


class Conv32F(nn.Module):
    """Conv32F: four conv3×3 blocks at width 32, 2×2 stride-2 floor max pools
    after blocks 1–3 (block 4 unpooled), flattened (NHWC order) when
    ``is_flatten``; no logits head."""

    def __init__(self, is_flatten: bool = False, is_feature: bool = False,
                 leaky_relu: bool = False, negative_slope: float = 0.2, num_channels: int = 1,
                 use_running_statistics: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.is_flatten = is_flatten
        self.is_feature = is_feature
        blk = dict(use_running_statistics=use_running_statistics, leaky_relu=leaky_relu,
                   negative_slope=negative_slope)
        self.layer1 = ConvBnAct(num_channels, 32, **blk)
        self.layer2 = ConvBnAct(32, 32, **blk)
        self.layer3 = ConvBnAct(32, 32, **blk)
        self.layer4 = ConvBnAct(32, 32, **blk)

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype)
        maps = []
        for i, layer in enumerate((self.layer1, self.layer2, self.layer3, self.layer4)):
            x = layer(x)
            if i < 3:
                x = F.max_pool2d(x, 2, 2)
            maps.append(x)
        out = x.float()
        if self.is_flatten:
            out = _nhwc_flatten(out)
        if self.is_feature:
            return tuple(m.float() for m in maps[:-1]) + (out,)
        return out


conv32f = BACKBONES.register("Conv32F")(backbone_factory(Conv32F, "last_pool", "maxpool_last2"))


class R2D2Embedding(nn.Module):
    """R2D2's 4-block embedding: conv3×3 (with bias) → BN → 2×2 max pool →
    LeakyReLU(0.1) → Dropout, widths 96/192/384/512; blocks 3 and 4 keep
    with probability 0.9; block 4 has no activation and a stride-1 pool.
    The output is the concatenation of blocks 3 and 4, each flattened in CHW
    order (as the reference and the JAX package)."""

    WIDTHS = (96, 192, 384, 512)

    def __init__(self, num_channels: int = 1, use_running_statistics: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cin = num_channels
        for i, width in enumerate(self.WIDTHS, start=1):
            setattr(self, f"block{i}", nn.Sequential(
                Conv2d(cin, width, 3, padding=1, bias=True),
                BatchNorm(width, use_running_statistics)))
            cin = width
        self.drop3 = Dropout(0.1)
        self.drop4 = Dropout(0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        b1 = F.leaky_relu(F.max_pool2d(self.block1(x), 2, 2), 0.1)
        b2 = F.leaky_relu(F.max_pool2d(self.block2(b1), 2, 2), 0.1)
        b3 = self.drop3(F.leaky_relu(F.max_pool2d(self.block3(b2), 2, 2), 0.1))
        b4 = self.drop4(F.max_pool2d(self.block4(b3), 2, 1))
        n = x.shape[0]
        return torch.cat([b3.reshape(n, -1), b4.reshape(n, -1)], dim=-1).float()


r2d2_embedding = BACKBONES.register("R2D2Embedding")(backbone_factory(R2D2Embedding))


class Conv64FMCL(nn.Module):
    """Dense-map 4-block conv for MCL-style local-descriptor methods:
    bias-free conv3×3 → BN → LeakyReLU(0.2) → 2×2 max pool in every block,
    a ``[64, F/16, T/16]`` float32 map."""

    def __init__(self, num_channels: int = 1, use_running_statistics: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        blk = dict(use_running_statistics=use_running_statistics, leaky_relu=True, use_bias=False)
        self.layer1 = ConvBnAct(num_channels, 64, **blk)
        self.layer2 = ConvBnAct(64, 64, **blk)
        self.layer3 = ConvBnAct(64, 64, **blk)
        self.layer4 = ConvBnAct(64, 64, **blk)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = F.max_pool2d(layer(x), 2, 2)
        return x.float()


conv64f_mcl = BACKBONES.register("Conv64F_MCL")(backbone_factory(Conv64FMCL))
