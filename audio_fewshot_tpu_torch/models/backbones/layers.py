"""Shared backbone building blocks (counterpart of
``audio_fewshot_tpu/models/backbones/layers.py``).

- Backbones take spectrograms as ``[N, C, F, T]``, the JAX package's public
  layout too, and compute in NCHW, torch's native layout.
- Parameters stay float32; ``Conv2d`` computes in its input's dtype (bf16 by
  default), and ``BatchNorm`` takes bf16 input with float32 statistics and
  float32 maths, returning its input's dtype — flax's ``dtype=bf16``
  mixed-precision recipe.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 weight is cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class BatchNorm(nn.BatchNorm2d):
    """``BatchNorm2d`` with torch ``track_running_stats`` semantics
    (``use_running_statistics=False``: batch statistics in train AND eval).
    eps 1e-5, momentum 0.1 (flax momentum 0.9).  Float32 parameters and
    statistics (reduced in float32 on bf16 input); the output keeps the
    input's dtype.

    In train mode the running variance follows flax, not torch: it is
    updated with the *biased* batch variance (torch uses the unbiased one,
    n/(n-1) larger)."""

    def __init__(self, num_features: int, use_running_statistics: bool = True):
        super().__init__(num_features, eps=1e-5, momentum=0.1,
                         track_running_stats=use_running_statistics)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        # momentum 1 into scratch buffers: they receive the batch mean and
        # the unbiased batch variance from the library's own training kernel
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var * ((n - 1) / n), self.momentum)
            self.num_batches_tracked.add_(1)
        return out


def clean_kwargs(kwargs):
    """Drop None-valued config kwargs (YAML ``~``/null passthrough)."""
    return {k: v for k, v in kwargs.items() if v is not None}
