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

import functools
import inspect
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 weight is cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class Linear(nn.Linear):
    """``nn.Linear`` whose float32 weight is cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class _FlaxBatchNorm:
    """Train-mode statistics as flax takes them, for ``BatchNorm`` and
    ``BatchNorm1d``.

    - The running variance is updated with the *biased* batch variance
      (torch uses the unbiased one, n/(n-1) larger).
    - ``mask`` (``[N]`` bool, True = the row contributes) restricts the batch
      statistics, and their running update, to the valid rows, as flax's
      ``nn.BatchNorm(mask=...)`` does: heads whose batch-statistics BNs run
      over bucket-padded batches keep the padding out of the real rows'
      normalisation.  Under running statistics (eval) it changes nothing.
    """

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch_stats = self.training or not self.track_running_stats
        update = self.training and self.track_running_stats
        if not batch_stats or (mask is None and not update):
            return super().forward(x)
        if mask is None:
            # momentum 1 into scratch buffers: they receive the batch mean and
            # the unbiased batch variance from the library's own training kernel
            mean = torch.zeros_like(self.running_mean)
            var = torch.ones_like(self.running_var)
            out = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
            n = x.numel() // x.shape[1]
            var = var * ((n - 1) / n)
        else:
            out, mean, var = self._masked(x, mask)
        if update:
            self._update_running(mean, var)
        return out

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
        self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
        self.num_batches_tracked.add_(1)

    def _masked(self, x: torch.Tensor, mask: torch.Tensor):
        """Output, mean and biased variance over the rows where ``mask``, in
        float32 at least (float64 stays float64)."""
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        w = mask.to(xs.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
        count = w.sum() * (xs[0, 0].numel())
        mean = (xs * w).sum(dims) / count
        var = (((xs - mean.reshape(shape)) ** 2) * w).sum(dims) / count
        y = (xs - mean.reshape(shape)) * torch.rsqrt(var + self.eps).reshape(shape)
        if self.weight is not None:
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype), mean, var


class BatchNorm(_FlaxBatchNorm, nn.BatchNorm2d):
    """``BatchNorm2d`` with torch ``track_running_stats`` semantics
    (``use_running_statistics=False``: batch statistics in train AND eval).
    eps 1e-5, momentum 0.1 (flax momentum 0.9).  Float32 parameters and
    statistics (reduced in float32 on bf16 input); the output keeps the
    input's dtype.  Train mode and ``mask`` as ``_FlaxBatchNorm``."""

    def __init__(self, num_features: int, use_running_statistics: bool = True):
        super().__init__(num_features, eps=1e-5, momentum=0.1,
                         track_running_stats=use_running_statistics)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    """``BatchNorm1d`` over ``[N, D]`` with the semantics of ``BatchNorm``
    (Conv64F's logits head)."""

    def __init__(self, num_features: int, use_running_statistics: bool = True):
        super().__init__(num_features, eps=1e-5, momentum=0.1,
                         track_running_stats=use_running_statistics)


class _SeededNoise(nn.Module):
    """A train-mode noise layer that draws from its own ``torch.Generator``
    on the input's device, seeded by ``seed_dropout`` (``reseed``), never
    from the global RNG."""

    def __init__(self):
        super().__init__()
        self.seed = 0
        self.generator: Optional[torch.Generator] = None

    def reseed(self, seed: int) -> None:
        self.seed = int(seed)
        self.generator = None

    def _generator(self, x: torch.Tensor) -> torch.Generator:
        if self.generator is None or self.generator.device != x.device:
            self.generator = torch.Generator(device=x.device).manual_seed(self.seed)
        return self.generator


class Dropout(_SeededNoise):
    """Inverted dropout (keep with probability 1 − ``rate``, scale the kept
    values by 1 / (1 − ``rate``)), as flax's ``nn.Dropout``.  The mask comes
    from the module's own generator (``_SeededNoise``).  The identity in
    eval."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        gen = self._generator(x)
        keep = torch.empty(x.shape, device=x.device).bernoulli_(keep_prob, generator=gen)
        return torch.where(keep.bool(), x / keep_prob, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


class GaussianNoise(_SeededNoise):
    """Standard normal draws for a head's sampler (LEO's latents and
    weights, VERSA's logits), from the module's own generator
    (``_SeededNoise``).  ``restart`` rewinds the generator to its seed: the
    heads call it at the start of each eval forward, so eval draws the same
    noise every call, as the JAX package samples eval logits from
    ``PRNGKey(0)``."""

    def restart(self) -> None:
        self.generator = None

    def draw(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.randn(shape, generator=self._generator(like), device=like.device,
                           dtype=like.dtype)


def dropblock_mask(seeds: torch.Tensor, block_size: int) -> torch.Tensor:
    """The scaled DropBlock mask ``[n, c, h, w]`` of 0/1 ``seeds`` ``[n, c,
    h − bs + 1, w − bs + 1]`` (``bs`` = ``block_size``), as the JAX package's
    ``DropBlock`` computes it: the seeds padded by (bs//2, bs − 1 − bs//2) on
    both sides, dilated by flax's stride-1 "SAME" max pool (which pads
    ((bs − 1)//2, bs//2): for an even bs that is not torch's symmetric
    padding, so it is padded here explicitly), ``block = 1 − pooled``, scaled
    by 1 / max(mean(block), 1e-6) over the whole tensor."""
    bs = block_size
    lo, hi = bs // 2, bs - 1 - bs // 2
    padded = F.pad(seeds, (lo, hi, lo, hi))
    # zero padding pools as flax's −inf padding: the seeds are ≥ 0 and every
    # window holds at least one of them
    lo, hi = (bs - 1) // 2, bs // 2
    block = 1.0 - F.max_pool2d(F.pad(padded, (lo, hi, lo, hi)), bs, stride=1)
    return block * (1.0 / block.mean().clamp(min=1e-6))


class DropBlock(_SeededNoise):
    """DropBlock (counterpart of ``DropBlock`` in the JAX package's
    ``layers.py``): drops ``block_size`` squares of each channel's map around
    Bernoulli(γ) seeds drawn over the valid interior ``[n, c, h − bs + 1,
    w − bs + 1]``, bs = min(``block_size``, h, w), and rescales the rest
    (``dropblock_mask``).  The seeds come from the module's own generator
    (``_SeededNoise``); ``gamma`` may be a tensor on the device (no host
    sync).  The identity in eval."""

    def __init__(self, block_size: int = 5):
        super().__init__()
        self.block_size = block_size

    def draw_seeds(self, x: torch.Tensor, gamma) -> torch.Tensor:
        n, c, h, w = x.shape
        bs = min(self.block_size, h, w)
        u = torch.rand((n, c, h - bs + 1, w - bs + 1), device=x.device,
                       generator=self._generator(x))
        return (u < gamma).to(torch.float32)

    def forward(self, x: torch.Tensor, gamma) -> torch.Tensor:
        if not self.training:
            return x
        bs = min(self.block_size, *x.shape[-2:])
        return x * dropblock_mask(self.draw_seeds(x, gamma), bs).to(x.dtype)

    def extra_repr(self) -> str:
        return f"block_size={self.block_size}"


def seed_dropout(module: nn.Module, seed: int) -> None:
    """Seed every ``Dropout`` and ``DropBlock`` of ``module``, each (in module
    order) with its own seed drawn from ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    for m in module.modules():
        if isinstance(m, _SeededNoise):
            m.reseed(int(torch.randint(2 ** 62, (), generator=gen)))


def activation_fn(leaky_relu: bool, negative_slope: float) -> Callable:
    if leaky_relu:
        return functools.partial(F.leaky_relu, negative_slope=negative_slope)
    return F.relu


class ConvBnAct(nn.Sequential):
    """Conv3×3 → BN → activation, the four-conv-block unit.  A 3×3 "SAME"
    conv at stride 1 is symmetric padding 1.  State-dict keys ``0.*`` (conv)
    and ``1.*`` (BN), the reference ``layer{i}`` Sequential's."""

    def __init__(self, in_channels: int, features: int, use_running_statistics: bool = True,
                 leaky_relu: bool = False, negative_slope: float = 0.2, use_bias: bool = True):
        super().__init__(Conv2d(in_channels, features, 3, padding=1, bias=use_bias),
                         BatchNorm(features, use_running_statistics))
        self.act = activation_fn(leaky_relu, negative_slope)

    def forward(self, x: torch.Tensor, sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # sample_mask: [N] bool, the rows that contribute to batch statistics
        return self.act(self[1](self[0](x), sample_mask))


def floor_power(num: int, divisor: int, power: int) -> int:
    """``num`` floor-divided by ``divisor`` ``power`` times: a side of a map
    after ``power`` floor pools of stride ``divisor`` (it sizes Conv64F's
    logits head, as in the reference)."""
    for _ in range(power):
        num = num // divisor
    return num


def backbone_factory(build: Callable[..., nn.Module], *ignored: str) -> Callable[..., nn.Module]:
    """The registry factory of ``build`` (a backbone class, or a partial of
    one).

    It drops None-valued config kwargs (YAML ``~``/null passthrough) and the
    ``ignored`` names (kwargs that shipped configs carry through a stale
    include, which this backbone ignores as the JAX package does); any other
    kwarg ``build`` does not take raises.  Its signature is ``build``'s plus
    ``ignored``: ``build_method`` passes it only the injected knobs it names."""

    def factory(**kwargs):
        return build(**{k: v for k, v in kwargs.items() if v is not None and k not in ignored})

    params = list(inspect.signature(build).parameters.values())
    params += [inspect.Parameter(k, inspect.Parameter.KEYWORD_ONLY, default=None)
               for k in ignored]
    factory.__signature__ = inspect.Signature(params)
    return factory
