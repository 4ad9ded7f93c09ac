"""The class-aware Vision Transformer over spectrograms (counterpart of
``audio_fewshot_tpu/models/backbones/vit.py``): ``vit_tiny``, ``vit_small``,
``VisionTransformer`` (token sequences, the CPEA contract) and ``ViT`` (the
standard ViT's kwarg names, its cls feature or mean token).

The input is right/bottom-cropped to multiples of the patch (``[128, 157]``
gives 8×9 patches at patch 16, 73 tokens with the cls token); the patch
embedding is a strided conv; each block is LN → multi-head attention →
residual, LN → fc1 → exact GELU → fc2 → residual; a final LN.  Dropout
(``drop_rate``) acts after the position embedding, on the attention output
and after both MLP linears, never on the attention probabilities.

State-dict keys are the reference ``vit_class_aware.py`` names
(``patch_embed.proj.*``, ``cls_token``, ``pos_embed``,
``blocks.{i}.norm{1,2}.*``, ``blocks.{i}.attn.qkv.*`` with the q | k | v rows
packed, ``blocks.{i}.attn.proj.*``, ``blocks.{i}.mlp.fc{1,2}.*``,
``norm.*``).  The token stream computes in ``dtype`` (bf16 by default) from
float32 parameters; LayerNorm reduces and normalises in float32 and returns
``dtype``; the attention is plain products and a softmax (q scaled by
1/√head_dim first, as flax does), the softmax accumulating in float32 inside
the kernel.  The tokens come out float32.  torch infers no shapes, so the
position embedding is sized from ``spec_shape`` (``build_method`` passes the
config's).  ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant); the block's dropout generators
are rewound for the recompute, so it draws the forward's masks.
"""

from __future__ import annotations

import functools
import inspect
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...registry import BACKBONES
from ..init import lecun_normal_
from .layers import Conv2d, Dropout, Linear, backbone_factory


class LayerNorm(nn.LayerNorm):
    """LayerNorm in float32 at least on any input dtype, returning the input's
    dtype (flax's float32 reductions under ``dtype=bf16``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, torch.float32)
        return F.layer_norm(x.to(dtype), self.normalized_shape, self.weight.to(dtype),
                            self.bias.to(dtype), self.eps).to(x.dtype)


class Attention(nn.Module):
    """Multi-head self-attention with a packed ``qkv`` projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, d = x.shape
        hd = d // self.num_heads
        q, k, v = self.qkv(x).reshape(n, t, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        attn = torch.softmax(torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(n, t, d)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, drop: float):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.drop1 = Dropout(drop)
        self.drop2 = Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop2(self.fc2(self.drop1(F.gelu(self.fc1(x)))))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, drop: float, ln_eps: float):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads)
        self.attn_drop = Dropout(drop)
        self.norm2 = LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn_drop(self.attn(self.norm1(x)))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, num_channels: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(num_channels, embed_dim, patch_size, stride=patch_size)


class VisionTransformer(nn.Module):
    """``[N, C, F, T]`` → the token sequence ``[N, 1 + L, embed_dim]`` with
    ``return_tokens``, else the cls feature (``pool="cls"``) or the mean token
    (``pool="mean"``), float32.  ``ln_eps`` 1e-6 is the class-aware
    reference's; ``final_norm=False`` drops the last LayerNorm."""

    def __init__(self, patch_size: int = 16, embed_dim: int = 192, depth: int = 12,
                 num_heads: int = 3, mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 return_tokens: bool = False, num_channels: int = 1, ln_eps: float = 1e-6,
                 pool: str = "cls", final_norm: bool = True, remat: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 spec_shape: Sequence[int] = (1, 128, 157)):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"pool must be 'cls' or 'mean', got {pool!r}")
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.return_tokens = return_tokens
        self.pool = pool
        self.remat = remat
        self.dtype = dtype
        self.patch_embed = PatchEmbed(patch_size, num_channels, embed_dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, self.map_shape(spec_shape)[0], embed_dim))
        self.pos_drop = Dropout(drop_rate)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, drop_rate, ln_eps) for _ in range(depth))
        self.norm = LayerNorm(embed_dim, eps=ln_eps) if final_norm else None
        # flax's initialisers: normal(0.02) tokens, lecun_normal kernels, zero biases
        with torch.no_grad():
            nn.init.normal_(self.cls_token, 0.0, 0.02)
            nn.init.normal_(self.pos_embed, 0.0, 0.02)
            for m in self.modules():
                if isinstance(m, (nn.Linear, nn.Conv2d)):
                    lecun_normal_(m.weight)
                    m.bias.zero_()

    def map_shape(self, spec_shape: Sequence[int]) -> Tuple[int, int]:
        """``(tokens, embed_dim)`` of the sequence a ``spec_shape`` segment
        leaves (the cls token and one per whole patch), for heads that size
        their layers from it (``build_method`` passes it)."""
        h, w = spec_shape[-2:]
        return (1 + (h // self.patch_size) * (w // self.patch_size), self.embed_dim)

    def _block(self, block: Block, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return block(x)
        drops = [m for m in block.modules() if isinstance(m, Dropout)]
        states = [m._generator(x).get_state() for m in drops]

        def run(y):
            for m, state in zip(drops, states):
                m.generator.set_state(state)
            return block(y)

        return checkpoint(run, x, use_reentrant=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        n, _, h, w = x.shape
        x = x[:, :, : (h // p) * p, : (w // p) * p].to(self.dtype)
        x = self.patch_embed.proj(x).flatten(2).transpose(1, 2)  # [N, L, D], row-major patches
        cls = self.cls_token.to(self.dtype).expand(n, -1, -1)
        x = self.pos_drop(torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype))
        for block in self.blocks:
            x = self._block(block, x)
        if self.norm is not None:
            x = self.norm(x)
        x = x.float()
        if self.return_tokens:
            return x
        return x.mean(dim=1) if self.pool == "mean" else x[:, 0]


vit_tiny = BACKBONES.register("vit_tiny")(backbone_factory(functools.partial(
    VisionTransformer, embed_dim=192, depth=12, num_heads=3, return_tokens=True)))
vit_small = BACKBONES.register("vit_small")(backbone_factory(functools.partial(
    VisionTransformer, embed_dim=384, depth=12, num_heads=6, return_tokens=True)))
# the reference's class-aware registry name (CPEA.yaml); our attention always
# carries biases, so qkv_bias is accepted and ignored
vision_transformer = BACKBONES.register("VisionTransformer")(backbone_factory(
    functools.partial(VisionTransformer, return_tokens=True), "qkv_bias"))

# the standard ViT's kwarg names (reference vit.py, config/backbones/ViT.yaml)
_VIT_RENAMES = {"dim": "embed_dim", "heads": "num_heads", "channels": "num_channels",
                "dropout": "drop_rate"}
_VIT_DROPPED = ("image_size", "dim_head", "emb_dropout", "num_classes")


@BACKBONES.register("ViT")
def vit(**kwargs) -> VisionTransformer:
    """The standard ViT under the reference's name, as the JAX package's:
    the reference's kwarg names renamed, ``mlp_dim`` as ``mlp_ratio``,
    ``dim_head`` / ``emb_dropout`` / ``num_classes`` / ``image_size``
    dropped, LayerNorm eps 1e-5 (torch's default, where the class-aware
    factories pin 1e-6), the final-norm'd cls feature by default."""
    kwargs = {k: v for k, v in kwargs.items() if v is not None}
    for src, dst in _VIT_RENAMES.items():
        if src in kwargs:
            kwargs.setdefault(dst, kwargs.pop(src))
    mlp_dim = kwargs.pop("mlp_dim", None)
    if mlp_dim and kwargs.get("embed_dim"):
        kwargs.setdefault("mlp_ratio", float(mlp_dim) / kwargs["embed_dim"])
    for key in _VIT_DROPPED:
        kwargs.pop(key, None)
    kwargs.setdefault("ln_eps", 1e-5)
    return VisionTransformer(**kwargs)


vit.__signature__ = inspect.Signature(
    list(inspect.signature(VisionTransformer).parameters.values())
    + [inspect.Parameter(k, inspect.Parameter.KEYWORD_ONLY, default=None)
       for k in (*_VIT_RENAMES, "mlp_dim", *_VIT_DROPPED)])
