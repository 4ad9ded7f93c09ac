"""The Swin Transformer over spectrograms (counterpart of
``audio_fewshot_tpu/models/backbones/swin.py``): ``swin_mini``, ``swin_t``,
``swin_s``, ``swin_b`` and ``swin_l``.

Each stage ``s`` starts with an f×f patch merge (the input cropped to whole
patches, the f×f×C patch flattened in the reference's unfold order (c, kh,
kw) into a Linear to ``embed_dim · 2^s``), then blocks in pairs, regular and
shifted: LayerNorm (eps 1e-5) → windowed attention → residual, LayerNorm →
fc1 → exact-erf GELU → fc2 → residual.  A block's window is the configured
one clamped to its map, ``ws = min(window_size, h, w)``; it pads the map to
whole windows, then rolls it by ``window_size // 2`` (the official order),
attends within windows, rolls back and crops; a shifted block shifts only
when its map spans more than one window, with −100 on the pairs of its
padded canvas that the roll brought together from different regions.  The
attention projects to ``heads · head_dim`` (``head_dim`` 32, not ``dim /
heads``), with a bias on ``qkv``, scales by 1/√head_dim in the compute dtype
and adds a per-head relative-position table ``[(2ws − 1)², heads]``,
indexed by (i − j), and the mask in it before the softmax.  After the last
stage a final LayerNorm (``final_norm``), float32, then the mean over the
map (``is_flatten``) or the NCHW map.

State-dict keys are the reference's (``swin_transformer.py``):
``stage{s+1}.patch_partition.linear``, ``stage{s+1}.layers.{b//2}.{b%2}.
attention_block.fn.{norm,fn.to_qkv,fn.to_out}``,
``...mlp_block.fn.{norm,fn.net.0,fn.net.2}``.  Two kept beyond it: the
JAX package's ``to_qkv.bias`` (the reference's qkv has none) and its
per-head table ``attention_block.fn.fn.rel_pos_bias`` (the reference's
``pos_embedding`` is one scalar table indexed by (j − i)); and ``norm``,
the final LayerNorm the reference does not have.  The parameters' shapes
depend on the input (each block's table follows its clamped window), so the
module is built for ``spec_shape`` (``build_method`` passes the config's)
and refuses another input size.  The blocks compute in ``dtype`` (bf16 by
default) from float32 parameters; LayerNorm reduces in float32.  ``remat``
recomputes each block in the backward (``torch.utils.checkpoint``).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...registry import BACKBONES
from ..init import lecun_normal_
from .layers import Linear, backbone_factory
from .vit import LayerNorm

LN_EPS = 1e-5


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``[N, H, W, C]`` → ``[N · nW, ws², C]``, windows row-major."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(win: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    c = win.shape[-1]
    x = win.reshape(-1, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """The shifted windows' mask on an ``h × w`` (padded) canvas: −100 on the
    pairs from different regions, ``[nW, ws², ws²]`` float32."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = window_partition(torch.from_numpy(img[None, :, :, None].astype(np.float32)), ws)[..., 0]
    diff = win[:, None, :] - win[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def relative_position_index(ws: int) -> torch.Tensor:
    """``[ws², ws²]`` row of the table for each token pair (i, j): the
    displacement i − j on both axes, shifted to be non-negative."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    return torch.from_numpy((rel[0] + ws - 1) * (2 * ws - 1) + (rel[1] + ws - 1))


def stage_maps(spec_shape: Sequence[int], factors: Sequence[int]) -> List[Tuple[int, int]]:
    """The ``(h, w)`` map of each stage of a ``spec_shape`` segment."""
    h, w = spec_shape[-2:]
    maps = []
    for f in factors:
        h, w = h // f, w // f
        maps.append((h, w))
    return maps


class WindowAttention(nn.Module):
    """Multi-head attention within ``ws × ws`` windows, ``[B, ws², C]`` →
    ``[B, ws², C]``."""

    def __init__(self, dim: int, num_heads: int, window_size: int, head_dim: int = 32):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        inner = num_heads * head_dim
        self.to_qkv = Linear(dim, 3 * inner)
        self.to_out = Linear(inner, dim)
        self.rel_pos_bias = nn.Parameter(torch.empty((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("rel_index", relative_position_index(window_size).reshape(-1),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, nt, _ = x.shape
        heads, hd = self.num_heads, self.head_dim
        q, k, v = self.to_qkv(x).reshape(b, nt, 3, heads, hd).permute(2, 0, 3, 1, 4)
        # 1/√head_dim rounded to the compute dtype first, as the JAX package divides
        scale = float(torch.tensor(math.sqrt(hd), dtype=q.dtype))
        attn = torch.matmul(q, k.transpose(-1, -2)) / scale
        bias = self.rel_pos_bias[self.rel_index].reshape(nt, nt, heads).permute(2, 0, 1)
        attn = attn + bias.to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b // nw, nw, heads, nt, nt)
                    + mask[None, :, None].to(attn.dtype)).reshape(b, heads, nt, nt)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, nt, heads * hd)
        return self.to_out(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(Linear(dim, hidden), nn.GELU(), Linear(hidden, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class PreNorm(nn.Module):
    """``norm`` then ``fn``: the reference's ``Residual(PreNorm(dim, fn))``
    key path (``.fn.norm``, ``.fn.fn``) under a ``Residual``."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = LayerNorm(dim, eps=LN_EPS)
        self.fn = fn


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class SwinBlock(nn.Module):
    """One block on its stage's ``(h, w)`` map; ``shift`` 0 is a regular
    block."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 hw: Tuple[int, int], head_dim: int = 32, mlp_ratio: float = 4.0):
        super().__init__()
        h, w = hw
        self.hw = (h, w)
        self.ws = min(window_size, h, w)
        self.shift = shift if (h > self.ws or w > self.ws) else 0
        self.attention_block = Residual(PreNorm(dim, WindowAttention(
            dim, num_heads, self.ws, head_dim)))
        self.mlp_block = Residual(PreNorm(dim, FeedForward(dim, int(dim * mlp_ratio))))

    def padded(self) -> Tuple[int, int]:
        """The map padded to whole windows."""
        h, w = self.hw
        return h + (self.ws - h % self.ws) % self.ws, w + (self.ws - w % self.ws) % self.ws

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        n, h, w, c = x.shape
        ws, shift = self.ws, self.shift
        pre = self.attention_block.fn
        y = pre.norm(x)
        hp, wp = self.padded()
        if (hp, wp) != (h, w):
            y = F.pad(y, (0, 0, 0, wp - w, 0, hp - h))
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        y = window_reverse(pre.fn(window_partition(y, ws), mask if shift else None), ws, hp, wp)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w]
        pre = self.mlp_block.fn
        return x + pre.fn(pre.norm(x))


class PatchMerging(nn.Module):
    """f×f patches, flattened (c, kh, kw), into a Linear (the reference's
    ``nn.Unfold`` order)."""

    def __init__(self, in_channels: int, out_channels: int, factor: int):
        super().__init__()
        self.factor = factor
        self.linear = Linear(in_channels * factor * factor, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.factor
        n, h, w, c = x.shape
        hf, wf = h // f, w // f
        x = x[:, : hf * f, : wf * f].reshape(n, hf, f, wf, f, c)
        return self.linear(x.permute(0, 1, 3, 5, 2, 4).reshape(n, hf, wf, c * f * f))


class StageModule(nn.Module):
    """The patch merge and the stage's blocks; ``attn_mask`` (not saved) is
    its shifted blocks' mask on their padded canvas, None when they do not
    shift."""

    def __init__(self, in_channels: int, dim: int, depth: int, num_heads: int, factor: int,
                 window_size: int, head_dim: int, hw: Tuple[int, int]):
        super().__init__()
        self.patch_partition = PatchMerging(in_channels, dim, factor)
        blocks = [SwinBlock(dim, num_heads, window_size, 0 if b % 2 == 0 else window_size // 2,
                            hw, head_dim) for b in range(depth)]
        self.layers = nn.ModuleList(nn.ModuleList(blocks[i: i + 2])
                                    for i in range(0, depth, 2))
        shifted = blocks[1] if depth > 1 else None
        mask = (shift_attn_mask(*shifted.padded(), shifted.ws, shifted.shift)
                if shifted is not None and shifted.shift else None)
        self.register_buffer("attn_mask", mask, persistent=False)

    def blocks(self):
        return [block for pair in self.layers for block in pair]


class SwinTransformer(nn.Module):
    """``[N, C, F, T]`` → the mean feature ``[N, embed_dim · 2^(S−1)]``
    (``is_flatten``) or the NCHW map of the last stage, float32."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 downscaling_factors: Sequence[int] = (4, 2, 2, 2), window_size: int = 7,
                 head_dim: int = 32, is_flatten: bool = True, final_norm: bool = True,
                 num_channels: int = 1, remat: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 spec_shape: Sequence[int] = (1, 128, 157)):
        super().__init__()
        self.embed_dim, self.depths = embed_dim, tuple(depths)
        self.factors = tuple(downscaling_factors)
        self.is_flatten, self.remat, self.dtype = is_flatten, remat, dtype
        self.spec_hw = tuple(spec_shape[-2:])
        maps = stage_maps(spec_shape, self.factors)
        in_c = num_channels
        for s, (depth, heads, f, hw) in enumerate(zip(depths, num_heads, self.factors, maps)):
            if min(hw) < 1:
                raise ValueError(f"swin: stage {s} of a {list(spec_shape)} input has an empty "
                                 f"{hw} map (downscaling factors {self.factors})")
            dim = embed_dim * 2 ** s
            self.add_module(f"stage{s + 1}", StageModule(in_c, dim, depth, heads, f,
                                                         window_size, head_dim, hw))
            in_c = dim
        self.norm = LayerNorm(in_c, eps=LN_EPS) if final_norm else None
        # flax's initialisers: lecun_normal kernels, zero biases, normal(0.02) tables
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    lecun_normal_(m.weight)
                    m.bias.zero_()
                elif isinstance(m, WindowAttention):
                    nn.init.normal_(m.rel_pos_bias, 0.0, 0.02)

    def stages(self) -> List[StageModule]:
        return [getattr(self, f"stage{s + 1}") for s in range(len(self.depths))]

    def map_shape(self, spec_shape: Sequence[int]) -> Tuple[int, int, int]:
        """``(c, h, w)`` of the output for a ``spec_shape`` segment (1 × 1
        after the mean)."""
        c = self.embed_dim * 2 ** (len(self.depths) - 1)
        h, w = stage_maps(spec_shape, self.factors)[-1]
        return (c, 1, 1) if self.is_flatten else (c, h, w)

    def feature_dim(self, spec_shape: Sequence[int]) -> int:
        c, h, w = self.map_shape(spec_shape)
        return c * h * w

    def _block(self, block: SwinBlock, x: torch.Tensor, mask) -> torch.Tensor:
        if self.remat and self.training and torch.is_grad_enabled():
            return checkpoint(block, x, mask, use_reentrant=False)
        return block(x, mask)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[-2:]) != self.spec_hw:
            raise ValueError(f"swin: built for {list(self.spec_hw)} inputs (its windows and "
                             f"tables follow the map), got {list(x.shape[-2:])}")
        x = x.to(self.dtype).permute(0, 2, 3, 1)  # NHWC
        for stage in self.stages():
            x = stage.patch_partition(x)
            for block in stage.blocks():
                x = self._block(block, x, stage.attn_mask)
        if self.norm is not None:
            x = self.norm(x)
        x = x.float()
        return x.mean(dim=(1, 2)) if self.is_flatten else x.permute(0, 3, 1, 2)


#: each factory's downscaling factors (the reference's, swin_transformer.py)
SWIN_FACTORS = {"swin_mini": (3, 2, 2, 1), "swin_t": (4, 2, 2, 2), "swin_s": (4, 2, 2, 2),
                "swin_b": (4, 2, 2, 2), "swin_l": (4, 2, 2, 2)}
_SWIN_WIDTHS = {
    "swin_mini": dict(embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24)),
    "swin_t": dict(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_s": dict(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_b": dict(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "swin_l": dict(embed_dim=192, depths=(2, 2, 18, 2), num_heads=(6, 12, 24, 48)),
}
for _name, _widths in _SWIN_WIDTHS.items():
    BACKBONES.register(_name)(backbone_factory(functools.partial(
        SwinTransformer, downscaling_factors=SWIN_FACTORS[_name], **_widths)))
