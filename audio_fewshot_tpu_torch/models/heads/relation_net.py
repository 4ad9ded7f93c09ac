"""RelationNet: a learned relation scorer over concatenated feature maps
(counterpart of ``audio_fewshot_tpu/models/heads/relation_net.py``).

The class map is the SUM of its shots' maps; each (query, class) pair of maps
is concatenated on the channels and scored by ``relation_layer``: two blocks
of a 3×3 VALID conv, a BN on batch statistics (in train and in eval), ReLU
and a 2×2 max pool where both sides are at least 2, then fc(→ 8) → ReLU →
fc(→ 1).  The BNs' statistics come from the pairs of real query rows only
(``sample_mask``), so the scores of real rows do not depend on bucket
padding; over several ranks they span every rank's pairs, in eval too.  Parameters carry the reference torch names
(``relation_layer.layers.{0,1,4,5}``, ``relation_layer.fc.{0,2}``).

torch infers no shapes: ``fc.0``'s width comes from ``map_shape``.  At the
shipped Conv64F geometry (a 4×5 map) the first block leaves 1×1 and the
second conv nothing; the JAX package fails there at init, and the port
raises a ``ValueError`` at construction that names the way out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.collectives import sharded_rows
from ...registry import CLASSIFIERS
from ..backbones.layers import BatchNorm, Conv2d
from .local_metrics import LocalDescriptorMethod


class BatchStatBatchNorm(BatchNorm):
    """A BN that normalises with the batch statistics of the rows where
    ``mask`` in train and in eval, over every rank's rows inside
    ``parallel.sharded_rows``.  In train mode it also updates its running
    statistics as flax does (they are kept, never read)."""

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            return super().forward(x, mask)
        if mask is None:
            mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        return self.batch_normalize(x, mask)


def relation_map_hw(h: int, w: int) -> Tuple[int, int]:
    """The side lengths ``relation_layer`` leaves of an ``h × w`` pair map; a
    side below 1 where a conv leaves nothing."""
    for _ in range(2):
        h, w = h - 2, w - 2
        if h < 1 or w < 1:
            return h, w
        if h >= 2 and w >= 2:
            h, w = h // 2, w // 2
    return h, w


class RelationLayer(nn.Module):
    def __init__(self, in_channels: int, feat_dim: int, map_hw: Sequence[int]):
        super().__init__()
        h, w = relation_map_hw(*map_hw)
        if h < 1 or w < 1:
            raise ValueError(
                f"RelationNet: the backbone's {map_hw[0]}x{map_hw[1]} map is too small for the "
                "relation layer's two 3x3 VALID convs and 2x2 pools (the second conv leaves "
                "an empty map); set the backbone's maxpool_last2: false (a 14x17 map from "
                "[1, 128, 157] segments) or use larger segments")
        self.layers = nn.Sequential(
            Conv2d(in_channels, feat_dim, 3), BatchStatBatchNorm(feat_dim), nn.ReLU(),
            nn.MaxPool2d(2), Conv2d(feat_dim, feat_dim, 3), BatchStatBatchNorm(feat_dim),
            nn.ReLU(), nn.MaxPool2d(2))
        self.fc = nn.Sequential(nn.Linear(feat_dim * h * w, 8), nn.ReLU(), nn.Linear(8, 1))

    def forward(self, x: torch.Tensor, sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x [N, 2c, h, w]`` → ``[N, 1]``; ``sample_mask [N]`` marks the pairs
        whose rows feed the BN statistics."""
        for i in (0, 4):
            x = F.relu(self.layers[i + 1](self.layers[i](x), sample_mask))
            if x.shape[-2] >= 2 and x.shape[-1] >= 2:
                x = F.max_pool2d(x, 2, 2)
        # NHWC order, as the JAX package flattens (the reference flattens NCHW)
        return self.fc(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


@CLASSIFIERS.register("RelationNet")
class RelationNet(LocalDescriptorMethod):
    """``feat_height`` / ``feat_width`` are accepted for the configs and not
    read: ``map_shape`` (from ``build_method``) sizes ``fc.0``."""

    needs_map_shape = True

    def __init__(self, emb_func, map_shape: Sequence[int], feat_dim: int = 64,
                 feat_height: int = 3, feat_width: int = 3, **kwargs):
        super().__init__(emb_func, **kwargs)
        c, h, w = (int(v) for v in map_shape)
        self.relation_layer = RelationLayer(2 * c, feat_dim, (h, w))

    @staticmethod
    def pairs(qry: torch.Tensor, sup: torch.Tensor, way: int, shot: int) -> torch.Tensor:
        """``[E, G, c, h, w]`` × ``[E, W*S, c, h, w]`` → the ``[E*G*W, 2c, h, w]``
        stack of (query, class sum) pairs."""
        e, g, c, h, w = qry.shape
        proto = sup.reshape(e, way, shot, c, h, w).sum(dim=2)
        q = qry[:, :, None].expand(e, g, way, c, h, w)
        p = proto[:, None].expand(e, g, way, c, h, w)
        return torch.cat([q, p], dim=3).reshape(e * g * way, 2 * c, h, w)

    def _logits(self, batch, setting):
        sup, qry = self.embed(batch)
        e, g = qry.shape[:2]
        pair_mask = (batch.query_mask > 0).reshape(-1).repeat_interleave(setting.way)
        with sharded_rows():  # the BNs' moments over every rank's real pairs
            scores = self.relation_layer(self.pairs(qry, sup, setting.way, setting.shot),
                                         pair_mask)
        return scores.reshape(e, g, setting.way)
