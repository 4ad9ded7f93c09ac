"""ATLNet: episodic attention and adaptive-threshold local matching
(counterpart of ``audio_fewshot_tpu/models/heads/atl_net.py``).

A shared 1×1 conv + BN + LeakyReLU transform ``W`` of the feature maps,
the cosine match of the transformed query descriptors against all
transformed support descriptors, and an MLP ``f_psi`` that gives each query
descriptor an adaptive threshold; the thresholded, L1-normalised attention
weighs the cosine match of the untransformed descriptors; the score sums
over the support positions, averages over shots and query positions, and is
scaled.  Parameters carry the reference torch names (``atlLayer.W.0`` /
``.1``, ``atlLayer.attenLayer.f_psi.0`` / ``.2``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...parallel.collectives import sharded_rows
from ...registry import CLASSIFIERS
from ..backbones.layers import BatchNorm, Conv2d
from .local_metrics import LocalDescriptorMethod, l2_normalize


class AEAModule(nn.Module):
    """The adaptive threshold ``f_psi(q) · value_interval + from_value`` of
    each transformed query descriptor, and the attention
    ``sigmoid(atten_scale_value · (f_x − threshold))`` normalised over the
    support positions."""

    def __init__(self, feat_dim: int, atten_scale_value: float, from_value: float,
                 value_interval: float):
        super().__init__()
        self.atten_scale_value = atten_scale_value
        self.from_value = from_value
        self.value_interval = value_interval
        self.f_psi = nn.Sequential(nn.Linear(feat_dim, feat_dim // 16), nn.LeakyReLU(0.2),
                                   nn.Linear(feat_dim // 16, 1), nn.Sigmoid())

    def forward(self, wq: torch.Tensor, f_x: torch.Tensor) -> torch.Tensor:
        threshold = self.f_psi(wq) * self.value_interval + self.from_value  # [E, G, hw, 1]
        gate = torch.sigmoid(self.atten_scale_value * (f_x - threshold))
        return gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-12)


class ATLModule(nn.Module):
    """``W`` (shared by query and support) and the AEA attention.  ``W`` runs
    on the query maps first, then on the support maps: in train mode its BN
    takes each call's moments over every rank's episodes and updates its
    running statistics twice a step, in that order, as the JAX package's."""

    def __init__(self, in_channels: int, feat_dim: int = 64, scale_value: float = 30.0,
                 atten_scale_value: float = 50.0, from_value: float = 0.5,
                 value_interval: float = 0.3):
        super().__init__()
        self.feat_dim = feat_dim
        self.scale_value = scale_value
        self.W = nn.Sequential(Conv2d(in_channels, feat_dim, 1, bias=False), BatchNorm(feat_dim),
                               nn.LeakyReLU(0.2))
        self.attenLayer = AEAModule(feat_dim, atten_scale_value, from_value, value_interval)

    def forward(self, query_feat: torch.Tensor, support_feat: torch.Tensor, way: int,
                shot: int) -> torch.Tensor:
        e, g, c, h, w = query_feat.shape
        ws, hw, fd = support_feat.shape[1], h * w, self.feat_dim

        def transform(x: torch.Tensor, n: int) -> torch.Tensor:
            with sharded_rows():  # train-mode moments over every rank's episodes
                return self.W(x.reshape(e * n, c, h, w)).reshape(e, n, fd, hw)

        wq = l2_normalize(transform(query_feat, g).transpose(-1, -2), -1)  # [E, G, hw, fd]
        wsup = transform(support_feat, ws).transpose(1, 2).reshape(e, fd, ws * hw)
        f_x = torch.einsum("egxc,ecy->egxy", wq, l2_normalize(wsup, 1))  # [E, G, hw, ws·hw]
        atten = self.attenLayer(wq, f_x)

        q = l2_normalize(query_feat.reshape(e, g, c, hw).transpose(-1, -2), -1)
        s = support_feat.reshape(e, ws, c, hw).transpose(1, 2).reshape(e, c, ws * hw)
        match = torch.einsum("egxc,ecy->egxy", q, l2_normalize(s, 1))
        scored = (atten * match).reshape(e, g, hw, way, shot, hw).sum(dim=-1)
        return scored.mean(dim=(2, 4)) * self.scale_value  # [E, G, way]


@CLASSIFIERS.register("ATLNet")
class ATLNet(LocalDescriptorMethod):
    """``map_shape`` (the backbone's ``(c, h, w)``, from ``build_method``)
    gives ``W``'s input width."""

    needs_map_shape = True

    def __init__(self, emb_func, map_shape: Sequence[int], feat_dim: int = 64,
                 scale_value: float = 30.0, atten_scale_value: float = 50.0,
                 from_value: float = 0.5, value_interval: float = 0.3, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.atlLayer = ATLModule(int(map_shape[0]), feat_dim, scale_value, atten_scale_value,
                                  from_value, value_interval)

    def _logits(self, batch, setting):
        sup, qry = self.embed(batch)
        return self.atlLayer(qry, sup, setting.way, setting.shot)
