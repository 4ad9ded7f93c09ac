"""FEAT, few-shot embedding adaptation with a set-to-set transformer
(counterpart of ``audio_fewshot_tpu/models/heads/feat.py``).

The class-mean prototypes of each episode attend to each other through
``SetAttention`` (single-head scaled dot-product attention with dropout,
a residual and a LayerNorm); the logits are the euclidean (or cosine)
metric of the queries to the adapted prototypes over ``temperature``.
Training adds a contrastive regulariser: each class's [shot | query]
members attend among themselves, and every member is classified against
the adapted class centres at ``temperature2``; loss = ``balance``·CE +
CE_reg.

The attention is as wide as the features: 12800 for the flat resnet12 at
``[1, 128, 157]``, whatever the config's ``hdim`` (the JAX package sizes it
so; ``hdim`` is accepted and not read).  torch infers no shapes, so the
width comes from ``map_shape`` (c·h·w).  Parameters carry the reference
names ``slf_attn.w_qs`` / ``w_ks`` / ``w_vs`` / ``fc`` / ``layer_norm``.

Over several ranks (``parallel``) each rank takes its shard of a step's
episodes.  Both terms of the loss are per-episode work averaged over equal
counts: the episodic CE over the valid query segments (a train batch's are
all valid, ``way · query`` an episode) and the regulariser's CE over each
episode's ``way · (shot + query)`` members, so the ranks' mean gradient is
the whole step's and no count needed making global.  Only the attention's
Dropout masks are drawn per rank (``layers.seed_dropout``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..backbones.layers import Dropout
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from ..init import lecun_normal_
from ..losses import cross_entropy
from .local_metrics import l2_normalize
from .proto_net import neg_sq_euclidean, prototypes


class SetAttention(nn.Module):
    """Single-head set-to-set attention over ``[..., n, d]``: ``w_qs`` /
    ``w_ks`` / ``w_vs`` (bias-free), softmax(q kᵀ / √d), ``Dropout(attn_dropout)``
    on the attention, the product with v, ``fc``, ``Dropout(dropout)``, the
    residual and ``LayerNorm(eps=1e-5)``.  Kernels drawn as flax's
    ``lecun_normal``, biases 0; the dropouts draw from their own generators
    (``layers.Dropout``)."""

    def __init__(self, d: int, dropout: float = 0.5, attn_dropout: float = 0.1):
        super().__init__()
        self.w_qs = nn.Linear(d, d, bias=False)
        self.w_ks = nn.Linear(d, d, bias=False)
        self.w_vs = nn.Linear(d, d, bias=False)
        self.fc = nn.Linear(d, d)
        self.layer_norm = nn.LayerNorm(d, eps=1e-5)
        self.attn_dropout = Dropout(attn_dropout)
        self.dropout = Dropout(dropout)
        for lin in (self.w_qs, self.w_ks, self.w_vs, self.fc):
            lecun_normal_(lin.weight)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        q, k, v = self.w_qs(x), self.w_ks(x), self.w_vs(x)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d), dim=-1)
        out = torch.matmul(self.attn_dropout(attn), v)
        out = self.dropout(self.fc(out))
        return self.layer_norm(out + x)


def metric_logits(query: torch.Tensor, proto: torch.Tensor, mode: str,
                  temperature: float) -> torch.Tensor:
    """``[E, G, way]``: −‖q − p‖² (``euclidean``) or the cosine, over
    ``temperature``."""
    if mode == "euclidean":
        return neg_sq_euclidean(query, proto) / temperature
    return torch.matmul(l2_normalize(query, -1), l2_normalize(proto, -1).transpose(-1, -2)) \
        / temperature


@CLASSIFIERS.register("FEAT")
class FEAT(MethodBase):
    """``map_shape`` (the backbone's ``(c, h, w)``, from ``build_method``)
    gives the attention's width c·h·w."""

    model_type = ModelType.METRIC
    needs_map_shape = True
    shardable = True

    def __init__(self, emb_func, map_shape: Sequence[int], hdim: int = 64,
                 temperature: float = 1.0, temperature2: float = 1.0, balance: float = 0.5,
                 mode: str = "euclidean", **kwargs):
        super().__init__(emb_func, **kwargs)
        self.hdim = hdim
        self.temperature = float(temperature)
        self.temperature2 = float(temperature2)
        self.balance = float(balance)
        self.mode = mode
        self.slf_attn = SetAttention(math.prod(int(n) for n in map_shape))

    def _adapted_logits(self, sup: torch.Tensor, qry: torch.Tensor,
                        setting: EpisodeSetting) -> torch.Tensor:
        proto = self.slf_attn(prototypes(sup.float(), setting.way, setting.shot))
        return metric_logits(qry.float(), proto, self.mode, self.temperature)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        return self._adapted_logits(sup, qry, setting)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        sup, qry = self.embed(batch)
        sup, qry = sup.float(), qry.float()
        seg_logits = self._adapted_logits(sup, qry, setting)
        loss1 = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)

        # the regulariser over way-major [shot | query] class groups: the
        # train loader's unpadded, way-major queries (G = way · query)
        e, g, d = qry.shape
        way, shot = setting.way, setting.shot
        if g != way * setting.query:
            raise ValueError(f"FEAT's regulariser needs the train batch's {way} x "
                             f"{setting.query} way-major, unpadded queries; got {g} query rows")
        q_per = setting.query
        aux = torch.cat([sup.reshape(e, way, shot, d), qry.reshape(e, way, q_per, d)], dim=2)
        aux_emb = self.slf_attn(aux.reshape(e * way, shot + q_per, d))
        centers = aux_emb.reshape(e, way, shot + q_per, d).mean(dim=2)
        samples = aux.reshape(e, way * (shot + q_per), d)
        reg_logits = metric_logits(samples, centers, self.mode, self.temperature2)
        reg_targets = torch.arange(way, device=reg_logits.device).repeat_interleave(
            shot + q_per).expand(e, -1)
        loss_reg = cross_entropy(reg_logits.reshape(-1, way), reg_targets.reshape(-1))
        loss = self.balance * loss1 + loss_reg
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
