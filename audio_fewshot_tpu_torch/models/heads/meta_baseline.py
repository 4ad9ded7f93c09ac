"""MetaBaseline (counterpart of
``audio_fewshot_tpu/models/heads/meta_baseline.py``): cosine similarity to
class-mean prototypes, scaled by a learnable temperature ``temp`` (a scalar,
10 at init; the reference torch name), in float32."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from .proto_net import proto_logits


def cosine_proto_logits(query_feat: torch.Tensor, support_feat: torch.Tensor, way: int,
                        shot: int) -> torch.Tensor:
    """``[E, G, way]`` cosine similarities of the queries to the class-mean
    prototypes."""
    return proto_logits(query_feat, support_feat, way, shot, mode="cos_sim")


@CLASSIFIERS.register("MetaBaseline")
class MetaBaseline(MethodBase):
    model_type = ModelType.METRIC
    shardable = True

    def __init__(self, emb_func, temperature: float = 10.0, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.temp = nn.Parameter(torch.tensor(float(temperature)))

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        return self.temp * cosine_proto_logits(qry, sup, setting.way, setting.shot)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        seg_logits = self(batch, setting)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
