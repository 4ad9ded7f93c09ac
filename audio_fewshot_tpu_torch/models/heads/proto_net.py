"""ProtoNet — Prototypical Networks (counterpart of
``audio_fewshot_tpu/models/heads/proto_net.py``): class-mean prototypes and
negative squared-euclidean or cosine logits, one batched product over the
episode axis (the ragged query axis is dense and masked), in float32.
``use_bpa`` (``ops/bpa.py``) is not ported yet and raises."""

from __future__ import annotations

from typing import Tuple

import torch

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy


def neg_sq_euclidean(query_feat: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    """−‖q − p‖² ``[E, G, way]`` via 2q·p − ‖q‖² − ‖p‖²: one product instead
    of the ``[E, G, way, D]`` difference tensor."""
    query_feat, proto = query_feat.float(), proto.float()
    qp = torch.matmul(query_feat, proto.transpose(-1, -2))
    q2 = (query_feat * query_feat).sum(dim=-1)[..., None]
    p2 = (proto * proto).sum(dim=-1)[:, None, :]
    return 2.0 * qp - q2 - p2


def prototypes(support_feat: torch.Tensor, way: int, shot: int) -> torch.Tensor:
    """Class-mean prototypes ``[E, way, D]`` from way-major ``[E, way*shot, D]``."""
    e, _, d = support_feat.shape
    return support_feat.reshape(e, way, shot, d).mean(dim=2)


def proto_logits(query_feat: torch.Tensor, support_feat: torch.Tensor, way: int, shot: int,
                 mode: str = "euclidean") -> torch.Tensor:
    """``[E, G, way]`` logits: ``euclidean`` (−‖q − p‖²) or ``cos_sim``."""
    proto = prototypes(support_feat.float(), way, shot)
    if mode == "euclidean":
        return neg_sq_euclidean(query_feat, proto)
    if mode == "cos_sim":
        q = query_feat.float()
        qn = q / q.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        pn = proto / proto.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        return torch.matmul(qn, pn.transpose(-1, -2))
    raise ValueError(f"unknown proto mode {mode!r}")


@CLASSIFIERS.register("ProtoNet")
class ProtoNet(MethodBase):
    model_type = ModelType.METRIC

    def __init__(self, emb_func, mode: str = "euclidean", use_bpa: bool = False, **kwargs):
        super().__init__(emb_func, **kwargs)
        if use_bpa:
            raise NotImplementedError(
                "use_bpa (ops/bpa.py) is not ported yet (ROADMAP Queue A item 6)")
        self.mode = mode

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        return proto_logits(qry, sup, setting.way, setting.shot, self.mode)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        sup, qry = self.embed(batch)
        seg_logits = proto_logits(qry, sup, setting.way, setting.shot, self.mode)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
