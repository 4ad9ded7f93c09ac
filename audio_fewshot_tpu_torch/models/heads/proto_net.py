"""ProtoNet — Prototypical Networks (counterpart of
``audio_fewshot_tpu/models/heads/proto_net.py``): class-mean prototypes and
negative squared-euclidean or cosine logits, one batched product over the
episode axis (the ragged query axis is dense and masked), in float32.
``use_bpa`` runs the BPA transform (``ops/bpa.py``) over each episode's
[support ‖ query] features first (``apply_bpa``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...episode import EpisodeBatch, segment_targets
from ...ops.bpa import bpa_transform
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


def apply_bpa(sup: torch.Tensor, qry: torch.Tensor, query_mask: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BPA transform (cosine cost) over each episode's [support ‖ query]
    set: ``[E, W*S, D]``, ``[E, G, D]`` → ``[E, W*S, n]``, ``[E, G, n]`` with
    n = W*S + G.  ``query_mask`` keeps padded query segments out of the
    transport marginals."""
    ws = sup.shape[1]
    feats = torch.cat([sup, qry], dim=1)
    row_mask = None
    if query_mask is not None:
        row_mask = torch.cat([torch.ones(sup.shape[:2], dtype=query_mask.dtype,
                                         device=query_mask.device), query_mask], dim=1)
    affin = bpa_transform(feats, distance="cosine", row_mask=row_mask)
    return affin[:, :ws], affin[:, ws:]


def episode_features(method: MethodBase, batch: EpisodeBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """``method.embed(batch)``, BPA-transformed where the method's
    ``use_bpa`` is on (ProtoNet's and DeepBDC's ``forward`` and ``loss``)."""
    sup, qry = method.embed(batch)
    if method.use_bpa:
        sup, qry = apply_bpa(sup, qry, batch.query_mask)
    return sup, qry


@CLASSIFIERS.register("ProtoNet")
class ProtoNet(MethodBase):
    model_type = ModelType.METRIC
    shardable = True

    def __init__(self, emb_func, mode: str = "euclidean", use_bpa: bool = False, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.mode = mode
        self.use_bpa = use_bpa

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = episode_features(self, batch)
        return proto_logits(qry, sup, setting.way, setting.shot, self.mode)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        sup, qry = episode_features(self, batch)
        seg_logits = proto_logits(qry, sup, setting.way, setting.shot, self.mode)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
