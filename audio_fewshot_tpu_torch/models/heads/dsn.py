"""DSN, adaptive subspace classifiers (counterpart of
``audio_fewshot_tpu/models/heads/dsn.py``).

Each class's subspace is spanned by the top ``shot − 1`` left singular
vectors of its support matrix ``[d, shot]`` (the raw support, not centred,
as the JAX package and the reference); a query's logit is −‖q − P Pᵀ q‖² / d.
With ``discriminative`` the train loss adds ``disc_weight`` × the squared
Frobenius overlap of the class subspaces, summed over the batch's episodes
(every rank's, over several ranks).  1-shot falls back to
nearest-prototype logits (a 0-dimensional subspace is degenerate).  In
float32, one batched ``torch.linalg.svd`` over ``[E·way, d, shot]``.

The gradient through the SVD has 1 / (σᵢ² − σⱼ²) terms: it is finite only
while the support's singular values are apart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...episode import EpisodeBatch, segment_targets
from ...parallel.collectives import sharded_world
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from .proto_net import proto_logits


def dsn_logits(query_feat: torch.Tensor, support_feat: torch.Tensor, way: int, shot: int,
               normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """query ``[E, G, d]``, way-major support ``[E, way·shot, d]`` →
    (logits ``[E, G, way]``, subspaces ``[E, way, d, k]``), k = max(shot − 1, 1)."""
    e, _, d = support_feat.shape
    sup = support_feat.float().reshape(e, way, shot, d).transpose(-1, -2)  # [E, way, d, shot]
    uu = torch.linalg.svd(sup, full_matrices=False)[0]
    subspace = uu[..., : max(shot - 1, 1)]
    q = query_feat.float()
    coef = torch.einsum("ewdk,egd->ewgk", subspace, q)
    proj = torch.einsum("ewdk,ewgk->ewgd", subspace, coef)
    diff = q[:, None] - proj
    logits = -(diff * diff).sum(dim=-1).transpose(1, 2)  # [E, G, way]
    if normalize:
        logits = logits / d
    return logits, subspace


def dsn_disc_loss(subspace: torch.Tensor) -> torch.Tensor:
    """The summed squared Frobenius overlap ‖PᵥᵀP_w‖² of every pair of
    distinct class subspaces."""
    way = subspace.shape[1]
    overlap = torch.einsum("ewdk,evdl->ewvkl", subspace, subspace)
    fro2 = (overlap * overlap).sum(dim=(-2, -1))  # [E, way, way]
    off = 1.0 - torch.eye(way, dtype=fro2.dtype, device=fro2.device)
    return (fro2 * off).sum()


@CLASSIFIERS.register("DSN")
class DSN(MethodBase):
    model_type = ModelType.METRIC
    shardable = True

    def __init__(self, emb_func, discriminative: bool = False, disc_weight: float = 0.03,
                 **kwargs):
        super().__init__(emb_func, **kwargs)
        self.discriminative = discriminative
        self.disc_weight = disc_weight

    def _logits(self, batch: EpisodeBatch, setting: EpisodeSetting
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        sup, qry = self.embed(batch)
        if setting.shot < 2:
            return proto_logits(qry, sup, setting.way, setting.shot), None
        return dsn_logits(qry, sup, setting.way, setting.shot)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        return self._logits(batch, setting)[0]

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        seg_logits, subspace = self._logits(batch, setting)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        if self.discriminative and subspace is not None:
            # a sum over the episodes: over N ranks each rank's sum times N,
            # whose mean over the ranks (the logged loss, the averaged
            # gradients) is the sum over every rank's episodes, with no
            # collective in the step
            world = sharded_world()
            ranks = 1 if world is None else world.size
            loss = loss + self.disc_weight * dsn_disc_loss(subspace) * ranks
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
