"""R2D2, differentiable closed-form ridge regression, and R2D2MCL
(counterpart of ``audio_fewshot_tpu/models/heads/r2d2.py``).

The dual ridge solve ``W = Sᵀ (S Sᵀ + γI)⁻¹ Y`` over each episode's support
features, logits ``α·QW + β``, with learnable α, β, γ (1, 0 and 50 at
init; the reference keys ``classifier.alpha`` / ``beta`` / ``gamma``, [1]
each).  One batched ``torch.linalg.solve_ex`` over the ``[E, W·S, W·S]``
systems, in float32; ``solve_ex`` leaves ``info`` on the device (no host
sync a call), and a failed factorisation (S Sᵀ + γI is positive definite
for γ > 0, so it should not happen) turns that episode's logits into NaN,
where the caller's finiteness checks see it.

R2D2MCL pools each query map by the MCL Katz centrality of its positions
(``mcl.katz_query_mask``) and each support map by its mean, then solves the
same ridge.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from .mcl import katz_query_mask


def ridge_logits(query: torch.Tensor, support: torch.Tensor, support_onehot: torch.Tensor,
                 alpha: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Batched dual ridge: query ``[E, G, D]``, support ``[E, NS, D]``, one-hot
    ``[E, NS, W]`` → ``[E, G, W]``."""
    ns = support.shape[1]
    gram = torch.matmul(support, support.transpose(-1, -2))
    eye = torch.eye(ns, dtype=gram.dtype, device=gram.device)
    sol, info = torch.linalg.solve_ex(gram + gamma * eye, support_onehot)  # [E, NS, W]
    w = torch.matmul(support.transpose(-1, -2), sol)  # [E, D, W]
    logits = alpha * torch.matmul(query, w) + beta
    return torch.where((info != 0)[:, None, None], torch.nan, logits)


class R2D2Layer(nn.Module):
    """The ridge's learned scalars."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))
        self.beta = nn.Parameter(torch.zeros(1))
        self.gamma = nn.Parameter(torch.full((1,), 50.0))


@CLASSIFIERS.register("R2D2")
class R2D2(MethodBase):
    model_type = ModelType.META
    shardable = True

    def __init__(self, emb_func, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.classifier = R2D2Layer()

    def _ridge(self, qry: torch.Tensor, sup: torch.Tensor, batch: EpisodeBatch,
               setting: EpisodeSetting) -> torch.Tensor:
        c = self.classifier
        onehot = F.one_hot(batch.support_target.long(), setting.way).to(sup.dtype)
        return ridge_logits(qry, sup, onehot, c.alpha, c.beta, c.gamma)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        return self._ridge(qry.float(), sup.float(), batch, setting)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        seg_logits = self(batch, setting)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))


@CLASSIFIERS.register("R2D2MCL")
class R2D2MCL(R2D2):
    """The ridge over MCL-attended features: each query map pooled by its
    positions' Katz weights, each support map by its mean.  No shipped
    config; the defaults are every reproduce config's (katz 0.5, γ 20,
    γ₂ 10)."""

    needs_feature_map = True

    def __init__(self, emb_func, katz_factor: float = 0.5, gamma: float = 20.0,
                 gamma2: float = 10.0, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.katz_factor = katz_factor
        self.gamma = gamma
        self.gamma2 = gamma2

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        sup, qry = sup.float(), qry.float()
        e, g, c, h, w = qry.shape
        mask = katz_query_mask(qry, sup, setting.way, setting.shot, self.katz_factor,
                               self.gamma, self.gamma2)
        qry_vec = torch.einsum("egcx,egx->egc", qry.reshape(e, g, c, h * w), mask)
        return self._ridge(qry_vec, sup.mean(dim=(-2, -1)), batch, setting)
