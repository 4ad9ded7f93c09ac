"""FRN, feature-map ridge-regression reconstruction (counterpart of
``audio_fewshot_tpu/models/heads/frn.py``).

Each query descriptor (a position of its ``[c, h, w]`` map) is
reconstructed from its class's pooled support descriptors ``S`` ``[shot·hw,
c]`` by ridge regression in the Woodbury form, q̄ = ρ · q (SᵀS + λI)⁻¹ SᵀS,
with λ = (shot·hw / c)·e^{r₀} + 1e-6 and ρ = e^{r₁}; the logit is minus the
mean squared reconstruction error over the query's positions, times
``scale``.  The train loss adds ``aux_weight`` × ``auxrank_loss``, the mean
squared cross-class similarity of the normalised support descriptors.
Parameters carry the reference names ``frn_layer.scale`` [1] and
``frn_layer.r`` [2].

SᵀS and its solve (``torch.linalg.solve_ex``, no host sync on its
``info``) run in float64, the reconstruction in float32; the JAX package
forms both in float32, which at the shipped geometry (SᵀS + λI
ill-conditioned) puts its logits ~3.5e-4 of their scale off a float64
evaluation.  A
failed factorisation (``info`` ≠ 0; SᵀS + λI is positive definite, so it
should not happen) turns that class's logits, and with them the loss, into
NaN on the device, where the caller's finiteness checks see it.  In eval
(no autograd) the reconstruction error is formed in place: the [E, G·hw,
way, c] reconstruction is the one large tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy


def frn_recon_dist(query_d: torch.Tensor, support_d: torch.Tensor, alpha: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """Squared reconstruction errors ``[E, Gr, way]`` of the query
    descriptors ``[E, Gr, d]`` from each class's support pool ``[E, way, sr,
    d]`` (NaN for a class whose solve failed)."""
    sr, d = support_d.shape[-2:]
    lam = (sr / d) * torch.exp(alpha) + 1e-6
    rho = torch.exp(beta)
    # SᵀS and the solve in float64: SᵀS + λI is ill-conditioned at the
    # shipped geometry (λ ≈ 0.56 beside eigenvalues of 10⁴), and a float32
    # SᵀS puts the logits ~3.5e-4 of their scale off (the card's and the
    # CPU's ~1e-3 apart); in float64, 1.4e-7
    s64 = support_d.to(torch.promote_types(support_d.dtype, torch.float64))
    sts = torch.matmul(s64.transpose(-1, -2), s64)  # [E, way, d, d]
    eye = torch.eye(d, dtype=sts.dtype, device=sts.device)
    hat, info = torch.linalg.solve_ex(sts + lam.to(sts.dtype) * eye, sts)
    hat = hat.to(support_d.dtype)
    e, way = hat.shape[:2]
    # one [E, Gr, d] × [E, d, way·d] product: no broadcast copy of the queries
    q_bar = torch.bmm(query_d, hat.permute(0, 2, 1, 3).reshape(e, d, way * d))
    q_bar = q_bar.view(e, -1, way, d)  # [E, Gr, way, d]
    q = query_d[:, :, None]
    if torch.is_grad_enabled():
        diff = q_bar * rho - q
        dist = (diff * diff).sum(dim=-1)
    else:
        diff = q_bar.mul_(rho).sub_(q)
        dist = diff.square_().sum(dim=-1)
    return torch.where((info != 0)[:, None], torch.nan, dist)


def auxrank_loss(support_d: torch.Tensor, way: int) -> torch.Tensor:
    """Mean squared cross-class similarity of the L2-normalised support
    descriptors ``[E, way, sr, d]``."""
    sn = F.normalize(support_d, dim=-1, eps=1e-12)
    sim = torch.einsum("ewnd,evmd->ewvnm", sn, sn)
    off = 1.0 - torch.eye(way, dtype=sim.dtype, device=sim.device)
    cross = sim * off[None, :, :, None, None]
    return (cross * cross).sum() / (sim.shape[0] * way * (way - 1) + 1e-9)


class FRNLayer(nn.Module):
    """The learned scalars: ``scale`` (1 at init) and ``r`` = (log λ's
    offset, log ρ) (0 at init)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.r = nn.Parameter(torch.zeros(2))


@CLASSIFIERS.register("FRN")
class FRN(MethodBase):
    model_type = ModelType.METRIC
    shardable = True
    needs_feature_map = True

    def __init__(self, emb_func, aux_weight: float = 0.03, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.aux_weight = aux_weight
        self.frn_layer = FRNLayer()

    @staticmethod
    def _pools(qry: torch.Tensor, sup: torch.Tensor, way: int, shot: int):
        """Query descriptors ``[E, G, hw, c]`` and the class pools ``[E, way,
        shot·hw, c]``."""
        e, g, c, h, w = qry.shape
        hw = h * w
        qd = qry.reshape(e, g, c, hw).transpose(-1, -2)
        sd = sup.reshape(e, way, shot, c, hw).transpose(-1, -2).reshape(e, way, shot * hw, c)
        return qd, sd

    def _logits(self, batch: EpisodeBatch, setting: EpisodeSetting
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        sup, qry = self.embed(batch)
        qd, sd = self._pools(qry.float(), sup.float(), setting.way, setting.shot)
        e, g, hw, c = qd.shape
        r = self.frn_layer.r
        dist = frn_recon_dist(qd.reshape(e, g * hw, c), sd, r[0], r[1])
        return -dist.reshape(e, g, hw, setting.way).mean(dim=2) * self.frn_layer.scale, sd

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        return self._logits(batch, setting)[0]

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        seg_logits, sd = self._logits(batch, setting)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        loss = loss + self.aux_weight * auxrank_loss(sd, setting.way)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
