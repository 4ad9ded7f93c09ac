"""VERSA, the amortised Bayesian few-shot head (counterpart of
``audio_fewshot_tpu/models/heads/versa.py``).

A shared trunk ``h`` (Linear(D → d_theta) → BN → ReLU → Dropout(
``drop_rate``)) over the support and query features; four ψ predictors
(Linear-ELU-Linear-ELU-Linear) map each class's mean trunk feature to the
mean and log-variance of its weight (``[d_theta]``) and bias; the query
logits' distribution is ``mean = q·wm + bm``, ``logvar = log(q²·exp(wl) +
exp(bl))``, and ``sample_num`` Monte-Carlo samples are averaged by
logsumexp.  The training loss is the negative mean over the real query
rows of each row's log-likelihood averaged the same way, a NaN row
counting 0.

- The trunk's BN always normalises with batch statistics, in eval too,
  taken over the support and real query rows of ALL episodes of the batch
  at once (padded query rows masked out); in training it also updates its
  running statistics, which nothing reads (the reference's ``h.1``).
- The sampling noise comes from ``noise`` (``layers.GaussianNoise``); an
  eval forward restarts it from its seed.

Keys: ``h.0`` (the Linear), ``h.1`` (the BN), ``{weight,bias}_{mean,logvar}
.layers.{0,2,4}`` (the reference's).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..backbones.layers import BatchNorm1d, Dropout, GaussianNoise
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType
from ..init import dense


class BatchStatBatchNorm1d(BatchNorm1d):
    """``BatchNorm1d`` on the masked batch statistics in train and eval; its
    running statistics move in train mode only, as flax's ``BatchNorm``
    with ``use_running_average=False`` under a mutable ``batch_stats``."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        out, mean, var = self._masked(x, mask)
        if self.training:
            self._update_running(mean, var)
        return out


class Predictor(nn.Module):
    def __init__(self, hid_dim: int, out_dim: int):
        super().__init__()
        self.layers = nn.Sequential(dense(hid_dim, hid_dim), nn.ELU(), dense(hid_dim, hid_dim),
                                    nn.ELU(), dense(hid_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


@CLASSIFIERS.register("VERSA")
class VERSA(MethodBase):
    model_type = ModelType.META
    #: ``build_method`` passes the backbone's flat feature width as ``feat_dim``
    needs_feat_dim = True

    def __init__(self, emb_func, feat_dim: int, sample_num: int = 10, d_theta: int = 256,
                 drop_rate: float = 0.0, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.sample_num = sample_num
        self.h = nn.Sequential(dense(feat_dim, d_theta), BatchStatBatchNorm1d(d_theta))
        self.drop = Dropout(drop_rate)
        self.weight_mean = Predictor(d_theta, d_theta)
        self.weight_logvar = Predictor(d_theta, d_theta)
        self.bias_mean = Predictor(d_theta, 1)
        self.bias_logvar = Predictor(d_theta, 1)
        self.noise = GaussianNoise()

    def _logit_distribution(self, batch: EpisodeBatch, setting: EpisodeSetting
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The query logits' mean and log-variance, ``[E, G, way]`` each."""
        sup, qry = self.embed(batch)
        e, ws, d = sup.shape
        g = qry.shape[1]
        rows = torch.cat([sup.reshape(-1, d), qry.reshape(-1, d)])
        mask = torch.cat([torch.ones(e * ws, dtype=torch.bool, device=rows.device),
                          (batch.query_mask > 0).reshape(-1)])
        h = self.drop(F.relu(self.h[1](self.h[0](rows), mask)))
        sup_h, qry_h = h[:e * ws].reshape(e, ws, -1), h[e * ws:].reshape(e, g, -1)
        class_feat = sup_h.reshape(e, setting.way, setting.shot, -1).mean(dim=2)
        wm, wl = self.weight_mean(class_feat).mT, self.weight_logvar(class_feat).mT
        bm, bl = self.bias_mean(class_feat).mT, self.bias_logvar(class_feat).mT
        mean = torch.bmm(qry_h, wm) + bm
        logvar = torch.log(torch.bmm(qry_h ** 2, torch.exp(wl)) + torch.exp(bl))
        return mean, logvar

    def _samples(self, mean: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
        """``[sample_num, E, G, way]`` logits."""
        eps = self.noise.draw((self.sample_num,) + tuple(mean.shape), mean)
        return mean + eps * torch.exp(0.5 * logvar)

    def _average(self, x: torch.Tensor) -> torch.Tensor:
        return torch.logsumexp(x, dim=0) - math.log(self.sample_num)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        self.noise.restart()
        return self._average(self._samples(*self._logit_distribution(batch, setting)))

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        samples = self._samples(*self._logit_distribution(batch, setting))
        target = segment_targets(batch).long()
        logp = F.log_softmax(samples, dim=-1)
        ll = logp.gather(-1, target.expand(samples.shape[:-1])[..., None])[..., 0]
        score = self._average(ll)
        score = torch.where(torch.isnan(score), torch.zeros_like(score), score)
        mask = batch.query_mask.to(score.dtype)
        loss = -(score * mask).sum() / mask.sum().clamp(min=1.0)
        seg_logits = self._average(samples)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
