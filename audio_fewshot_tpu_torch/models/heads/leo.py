"""LEO, latent embedding optimisation (counterpart of
``audio_fewshot_tpu/models/heads/leo.py``).

The encoder maps each episode's support features to a per-class latent
Gaussian: ``encoder_func`` (D → hid), then every ``(way·shot)²`` pair of a
class's samples with all samples (concatenated), three bias-free relation
Linears with ReLU, and the mean over a class's pairs → ``[E, way, 2·hid]``
(mean ‖ log-variance).  A latent is sampled, ``iter`` SGD steps at ``lr``
move it on the support cross-entropy of the classifier weights the decoder
(hid → 2·D, mean ‖ log-variance) samples from it, and ``finetune_iter``
steps at ``finetune_lr`` fine-tune the decoded weights ``[E, D, way]``.
Training adds the latent KL, the encoder penalty ‖z − z₀‖² and the
decoder kernel's row-orthogonality penalty.

- The backbone runs as the JAX package's ``train=False`` under ``no_grad``
  in ``loss`` too (running statistics, no Dropout, no gradient), even while
  the ``Trainer`` holds the module in train mode: only the encoder and the
  decoder learn.
- Sampling is ``mean + exp(½·logvar)·ε`` (the JAX package's documented
  delta from the reference's raw scale).  The decoder's noise is ONE draw,
  reused at every latent step and at the final decode.  The draws come
  from ``noise`` (``layers.GaussianNoise``): the latent's first, then the
  decoder's; an eval forward restarts it from its seed.
- The support cross-entropy of both loops is the mean over all the batch's
  support rows, as the JAX package takes it, so an episode's gradient is
  1/E of its own mean's.  The loops step all episodes at once
  (``maml.sgd_steps``), second order in training.
- The kwarg is ``inner_para``; the decoder is sized from the backbone's
  flat width (``needs_feat_dim``).

Keys: ``encoder.encoder_func``, ``encoder.relation_net.{0,2,4}``,
``decoder.decoder_func`` (the reference's).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..backbones.layers import GaussianNoise
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from ..init import dense
from .maml import _eval_mode, sgd_steps


class LEOEncoder(nn.Module):
    def __init__(self, feat_dim: int, hid_dim: int):
        super().__init__()
        self.encoder_func = dense(feat_dim, hid_dim)
        layers = []
        for _ in range(3):
            layers += [dense(2 * hid_dim, 2 * hid_dim, bias=False), nn.ReLU()]
        self.relation_net = nn.Sequential(*layers)

    def forward(self, sup: torch.Tensor, way: int, shot: int) -> torch.Tensor:
        """``sup`` [E, way·shot, D] → ``[E, way, 2·hid]``."""
        e = sup.shape[0]
        out = self.encoder_func(sup).reshape(e, way, shot, -1)
        t1 = out.repeat_interleave(shot, dim=2).repeat_interleave(way, dim=1)
        t2 = out.repeat(1, way, shot, 1)
        x = self.relation_net(torch.cat([t1, t2], dim=-1))
        return x.reshape(e, way, way * shot * shot, -1).mean(dim=2)


class LEODecoder(nn.Module):
    def __init__(self, hid_dim: int, feat_dim: int):
        super().__init__()
        self.decoder_func = dense(hid_dim, 2 * feat_dim)


def _sample(mean_logvar: torch.Tensor, eps: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    mean, logvar = mean_logvar.chunk(2, dim=-1)
    return mean + eps * torch.exp(0.5 * logvar), mean, logvar


@CLASSIFIERS.register("LEO")
class LEO(MethodBase):
    model_type = ModelType.META
    #: ``build_method`` passes the backbone's flat feature width as ``feat_dim``
    needs_feat_dim = True

    def __init__(self, emb_func, feat_dim: int, inner_para: Optional[Dict] = None,
                 hid_dim: int = 64, kl_weight: float = 0.001,
                 encoder_penalty_weight: float = 1e-9,
                 orthogonality_penalty_weight: float = 1e-3, **kwargs):
        super().__init__(emb_func, **kwargs)
        p = dict(inner_para or {})
        self.inner_iter = int(p.get("iter", 5))
        self.inner_lr = float(p.get("lr", 1.0))
        self.ft_iter = int(p.get("finetune_iter", 5))
        self.ft_lr = float(p.get("finetune_lr", 0.001))
        self.feat_dim = feat_dim
        self.hid_dim = hid_dim
        self.kl_weight = kl_weight
        self.encoder_penalty_weight = encoder_penalty_weight
        self.orthogonality_penalty_weight = orthogonality_penalty_weight
        self.encoder = LEOEncoder(feat_dim, hid_dim)
        self.decoder = LEODecoder(hid_dim, feat_dim)
        self.noise = GaussianNoise()

    def _features(self, batch: EpisodeBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad(), _eval_mode(self.emb_func):
            return self.embed(batch)

    def _adapt(self, sup: torch.Tensor, sup_y: torch.Tensor, setting: EpisodeSetting,
               second_order: bool = True):
        """(classifier weights ``[E, D, way]``, KL, encoder penalty)."""
        enc = self.encoder(sup, setting.way, setting.shot)
        latent0, mean, logvar = _sample(enc, self.noise.draw(enc[..., :self.hid_dim].shape, enc))
        kl = 0.5 * (mean ** 2 + torch.exp(logvar) - logvar - 1.0).mean()
        eps_dec = self.noise.draw(sup.shape[:1] + (setting.way, self.feat_dim), sup)
        y = sup_y.reshape(-1).long()

        def decode(z):
            return _sample(self.decoder.decoder_func(z), eps_dec)[0].transpose(1, 2)

        def support_loss(w):
            return F.cross_entropy(torch.bmm(sup, w).reshape(-1, setting.way), y)

        latent, = sgd_steps([latent0], lambda t, step: support_loss(decode(t[0])),
                            self.inner_iter, self.inner_lr, second_order)
        encoder_penalty = ((latent0 - latent) ** 2).mean()
        weight, = sgd_steps([decode(latent)], lambda t, step: support_loss(t[0]),
                            self.ft_iter, self.ft_lr, second_order)
        return weight, kl, encoder_penalty

    def _orthogonality(self) -> torch.Tensor:
        """Row-correlation penalty of the decoder kernel, ``[2D, hid]`` (the
        Linear's own layout)."""
        w = self.decoder.decoder_func.weight
        wn = w / w.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        corr = wn @ wn.T
        return ((corr - torch.eye(corr.shape[0], dtype=corr.dtype, device=corr.device)) ** 2).mean()

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        self.noise.restart()
        sup, qry = self._features(batch)
        weight, _, _ = self._adapt(sup, batch.support_target, setting)
        return torch.bmm(qry, weight)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting,
             second_order: bool = True) -> Tuple[torch.Tensor, LossOutput]:
        sup, qry = self._features(batch)
        weight, kl, enc_pen = self._adapt(sup, batch.support_target, setting, second_order)
        seg_logits = torch.bmm(qry, weight)
        loss = (masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
                + self.kl_weight * kl + self.encoder_penalty_weight * enc_pen
                + self.orthogonality_penalty_weight * self._orthogonality())
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
