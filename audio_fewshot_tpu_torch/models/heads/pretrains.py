"""Backbone pretrainers: MetabaselinePretrain, FEAT_Pretrain,
DeepBDC_Pretrain, MTLPretrain, FRN_Pretrain and S2M2 (counterpart of
``audio_fewshot_tpu/models/heads/pretrains.py``).

Each trains the backbone with global cross-entropy through a linear
``classifier`` of ``num_class`` outputs on flat batches (``finetuning.
FinetuningBase``) and validates with a metric head over frozen features,
no adaptation: cosine to the class prototypes (MetabaselinePretrain,
``meta_baseline.cosine_proto_logits``), negative squared euclidean
(FEAT_Pretrain, ``proto_net.proto_logits``), or DeepBDC's shot-switched
prototypes (DeepBDC_Pretrain's ``val_type: meta``,
``deepbdc.bdc_proto_logits``; its ``stl`` fits the probe,
``finetuning.sklearn_probe_logits``, at ``penalty_C``).  Their ``save_part:
[emb_func]`` checkpoint is what a later method loads through
``pretrain_path``.  DeepBDC_Pretrain's distillation needs a teacher, which
only ``set_teacher`` gives.

- MTLPretrain trains through ``pre_fc`` (Linear 1000 → ReLU → Linear) and
  validates a linear learner from zero, ``inner_param.iter`` (5) full-support
  gradient steps at lr 0.01, all episodes at once (``sgd_head_steps`` over
  the written-out ``linear_head_gradient``).
- FRN_Pretrain has no ``classifier``: each map position of a flat batch,
  scaled by 1/√640 whatever the width, is ridge-reconstructed from each
  class's rows of the global category matrix ``frn_layer.cat_mat``
  ``[num_class, h·w, c]`` (``frn.frn_recon_dist``; ``frn_layer.scale``
  trained, ``frn_layer.r`` a frozen buffer at 0); the loss is the NLL of the
  position-averaged negative distances × scale.  Validation reconstructs
  query positions from each class's support pool, as FRN does, and
  returns log-probabilities.
- S2M2 trains the cosine head on input mixup, λ·CE(y) + (1 − λ)·CE(y[perm])
  with λ ~ Beta(α, α) and perm drawn on the host (``MixupDraws``), plus
  0.5·(class CE + the CE of ``rot_classifier`` (Linear 4) at the flip's
  index) over [x, time-flip, freq-flip, both]: two backbone calls a step.
  Both calls start from the step's BN statistics and DropBlock counters,
  and only the second's updates stay, as in the JAX package (one momentum
  update a step, by the flipped batch).  Validation adapts the cosine head,
  as BaselinePlus.  Over several ranks the permutation spans the whole flat
  batch (rank 0's draw on every rank) and each rank takes its rows'
  partners from the gathered batch (``S2M2.mix``), so every rank mixes the
  rows one rank mixes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...episode import EpisodeBatch, FlatBatch
from ...parallel.collectives import gather_rows, sharded_rows, sharded_world
from ...registry import CLASSIFIERS
from ..backbones.layers import _SeededNoise
from ..base import EpisodeSetting, LossOutput
from ..init import dense
from ..losses import cross_entropy
from .deepbdc import bdc_proto_logits
from .finetuning import (FinetuningBase, _ProbeEval, _accuracy, _wide, flat_only,
                         linear_head_gradient, sgd_head_steps)
from .frn import frn_recon_dist
from .meta_baseline import cosine_proto_logits
from .proto_net import proto_logits


class GlobalPretrain(FinetuningBase):
    """The linear global head; validation with the ``val_metric`` head."""

    val_metric = "cos_sim"  # "cos_sim" | "euclidean" | "bdc"

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        if self.val_metric == "cos_sim":
            return cosine_proto_logits(qry, sup, setting.way, setting.shot)
        if self.val_metric == "bdc":
            return bdc_proto_logits(qry, sup, setting.way, setting.shot)
        return proto_logits(qry, sup, setting.way, setting.shot, "euclidean")


@CLASSIFIERS.register("MetabaselinePretrain")
class MetabaselinePretrain(GlobalPretrain):
    val_metric = "cos_sim"


@CLASSIFIERS.register("FEAT_Pretrain")
class FEATPretrain(GlobalPretrain):
    val_metric = "euclidean"


@CLASSIFIERS.register("DeepBDC_Pretrain")
class DeepBDCPretrain(_ProbeEval, GlobalPretrain):
    """``val_type`` ``meta`` (the BDC prototypes) or ``stl`` (the probe at
    ``penalty_C`` on L2-normalised features); with ``is_distill`` and a
    teacher set, + α·KL to the teacher's logits at ``kd_T``."""

    val_metric = "bdc"

    def __init__(self, emb_func, val_type: str = "meta", penalty_C: float = 0.1,
                 is_distill: bool = False, kd_T: float = 4.0, alpha: float = 0.5, **kwargs):
        super().__init__(emb_func, **kwargs)
        if val_type not in ("meta", "stl"):
            raise ValueError(f"val_type must be 'meta' or 'stl', got {val_type!r}")
        self.val_type = val_type
        self.probe_c = penalty_C
        self.is_distill = is_distill
        self.kd_T = kd_T
        self.alpha = alpha

    def loss(self, batch: FlatBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        return self._distilled(*super().loss(batch, setting), batch)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        if self.val_type == "stl":
            return FinetuningBase.forward(self, batch, setting)
        return super().forward(batch, setting)


@CLASSIFIERS.register("MTLPretrain")
class MTLPretrain(FinetuningBase):
    """Global CE through ``pre_fc``; validation adapts a linear learner from
    zero, ``adapt_iter`` plain gradient steps at lr 0.01."""

    def __init__(self, emb_func, inner_param: Optional[Dict] = None, **kwargs):
        super().__init__(emb_func, inner_param=inner_param, **kwargs)
        self.adapt_iter = int(dict(inner_param or {}).get("iter", 5))
        self.pre_fc = nn.Sequential(dense(self.feat_dim, 1000), nn.ReLU(),
                                    dense(1000, self.num_class))

    def _global_head(self) -> Optional[nn.Module]:
        return None

    def global_logits(self, feats: torch.Tensor) -> torch.Tensor:
        return self.pre_fc(feats)

    @torch.no_grad()
    def episode_head_logits(self, sup_f, sup_y, qry_f, way: int) -> torch.Tensor:
        sup_f, qry_f = _wide(sup_f), _wide(qry_f)
        e, _, d = sup_f.shape
        onehot = F.one_hot(sup_y.long(), way).to(sup_f.dtype)
        w, b = sgd_head_steps((sup_f.new_zeros((e, d, way)), sup_f.new_zeros((e, way))),
                              linear_head_gradient(sup_f, onehot), self.adapt_iter, 0.01,
                              momentum=0.0, weight_decay=0.0)
        return torch.baddbmm(b[:, None], qry_f, w)


class FRNPretrainLayer(nn.Module):
    """``scale`` (1, trained), ``r`` = [α, β] (0, a buffer: frozen) and
    ``cat_mat`` ``[num_class, h·w, c]`` ~ N(0, 1)."""

    def __init__(self, num_class: int, resolution: int, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.register_buffer("r", torch.zeros(2))
        self.cat_mat = nn.Parameter(torch.randn(num_class, resolution, channels))


@CLASSIFIERS.register("FRN_Pretrain")
class FRNPretrain(FinetuningBase):
    """Ridge reconstruction from the global category matrix (``map_shape``,
    from ``build_method``, sizes it)."""

    needs_feature_map = True
    needs_map_shape = True
    #: the map, not flat features: the shipped configs name the plain
    #: resnet12 (flat by default, where the JAX package fails on unpacking
    #: the map's shape); a config's own kwargs win
    backbone_kwarg_defaults = {"is_flatten": False, "avg_pool": False}

    def __init__(self, emb_func, map_shape: Sequence[int], num_class: int = 64, **kwargs):
        super().__init__(emb_func, num_class=num_class, **kwargs)
        c, h, w = (int(n) for n in map_shape)
        self.frn_layer = FRNPretrainLayer(num_class, h * w, c)

    def _global_head(self) -> Optional[nn.Module]:
        return None

    @staticmethod
    def _rows(feats: torch.Tensor) -> torch.Tensor:
        """``[n, c, h, w]`` → the positions as rows ``[n, h·w, c]``, over the
        hard-coded √640."""
        n, c = feats.shape[:2]
        return feats.float().reshape(n, c, -1).transpose(1, 2) / math.sqrt(640.0)

    def loss(self, batch: FlatBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        flat_only(batch)
        with sharded_rows():
            rows = self._rows(self.emb_func(batch.data))
        n, hw, c = rows.shape
        layer = self.frn_layer
        dist = frn_recon_dist(rows.reshape(1, n * hw, c), layer.cat_mat[None],
                              layer.r[0], layer.r[1])
        neg = -dist.reshape(n, hw, self.num_class).mean(dim=1) * layer.scale
        logp = F.log_softmax(neg, dim=-1)
        loss = -logp.gather(1, batch.target.long()[:, None]).mean()
        return loss, LossOutput(logp, {"acc": _accuracy(neg, batch.target)})

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        e, ws, c, h, w = sup.shape
        g, hw = qry.shape[1], h * w
        sup_rows = self._rows(sup.reshape(e * ws, c, h, w)).reshape(
            e, setting.way, setting.shot * hw, c)
        q_rows = self._rows(qry.reshape(e * g, c, h, w)).reshape(e, g * hw, c)
        layer = self.frn_layer
        dist = frn_recon_dist(q_rows, sup_rows, layer.r[0], layer.r[1])
        neg = -dist.reshape(e, g, hw, setting.way).mean(dim=2) * layer.scale
        return F.log_softmax(neg, dim=-1)


class MixupDraws(_SeededNoise):
    """S2M2's mixup draws: λ ~ Beta(α, α) and a permutation of the batch,
    from a host numpy generator seeded by ``seed_dropout`` (the trainer
    reseeds it each epoch).  The permutation spans the whole flat batch, so
    every rank draws the same values."""

    same_on_every_rank = True

    def __init__(self, alpha: float):
        super().__init__()
        self.alpha = alpha
        self.rng: Optional[np.random.Generator] = None

    def reseed(self, seed: int) -> None:
        super().reseed(seed)
        self.rng = None

    def draw(self, batch_size: int) -> Tuple[float, np.ndarray]:
        if self.rng is None:
            self.rng = np.random.default_rng((self.seed, 19))
        return float(self.rng.beta(self.alpha, self.alpha)), self.rng.permutation(batch_size)


@contextlib.contextmanager
def restored_buffers(module: nn.Module):
    """The buffers of ``module`` (BN statistics, DropBlock counters) put
    back as they were on entry, when the block ends."""
    saved = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for buf, value in saved:
                buf.copy_(value)


@CLASSIFIERS.register("S2M2")
class S2M2(FinetuningBase):
    """Input mixup + the four flips with ``rot_classifier``; validation by
    the cosine head's adaptation."""

    head_kind = "cosine"

    def __init__(self, emb_func, alpha: float = 2.0, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.alpha = alpha
        self.mixup = MixupDraws(alpha)
        self.rot_classifier = dense(self.feat_dim, 4)

    def backbone_rows(self, batch_size: int) -> int:
        return 5 * batch_size

    @torch.no_grad()
    def mix(self, x: torch.Tensor, y: torch.Tensor) -> Tuple[float, torch.Tensor, torch.Tensor]:
        """λ, the mixed rows λ·x + (1 − λ)·x[perm] and the partners'
        targets y[perm] of this rank's rows, λ and perm drawn for the whole
        flat batch.  Over several ranks the partners come from the batch
        gathered in rank order: the data take no gradient, and gathering
        on the device works on bank rows too, which the host never holds."""
        world = sharded_world()
        x_all, y_all = gather_rows(x, world), gather_rows(y, world)
        lam, perm = self.mixup.draw(x_all.shape[0])
        perm = torch.from_numpy(np.array(perm, dtype=np.int64)).to(x.device)
        if world is not None:
            perm = perm[world.rows(perm.shape[0])]
        return lam, lam * x + (1.0 - lam) * x_all[perm], y_all[perm]

    def loss(self, batch: FlatBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        flat_only(batch)
        x, y = batch.data, batch.target
        b = x.shape[0]
        lam, mixed, y_perm = self.mix(x, y)
        # the second call starts from the statistics the first started from
        with restored_buffers(self.emb_func):
            logits_mix = self.global_logits(self.flat_features(mixed))
        loss_mm = lam * cross_entropy(logits_mix, y) + (1.0 - lam) * cross_entropy(
            logits_mix, y_perm)
        flips = torch.cat([x, torch.flip(x, (-1,)), torch.flip(x, (-2,)), torch.flip(x, (-2, -1))])
        feats = self.flat_features(flips)
        logits = self.global_logits(feats)
        rot_y = torch.arange(4, device=x.device).repeat_interleave(b)
        loss_rot = 0.5 * cross_entropy(logits, y.repeat(4)) + 0.5 * cross_entropy(
            self.rot_classifier(feats), rot_y)
        return loss_mm + loss_rot, LossOutput(logits[:b], {"acc": _accuracy(logits[:b], y)})
