"""Backbone pretrainers: MetabaselinePretrain, FEAT_Pretrain and
DeepBDC_Pretrain (counterpart of
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
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...episode import EpisodeBatch, FlatBatch
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput
from .deepbdc import bdc_proto_logits
from .finetuning import FinetuningBase, _ProbeEval
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
