"""Method base (counterpart of ``audio_fewshot_tpu/models/base.py``).

A method is an ``nn.Module`` that owns the backbone as ``emb_func`` (so its
``state_dict`` keys are ``emb_func.<reference torch name>``) and maps an
``EpisodeBatch`` of tensors to per-segment logits ``[E, G, way]``.  The
module's mode is the JAX package's ``train`` flag: in train mode ``embed``
runs the backbone with batch statistics over the whole episode batch, and
``loss`` returns the training loss with its logits and metrics.  A head
with parameters owns them as a submodule of its own beside ``emb_func``
(under the reference torch name), so ``optim.py`` gives it its own
parameter group, as the JAX package's ``head`` key does.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..episode import EpisodeBatch, segment_targets
from ..parallel.collectives import sharded_rows
from ..utils.aggregate import majority_vote, segment_accuracy
from ..utils.spans import span


class ModelType(enum.Enum):
    ABSTRACT = 0
    METRIC = 1
    META = 2
    FINETUNING = 3


@dataclass(frozen=True)
class EpisodeSetting:
    """Episode geometry."""

    way: int
    shot: int
    query: int


@dataclass
class LossOutput:
    seg_logits: torch.Tensor  # [E, G, way]
    metrics: Dict[str, torch.Tensor] = field(default_factory=dict)


def masked_cross_entropy(
    seg_logits: torch.Tensor, seg_target: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Mean cross-entropy over the valid query segments, in float32 at least
    (float64 logits keep float64)."""
    logp = F.log_softmax(seg_logits.to(torch.promote_types(seg_logits.dtype, torch.float32)),
                         dim=-1)
    nll = -logp.gather(-1, seg_target.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


class MethodBase(nn.Module):
    model_type = ModelType.ABSTRACT
    #: whether ``embed`` keeps the backbone's ``[c, h, w]`` maps (local-
    #: descriptor heads) instead of flattening them
    needs_feature_map = False
    #: audited to compute over several ranks what it computes over one: its
    #: loss is a mean over equally sharded episodes (or flat rows), and each
    #: reduction over that axis (the backbone's and the head's BatchNorm
    #: moments, DSN's sum over episodes, LEO's inner mean over the support
    #: rows, LEO's and VERSA's draws, DMatchingNet's running statistics,
    #: ``ood_topk``, the calibration quantiles, S2M2's mixup partners) is
    #: taken over all ranks.  Every registered method is; ``Trainer`` and
    #: ``Test`` refuse any other method at a world larger than one
    shardable = False

    def __init__(self, emb_func: nn.Module, **kwargs):
        # kwargs: the episode geometry every classifier receives (way_num,
        # shot_num, query_num); this slice's heads take it from the setting
        super().__init__()
        self.emb_func = emb_func

    @staticmethod
    def _flatten_inputs(batch: EpisodeBatch) -> torch.Tensor:
        seg = batch.segment_shape
        return torch.cat(
            [batch.support.reshape((-1,) + seg), batch.query.reshape((-1,) + seg)],
            dim=0,
        )

    def embed(self, batch: EpisodeBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Support and query through ONE backbone call (as the reference runs
        the whole flat batch through ``emb_func``).  Returns
        (support_feat [E, W*S, D], query_feat [E, G, D]), or with
        ``needs_feature_map`` ([E, W*S, c, h, w], [E, G, c, h, w])."""
        e = batch.num_episodes
        ws = batch.support.shape[1]
        g = batch.query.shape[1]
        # the batch statistics span every rank's episodes
        with sharded_rows(), span("afs.backbone"):
            feats = self.emb_func(self._flatten_inputs(batch))
        if not self.needs_feature_map:
            feats = feats.reshape(feats.shape[0], -1)
        tail = feats.shape[1:]
        return feats[: e * ws].reshape((e, ws) + tail), feats[e * ws :].reshape((e, g) + tail)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        """Training loss (the module in train mode) and its ``LossOutput``."""
        raise NotImplementedError

    @torch.no_grad()
    def train_metrics(self, seg_logits: torch.Tensor, batch: EpisodeBatch) -> Dict[str, torch.Tensor]:
        return {"acc": segment_accuracy(seg_logits, segment_targets(batch), batch.query_mask)}

    def eval_episode_accuracy(self, seg_logits: torch.Tensor, batch: EpisodeBatch) -> torch.Tensor:
        """Per-episode clip-level majority-vote accuracy ``[E]`` in percent."""
        with span("afs.vote"):
            preds = majority_vote(
                seg_logits, batch.query_clip, batch.query_mask, batch.num_query_clips
            )
            return (preds == batch.query_target).float().mean(dim=-1) * 100.0
