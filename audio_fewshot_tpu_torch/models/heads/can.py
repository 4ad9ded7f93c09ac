"""CAN, cross-attention networks (counterpart of
``audio_fewshot_tpu/models/heads/can.py``).

Class prototypes (the mean of their shots' ``[c, hw]`` maps) and query maps
attend to each other through ``CAM``: the position-wise cosine correlation
``[E, way, G, hw, hw]``, averaged over each side's own positions, squeezed
through a 1×1-conv bottleneck (``mid`` wide, BN, ReLU) and expanded back,
weighs the partner positions; ``softmax(·/0.025) + 1`` over the own
positions is the attention.  Eval logits are ``scale_cls`` × the cosine of
the pooled attended prototype and query.  The train loss is 0.5 × the
per-position metric cross-entropy (each attended query position against the
pooled prototypes) plus the per-position cross-entropy of a 1×1-conv
classifier over ``num_classes`` global classes on the true class's attended
map (``global_target``).

``mid`` is the config's ``HW`` where the map has HW² positions (the
reference's square image maps), else round(√hw): 8 for the 8×9 map of a
``[1, 128, 157]`` segment.  torch infers no shapes, so hw and c come from
``map_shape``.  Parameters carry the reference names
(``cam_layer.cam.conv1.conv`` / ``conv1.bn`` / ``conv2``,
``cam_layer.classifier``), the 1×1 convolutions computed as products.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...parallel.collectives import sharded_rows
from ...registry import CLASSIFIERS
from ..backbones.layers import BatchNorm1d
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType
from ..init import lecun_normal_
from .local_metrics import l2_normalize


def _conv1x1(cin: int, cout: int) -> nn.Conv2d:
    """A 1×1 conv used as a product, drawn as flax's ``Dense`` (lecun_normal
    kernel, zero bias)."""
    conv = nn.Conv2d(cin, cout, 1)
    lecun_normal_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


def _apply1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` on the last axis of ``x``."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class ConvBlock(nn.Module):
    """The bottleneck's first 1×1 conv and its BN (flax's batch norm: biased
    variance, one update a train step)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _conv1x1(cin, cout)
        self.bn = BatchNorm1d(cout)


class CAM(nn.Module):
    def __init__(self, hw: int, mid: int):
        super().__init__()
        self.conv1 = ConvBlock(hw, mid)
        self.conv2 = _conv1x1(mid, hw)

    def forward(self, corr: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        """corr ``[..., n1, n2, M_own, M_partner]`` → the attention over the
        own positions ``[..., n1, n2, M_own]``.  In train mode the BN uses
        the batch statistics over every leading axis (over every rank's
        episodes); ``update_stats=False`` leaves its running statistics
        alone."""
        a = corr.mean(dim=-2)
        z = _apply1x1(self.conv1.conv, a)
        bn = self.conv1.bn
        flat = z.reshape(-1, z.shape[-1])
        with sharded_rows():  # the rows of every rank's episodes
            flat = bn.batch_normalize(flat) if bn.training and not update_stats else bn(flat)
        z = _apply1x1(self.conv2, F.relu(flat.reshape(z.shape)))
        att = (corr * z[..., None, :]).mean(dim=-1)
        return torch.softmax(att / 0.025, dim=-1) + 1.0


class CAMLayer(nn.Module):
    def __init__(self, c: int, hw: int, mid: int, num_classes: int):
        super().__init__()
        self.cam = CAM(hw, mid)
        self.classifier = _conv1x1(c, num_classes)


@CLASSIFIERS.register("CAN")
class CAN(MethodBase):
    """``iter_num_prob`` (the reference's disabled transductive stage) and
    ``nFeat`` are accepted for the configs and not read, as in the JAX
    package; ``map_shape`` (from ``build_method``) gives c and hw."""

    model_type = ModelType.METRIC
    needs_feature_map = True
    needs_map_shape = True
    shardable = True

    def __init__(self, emb_func, map_shape: Sequence[int], scale_cls: float = 7.0,
                 iter_num_prob: float = 35.0 / 75, num_classes: int = 25, nFeat: int = 640,
                 HW: int = 5, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.scale_cls = scale_cls
        self.num_classes = num_classes
        c, h, w = (int(n) for n in map_shape)
        hw = h * w
        mid = int(HW) if hw == int(HW) ** 2 else max(1, int(round(hw ** 0.5)))
        self.cam_layer = CAMLayer(c, hw, mid, num_classes)

    def _attended(self, sup: torch.Tensor, qry: torch.Tensor, way: int, shot: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The pooled attended prototypes ``[E, G, way, c]``, the query maps
        ``[E, G, c, hw]`` and their attention ``[E, way, G, hw]``.  In train
        mode the CAM's BN runs twice (prototype side, then query side) and
        its running statistics keep the second call's update, as the JAX
        package's merge of the two calls' updates does."""
        e, _, c, h, w = sup.shape
        g, hw = qry.shape[1], h * w
        proto = sup.float().reshape(e, way, shot, c, hw).mean(dim=2)  # [E, way, c, hw]
        q = qry.float().reshape(e, g, c, hw)
        corr = torch.einsum("ewcx,egcy->ewgxy", l2_normalize(proto, 2), l2_normalize(q, 2))
        a_p = self.cam_layer.cam(corr, update_stats=False)
        a_q = self.cam_layer.cam(corr.transpose(-1, -2))
        proto_att = torch.einsum("ewcx,ewgx->egwc", proto, a_p) / hw
        return proto_att, q, a_q

    def _sims(self, proto_att: torch.Tensor, qry_att: torch.Tensor) -> torch.Tensor:
        return self.scale_cls * (l2_normalize(proto_att, -1) * l2_normalize(qry_att, -1)).sum(-1)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        proto_att, q, a_q = self._attended(sup, qry, setting.way, setting.shot)
        # the attended query maps pooled over their positions, without the
        # [E, G, way, c, hw] maps
        qry_att = torch.einsum("egcy,ewgy->egwc", q, a_q) / q.shape[-1]
        return self._sims(proto_att, qry_att)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        sup, qry = self.embed(batch)
        proto_att, q, a_q = self._attended(sup, qry, setting.way, setting.shot)
        qry_maps = torch.einsum("egcy,ewgy->egwcy", q, a_q)  # [E, G, way, c, hw]
        targets = segment_targets(batch)
        mask = batch.query_mask.float()
        denom = mask.sum().clamp(min=1.0)

        # the per-position metric cross-entropy
        pos_scores = self.scale_cls * torch.einsum(
            "egwcy,egwc->egwy", l2_normalize(qry_maps, 3), l2_normalize(proto_att, -1))
        logp = F.log_softmax(pos_scores, dim=2)
        picked = logp.gather(2, targets[:, :, None, None].expand(-1, -1, 1, logp.shape[-1]))
        metric_loss = -(picked[:, :, 0].mean(dim=-1) * mask).sum() / denom
        seg_logits = pos_scores.sum(dim=-1)
        loss = 0.5 * metric_loss

        if batch.global_target is not None:
            # the per-position global cross-entropy on the true class's map
            e, g, way, c, hw = qry_maps.shape
            true_maps = qry_maps.gather(2, targets[:, :, None, None, None].expand(
                -1, -1, 1, c, hw))[:, :, 0]  # [E, G, c, hw]
            glogits = _apply1x1(self.cam_layer.classifier, true_maps.transpose(-1, -2))
            g_qry = batch.global_target[:, sup.shape[1]:]
            if tuple(glogits.shape[:2]) != tuple(g_qry.shape):
                raise ValueError(
                    f"CAN global cross-entropy: attended logits {tuple(glogits.shape[:2])} "
                    f"against query global targets {tuple(g_qry.shape)} (global_target must "
                    "be [support ‖ query] along axis 1)")
            glogp = F.log_softmax(glogits, dim=-1)
            gpicked = glogp.gather(-1, g_qry.long()[:, :, None, None].expand(-1, -1, hw, 1))
            loss = loss - (gpicked[..., 0].mean(dim=-1) * mask).sum() / denom
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
