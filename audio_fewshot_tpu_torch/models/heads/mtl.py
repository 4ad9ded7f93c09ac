"""MTL, meta-transfer learning's head-only inner loop (counterpart of
``audio_fewshot_tpu/models/heads/mtl.py``).

A ``Linear(feat_dim → way)`` base learner over the backbone's flat
features (the plain resnet12's 12800, flattened NHWC), adapted per episode
by ``iter`` plain SGD steps at ``lr`` on the support cross-entropy (100 and
0.01 as shipped, in training and in eval), then applied to the queries.
The backbone runs once per batch in the module's own mode (``embed``); the
episodes adapt together, each its own ``[E, way, D]`` copy of the weights
(``maml.adapt_linear_head``, as ANIL's), second order in training.
``num_classes`` is accepted and unused, as in the JAX package.

The weights are the reference's ``base_learner.fc1_w`` ``[way, D]`` and
``base_learner.fc1_b`` (its ``vars.{0,1}`` are aliases of the same
tensors), drawn as flax's ``Dense`` (lecun_normal kernel, zero bias).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from ..init import lecun_normal_
from .maml import adapt_linear_head, linear_logits


class MTLBaseLearner(nn.Module):
    def __init__(self, feat_dim: int, way: int):
        super().__init__()
        self.fc1_w = nn.Parameter(torch.empty(way, feat_dim))
        self.fc1_b = nn.Parameter(torch.zeros(way))
        lecun_normal_(self.fc1_w)


@CLASSIFIERS.register("MTL")
class MTL(MethodBase):
    model_type = ModelType.META
    shardable = True
    #: ``build_method`` passes the backbone's flat feature width as ``feat_dim``
    needs_feat_dim = True

    def __init__(self, emb_func, feat_dim: int, inner_param: Optional[Dict] = None,
                 num_classes: int = 64, way_num: int = 5, **kwargs):
        super().__init__(emb_func, **kwargs)
        p = dict(inner_param or {})
        self.inner_iter = int(p.get("iter", 100))
        self.inner_lr = float(p.get("lr", 0.01))
        self.base_learner = MTLBaseLearner(feat_dim, way_num)

    def _run(self, batch: EpisodeBatch, setting: EpisodeSetting, n_steps: int,
             second_order: bool = True) -> torch.Tensor:
        sup_f, qry_f = self.embed(batch)
        w, b = adapt_linear_head(self.base_learner.fc1_w, self.base_learner.fc1_b, sup_f,
                                 batch.support_target, n_steps, self.inner_lr, second_order)
        return linear_logits(qry_f, w, b)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        return self._run(batch, setting, self.inner_iter)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        seg_logits = self._run(batch, setting, self.inner_iter)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
