"""CPEANet, Class-token Patch-Embedding Adaptation (counterpart of
``audio_fewshot_tpu/models/heads/cpea.py``), over the class-aware ViT's
token sequences ``[N, 1 + L, C]``.

``CPEALayer``: a shared MLP ``C → in_dim//4 → C`` (exact GELU) over each
segment's mean token, added back to every token; LayerNorm (eps 1e-5); the
patch tokens plus twice the cls token; L2-normalised (clamp 1e-12) and
centred over the channels.  The support is averaged per class (way-major),
then per (query, class) the ``[L, L]`` patch similarity is squared,
flattened to L² and scored by an MLP ``L² → 256 → 1``.  The reference
hard-codes fc2's input to 72²; here it is sized from the backbone's token
count (``map_shape``).  All in float32, batched over the episodes.  Keys are
the reference names ``CPEA.fc1.fc{1,2}``, ``CPEA.fc_norm1``,
``CPEA.fc2.fc{1,2}``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from ..init import lecun_normal_


class Mlp(nn.Module):
    """``fc1`` → exact GELU → ``fc2``, drawn as flax's ``Dense`` (lecun_normal
    kernels, zero biases)."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out)
        for fc in (self.fc1, self.fc2):
            lecun_normal_(fc.weight)
            nn.init.zeros_(fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def _patch_embedding(tokens: torch.Tensor) -> torch.Tensor:
    """Patch tokens plus twice the cls token: ``[..., 1 + L, C]`` → ``[..., L, C]``."""
    return tokens[..., 1:, :] + 2.0 * tokens[..., :1, :]


def _normalise_centre(x: torch.Tensor) -> torch.Tensor:
    x = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return x - x.mean(dim=-1, keepdim=True)


class CPEALayer(nn.Module):
    def __init__(self, in_dim: int, tokens: int, channels: int):
        super().__init__()
        patches = tokens - 1
        self.fc1 = Mlp(channels, in_dim // 4, channels)
        self.fc_norm1 = nn.LayerNorm(channels, eps=1e-5)
        self.fc2 = Mlp(patches * patches, 256, 1)

    def forward(self, feat_query: torch.Tensor, feat_shot: torch.Tensor, way: int,
                shot: int) -> torch.Tensor:
        """``feat_query`` ``[E, G, 1 + L, C]``, ``feat_shot`` ``[E, way·shot,
        1 + L, C]`` → logits ``[E, G, way]``."""
        fq = self.fc_norm1(self.fc1(feat_query.mean(dim=2, keepdim=True)) + feat_query)
        fs = self.fc_norm1(self.fc1(feat_shot.mean(dim=2, keepdim=True)) + feat_shot)
        q = _normalise_centre(_patch_embedding(fq))  # [E, G, L, C]
        s = _patch_embedding(fs)
        e, _, l, c = s.shape
        s = _normalise_centre(s.reshape(e, way, shot, l, c).mean(dim=2))  # [E, way, L, C]
        sim = torch.einsum("ewlc,egmc->egwlm", s, q)  # [E, G, way, L, L]
        return self.fc2((sim * sim).flatten(-2))[..., 0]


@CLASSIFIERS.register("CPEANet")
class CPEANet(MethodBase):
    model_type = ModelType.METRIC
    shardable = True
    #: the backbone hands over token sequences [N, 1 + L, C]
    needs_feature_map = True
    needs_map_shape = True

    def __init__(self, emb_func, map_shape: Sequence[int], in_dim: int = 384, **kwargs):
        super().__init__(emb_func, **kwargs)
        tokens, channels = (int(n) for n in map_shape)
        self.CPEA = CPEALayer(in_dim, tokens, channels)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        return self.CPEA(qry.float(), sup.float(), setting.way, setting.shot)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        seg_logits = self(batch, setting)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))
