"""DN4: local-descriptor k-nearest-neighbour matching (counterpart of
``audio_fewshot_tpu/models/heads/dn4.py``): normalise the local
descriptors, take each query position's cosine similarity to all
``shot·h·w`` descriptors of a class, and sum the top ``n_k``.  One batched
product over the episode axis and a ``topk`` over the last axis, in
float32; the summed top-k values do not depend on the order of ties."""

from __future__ import annotations

import torch

from ...registry import CLASSIFIERS
from .local_metrics import LocalDescriptorMethod, l2_normalize


def dn4_logits(query_feat: torch.Tensor, support_feat: torch.Tensor, way: int, shot: int,
               n_k: int) -> torch.Tensor:
    """``query_feat [E, G, c, h, w]``, ``support_feat [E, W*S, c, h, w]`` →
    ``[E, G, way]``."""
    e, g, c, h, w = query_feat.shape
    hw = h * w
    q = l2_normalize(query_feat.reshape(e, g, c, hw).transpose(-1, -2), -1)  # [E, G, hw, c]
    s = support_feat.reshape(e, way, shot, c, hw).permute(0, 1, 3, 2, 4)
    s = l2_normalize(s.reshape(e, way, c, shot * hw), 2)
    rel = torch.einsum("egxc,ewcy->egwxy", q, s)  # [E, G, way, hw, s·hw]
    return rel.topk(n_k, dim=-1).values.sum(dim=(-2, -1))


@CLASSIFIERS.register("DN4")
class DN4(LocalDescriptorMethod):
    def __init__(self, emb_func, n_k: int = 3, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.n_k = n_k

    def _logits(self, batch, setting):
        sup, qry = self.embed(batch)
        return dn4_logits(qry, sup, setting.way, setting.shot, self.n_k)
