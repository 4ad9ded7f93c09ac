"""MCL: Mutual Centralized Learning by bipartite Katz random walks
(counterpart of ``audio_fewshot_tpu/models/heads/mcl.py``).

The cosine similarity between query local descriptors and class-averaged
support maps forms a bipartite graph with row-softmax transition matrices in
both directions; the Katz centrality ``((I − αT)⁻¹ − I)·1`` of the support
nodes, summed per class, is the prediction.  One batched ``torch.linalg.solve``
over the ``[E, G]`` systems of size way·hw + hw, in float32.
``katz_query_mask`` (the query nodes' centrality) serves R2D2MCL.
"""

from __future__ import annotations

import torch

from ...registry import CLASSIFIERS
from .local_metrics import LocalDescriptorMethod, l2_normalize


def bipartite_similarity(query_feat: torch.Tensor, support_feat: torch.Tensor, way: int,
                         shot: int) -> torch.Tensor:
    """Cosine similarity of query local descriptors to class-averaged support
    maps: query ``[E, G, c, h, w]``, support ``[E, W*S, c, h, w]`` → S
    ``[E, G, hw, way·hw]``."""
    e, g, c, h, w = query_feat.shape
    hw = h * w
    sup = l2_normalize(support_feat.reshape(e, way, shot, c, hw).mean(dim=2), 2)  # [E, way, c, hw]
    qry = l2_normalize(query_feat.reshape(e, g, c, hw), 2)
    return torch.einsum("egcx,ewcy->egxwy", qry, sup).reshape(e, g, hw, way * hw)


def katz_vector(s_mat: torch.Tensor, katz_factor: float, gamma: float,
                gamma2: float) -> torch.Tensor:
    """Katz centrality ``((I − αT)⁻¹ − I)·1`` of the bipartite graph of
    ``s_mat [..., M_q, M_s]`` → ``[..., M_s + M_q]`` (support nodes first)."""
    m_q, m_s = s_mat.shape[-2], s_mat.shape[-1]
    lead = s_mat.shape[:-2]
    t_sq = torch.softmax(gamma * s_mat, dim=-1)  # rows over the support nodes
    t_qs = torch.softmax(gamma2 * s_mat.transpose(-1, -2), dim=-1)
    n = m_s + m_q
    zeros = dict(dtype=s_mat.dtype, device=s_mat.device)
    top = torch.cat([torch.zeros(lead + (m_s, m_s), **zeros), t_sq.transpose(-1, -2)], dim=-1)
    bottom = torch.cat([t_qs.transpose(-1, -2), torch.zeros(lead + (m_q, m_q), **zeros)], dim=-1)
    t_full = torch.cat([top, bottom], dim=-2)  # [..., n, n]
    eye = torch.eye(n, **zeros)
    ones = torch.ones(lead + (n, 1), **zeros)
    return torch.linalg.solve(eye - katz_factor * t_full, ones)[..., 0] - 1.0


def mcl_logits(query_feat: torch.Tensor, support_feat: torch.Tensor, way: int, shot: int,
               katz_factor: float = 0.5, gamma: float = 20.0,
               gamma2: float = 10.0) -> torch.Tensor:
    """``[E, G, way]`` probabilities: the Katz mass of each class's support
    nodes, normalised over the support nodes."""
    hw = query_feat.shape[-2] * query_feat.shape[-1]
    s_mat = bipartite_similarity(query_feat, support_feat, way, shot)
    sup_katz = katz_vector(s_mat, katz_factor, gamma, gamma2)[..., : way * hw]
    sup_katz = sup_katz / sup_katz.sum(dim=-1, keepdim=True).clamp(min=1e-12)
    e, g = s_mat.shape[:2]
    return sup_katz.reshape(e, g, way, hw).sum(dim=-1)


def katz_query_mask(query_feat: torch.Tensor, support_feat: torch.Tensor, way: int, shot: int,
                    katz_factor: float, gamma: float, gamma2: float) -> torch.Tensor:
    """The query nodes' Katz centrality, normalised to sum 1 over each
    query's positions: ``[E, G, h·w]`` weights (R2D2MCL's query pooling)."""
    hw = query_feat.shape[-2] * query_feat.shape[-1]
    s_mat = bipartite_similarity(query_feat, support_feat, way, shot)
    q_katz = katz_vector(s_mat, katz_factor, gamma, gamma2)[..., way * hw:]
    return q_katz / q_katz.sum(dim=-1, keepdim=True).clamp(min=1e-12)


@CLASSIFIERS.register("MCL")
class MCL(LocalDescriptorMethod):
    """Logits are the log of ``mcl_logits``' probabilities (the reference
    trains NLL over their log).  ``n_k`` is accepted for the configs and not
    read, as in the JAX package."""

    def __init__(self, emb_func, n_k: int = 1, katz_factor: float = 0.5,
                 gamma: float = 20.0, gamma2: float = 10.0, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.katz_factor = katz_factor
        self.gamma = gamma
        self.gamma2 = gamma2

    def _logits(self, batch, setting):
        sup, qry = self.embed(batch)
        probs = mcl_logits(qry, sup, setting.way, setting.shot, self.katz_factor,
                           self.gamma, self.gamma2)
        return torch.log(probs.clamp(min=1e-12))
