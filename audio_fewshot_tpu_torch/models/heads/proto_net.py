"""Prototype helpers (counterpart of ``prototypes`` / ``neg_sq_euclidean`` in
``audio_fewshot_tpu/models/heads/proto_net.py``), in float32."""

from __future__ import annotations

import torch


def neg_sq_euclidean(query_feat: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    """−‖q − p‖² ``[E, G, way]`` via 2q·p − ‖q‖² − ‖p‖²: one product instead
    of the ``[E, G, way, D]`` difference tensor."""
    query_feat, proto = query_feat.float(), proto.float()
    qp = torch.matmul(query_feat, proto.transpose(-1, -2))
    q2 = (query_feat * query_feat).sum(dim=-1)[..., None]
    p2 = (proto * proto).sum(dim=-1)[:, None, :]
    return 2.0 * qp - q2 - p2


def prototypes(support_feat: torch.Tensor, way: int, shot: int) -> torch.Tensor:
    """Class-mean prototypes ``[E, way, D]`` from way-major ``[E, way*shot, D]``."""
    e, _, d = support_feat.shape
    return support_feat.reshape(e, way, shot, d).mean(dim=2)
