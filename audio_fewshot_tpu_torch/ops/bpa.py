"""BPA: the Balanced Pairwise Affinities feature transform (counterpart of
``audio_fewshot_tpu/ops/bpa.py``).

Self-optimal transport over the pairwise distance matrix of a feature set:
a log-space Sinkhorn of a fixed 10 iterations (the reference stops early at
a threshold; a fixed count gives the JAX package's result), diagonal masking,
optional clamping of known-label pairs; the transport plan's rows become the
new features.  Batched over the leading axes, in the input's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

DIAG_VAL = 1e5


def log_sinkhorn(cost: torch.Tensor, reg: float = 0.1, num_iters: int = 10,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Log-space Sinkhorn over ``[..., n, n]`` costs; returns the log
    transport plan.  ``mask`` (``[..., n]``, 1 = real row): padded rows get
    (almost) no marginal mass, so they carry no transport."""
    n = cost.shape[-1]
    if mask is None:
        log_mu = torch.log(torch.full(cost.shape[:-1], 1.0 / n, dtype=cost.dtype,
                                      device=cost.device) + 1e-8)
    else:
        mask = mask.to(cost.dtype)
        log_mu = torch.log(mask / mask.sum(dim=-1, keepdim=True).clamp(min=1.0) + 1e-8)
    log_nu = log_mu

    def modified_cost(u, v):
        return (-cost + u[..., :, None] + v[..., None, :]) / reg

    u = torch.zeros(cost.shape[:-1], dtype=cost.dtype, device=cost.device)
    v = torch.zeros_like(u)
    for _ in range(num_iters):
        u = reg * (log_mu - torch.logsumexp(modified_cost(u, v), dim=-1)) + u
        v = reg * (log_nu - torch.logsumexp(modified_cost(u, v), dim=-2)) + v
    return modified_cost(u, v)


def bpa_transform(x: torch.Tensor, labels: Optional[torch.Tensor] = None, n_labeled: int = 0,
                  num_classes: int = 0, distance: str = "cosine", ot_reg: float = 0.1,
                  sinkhorn_iterations: int = 10, mask_diag: bool = True, max_scale: bool = True,
                  row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BPA features of ``[..., n, d]`` sets → ``[..., n, n]`` affinities.

    ``labels`` / ``n_labeled``: the known labels of the first ``n_labeled``
    rows (the support set) clamp their pairwise affinities to exactly 0 or 1.
    ``row_mask`` (``[..., n]``, 1 = real row) keeps padded rows out of the
    transport marginals, so the affinities of real rows do not depend on
    the padding."""
    n = x.shape[-2]
    if distance == "euclidean":
        d2 = ((x[..., :, None, :] - x[..., None, :, :]) ** 2).sum(dim=-1)
        cost = torch.sqrt(d2.clamp(min=1e-12))
        cost = cost / cost.amax(dim=(-2, -1), keepdim=True)
    else:
        xn = F.normalize(x, dim=-1, eps=1e-12)
        cost = 1.0 - torch.matmul(xn, xn.transpose(-1, -2))
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    if mask_diag:
        cost = cost.masked_fill(eye, DIAG_VAL)
    p = torch.exp(log_sinkhorn(cost, reg=ot_reg, num_iters=sinkhorn_iterations, mask=row_mask))
    if max_scale:
        p = p / p.amax(dim=(-2, -1), keepdim=True)
    if labels is not None and n_labeled > 0:
        onehot = F.one_hot(labels.long(), num_classes).to(p.dtype)
        same = torch.matmul(onehot, onehot.transpose(-1, -2)) > 0
        idx = torch.arange(n, device=x.device)
        known = (idx[:, None] < n_labeled) & (idx[None, :] < n_labeled)
        p = torch.where(known & same, torch.ones_like(p), p)
        p = torch.where(known & ~same, torch.zeros_like(p), p)
    if mask_diag:
        p = p.masked_fill(eye, 1.0)
    return p
