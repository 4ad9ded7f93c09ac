"""Clip-level aggregation of per-segment logits (counterpart of
``audio_fewshot_tpu/utils/aggregate.py``).

A ragged clip is a clip-id vector plus a mask, so aggregation is a one-hot
contraction.  Ties in a majority vote go to the smallest class: the vote
counts are exact small integers and ``torch.argmax`` returns the first
maximum, as ``torch.mode`` in the reference and ``jnp.argmax`` do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def clip_scatter_matrix(clip_id: torch.Tensor, mask: torch.Tensor, num_clips: int) -> torch.Tensor:
    """One-hot segment→clip scatter matrix ``[..., G, Wq]`` (masked)."""
    onehot = F.one_hot(clip_id.long(), num_clips).float()
    return onehot * mask.float()[..., None]


def clip_vote_counts(
    seg_logits: torch.Tensor, clip_id: torch.Tensor, mask: torch.Tensor, num_clips: int
) -> torch.Tensor:
    """Per-clip vote counts ``[..., Wq, W]``: each valid segment votes its
    argmax class."""
    way = seg_logits.shape[-1]
    pred_onehot = F.one_hot(seg_logits.argmax(dim=-1), way).float()
    scatter = clip_scatter_matrix(clip_id, mask, num_clips)
    return torch.einsum("...gc,...gw->...cw", scatter, pred_onehot)


def majority_vote(
    seg_logits: torch.Tensor, clip_id: torch.Tensor, mask: torch.Tensor, num_clips: int
) -> torch.Tensor:
    """``[..., Wq]`` clip predictions: the mode of per-segment argmaxes."""
    return clip_vote_counts(seg_logits, clip_id, mask, num_clips).argmax(dim=-1)


def average_logits(
    seg_logits: torch.Tensor, clip_id: torch.Tensor, mask: torch.Tensor, num_clips: int
) -> torch.Tensor:
    """Per-clip mean of segment logits ``[..., Wq, W]`` (zero for empty clips)."""
    scatter = clip_scatter_matrix(clip_id, mask, num_clips)
    sums = torch.einsum("...gc,...gw->...cw", scatter, seg_logits.float())
    counts = scatter.sum(dim=-2)[..., None]
    return torch.where(counts > 0, sums / counts.clamp(min=1.0), torch.zeros_like(sums))


def segment_accuracy(seg_logits: torch.Tensor, seg_target: torch.Tensor, mask=None) -> torch.Tensor:
    """Top-1 per-segment accuracy in percent (masked segments left out)."""
    correct = (seg_logits.argmax(dim=-1) == seg_target).float()
    if mask is None:
        return correct.mean() * 100.0
    mask = mask.float()
    return (correct * mask).sum() / mask.sum().clamp(min=1.0) * 100.0


def mean_confidence_interval(values, confidence: float = 0.95):
    """95 % t-interval over per-episode accuracies.  Returns (mean, half-width)."""
    from scipy import stats

    a = np.asarray(values, dtype=np.float64)
    n = a.size
    if n <= 1:
        return float(a.mean()) if n else 0.0, 0.0
    se = a.std(ddof=1) / np.sqrt(n)
    return float(a.mean()), float(se * stats.t.ppf((1 + confidence) / 2.0, n - 1))
