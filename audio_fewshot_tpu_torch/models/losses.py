"""Shared loss functions (the port's copy of what it needs of
``audio_fewshot_tpu/models/losses.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of ``logits [..., C]`` at integer ``targets [...]``,
    in float32 at least (float64 logits keep float64)."""
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    return -logp.gather(-1, targets.long()[..., None]).mean()


def l2_dist_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the Euclidean norm of each row's difference,
    ``mean(sqrt(sum_dim1 (pred - target)²))``; 0 where that is NaN."""
    d = pred - target
    loss = torch.sqrt((d * d).sum(dim=1)).mean()
    return torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)


def label_smooth_ce(logits: torch.Tensor, targets: torch.Tensor,
                    smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed cross-entropy: the mean over the batch of −Σ soft ·
    log-softmax, soft = onehot · (1 − ``smoothing``) + ``smoothing`` / C."""
    n = logits.shape[-1]
    logp = F.log_softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    soft = F.one_hot(targets.long(), n).to(logp.dtype) * (1.0 - smoothing) + smoothing / n
    return -(soft * logp).sum(dim=-1).mean()


def distill_kl_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
                    temperature: float = 4.0) -> torch.Tensor:
    """KL(teacher ∥ student) at temperature T, times T² (Hinton
    distillation); the teacher's probabilities clamped at 1e-12 in the
    log."""
    t = temperature
    log_s = F.log_softmax(student_logits / t, dim=-1)
    p_t = F.softmax(teacher_logits / t, dim=-1)
    return (p_t * (torch.log(p_t.clamp(min=1e-12)) - log_s)).sum(dim=-1).mean() * (t * t)
