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
