"""Brownian Distance Covariance pooling (DeepBDC) in plain PyTorch.

Counterpart of ``audio_fewshot_tpu/ops/bdc.py``: one batched gram product
plus an elementwise/reduction epilogue.  This is the plain version of the
CUDA kernel in ``ops/bdc_cuda.py``: the CPU runs it, and the card compares
the kernel against it.
"""

from __future__ import annotations

import numpy as np
import torch


def bdc_pool(x: torch.Tensor, log_t: torch.Tensor) -> torch.Tensor:
    """``[B, d, M]`` feature maps → ``[B, d, d]`` double-centred BDC matrices
    (float32).  ``log_t`` is the scalar log-temperature."""
    x = x.float()
    # full fp32: the gram feeds a sqrt of differences of near-identical
    # values, so TF32 rounding would put visible noise on the zero diagonal
    gram = torch.matmul(x, x.transpose(-1, -2))
    # the diagonal comes from the gram itself: a separate sum(x * x) rounds
    # differently and diverges by ~1e-3 through the sqrt cancellation
    diag = torch.diagonal(gram, dim1=-2, dim2=-1)
    dist2 = torch.clamp(diag[..., :, None] + diag[..., None, :] - 2.0 * gram, min=0.0)
    dcov = torch.sqrt(torch.exp(log_t.float().reshape(())) * dist2 + 1e-5)
    row = dcov.mean(dim=-1, keepdim=True)
    col = dcov.mean(dim=-2, keepdim=True)
    grand = dcov.mean(dim=(-2, -1), keepdim=True)
    return dcov - row - col + grand


def triu_indices_flat(d: int) -> np.ndarray:
    """Flattened upper-triangular (diagonal included) indices of a d×d
    matrix, row-major — the ``np.triu_indices`` order."""
    iu = np.triu_indices(d)
    return (iu[0] * d + iu[1]).astype(np.int64)


def triuvec(mat: torch.Tensor) -> torch.Tensor:
    """``[..., d, d]`` → ``[..., d(d+1)/2]`` upper-triangular vector."""
    d = mat.shape[-1]
    flat = mat.reshape(mat.shape[:-2] + (d * d,))
    idx = torch.from_numpy(triu_indices_flat(d)).to(mat.device)
    return flat.index_select(-1, idx)
