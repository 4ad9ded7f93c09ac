"""Brownian Distance Covariance pooling (DeepBDC) in plain PyTorch.

Counterpart of ``audio_fewshot_tpu/ops/bdc.py``: one batched gram product
plus an elementwise/reduction epilogue.  This is the plain version of the
CUDA kernel in ``ops/bdc_cuda.py``: the CPU runs it, and the card compares
the kernel against it.
"""

from __future__ import annotations

import numpy as np
import torch


def bdc_from_gram(gram: torch.Tensor, log_t: torch.Tensor) -> torch.Tensor:
    """``[..., d, d]`` gram matrices ``x xᵀ`` → double-centred BDC matrices,
    in the gram's dtype (float64 grams give the float64 truth)."""
    # the diagonal comes from the gram itself: a separate sum(x * x) rounds
    # differently and diverges by ~1e-3 through the sqrt cancellation
    diag = torch.diagonal(gram, dim1=-2, dim2=-1)
    dist2 = torch.clamp(diag[..., :, None] + diag[..., None, :] - 2.0 * gram, min=0.0)
    dcov = torch.sqrt(torch.exp(log_t.to(gram.dtype).reshape(())) * dist2 + 1e-5)
    row = dcov.mean(dim=-1, keepdim=True)
    col = dcov.mean(dim=-2, keepdim=True)
    grand = dcov.mean(dim=(-2, -1), keepdim=True)
    return dcov - row - col + grand


def bdc_pool(x: torch.Tensor, log_t: torch.Tensor) -> torch.Tensor:
    """``[B, d, M]`` feature maps → ``[B, d, d]`` double-centred BDC matrices
    (float32).  ``log_t`` is the scalar log-temperature."""
    x = x.float()
    # full fp32: the gram feeds a sqrt of differences of near-identical
    # values, so TF32 rounding would put visible noise on the zero diagonal
    return bdc_from_gram(torch.matmul(x, x.transpose(-1, -2)), log_t)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → the nearest TF32 value (10 mantissa bits, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds), by integer arithmetic on the
    bits.  Finite inputs only."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32 by dropping the 13 low mantissa bits, as the tensor
    core reads a float32 register it is given as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def gram_split_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x xᵀ`` by the arithmetic of the CUDA kernel: ``hi = tf32(x)``
    rounded to nearest, ``lo = x − hi`` truncated to TF32, and
    ``hi·hiᵀ + (hi·loᵀ + lo·hiᵀ)`` with float32 sums.  It bounds the error of
    the kernel's design without a card; nothing on the main path calls it."""
    x = x.float()
    hi = round_tf32(x)
    lo = truncate_tf32(x - hi)
    hi_t = hi.transpose(-1, -2)
    small = torch.matmul(hi, lo.transpose(-1, -2)) + torch.matmul(lo, hi_t)
    return torch.matmul(hi, hi_t) + small


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
