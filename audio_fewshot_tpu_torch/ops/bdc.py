"""Brownian Distance Covariance pooling (DeepBDC) in plain PyTorch.

Counterpart of ``audio_fewshot_tpu/ops/bdc.py``: one batched gram product
plus an elementwise/reduction epilogue.  This is the plain version of the
CUDA kernel in ``ops/bdc_cuda.py``: the CPU runs it, and the card compares
the kernel against it.  ``bdc_pool_triu_vjp`` is the plain version of the
backward kernel: autograd through ``bdc_pool`` and ``triuvec``;
``bdc_pool_triu_vjp_direct`` repeats the backward kernel's own arithmetic.
"""

from __future__ import annotations

from typing import Tuple

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


def bdc_pool_triu_vjp(x: torch.Tensor, log_t: torch.Tensor,
                      grad_triu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``sum(grad_triu * triuvec(bdc_pool(x, log_t)))`` by x and
    by ``log_t``, by autograd through the plain version (in x's dtype, so a
    float64 x gives the float64 truth)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        lg = log_t.detach().to(x.dtype).requires_grad_(True)
        gram = torch.matmul(xg, xg.transpose(-1, -2))
        tri = triuvec(bdc_from_gram(gram, lg))
        grad_x, grad_log_t = torch.autograd.grad(tri, (xg, lg), grad_triu.to(x.dtype))
    return grad_x, grad_log_t.to(log_t.dtype)


def bdc_pool_triu_vjp_direct(x: torch.Tensor, log_t: torch.Tensor,
                             grad_triu: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``bdc_pool_triu_vjp`` by the arithmetic of the
    backward kernel (``csrc/bdc_pool_backward.cu``): squared distances
    summed from the differences of rows (not from the gram), the symmetric
    part of the centred incoming gradient, and x̄_i = 2 Σ_j S_ij (x_i − x_j).
    It bounds the kernel's error without a card; nothing on the main path
    calls it."""
    b, d, _ = x.shape
    t = torch.exp(log_t.to(x.dtype).reshape(()))
    full = torch.zeros((b, d * d), dtype=x.dtype, device=x.device)
    full[:, torch.from_numpy(triu_indices_flat(d)).to(x.device)] = grad_triu.to(x.dtype)
    full = full.reshape(b, d, d)
    ysym = full + full.transpose(-1, -2)
    rows = ysym.sum(dim=-1)
    dsym = (ysym - (rows[:, :, None] + rows[:, None, :]) / d
            + (rows.sum(dim=-1) / d ** 2)[:, None, None])
    grad_x = torch.empty_like(x)
    grad_t = torch.zeros((), dtype=x.dtype, device=x.device)
    for i in range(b):  # one element at a time: the differences are [d, d, M]
        diff = x[i, :, None, :] - x[i, None, :, :]
        dist2 = (diff * diff).sum(dim=-1)
        s = torch.where(dist2 > 0, dsym[i] * t / (2.0 * torch.sqrt(t * dist2 + 1e-5)),
                        torch.zeros_like(dist2))
        grad_x[i] = 2.0 * (s[:, :, None] * diff).sum(dim=1)
        grad_t = grad_t + 0.5 * (s * dist2).sum()
    return grad_x, grad_t.reshape(log_t.shape).to(log_t.dtype)


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
