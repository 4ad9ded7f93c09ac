"""Fused BDC pool: wrapper of the hand-written CUDA kernel ``csrc/bdc_pool.cu``.

Replaces the Pallas TPU kernel ``audio_fewshot_tpu/ops/bdc_pallas.py``
(``_bdc_kernel`` / ``bdc_pool_fused``), followed by ``triuvec``.

Bound on an H100 SXM at d = 64, M = 304: the gram is symmetric and only its
upper triangle is written, so the function needs B·d(d+1)·M FLOPs and moves
x once in and the upper triangle once out; the bytes take longer (3.35 TB/s)
than the operations, so it is bound by memory traffic.  The kernel is built
around that stream: persistent blocks walk the batch, x arrives through a
ring of shared-memory stages filled by the TMA unit from a ``[B][d][M]``
tensor map with the 128-byte swizzle (by 4-byte ``cp.async`` when x is not
16-byte aligned, i.e. M not a multiple of 4), only the gram's upper 16×8
units are computed, on the tensor cores by a three-pass split-TF32
``mma.sync`` that keeps fp32 accuracy, and an epilogue with a warp per row
writes each triu row as one contiguous run.  ``ops/bdc.py::gram_split_tf32``
repeats that arithmetic in plain PyTorch;
``python -m audio_fewshot_tpu_torch.profile_bdc_pool`` shows where the
kernel's time goes.

The gradient is a kernel too, ``csrc/bdc_pool_backward.cu``, behind the
``torch.autograd.Function`` ``BdcPoolTriu``: ``bdc_pool_triu`` goes through
it whenever grad is enabled and an input requires grad.  Its forward is the
kernel above; its backward recomputes the gram in exact fp32 and writes the
gradients of x and of ``log_t`` (``bdc_pool_triu_backward``).

On a CPU tensor both wrappers run the plain version (``ops/bdc.py``, and
autograd through it); on a CUDA tensor they launch their kernel or raise.
``launches`` and ``backward_launches`` count the launches of each kernel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from .bdc import bdc_pool, bdc_pool_triu_vjp, triuvec
from .build import build_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "bdc_pool.cu"
BACKWARD_SOURCE = SOURCE.with_name("bdc_pool_backward.cu")
MAX_DIM = 128

#: number of forward kernel launches since the last reset (set to 0 to reset)
launches = 0
#: number of backward kernel launches since the last reset (set to 0 to reset)
backward_launches = 0


@functools.cache
def library_path() -> Path:
    """The kernel's shared library, built at first use; ``nvcc``'s report
    lies beside it as ``.log``."""
    return build_library("bdc_pool", [SOURCE])


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    lib = ctypes.CDLL(str(library_path()))
    lib.bdc_pool_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.bdc_pool_launch.restype = ctypes.c_int
    return lib


@functools.cache
def backward_library_path() -> Path:
    """The backward kernel's shared library, built at first use; ``nvcc``'s
    report lies beside it as ``.log``."""
    return build_library("bdc_pool_backward", [BACKWARD_SOURCE])


@functools.cache
def backward_library() -> ctypes.CDLL:
    """Build (at first use) and load the backward kernel's shared library."""
    lib = ctypes.CDLL(str(backward_library_path()))
    lib.bdc_pool_backward_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.bdc_pool_backward_launch.restype = ctypes.c_int
    return lib


def check_kernel_inputs(x: torch.Tensor, log_t: torch.Tensor,
                        return_full: bool = False) -> None:
    """Raise on what the kernels do not take: the full matrix has no
    backward, so it is refused while grad is needed."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, d, M], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32 or log_t.dtype != torch.float32:
        raise TypeError(
            f"bdc_pool kernel takes float32, got x {x.dtype}, log_t {log_t.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if log_t.numel() != 1:
        raise ValueError(f"log_t must hold one value, got shape {tuple(log_t.shape)}")
    if log_t.device != x.device:
        raise ValueError(f"log_t on {log_t.device} but x on {x.device}")
    if not 1 <= x.shape[1] <= MAX_DIM:
        raise ValueError(f"bdc_pool kernel supports 1 <= d <= {MAX_DIM}, got d={x.shape[1]}")
    if x.shape[2] < 1:
        raise ValueError("x must have M >= 1 positions")
    if return_full and torch.is_grad_enabled() and (x.requires_grad or log_t.requires_grad):
        raise RuntimeError(
            "the full BDC matrix has no backward: call "
            "bdc_pool_triu(return_full=True) under torch.no_grad()"
        )


def _forward(x: torch.Tensor, log_t: torch.Tensor, return_full: bool):
    """Launch the forward kernel on checked CUDA inputs."""
    global launches
    b, d, m = x.shape
    tri = torch.empty((b, d * (d + 1) // 2), dtype=torch.float32, device=x.device)
    full: Optional[torch.Tensor] = (
        torch.empty((b, d, d), dtype=torch.float32, device=x.device)
        if return_full else None
    )
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.bdc_pool_launch(
            x.data_ptr(), log_t.data_ptr(), tri.data_ptr(),
            full.data_ptr() if full is not None else None,
            b, d, m, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bdc_pool kernel launch failed with CUDA error {err}")
    if b > 0:
        launches += 1
    return (tri, full) if return_full else tri


class BdcPoolTriu(torch.autograd.Function):
    """``triuvec(bdc_pool(x, log_t))`` on the card with a kernel for each
    direction.  Saves x and ``log_t``; the backward recomputes the gram."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, log_t: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, log_t)
        return _forward(x, log_t, return_full=False)

    @staticmethod
    def backward(ctx, grad_triu: torch.Tensor):
        x, log_t = ctx.saved_tensors
        grad_x, grad_log_t = bdc_pool_triu_backward(x, log_t, grad_triu)
        return (grad_x if ctx.needs_input_grad[0] else None,
                grad_log_t if ctx.needs_input_grad[1] else None)


def bdc_pool_triu(
    x: torch.Tensor, log_t: torch.Tensor, return_full: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``[B, d, M]`` → ``triuvec(bdc_pool(x, log_t))`` of shape
    ``[B, d(d+1)/2]``; with ``return_full`` also the ``[B, d, d]`` matrix
    (which has no backward on the card)."""
    if x.device.type == "cpu":
        mat = bdc_pool(x, log_t)
        tri = triuvec(mat)
        return (tri, mat) if return_full else tri
    if x.device.type != "cuda":
        raise ValueError(f"bdc_pool_triu runs on cpu or cuda, not {x.device}")
    check_kernel_inputs(x, log_t, return_full)
    if torch.is_grad_enabled() and (x.requires_grad or log_t.requires_grad):
        return BdcPoolTriu.apply(x, log_t)
    return _forward(x, log_t, return_full)


def bdc_pool_triu_backward(
    x: torch.Tensor, log_t: torch.Tensor, grad_triu: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of ``sum(grad_triu * triuvec(bdc_pool(x, log_t)))`` by x
    ``[B, d, M]`` and by ``log_t`` (its shape).  On the CPU by autograd
    through the plain version; on the card by the backward kernel, whose
    per-element ``log_t`` partials are summed here."""
    global backward_launches
    if x.device.type == "cpu":
        return bdc_pool_triu_vjp(x, log_t, grad_triu)
    if x.device.type != "cuda":
        raise ValueError(f"bdc_pool_triu_backward runs on cpu or cuda, not {x.device}")
    check_kernel_inputs(x, log_t)
    b, d, m = x.shape
    if grad_triu.shape != (b, d * (d + 1) // 2):
        raise ValueError(f"grad_triu must be {(b, d * (d + 1) // 2)}, "
                         f"got {tuple(grad_triu.shape)}")
    if grad_triu.dtype != torch.float32 or grad_triu.device != x.device:
        raise TypeError(f"grad_triu must be float32 on {x.device}, got "
                        f"{grad_triu.dtype} on {grad_triu.device}")
    grad_triu = grad_triu.contiguous()
    grad_x = torch.empty_like(x)
    parts = torch.empty((b,), dtype=torch.float32, device=x.device)
    lib = backward_library()
    with torch.cuda.device(x.device):
        err = lib.bdc_pool_backward_launch(
            x.data_ptr(), log_t.data_ptr(), grad_triu.data_ptr(),
            grad_x.data_ptr(), parts.data_ptr(), b, d, m,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bdc_pool_backward kernel launch failed with CUDA error {err}")
    if b > 0:
        backward_launches += 1
    return grad_x, parts.sum().reshape(log_t.shape)
