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

On a CPU tensor the wrapper runs the plain version (``ops/bdc.py``); on a
CUDA tensor it launches the kernel or raises.  ``launches`` counts kernel
launches.  There is no backward: the wrapper refuses inputs that require
grad while grad is enabled.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from .bdc import bdc_pool, triuvec
from .build import build_library

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "bdc_pool.cu"
MAX_DIM = 128

#: number of kernel launches since the last reset (set to 0 to reset)
launches = 0


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


def check_kernel_inputs(x: torch.Tensor, log_t: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
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
    if torch.is_grad_enabled() and (x.requires_grad or log_t.requires_grad):
        raise RuntimeError(
            "bdc_pool kernel has no backward yet: call it under torch.no_grad()"
        )


def bdc_pool_triu(
    x: torch.Tensor, log_t: torch.Tensor, return_full: bool = False
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """``[B, d, M]`` → ``triuvec(bdc_pool(x, log_t))`` of shape
    ``[B, d(d+1)/2]``; with ``return_full`` also the ``[B, d, d]`` matrix."""
    global launches
    if x.device.type == "cpu":
        mat = bdc_pool(x, log_t)
        tri = triuvec(mat)
        return (tri, mat) if return_full else tri
    if x.device.type != "cuda":
        raise ValueError(f"bdc_pool_triu runs on cpu or cuda, not {x.device}")
    check_kernel_inputs(x, log_t)
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
