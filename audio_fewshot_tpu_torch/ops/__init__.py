"""Compute ops: the BDC pool's plain PyTorch version and its CUDA kernel."""

from .bdc import bdc_pool, triu_indices_flat, triuvec
from .bdc_cuda import bdc_pool_triu

__all__ = ["bdc_pool", "bdc_pool_triu", "triu_indices_flat", "triuvec"]
