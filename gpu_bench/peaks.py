"""Published peaks of the card and the roofline arithmetic of the BDC pool
kernel.

Peaks: NVIDIA's H100 data sheets, dense rates, at the full power limit
(700 W for the SXM part).  ``bdc_bound_ms`` gives the least time of the BDC
pool at a launch's shape ``(B, d, M)``: the larger of the fp32 operations
over the CUDA cores' peak and of the bytes (each input read once, each
output written once) over the memory's.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAKS: Dict[str, Dict[str, float]] = {
    "H100 SXM": {"bf16_flops": 989e12, "fp32_flops": 67e12, "bytes": 3.35e12},
    "H100 PCIe": {"bf16_flops": 756e12, "fp32_flops": 51e12, "bytes": 2.0e12},
}


def card_peaks(name: str) -> Dict[str, float]:
    """The peaks of the card ``torch.cuda.get_device_name`` names."""
    return PEAKS["H100 PCIe"] if "PCIe" in name else PEAKS["H100 SXM"]


def bdc_bound_ms(b: int, d: int, m: int, peaks: Dict[str, float]) -> Tuple[float, str]:
    """The fused BDC pool: B·d(d+1)·M operations for the gram's upper
    triangle (the epilogue's O(B·d²) is under 1 % at M = 304), x read once
    and the upper triangle written once."""
    flops = 1.0 * b * d * (d + 1) * m
    nbytes = 4.0 * (b * d * m + 1 + b * d * (d + 1) // 2)
    t_ops, t_bytes = flops / peaks["fp32_flops"], nbytes / peaks["bytes"]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

