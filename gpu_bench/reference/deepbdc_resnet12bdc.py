"""Plain reference of DeepBDC on resnet12Bdc (Xie et al., CVPR 2022; the
config ``config/deepbdc/deepbdc_5shot_iid_seed0.yaml`` with
``config/backbones/resnet12Bdc.yaml``).

Four residual stages of three 3×3 convolutions with BatchNorm and
LeakyReLU(0.1), a 1×1 convolution with BatchNorm on the residual, a 2×2
max pool after stages 1–3 (planes 64/160/320/640: a ``[640, 16, 19]`` map of
a ``[1, 128, 157]`` segment); the BDC head: a 1×1 reduction to ``reduce_dim``
channels with BatchNorm and ReLU, then the Brownian distance covariance of
the M = h·w positions, double centred, as its upper triangle (d(d+1)/2
features).  The logits of a query segment are −‖q − p‖² to the class means
of the support features.  float32 throughout (the BDC matrix in float64),
TF32 off; ``q`` rounds every convolution's operands and output (the
control's lower precision).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from .common import Weights, batch_norm, conv, identity, neg_sq_distance, prototypes

PLANES = (64, 160, 320, 640)
PREFIX = "emb_func."

#: the limit of each number the comparison reads (``judge.py``), by the kind
#: of driver, set from the bf16 program's largest reading over 60 runs and
#: the float8 control's smallest on an NVIDIA H100 80GB HBM3 at 700 W
#: (``PERF.md`` gives them)
LIMITS = {
    # logit_gap: program ≤ 0.0195, control ≥ 0.096
    "eval": {"structure": 0.0, "vote": 0.0, "logit_gap": 0.045},
}


def _bn(name: str, width: int) -> List[Tuple[str, tuple, str]]:
    return [(f"{name}.weight", (width,), "bn_weight"), (f"{name}.bias", (width,), "bn_bias"),
            (f"{name}.running_mean", (width,), "bn_mean"),
            (f"{name}.running_var", (width,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "count")]


def weight_spec(model: dict) -> List[Tuple[str, tuple, str]]:
    """Every weight and buffer: ``(state_dict name, shape, kind)``."""
    kwargs = model["backbone"]["kwargs"]
    spec = []
    cin = int(kwargs.get("num_channels", 1))
    for i, planes in enumerate(PLANES, start=1):
        p = f"{PREFIX}layer{i}.0."
        for j, c_in in enumerate((cin, planes, planes), start=1):
            spec.append((f"{p}conv{j}.weight", (planes, c_in, 3, 3), "conv"))
            spec += _bn(f"{p}bn{j}", planes)
        spec.append((f"{p}downsample.0.weight", (planes, cin, 1, 1), "conv"))
        spec += _bn(f"{p}downsample.1", planes)
        cin = planes
    d = int(kwargs["reduce_dim"])
    spec.append((f"{PREFIX}bdc_pool.conv_dr_block.0.weight", (d, PLANES[-1], 1, 1), "conv"))
    spec += _bn(f"{PREFIX}bdc_pool.conv_dr_block.1", d)
    spec.append((f"{PREFIX}bdc_pool.temperature", (1, 1), "log_t"))
    return spec


def bdc_triu(x: torch.Tensor, log_t: torch.Tensor) -> torch.Tensor:
    """``[N, d, M]`` → the upper triangle (row-major, diagonal included) of
    the double-centred distance covariance, computed in float64 and returned
    in ``x``'s dtype."""
    dtype, x = x.dtype, x.double()
    gram = x @ x.transpose(-1, -2)
    diag = torch.diagonal(gram, dim1=-2, dim2=-1)
    dist2 = (diag[..., :, None] + diag[..., None, :] - 2.0 * gram).clamp(min=0.0)
    dcov = torch.sqrt(torch.exp(log_t.double().reshape(())) * dist2 + 1e-5)
    centred = (dcov - dcov.mean(dim=-1, keepdim=True) - dcov.mean(dim=-2, keepdim=True)
               + dcov.mean(dim=(-2, -1), keepdim=True))
    rows, cols = torch.triu_indices(x.shape[1], x.shape[1], device=x.device)
    return centred[:, rows, cols].to(dtype)


def features(w: Weights, x: torch.Tensor, q=identity) -> torch.Tensor:
    """``[N, C, F, T]`` segments → ``[N, d(d+1)/2]`` BDC features, BatchNorm
    on the running statistics."""
    act = lambda t: F.leaky_relu(t, 0.1)
    for i in range(1, len(PLANES) + 1):
        p = f"{PREFIX}layer{i}.0."
        out = act(batch_norm(conv(x, w, p + "conv1", 1, q), w, p + "bn1"))
        out = act(batch_norm(conv(out, w, p + "conv2", 1, q), w, p + "bn2"))
        out = batch_norm(conv(out, w, p + "conv3", 1, q), w, p + "bn3")
        res = batch_norm(conv(x, w, p + "downsample.0", 0, q), w, p + "downsample.1")
        x = act(out + res)
        if i < len(PLANES):
            x = F.max_pool2d(x, 2, 2)
    head = f"{PREFIX}bdc_pool.conv_dr_block."
    x = F.relu(batch_norm(conv(x, w, head + "0", 0, q), w, head + "1"))
    n, d, h, wd = x.shape
    return bdc_triu(x.reshape(n, d, h * wd), w[f"{PREFIX}bdc_pool.temperature"])


def logits(support: torch.Tensor, query: torch.Tensor, way: int, shot: int) -> torch.Tensor:
    """``[E, G, way]``: −‖q − p‖² to the class means (for shot > 1)."""
    proto = prototypes(support, way, shot)
    if shot > 1:
        return neg_sq_distance(query, proto)
    return query @ proto.transpose(-1, -2)
