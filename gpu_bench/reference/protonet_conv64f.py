"""Plain reference of ProtoNet on Conv64F (Snell et al., NeurIPS 2017;
LibFewShot's Conv64F; the config ``config/proto/proto_5shot_iid_seed0.yaml``
with ``config/backbones/Conv64F.yaml``).

Four blocks of a 3×3 convolution (with bias), BatchNorm and ReLU, 64
channels each, a 3×3 stride-3 max pool (floor) after every block; the last
map flattened channel-last, then the logits head: BatchNorm1d and a linear
layer to 1600 features (its Dropout is the identity in eval).  The logits
of a query segment are −‖q − p‖² to the class means of the support
features.  float32 throughout, TF32 off; ``q`` rounds every convolution's
operands and output and the linear layer's operands (the control's lower
precision).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from .common import Weights, batch_norm, conv, identity, neg_sq_distance, prototypes
from .deepbdc_resnet12bdc import _bn

WIDTH = 64
PREFIX = "emb_func."

#: the limit of each number the comparison reads (``judge.py``), set from
#: readings on an NVIDIA H100 80GB HBM3 at 700 W (``PERF.md`` gives them):
#: ``logit_gap`` between the bf16 program's largest over 30 runs (0.0404)
#: and the float8 control's smallest (0.286).
LIMITS = {
    "eval": {"structure": 0.0, "vote": 0.0, "logit_gap": 0.11},
}


def pooled(side: int) -> int:
    for _ in range(4):
        side //= 3
    return side


def weight_spec(model: dict) -> List[Tuple[str, tuple, str]]:
    """Every weight and buffer: ``(state_dict name, shape, kind)``."""
    kwargs = model["backbone"]["kwargs"]
    spec = []
    cin = int(kwargs.get("num_channels", 1))
    for i in range(1, 5):
        p = f"{PREFIX}layer{i}."
        spec += [(f"{p}0.weight", (WIDTH, cin, 3, 3), "conv"), (f"{p}0.bias", (WIDTH,), "bias")]
        spec += _bn(f"{p}1", WIDTH)
        cin = WIDTH
    _, h, w = model["spec_shape"]
    flat = WIDTH * pooled(h) * pooled(w)
    out = int(kwargs.get("logits_dim", 1600))
    spec += _bn(f"{PREFIX}logits.1", flat)
    spec += [(f"{PREFIX}logits.2.weight", (out, flat), "linear"),
             (f"{PREFIX}logits.2.bias", (out,), "bias")]
    return spec


def features(w: Weights, x: torch.Tensor, q=identity) -> torch.Tensor:
    """``[N, C, F, T]`` segments → ``[N, 1600]`` features."""
    for i in range(1, 5):
        p = f"{PREFIX}layer{i}."
        x = F.relu(batch_norm(conv(x, w, p + "0", 1, q), w, p + "1"))
        x = F.max_pool2d(x, 3, 3)
    flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    flat = batch_norm(flat, w, f"{PREFIX}logits.1")
    return F.linear(q(flat), q(w[f"{PREFIX}logits.2.weight"]), w[f"{PREFIX}logits.2.bias"])


def logits(support: torch.Tensor, query: torch.Tensor, way: int, shot: int) -> torch.Tensor:
    """``[E, G, way]``: −‖q − p‖² to the class means."""
    return neg_sq_distance(query, prototypes(support, way, shot))
