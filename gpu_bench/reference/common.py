"""Plain PyTorch pieces the references share: float32 with TF32 off,
convolution and BatchNorm over a flat dict of weights, the clip vote, and
the lower precision the control computes in.

Weights are a dict keyed by the program's ``state_dict`` names, made by the
benchmark from the seed (``gpu_bench/weights.py``); the references read
them and nothing else of the program.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]
BN_EPS = 1e-5
#: largest finite float8 e4m3 value
E4M3_MAX = 448.0


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    """float32 products and convolutions with TF32 off, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude at 448), back in float32; the gradient passes
    straight through.  The control's precision for a bfloat16 backbone."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


PRECISIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {"fp32": identity, "fp8": fp8}


def conv(x: torch.Tensor, w: Weights, name: str, padding: int, q=identity) -> torch.Tensor:
    """``F.conv2d`` with ``name``'s weight (and bias, where there is one),
    its operands and its output rounded by ``q`` (the activations a
    lower-precision backbone would store)."""
    return q(F.conv2d(q(x), q(w[name + ".weight"]), w.get(name + ".bias"), padding=padding))


def batch_norm(x: torch.Tensor, w: Weights, name: str) -> torch.Tensor:
    """BatchNorm over every axis but the channels, on the running statistics."""
    return F.batch_norm(x, w[name + ".running_mean"], w[name + ".running_var"],
                        w[name + ".weight"], w[name + ".bias"], False, 0.0, BN_EPS)


def prototypes(support: torch.Tensor, way: int, shot: int) -> torch.Tensor:
    """Class means ``[E, way, D]`` of way-major support features."""
    e, _, d = support.shape
    return support.reshape(e, way, shot, d).mean(dim=2)


def neg_sq_distance(query: torch.Tensor, proto: torch.Tensor) -> torch.Tensor:
    """−‖q − p‖² ``[E, G, way]``, from the differences themselves."""
    return -((query[:, :, None, :] - proto[:, None, :, :]) ** 2).sum(dim=-1)


def clip_votes(seg_logits: torch.Tensor, clip: torch.Tensor, mask: torch.Tensor,
               n_clips: int) -> torch.Tensor:
    """``[E, n_clips, way]``: each valid segment's vote for its argmax class."""
    way = seg_logits.shape[-1]
    votes = torch.zeros(seg_logits.shape[0], n_clips, way, dtype=torch.float64,
                        device=seg_logits.device)
    pred = F.one_hot(seg_logits.argmax(dim=-1), way).double() * mask.double()[..., None]
    return votes.scatter_add_(1, clip.long()[..., None].expand(-1, -1, way), pred)


def vote_accuracy(seg_logits: torch.Tensor, clip: torch.Tensor, mask: torch.Tensor,
                  target: torch.Tensor) -> torch.Tensor:
    """Per-episode clip accuracy in percent ``[E]``: each clip takes the class
    most of its segments vote for, ties to the smaller class."""
    votes = clip_votes(seg_logits, clip, mask, target.shape[-1])
    return (votes.argmax(dim=-1) == target).double().mean(dim=-1) * 100.0


def in_blocks(fn, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn`` over ``x``'s rows ``rows`` at a time, concatenated: a per-row
    function that fits in memory however many rows there are."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])

