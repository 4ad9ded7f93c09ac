"""The collectives of episode-axis data parallelism, on ``torch.distributed``
alone (the backbones' BatchNorm imports them, so this module imports
nothing else of the package): the run's ``World``, parameters broadcast
from rank 0, the gradients' mean over the ranks, an ordered gather of
per-episode rows, a differentiable sum over the ranks, the
``sharded_rows`` mark of calls whose batch axis spans the ranks, and the
``replicated_rows`` mark of passes in which every rank holds the whole
batch.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterable, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class World:
    """This process's place in the run: ``rank`` of ``size`` ranks, and the
    device it computes on."""

    rank: int = 0
    size: int = 1
    device: torch.device = torch.device("cpu")

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous slice of ``n`` rows."""
        if n % self.size:
            raise ValueError(f"a batch axis of {n} rows does not split over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


# -- parameters and collectives --------------------------------------------------------------

@torch.no_grad()
def replicate(module: torch.nn.Module, world: World) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0."""
    if world.size > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


@torch.no_grad()
def all_reduce_gradients(params: Iterable[torch.nn.Parameter], world: World) -> None:
    """Each gradient replaced by its mean over the ranks, through one
    all-reduce of one flat buffer.  A parameter without a gradient on some
    rank counts as zero there; one without a gradient on every rank keeps
    none."""
    if world.size == 1:
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    dtype = params[0].dtype
    for p in params[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    device = params[0].device
    has = [p.grad is not None for p in params]
    flat = torch.cat([torch.tensor(has, dtype=dtype, device=device)] + [
        (p.grad.to(dtype) if p.grad is not None else torch.zeros_like(p, dtype=dtype)).reshape(-1)
        for p in params])
    dist.all_reduce(flat)
    flags, offset = flat[:len(params)], len(params)
    for p, flag in zip(params, flags.tolist()):
        n = p.numel()
        if flag > 0:
            grad = (flat[offset:offset + n] / world.size).reshape(p.shape).to(p.dtype)
            if p.grad is None:
                p.grad = grad
            else:
                p.grad.copy_(grad)
        offset += n


def all_reduce_mean(x: torch.Tensor, world: World) -> torch.Tensor:
    """The mean over the ranks of ``x`` (a copy; ``x`` itself with one rank)."""
    if world.size == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / world.size


def gather_rows(x: torch.Tensor, world: Optional[World]) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) stacked along dim 0 in rank order, on
    every rank.  An all-reduce of a zero-filled global buffer into which each
    rank writes its own rows: exact (x + 0 = x), and it works on every
    backend, gloo with CUDA tensors too (gloo has no CUDA ``all_gather``)."""
    if world is None or world.size == 1:
        return x
    n = x.shape[0]
    wire = torch.int32 if not x.is_floating_point() else x.dtype
    out = torch.zeros((n * world.size,) + tuple(x.shape[1:]), dtype=wire, device=x.device)
    out[world.rank * n:(world.rank + 1) * n] = x.to(wire)
    dist.all_reduce(out)
    return out.to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradients over the ranks
    too: every rank's loss reaches every rank's rows through the sum."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum of ``x`` over the ranks of the run's group."""
    return _AllReduceSum.apply(x)


# -- rows that span the ranks ----------------------------------------------------------------

_sharded_depth = 0
_replicated_depth = 0


@contextlib.contextmanager
def sharded_rows():
    """Marks a call whose batch axis is the sharded one (a backbone over the
    whole episode or flat batch): inside it, batch statistics are taken
    over every rank's rows (``rows_sharded``).  Per-episode calls (the MAML
    family's inner loops, RENet's CCA) stay outside, as their statistics
    belong to one episode."""
    global _sharded_depth
    _sharded_depth += 1
    try:
        yield
    finally:
        _sharded_depth -= 1


@contextlib.contextmanager
def replicated_rows():
    """Marks a pass in which every rank holds the whole batch (the
    ``Trainer``'s replicated eval of a batch that does not split over the
    ranks): inside it no call's rows span the ranks, so nothing is summed
    or gathered over them."""
    global _replicated_depth
    _replicated_depth += 1
    try:
        yield
    finally:
        _replicated_depth -= 1


def sharded_world() -> Optional[World]:
    """This rank's place among the ranks whose rows make up one batch: the
    process group's rank and size, or None with one rank or inside
    ``replicated_rows``."""
    if (_replicated_depth or not (dist.is_available() and dist.is_initialized())
            or dist.get_world_size() == 1):
        return None
    return World(dist.get_rank(), dist.get_world_size())


def rows_sharded() -> bool:
    """True inside ``sharded_rows`` in a run of more than one rank (and not
    inside ``replicated_rows``)."""
    return _sharded_depth > 0 and sharded_world() is not None
