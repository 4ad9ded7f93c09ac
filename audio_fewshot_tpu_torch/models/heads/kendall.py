"""MetaBaselineKendall (DiffKendall), Kendall rank correlation to class-mean
prototypes (counterpart of ``MetaBaselineKendall`` in
``audio_fewshot_tpu/models/heads/kendall.py``).

Over the d(d − 1)/2 channel pairs (i < j) of a query q and a prototype p:

- eval (``exact``): Σ sign(qᵢ − qⱼ)·sign(pᵢ − pⱼ) / pairs;
- train: Σ (2σ(β·(qᵢ − qⱼ)(pᵢ − pⱼ)) − 1) / pairs / T, computed as
  Σ tanh(β/2 · (qᵢ − qⱼ)(pᵢ − pⱼ)) (the same function).

At d = 12800 (the flat resnet12) there are 81.9 M pairs, so nothing of size
[E, G, pairs] is formed.  The pairs go in strips of rows: rows [a0, a1)
against columns [a0, d), the pairs j ≤ i of the strip's diagonal block
weighted 0 (a pair (i, j) and (j, i) score alike, and i = j scores 0).
Each strip's pair differences come from broadcasting, without index
tensors; a strip holds about ``budget`` elements of its largest temporary.
The exact sums are integers: each strip's is exact in float32 (a product
of ±1/0 signs under 2²⁴ terms) and the strips add up in float64.  The
train score is a ``torch.autograd.Function`` whose backward recomputes each
strip: autograd through the strips would keep every strip's [E, G, way,
pairs] activations (≈ 82 GB at one 50-query episode).

``MetabaselineKendallPretrain`` trains the backbone with the finetuning
family's global linear CE on flat batches and validates with the exact
score against the class prototypes.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from .finetuning import FinetuningBase
from .proto_net import prototypes

#: elements of a strip's largest temporary (float32): 2²⁷ = 512 MiB in eval,
#: 2²⁶ = 256 MiB in the train score's backward
EXACT_BUDGET = 2 ** 27
SOFT_BUDGET = 2 ** 26


def num_pairs(d: int) -> int:
    return d * (d - 1) // 2


def strips(d: int, width: int) -> Iterator[Tuple[int, int]]:
    """Row ranges [a0, a1) covering 0 … d − 1 with (a1 − a0)·(d − a0) ≤
    ``width`` where one row allows it (at least one row a strip)."""
    a0 = 0
    while a0 < d - 1:
        a1 = min(d - 1, a0 + max(1, width // (d - a0)))
        yield a0, a1
        a0 = a1


def _pair_diffs(x: torch.Tensor, a0: int, a1: int) -> torch.Tensor:
    """``x [..., d]`` → xᵢ − xⱼ ``[..., a1 − a0, d − a0]`` for i ∈ [a0, a1),
    j ∈ [a0, d)."""
    return x[..., a0:a1, None] - x[..., None, a0:]


def _upper(a0: int, a1: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """1 where j > i, else 0, ``[a1 − a0, d − a0]``."""
    i = torch.arange(a0, a1, device=like.device)[:, None]
    j = torch.arange(a0, d, device=like.device)[None, :]
    return (j > i).to(like.dtype)


@torch.no_grad()
def kendall_exact_counts(query: torch.Tensor, proto: torch.Tensor,
                         budget: int = EXACT_BUDGET) -> torch.Tensor:
    """Σ_{i<j} sign(qᵢ − qⱼ)·sign(pᵢ − pⱼ) ``[E, G, way]`` in float64 (exact
    integers): query ``[E, G, d]``, proto ``[E, way, d]``."""
    e, g, d = query.shape
    total = torch.zeros((e, g, proto.shape[1]), dtype=torch.float64, device=query.device)
    # under 2^24 pairs a strip: its float32 sums of ±1 stay exact
    for a0, a1 in strips(d, min(2 ** 24, max(1, budget // max(1, e * g)))):
        sq = _pair_diffs(query, a0, a1).sign_().reshape(e, g, -1)
        sp = _pair_diffs(proto, a0, a1).sign_().mul_(_upper(a0, a1, d, proto))
        total += torch.bmm(sq, sp.reshape(e, proto.shape[1], -1).transpose(1, 2)).double()
    return total


class _SoftKendall(torch.autograd.Function):
    """Σ_{i<j} tanh(β/2 · (qᵢ − qⱼ)(pᵢ − pⱼ)) ``[E, G, way]``; the backward
    recomputes each strip."""

    @staticmethod
    def forward(ctx, query, proto, beta: float, budget: int):
        ctx.save_for_backward(query, proto)
        ctx.beta, ctx.budget = beta, budget
        e, g, d = query.shape
        way = proto.shape[1]
        total = query.new_zeros((e, g, way))
        for a0, a1, dq, dp in _soft_strips(query, proto, beta, budget):
            total += torch.tanh_(dq[:, :, None] * dp[:, None]).sum(dim=(-2, -1))
        return total

    @staticmethod
    def backward(ctx, grad):
        query, proto = ctx.saved_tensors
        gq, gp = torch.zeros_like(query), torch.zeros_like(proto)
        for a0, a1, dq, dp in _soft_strips(query, proto, ctx.beta, ctx.budget):
            t = torch.tanh_(dq[:, :, None] * dp[:, None])  # [E, G, way, rows, cols]
            h = t.square_().neg_().add_(1.0).mul_(grad[..., None, None])  # d total / d x
            g_dq = (h * dp[:, None]).sum(dim=2)  # [E, G, rows, cols]
            g_dp = h.mul_(dq[:, :, None]).sum(dim=1)  # [E, way, rows, cols]
            g_dp *= (0.5 * ctx.beta) * _upper(a0, a1, query.shape[-1], g_dp)
            for gx, gd in ((gq, g_dq), (gp, g_dp)):
                gx[..., a0:a1] += gd.sum(dim=-1)
                gx[..., a0:] -= gd.sum(dim=-2)
        return gq, gp, None, None


def _soft_strips(query, proto, beta: float, budget: int):
    """Each strip's (a0, a1, qᵢ − qⱼ, β/2 · (pᵢ − pⱼ) weighted by j > i)."""
    e, g, d = query.shape
    for a0, a1 in strips(d, max(1, budget // max(1, e * g * proto.shape[1]))):
        dp = _pair_diffs(proto, a0, a1).mul_(_upper(a0, a1, d, proto)).mul_(0.5 * beta)
        yield a0, a1, _pair_diffs(query, a0, a1), dp


def kendall_logits(query: torch.Tensor, proto: torch.Tensor, beta: float = 1.0,
                   temperature: float = 0.0125, exact: bool = False) -> torch.Tensor:
    """``[E, G, d]`` × ``[E, way, d]`` → ``[E, G, way]`` Kendall scores
    (float32): the exact sign agreement over the pairs, or the smooth
    score over the pairs divided by ``temperature``."""
    query, proto = query.float(), proto.float()
    p = num_pairs(query.shape[-1])
    if exact:
        return (kendall_exact_counts(query, proto) / p).float()
    return _SoftKendall.apply(query, proto, float(beta), SOFT_BUDGET) / p / temperature


@CLASSIFIERS.register("MetaBaselineKendall")
class MetaBaselineKendall(MethodBase):
    model_type = ModelType.METRIC
    shardable = True

    def __init__(self, emb_func, beta: float = 1.0, temperature: float = 0.0125, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.beta = beta
        self.temperature = temperature

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        return kendall_logits(qry, prototypes(sup.float(), setting.way, setting.shot), exact=True)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        sup, qry = self.embed(batch)
        proto = prototypes(sup.float(), setting.way, setting.shot)
        seg_logits = kendall_logits(qry, proto, self.beta, self.temperature, exact=False)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))


# the reference exports the class as DiffKendall too
CLASSIFIERS.register_alias("DiffKendall", "MetaBaselineKendall")


@CLASSIFIERS.register("MetabaselineKendallPretrain")
class MetabaselineKendallPretrain(FinetuningBase):
    """Global-CE pretraining (the linear ``classifier``), exact-Kendall
    validation against the class prototypes."""

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        return kendall_logits(qry, prototypes(sup.float(), setting.way, setting.shot), exact=True)
