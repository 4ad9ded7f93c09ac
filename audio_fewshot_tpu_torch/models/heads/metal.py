"""MeTAL, meta-learning with task-adaptive loss functions (counterpart of
``audio_fewshot_tpu/models/heads/metal.py``).

A Linear head (the reference's ``classifier.layers.0``) adapted per
episode by SGD on support cross-entropy plus two learned losses: ``meta_loss``
over the normalised support state ``[task state ‖ support logits ‖ one-hot
targets]`` and ``meta_query_loss`` over the query state ``[head-weight
means ‖ query logits ‖ Σ p·log p]`` (no minus sign: the JAX package's
"entropy" column).  ``train_iter`` steps in training, ``test_iter`` in
eval, at ``lr``; the backbone runs once per batch (``embed``) and the
episodes adapt together, each its own ``[E, way, D]`` copy of the head
(``maml.sgd_steps``), second order in training.

- **Default path**: each loss net is ``MetaLossNet``, an ``Embed(64, 8)``
  step embedding concatenated to the state, ``fc1`` (40) → ReLU → ``fc2``
  (→ 1); the task state is ``_normalize([support loss, mean(W_fast),
  mean(b_fast)])``.  More than 64 steps raise.  No reference counterpart:
  the keys mirror flax's names (``meta_loss.step_emb.weight``,
  ``meta_loss.fc{1,2}.*``).
- **``per_step_adapters: true``**: the reference's per-step loss nets
  (``meta_loss.layer_dict.step{i}.linear{1,2}.{weights,bias}``) and
  ``LossAdapter``\\ s (``meta_loss_adapter.loss_adapter.{i}.linear{1,2}``,
  ``multiplier_bias``, ``offset_bias``), ``test_iter`` sets each (so
  ``train_iter > test_iter`` raises), picked by the step the Python loop is
  at.  An adapter maps the task state (the support net's) or the masked
  mean of the normalised query state (the query net's) to a (multiplier,
  offset) pair per loss-net tensor, gated by the zero-initialised biases:
  ``(1 + m)·v + o`` per whole tensor, the identity at init.  The head
  means are the fast weights' at step 0 and the base weights' at steps
  ≥ 1: no inner-gradient path after step 0, an outer one through the base
  weights.

``_normalize`` divides by the Bessel-corrected standard deviation (plus
1e-12) over a whole state array; the query state is normalised over the
real rows only (``_normalize_rows``), so bucket padding changes no real
row's logits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from ..init import dense, lecun_normal_
from .maml import LinearHead, episode_cross_entropy, linear_logits, sgd_steps

MAX_STEPS = 64
N_TENSORS = 4  # a loss net's linear1.{weights,bias}, linear2.{weights,bias}


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Each episode's ``x`` [E, …] less its mean over its elements, over
    their Bessel-corrected standard deviation plus 1e-12."""
    flat = x.flatten(1)
    shape = (-1,) + (1,) * (x.dim() - 1)
    mean = flat.mean(dim=1).view(shape)
    return (x - mean) / (flat.std(dim=1, correction=1).view(shape) + 1e-12)


def _normalize_rows(x: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """``_normalize`` of ``x`` [E, G, C] over the elements of each episode's
    real rows (``row_mask`` [E, G], 1 for a real row): n = rows · C, the
    variance over n − 1.  Padded rows get values too; callers mask them."""
    m = row_mask[..., None]
    n = row_mask.sum(dim=1) * x.shape[-1]
    mean = (x * m).sum(dim=(1, 2)) / n
    centred = x - mean[:, None, None]
    var = (centred.square() * m).sum(dim=(1, 2)) / (n - 1.0)
    return centred / (var.sqrt() + 1e-12)[:, None, None]


class MetaLossNet(nn.Module):
    """Step-conditioned learned loss: MLP(state ‖ step embedding) → scalar."""

    def __init__(self, in_dim: int, hid_dim: int = 40, max_steps: int = MAX_STEPS):
        super().__init__()
        self.step_emb = nn.Embedding(max_steps, 8)
        lecun_normal_(self.step_emb.weight)  # flax's Embed: variance 1 / 8
        self.fc1 = dense(in_dim + 8, hid_dim)
        self.fc2 = dense(hid_dim, 1)

    def forward(self, state: torch.Tensor, step: int, mods=None) -> torch.Tensor:
        emb = self.step_emb.weight[step].expand(state.shape[:-1] + (8,))
        return self.fc2(F.relu(self.fc1(torch.cat([state, emb], dim=-1))))


class MetaLinearLayer(nn.Module):
    """The reference's ``MetaLinearLayer``: ``weights`` [out, in], ``bias``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weights = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        nn.init.xavier_uniform_(self.weights)


class StepLossNet(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear1 = MetaLinearLayer(dim, dim)
        self.linear2 = MetaLinearLayer(dim, 1)


class PerStepLossNet(nn.Module):
    """One Linear(d, d) + ReLU + Linear(d, 1) per step (the reference's
    ``MetaLossNetwork``), each tensor modulated per episode by ``mods``."""

    def __init__(self, dim: int, num_steps: int):
        super().__init__()
        self.layer_dict = nn.ModuleDict({f"step{i}": StepLossNet(dim) for i in range(num_steps)})

    def forward(self, x: torch.Tensor, step: int, mods: Sequence) -> torch.Tensor:
        """``x`` [E, N, d], ``mods`` one (multiplier, offset) pair of [E] per
        tensor → [E, N, 1]."""
        net = self.layer_dict[f"step{step}"]
        tensors = (net.linear1.weights, net.linear1.bias, net.linear2.weights, net.linear2.bias)
        w1, b1, w2, b2 = [(1.0 + m.view((-1,) + (1,) * v.dim())) * v
                          + o.view((-1,) + (1,) * v.dim()) for v, (m, o) in zip(tensors, mods)]
        y = F.relu(torch.baddbmm(b1[:, None], x, w1.transpose(1, 2)))
        return torch.baddbmm(b2[:, None], y, w2.transpose(1, 2))


class StepLossAdapter(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, dim)
        self.linear2 = nn.Linear(dim, 2 * N_TENSORS)
        for layer in (self.linear1, self.linear2):
            nn.init.xavier_uniform_(layer.weight)
            nn.init.zeros_(layer.bias)
        self.multiplier_bias = nn.Parameter(torch.zeros(N_TENSORS))
        self.offset_bias = nn.Parameter(torch.zeros(N_TENSORS))


class PerStepLossAdapter(nn.Module):
    """The reference's ``LossAdapter``: per step, a 2-layer MLP over a state
    ``[E, d]`` emitting one gated (multiplier, offset) pair per loss-net
    tensor."""

    def __init__(self, dim: int, num_steps: int):
        super().__init__()
        self.loss_adapter = nn.ModuleList(StepLossAdapter(dim) for _ in range(num_steps))

    def forward(self, x: torch.Tensor, step: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        a = self.loss_adapter[step]
        out = a.linear2(F.relu(a.linear1(x)))
        gm, go = out[:, :N_TENSORS], out[:, N_TENSORS:]
        return [(a.multiplier_bias[i] * gm[:, i], a.offset_bias[i] * go[:, i])
                for i in range(N_TENSORS)]


@CLASSIFIERS.register("MeTAL")
class MeTAL(MethodBase):
    model_type = ModelType.META
    #: ``build_method`` passes the backbone's flat feature width as ``feat_dim``
    needs_feat_dim = True

    def __init__(self, emb_func, feat_dim: int, inner_param: Optional[Dict] = None,
                 way_num: int = 5, **kwargs):
        super().__init__(emb_func, **kwargs)
        p = dict(inner_param or {})
        self.inner_lr = float(p.get("lr", 0.01))
        self.train_iter = int(p.get("train_iter", 5))
        self.test_iter = int(p.get("test_iter", 10))
        self.per_step_adapters = bool(p.get("per_step_adapters", False))
        self.classifier = LinearHead(feat_dim, way_num)
        s_dim, q_dim = 3 + 2 * way_num, 3 + way_num
        if self.per_step_adapters:
            if self.train_iter > self.test_iter:
                raise ValueError(
                    f"per_step_adapters sizes the loss nets by test_iter ({self.test_iter}), as "
                    f"the reference does: train_iter {self.train_iter} would index past them")
            self.meta_loss = PerStepLossNet(s_dim, self.test_iter)
            self.meta_query_loss = PerStepLossNet(q_dim, self.test_iter)
            self.meta_loss_adapter = PerStepLossAdapter(3, self.test_iter)
            self.meta_query_loss_adapter = PerStepLossAdapter(q_dim, self.test_iter)
        else:
            if max(self.train_iter, self.test_iter) > MAX_STEPS:
                raise ValueError(
                    f"MeTAL inner iters (train {self.train_iter} / test {self.test_iter}) "
                    f"exceed the step embedding's {MAX_STEPS} rows")
            self.meta_loss = MetaLossNet(s_dim)
            self.meta_query_loss = MetaLossNet(q_dim)

    def _inner_objective(self, sup_f, qry_f, sup_y, onehot, qm, w, b, step: int) -> torch.Tensor:
        """The sum over the episodes of support CE + meta_s + meta_q under the
        fast head ``(w, b)`` [E, way, D], [E, way]."""
        e, ws, g = sup_f.shape[0], sup_f.shape[1], qry_f.shape[1]
        s_preds, q_preds = linear_logits(sup_f, w, b), linear_logits(qry_f, w, b)
        s_loss = episode_cross_entropy(s_preds, sup_y)
        means = torch.stack([w.mean(dim=(1, 2)), b.mean(dim=1)], dim=1)  # [E, 2]
        if self.per_step_adapters and step > 0:
            base = self.classifier.layers[0]
            means = torch.stack([base.weight.mean(), base.bias.mean()]).expand(e, 2)
        task_state = _normalize(torch.cat([s_loss[:, None], means], dim=1))
        mods_s = self.meta_loss_adapter(task_state, step) if self.per_step_adapters else None
        s_state = torch.cat([task_state[:, None].expand(e, ws, 3), s_preds, onehot], dim=-1)
        meta_s = self.meta_loss(_normalize(s_state), step, mods_s).mean(dim=(1, 2))
        logp = F.log_softmax(q_preds, dim=-1)
        entropy = (logp.exp() * logp).sum(dim=-1, keepdim=True)
        q_state = torch.cat([means[:, None].expand(e, g, 2), q_preds, entropy], dim=-1)
        n_valid = qm.sum(dim=1)
        q_norm = _normalize_rows(q_state, qm)
        mods_q = None
        if self.per_step_adapters:
            mods_q = self.meta_query_loss_adapter(
                (q_norm * qm[..., None]).sum(dim=1) / n_valid[:, None], step)
        meta_q = (self.meta_query_loss(q_norm, step, mods_q)[..., 0] * qm).sum(dim=1) / n_valid
        return (s_loss + meta_s + meta_q).sum()

    def _run(self, batch: EpisodeBatch, setting: EpisodeSetting, n_steps: int,
             second_order: bool = True) -> torch.Tensor:
        sup_f, qry_f = self.embed(batch)
        e = sup_f.shape[0]
        y = batch.support_target.long()
        onehot = F.one_hot(y, setting.way).to(sup_f.dtype)
        qm = batch.query_mask.to(qry_f.dtype)
        head = self.classifier.layers[0]

        def objective(t, step):
            return self._inner_objective(sup_f, qry_f, y, onehot, qm, *t, step)

        w, b = sgd_steps((head.weight.expand(e, -1, -1), head.bias.expand(e, -1)),
                         objective, n_steps, self.inner_lr, second_order)
        return linear_logits(qry_f, w, b)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        return self._run(batch, setting, self.test_iter)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        seg_logits = self._run(batch, setting, self.train_iter)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))


# the reference's shipped metal.yaml spells the name in capitals
CLASSIFIERS.register_alias("METAL", "MeTAL")
