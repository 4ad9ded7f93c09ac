"""The MAML family: MAML, ANIL and BOIL (counterpart of
``audio_fewshot_tpu/models/heads/maml.py``).

The inner loop is functional: each SGD step applies the network to the
fast weights (``torch.func.functional_call`` on the backbone, ``F.linear``
for the head) and takes their gradient with ``torch.autograd.grad``, never
``.backward()``, so the method's own ``.grad`` stays untouched.  Where the
caller records autograd (``loss`` in training) the gradients are taken with
``create_graph=True`` and the outer gradient is exact second order, as
``jax.grad`` through the JAX package's ``lax.scan`` gives it; under
``no_grad`` (``Test.test_loop``, validation), or with parameters that need
no grad (as ``Test`` holds them), the loop opens ``torch.enable_grad()``
itself and steps detached copies of the parameters.  ``train_iter`` steps
(5) in training, ``test_iter`` (10) in eval.

- **MAML** adapts every parameter but a ``BatchNorm1d``'s (Conv64F's
  logits-head BN1d, ``emb_func.logits.1``, keeps its weights in the loop, as
  the reference's fast-weight conversion skips it) at one inner LR.  The
  backbone is applied as the JAX package's ``train=False``: Dropout off, even
  while the ``Trainer`` holds the module in train mode; its BNs run on batch
  statistics (``requires_batch_stat_bn``: ``build_method`` gives the backbone
  ``use_running_statistics=False``).  Batch statistics belong to each episode
  (the JAX package vmaps an episode function), so the episodes run one after
  another: each support pass normalises over its own W·S rows, each query
  pass over its own real rows (``sample_mask = query_mask > 0``).
- **ANIL** keeps running-statistics BN, runs the backbone once per batch in
  the module's own mode (train mode: Dropout on, BN statistics updated) and
  adapts only the ``classifier`` Linear, batched over the episodes (each
  episode's head gets its own gradient from the sum of the episodes' mean
  losses).
- **BOIL** steps the backbone at ``extractor_lr`` and the head at
  ``classifier_lr`` (keyed on the submodule, as the JAX package; PARITY.md),
  ``train_iter`` 1 by default, and evaluates by ``testing_method``:
  ``Directly`` (no step), ``Once_update`` (one step) or ``NIL`` (one step,
  then cosine logits of the queries against class prototypes of the adapted
  body's features, at the eval way).

The head is the reference's ``classifier.layers.0`` Linear over the
backbone's flat features (``feat_dim``, which ``build_method`` states),
drawn as flax's ``Dense`` (lecun_normal kernel, zero bias).
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ...episode import EpisodeBatch, segment_targets
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from ..init import dense

Params = Dict[str, torch.Tensor]
_EMB = "emb_func."
_HEAD_W, _HEAD_B = "classifier.layers.0.weight", "classifier.layers.0.bias"


class LinearHead(nn.Module):
    def __init__(self, feat_dim: int, way: int):
        super().__init__()
        self.layers = nn.Sequential(dense(feat_dim, way))


@contextlib.contextmanager
def _eval_mode(module: nn.Module):
    training = module.training
    module.train(False)
    try:
        yield
    finally:
        module.train(training)


def _records_outer_graph(params) -> bool:
    """Whether the caller records autograd through ``params`` (training);
    else (``no_grad``, or parameters that need no grad, as ``Test`` holds
    them) the inner loop steps detached copies."""
    return torch.is_grad_enabled() and any(p.requires_grad for p in params)


def sgd_steps(tensors: Sequence[torch.Tensor], objective: Callable, n_steps: int, lr: float,
              second_order: bool = True) -> List[torch.Tensor]:
    """``tensors`` after ``n_steps`` plain SGD steps at ``lr`` on
    ``objective(tensors, step)``, a scalar.  The head-only inner loops batch
    their episodes: each tensor carries a leading episode axis and the
    objective is the sum of the episodes' losses, so each episode's slice
    gets its own gradient.  Where the caller records autograd through the
    tensors, the steps stay in its graph (second order, or first order with
    ``second_order=False``); else they step detached copies."""
    outer = _records_outer_graph(tensors)
    tensors = list(tensors)
    if not outer:
        tensors = [t.detach().requires_grad_() for t in tensors]
    with torch.enable_grad():
        for step in range(n_steps):
            grads = torch.autograd.grad(objective(tensors, step), tensors,
                                        create_graph=outer and second_order)
            tensors = [t - lr * g for t, g in zip(tensors, grads)]
            if not outer:
                tensors = [t.detach().requires_grad_() for t in tensors]
    return tensors


def linear_logits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-episode Linear heads: ``x`` [E, N, D], ``w`` [E, way, D], ``b``
    [E, way] → [E, N, way]."""
    return torch.baddbmm(b[:, None], x, w.transpose(1, 2))


def episode_cross_entropy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``[E]``: each episode's mean cross-entropy of ``logits`` [E, N, way]."""
    e = logits.shape[0]
    return F.cross_entropy(logits.flatten(0, 1), target.reshape(-1).long(),
                           reduction="none").view(e, -1).mean(dim=1)


def adapt_linear_head(weight: torch.Tensor, bias: torch.Tensor, sup_f: torch.Tensor,
                      sup_y: torch.Tensor, n_steps: int, lr: float,
                      second_order: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """A Linear head ``(weight [way, D], bias [way])`` copied to each of the
    ``E`` episodes of ``sup_f`` [E, N, D] and stepped on its own support
    cross-entropy (ANIL, MTL): ``([E, way, D], [E, way])``."""
    e = sup_f.shape[0]

    def support_loss(t, step):
        return episode_cross_entropy(linear_logits(sup_f, *t), sup_y).sum()

    return tuple(sgd_steps((weight.expand(e, -1, -1), bias.expand(e, -1)), support_loss,
                           n_steps, lr, second_order))


class MAMLBase(MethodBase):
    model_type = ModelType.META
    shardable = True
    requires_batch_stat_bn = True
    #: ``build_method`` passes the backbone's flat feature width as ``feat_dim``
    needs_feat_dim = True

    def __init__(self, emb_func, feat_dim: int, inner_param: Optional[Dict] = None,
                 way_num: int = 5, **kwargs):
        super().__init__(emb_func, **kwargs)
        inner_param = inner_param or {}
        self.inner_lr = float(inner_param.get("lr", 1e-2))
        self.train_iter = int(inner_param.get("train_iter", 5))
        self.test_iter = int(inner_param.get("test_iter", 10))
        self.way_num = way_num
        self.classifier = LinearHead(feat_dim, way_num)
        # can the backbone keep padded rows out of its batch statistics?
        self._mask_kw = "sample_mask" in inspect.signature(type(emb_func).forward).parameters

    # -- the network over explicit (possibly adapted) parameters -------------------

    def _net(self, params: Params, x: torch.Tensor, sample_mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, flat features) of ``x`` under ``params`` (method-level
        names), the backbone as the JAX package's ``train=False``."""
        emb = {k[len(_EMB):]: v for k, v in params.items() if k.startswith(_EMB)}
        kw = {"sample_mask": sample_mask} if sample_mask is not None and self._mask_kw else {}
        with _eval_mode(self.emb_func):
            feats = functional_call(self.emb_func, emb, (x,), kw)
        feats = feats.reshape(feats.shape[0], -1)
        return F.linear(feats, params[_HEAD_W], params[_HEAD_B]), feats

    def _adaptable(self) -> Params:
        """The parameters the inner loop steps: all but those of a
        ``BatchNorm1d`` (Conv64F's logits head)."""
        frozen = {f"{name}.{p}" for name, m in self.named_modules()
                  if isinstance(m, nn.BatchNorm1d) for p, _ in m.named_parameters()}
        return {k: v for k, v in self.named_parameters() if k not in frozen}

    def _inner_lr(self, name: str) -> float:
        return self.inner_lr

    def _adapt(self, sup_x: torch.Tensor, sup_y: torch.Tensor, n_steps: int,
               second_order: bool = True) -> Params:
        """Every parameter after ``n_steps`` SGD steps on one episode's support
        loss.  Where the caller records autograd, the steps stay in its graph
        (second order, or first order with ``second_order=False``)."""
        params = dict(self.named_parameters())
        fast = self._adaptable()
        outer = _records_outer_graph(fast.values())
        if not outer:
            fast = {k: v.detach().requires_grad_() for k, v in fast.items()}
        with torch.enable_grad():
            for _ in range(n_steps):
                logits, _ = self._net({**params, **fast}, sup_x)
                grads = torch.autograd.grad(F.cross_entropy(logits, sup_y), list(fast.values()),
                                            create_graph=outer and second_order)
                fast = {k: w - self._inner_lr(k) * g for (k, w), g in zip(fast.items(), grads)}
                if not outer:
                    fast = {k: w.detach().requires_grad_() for k, w in fast.items()}
        return {**params, **fast}

    def _run(self, batch: EpisodeBatch, setting: EpisodeSetting, n_steps: int,
             second_order: bool = True) -> torch.Tensor:
        """``[E, G, way]`` query logits, each episode adapted on its own
        support and normalised over its own rows."""
        logits = []
        for e in range(batch.num_episodes):
            sup_x, sup_y = batch.support[e], batch.support_target[e].long()
            params = self._adapt(sup_x, sup_y, n_steps, second_order)
            logits.append(self._net(params, batch.query[e], batch.query_mask[e] > 0)[0])
        return torch.stack(logits)

    # -- method API ------------------------------------------------------------

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        return self._run(batch, setting, self.test_iter)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        seg_logits = self._run(batch, setting, self.train_iter)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))


@CLASSIFIERS.register("MAML")
class MAML(MAMLBase):
    """Full-network fast weights."""


@CLASSIFIERS.register("ANIL")
class ANIL(MAMLBase):
    """Head-only adaptation over features the backbone computes once per
    batch, with running-statistics BN."""

    requires_batch_stat_bn = False

    def _run(self, batch: EpisodeBatch, setting: EpisodeSetting, n_steps: int,
             second_order: bool = True) -> torch.Tensor:
        sup_f, qry_f = self.embed(batch)
        head = self.classifier.layers[0]
        w, b = adapt_linear_head(head.weight, head.bias, sup_f, batch.support_target, n_steps,
                                 self.inner_lr, second_order)
        return linear_logits(qry_f, w, b)


BOIL_TEST_MODES = ("Directly", "Once_update", "NIL")


@CLASSIFIERS.register("BOIL")
class BOIL(MAMLBase):
    """Body-only inner loop with per-group LRs and the reference's test
    modes (``testing_method``; ``inner_param.test_mode`` is an alias)."""

    def __init__(self, emb_func, feat_dim: int, inner_param: Optional[Dict] = None,
                 testing_method: Optional[str] = None, **kwargs):
        super().__init__(emb_func, feat_dim, inner_param=inner_param, **kwargs)
        inner_param = inner_param or {}
        self.extractor_lr = float(inner_param.get("extractor_lr", self.inner_lr))
        self.classifier_lr = float(inner_param.get("classifier_lr", 0.0))
        self.train_iter = int(inner_param.get("train_iter", 1))
        self.test_mode = str(testing_method or inner_param.get("test_mode", "Once_update"))
        if self.test_mode not in BOIL_TEST_MODES:
            raise ValueError(f"BOIL testing_method must be one of {BOIL_TEST_MODES}, "
                             f"got {self.test_mode!r}")

    def _inner_lr(self, name: str) -> float:
        return self.extractor_lr if name.startswith(_EMB) else self.classifier_lr

    def _nil_logits(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        """One body step, then the cosine of each query's adapted features to
        the class prototypes of the adapted support features."""
        logits = []
        for e in range(batch.num_episodes):
            sup_x, sup_y = batch.support[e], batch.support_target[e].long()
            params = self._adapt(sup_x, sup_y, 1)
            _, sup_f = self._net(params, sup_x)
            _, qry_f = self._net(params, batch.query[e], batch.query_mask[e] > 0)
            onehot = F.one_hot(sup_y, setting.way).to(sup_f.dtype)
            proto = (onehot.T @ sup_f) / onehot.sum(dim=0)[:, None].clamp(min=1.0)
            logits.append(F.normalize(qry_f, dim=-1, eps=1e-12)
                          @ F.normalize(proto, dim=-1, eps=1e-12).T)
        return torch.stack(logits)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        if self.test_mode == "Directly":
            return self._run(batch, setting, 0)
        if self.test_mode == "NIL":
            return self._nil_logits(batch, setting)
        return self._run(batch, setting, 1)
