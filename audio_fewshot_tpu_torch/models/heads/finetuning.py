"""The finetuning family: Baseline, BaselinePlus, NegNet, RFSModel and
SKDModel (counterpart of ``audio_fewshot_tpu/models/heads/finetuning.py``).

Training is global classification over all the train classes on flat
batches (``episode.FlatBatch``): ``loss`` runs the backbone in the module's
own mode and a ``classifier`` head of ``num_class`` outputs over its flat
features (``feat_dim``, which ``build_method`` states).  The head is
linear (Baseline, RFSModel, SKDModel; the reference's ``nn.Linear``), or
cosine, bias-free: scale · f̂ · wᵀ with f̂ = f / (‖f‖ + 1e-5) and the
unnormalised weight rows (BaselinePlus; scale 2 for up to 200 classes, else
10), or NegNet's plain cosine with normalised rows, scale_factor ·
(cos − margin · onehot).  Weights are drawn as flax's ``Dense``.

Evaluation adapts a fresh head to each episode's support set with the
backbone frozen, all episodes of a batch at once:

- Baseline, BaselinePlus and NegNet take ``inner_train_iter`` ×
  ⌈n_support / ``inner_batch_size``⌉ full-batch steps of SGD with momentum
  and coupled weight decay (``sgd_head_steps``, optax's
  ``add_decayed_weights`` → ``trace`` → ``scale(-lr)``: d = g + wd·p, buf =
  d + m·buf, p −= lr·buf), from zero (the linear head) or from the class
  prototypes (the cosine heads; NegNet's rows ``[way, D]`` with its
  ``inner_margin`` and ``inner_scale_factor`` and the 1e-12 clamps of
  ``F.normalize``).  The gradients are written out (``linear_head_gradient``,
  ``cosine_head_gradient``, ``negnet_head_gradient``): the heads are linear
  in their weights but for NegNet's row normalisation, and autograd in the
  loop made Baseline's eval step 43 % slower on the card (PERF.md);
- RFSModel and SKDModel fit a converged L2-penalised multinomial
  logistic regression (``sklearn_probe_logits``, C = 1) on L2-normalised
  features.

SKDModel's generation 0 trains on ``[x, time-flip, freq-flip, both]``
(90° turns would not keep a ``[1, 128, 157]`` segment's shape): γ·CE of
the class logits at the targets four times + α·the mean sigmoid BCE of
``rot_classifier`` (over the class logits) against the flip's index.  Its
generation 1 and RFSModel's distillation need a teacher, which only
``set_teacher`` gives (no entry point sets one, in either package).

Over several ranks (``parallel``) each rank takes its contiguous shard of a
flat batch.  ``flat_features`` runs the backbone inside ``sharded_rows``,
so train-mode BatchNorm takes its moments over every rank's rows (SKDModel's
flip copies included: the moments are sums, whatever the rows' order);
eval-mode calls (the teacher, the featuring pass) read running statistics,
which the mark leaves alone.  Every loss of the family, the pretrainers'
too, is a mean over this rank's rows, equal in number on every rank, so
the mean of the ranks' gradients is the whole batch's and no count needed
making global.  S2M2's mixup and IfslPretrain's featuring sums span the
whole batch: both gather or sum over the ranks (``pretrains.S2M2.mix``,
``Trainer.featuring_sums``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...episode import EpisodeBatch, FlatBatch
from ...parallel.collectives import sharded_rows
from ...registry import CLASSIFIERS
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType
from ..init import dense
from ..losses import cross_entropy, distill_kl_loss, l2_dist_loss

#: the probe's step sizes tried at once by its line search (largest first)
_PROBE_STEPS = tuple(2.0 ** k for k in range(2, -13, -1))
#: the probe's L-BFGS iterations and memory (the JAX package's optax L-BFGS)
_PROBE_ITERS, _PROBE_MEMORY = 128, 10
# the probe line search's Armijo and (strong) curvature constants
_ARMIJO, _CURVATURE = 1e-4, 0.9


def _wide(x: torch.Tensor) -> torch.Tensor:
    """Float32 at least (float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def cosine_scores(feats: torch.Tensor, weights: torch.Tensor, scale: float,
                  normalize_weights: bool = False) -> torch.Tensor:
    """scale · f̂ · wᵀ, f̂ = f / (‖f‖ + 1e-5), over ``weights`` ``[C, D]``
    rows (normalised the same way with ``normalize_weights``)."""
    f = feats / (feats.norm(dim=-1, keepdim=True) + 1e-5)
    w = weights
    if normalize_weights:
        w = w / (w.norm(dim=-1, keepdim=True) + 1e-5)
    return scale * torch.matmul(f, w.transpose(-1, -2))


def linear_head_gradient(x: torch.Tensor, onehot: torch.Tensor) -> Callable:
    """The gradient in ``(w [E, D, way], b [E, way])`` of each episode's mean
    cross-entropy of ``x·w + b`` over ``x`` [E, N, D] at ``onehot``."""
    n = x.shape[1]

    def gradient(w, b):
        r = (torch.softmax(torch.baddbmm(b[:, None], x, w), dim=-1) - onehot) / n
        return x.mT @ r, r.sum(dim=1)

    return gradient


def cosine_head_gradient(x: torch.Tensor, onehot: torch.Tensor, scale: float) -> Callable:
    """The gradient in ``w`` [E, D, way] of each episode's mean
    cross-entropy of ``scale · x·w`` (``x`` the normalised features)."""
    n = x.shape[1]

    def gradient(w):
        r = (torch.softmax(scale * (x @ w), dim=-1) - onehot) / n
        return (scale * (x.mT @ r),)

    return gradient


def negnet_head_gradient(x: torch.Tensor, onehot: torch.Tensor, scale: float,
                         margin: float) -> Callable:
    """The gradient in ``w`` [E, way, D] of each episode's mean
    cross-entropy of ``scale · (x·ŵᵀ − margin · onehot)``, ŵ the rows over
    ‖w‖ clamped at 1e-12 (``F.normalize``'s)."""
    n = x.shape[1]

    def gradient(w):
        norm = w.norm(dim=-1, keepdim=True)
        wn = w / norm.clamp(min=1e-12)
        r = (torch.softmax(scale * (x @ wn.mT - margin * onehot), dim=-1) - onehot) / n
        g_unit = scale * (r.mT @ x)  # the gradient at the normalised rows
        radial = wn * (wn * g_unit).sum(dim=-1, keepdim=True)
        return (torch.where(norm > 1e-12, (g_unit - radial) / norm, g_unit / 1e-12),)

    return gradient


def sgd_head_steps(params: Sequence[torch.Tensor], grads: Callable, n_steps: int, lr: float,
                   momentum: float, weight_decay: float) -> List[torch.Tensor]:
    """``params`` after ``n_steps`` SGD steps with momentum and coupled
    weight decay on the gradients ``grads(*params)`` gives (torch's ``SGD``,
    optax's ``add_decayed_weights`` → ``trace`` → ``scale(-lr)``): d = g +
    wd·p, buf = d + m·buf from buf = 0, p −= lr·buf.  Updates in place."""
    params = [p.clone() for p in params]
    bufs = [torch.zeros_like(p) for p in params]
    for _ in range(n_steps):
        for p, g, buf in zip(params, grads(*params), bufs):
            buf.mul_(momentum).add_(g.add_(p, alpha=weight_decay))
            p.sub_(buf, alpha=lr)
    return params


@torch.no_grad()
def sklearn_probe_logits(sup_f: torch.Tensor, sup_y: torch.Tensor, qry_f: torch.Tensor,
                         way: int, C: float) -> torch.Tensor:
    """Query logits ``[E, G, way]`` of the minimiser of

        0.5·‖W‖² + C · Σᵢ CE(xᵢ·W + b, yᵢ)

    for each episode of ``sup_f`` ``[E, N, D]`` (the intercept unpenalised),
    the objective sklearn's ``LogisticRegression(C=C)`` minimises.  It is
    strictly convex in W, so any solver that reaches the optimum gives the
    same logits; the intercept is fixed up to a constant, which no softmax
    sees.  A batched L-BFGS (``_PROBE_MEMORY`` pairs) over the episodes,
    ``_PROBE_ITERS`` iterations with no read back to the host: each
    iteration's line search
    scores every step size of ``_PROBE_STEPS`` at once (the logits are
    affine in the step), takes the lowest objective among those meeting the
    strong Wolfe conditions, else among those meeting Armijo's, else no
    step, and then restarts that episode's memory.  Curvature pairs with
    sᵀy ≤ 0 are left out.  It runs in float64 and returns the logits in the
    features' dtype: the line search compares objective values, which
    float32 stops resolving about 1e-3 of the logits away from the optimum
    (as the JAX package's float32 probe, 2e-3 from sklearn's), so two
    float32 runs whose features differ in the last bits would stop at
    different points."""
    out_dtype = _wide(sup_f).dtype
    x, q = sup_f.double(), qry_f.double()
    e, n, d = x.shape
    y = F.one_hot(sup_y.long(), way).to(x.dtype)  # [E, N, way]
    split = d * way
    memory = _PROBE_MEMORY

    def parts(p):
        return p[:, :split].reshape(e, d, way), p[:, split:]

    def logits_of(p, feats):
        w, b = parts(p)
        return torch.baddbmm(b[:, None], feats, w)

    def gradient(p, logits):
        w, _ = parts(p)
        r = C * (torch.softmax(logits, dim=-1) - y)
        return torch.cat([(w + x.mT @ r).flatten(1), r.sum(dim=1)], dim=1)

    steps = torch.tensor((0.0,) + _PROBE_STEPS, dtype=x.dtype, device=x.device)
    p = x.new_zeros((e, split + way))
    logits = logits_of(p, x)
    g = gradient(p, logits)
    s_mem = x.new_zeros((memory, e, p.shape[1]))
    y_mem = torch.zeros_like(s_mem)
    rho = x.new_zeros((memory, e))
    gamma = x.new_ones((e,))
    for it in range(_PROBE_ITERS):
        # two-loop recursion: d = −H·g
        r = g.clone()
        history = [j % memory for j in range(max(0, it - memory), it)]
        alphas = {}
        for j in reversed(history):
            alphas[j] = rho[j] * torch.linalg.vecdot(s_mem[j], r)
            r -= alphas[j][:, None] * y_mem[j]
        r *= gamma[:, None]
        for j in history:
            beta = rho[j] * torch.linalg.vecdot(y_mem[j], r)
            r += (alphas[j] - beta)[:, None] * s_mem[j]
        direction = -r
        # the line search: every step size at once
        w, _ = parts(p)
        dw, db = parts(direction)
        ld = torch.baddbmm(db[:, None], x, dw)  # the logits' change per unit step
        la = logits[:, None] + steps[None, :, None, None] * ld[:, None]  # [E, K, N, way]
        w, dw = w.flatten(1), dw.flatten(1)
        w_dw = torch.linalg.vecdot(w, dw)[:, None]
        dw_dw = torch.linalg.vecdot(dw, dw)[:, None]
        w_w = torch.linalg.vecdot(w, w)[:, None]
        ce = (torch.logsumexp(la, dim=-1) - (la * y[:, None]).sum(dim=-1)).sum(dim=-1)
        phi = 0.5 * (w_w + 2 * steps * w_dw + steps ** 2 * dw_dw) + C * ce
        dphi = (w_dw + steps * dw_dw
                + C * ((torch.softmax(la, dim=-1) - y[:, None]) * ld[:, None]).sum(dim=(-1, -2)))
        armijo = phi <= phi[:, :1] + _ARMIJO * steps * dphi[:, :1]
        armijo[:, 0] = False
        wolfe = armijo & (dphi.abs() <= _CURVATURE * dphi[:, :1].abs())
        inf = torch.full_like(phi, math.inf)
        pick = torch.where(wolfe.any(dim=1), torch.where(wolfe, phi, inf).argmin(dim=1),
                           torch.where(armijo, phi, inf).argmin(dim=1))
        step = torch.where(armijo.any(dim=1), steps[pick], torch.zeros_like(gamma))
        s = step[:, None] * direction
        p = p + s
        logits = logits_of(p, x)
        g_new = gradient(p, logits)
        yv = g_new - g
        g = g_new
        sy, yy = torch.linalg.vecdot(s, yv), torch.linalg.vecdot(yv, yv)
        keep = sy > 0
        slot = it % memory
        s_mem[slot], y_mem[slot] = s, yv
        rho[slot] = torch.where(keep, 1.0 / torch.where(keep, sy, 1.0), torch.zeros_like(sy))
        gamma = torch.where(keep, sy / torch.where(keep, yy, 1.0), gamma)
        # no acceptable step: restart that episode's memory (steepest descent)
        stalled = step == 0
        rho = torch.where(stalled[None], torch.zeros_like(rho), rho)
        gamma = torch.where(stalled, torch.ones_like(gamma), gamma)
    return logits_of(p, q).to(out_dtype)


def reference_matched_adaptation(head_kind: str, init_params: Dict[str, torch.Tensor],
                                 sup_f: torch.Tensor, sup_y: torch.Tensor, qry_f: torch.Tensor,
                                 perms: Sequence, batch_size: int, lr: float, momentum: float,
                                 weight_decay: float, way: int, margin: float = 0.0,
                                 scale: float = 1.0) -> torch.Tensor:
    """The query logits ``[Q, way]`` after the reference's
    ``set_forward_adaptation`` loop of one episode (its Baseline,
    BaselinePlus, S2M2 and NegNet): minibatch SGD over the given
    permutation schedule ``perms`` (one ``randperm`` of the support rows
    each), torch ``optim.SGD``'s step (d = g + wd·p; buf = d at the first
    step, else m·buf + d; p −= lr·buf), from the head's initial parameters.
    For users who need the reference's own eval adaptation rather than
    the full-batch steps of ``FinetuningBase``.  In float32.

    ``head_kind``:
      - ``"linear"``: {weight [way, D], bias [way]}, plain logits;
      - ``"dist_linear"``: {weight_g [way, 1], weight_v [way, D]} (torch's
        WeightNorm at dim 0), logits scale · (x / (‖x‖ + 1e-5)) @ (g·v /
        ‖v‖)ᵀ;
      - ``"neg_cosine"``: {weight [way, D]}, the inner steps' logits less
        ``margin`` at the true class before × scale, the query logits the
        plain cosine × scale (``F.normalize``'s 1e-12 clamps)."""
    if head_kind not in ("linear", "dist_linear", "neg_cosine"):
        raise ValueError(f"unknown head_kind {head_kind!r}: linear, dist_linear or neg_cosine")
    params = {k: torch.as_tensor(v, dtype=torch.float32, device=sup_f.device).clone()
              for k, v in init_params.items()}
    sup_f, qry_f, sup_y = sup_f.float(), qry_f.float(), sup_y.long()

    def head_logits(p, x, labels=None):
        if head_kind == "linear":
            return x @ p["weight"].T + p["bias"]
        if head_kind == "dist_linear":
            v = p["weight_v"]
            w = p["weight_g"] * v / v.norm(dim=1, keepdim=True)
            return scale * ((x / (x.norm(dim=1, keepdim=True) + 1e-5)) @ w.T)
        w = p["weight"]
        cos = ((x / x.norm(dim=1, keepdim=True).clamp(min=1e-12))
               @ (w / w.norm(dim=1, keepdim=True).clamp(min=1e-12)).T)
        if labels is None:
            return cos * scale
        return (cos - margin * F.one_hot(labels, way).to(cos.dtype)) * scale

    bufs = {k: torch.zeros_like(v) for k, v in params.items()}
    step = 0
    for perm in perms:
        perm = torch.as_tensor(perm, dtype=torch.long, device=sup_f.device)
        for i in range(0, sup_f.shape[0], batch_size):
            sel = perm[i:i + batch_size]
            live = {k: v.detach().requires_grad_() for k, v in params.items()}
            labels = sup_y[sel]
            with torch.enable_grad():
                loss = cross_entropy(head_logits(live, sup_f[sel], labels
                                                 if head_kind == "neg_cosine" else None), labels)
                grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
            for k in params:
                d = grads[k] + weight_decay * params[k]
                bufs[k] = d if (step == 0 and momentum) else momentum * bufs[k] + d
                params[k] = params[k] - lr * (bufs[k] if momentum else d)
            step += 1
    with torch.no_grad():
        return head_logits(params, qry_f)


def _normalize_probe_features(f: torch.Tensor) -> torch.Tensor:
    return f / (f.norm(dim=-1, keepdim=True) + 1e-5)


class FinetuningBase(MethodBase):
    model_type = ModelType.FINETUNING
    #: every flat loss of the family is a mean over equal shards (the
    #: module docstring)
    shardable = True
    #: ``build_method`` passes the backbone's flat feature width as ``feat_dim``
    needs_feat_dim = True
    #: the global head's kind, in training and in the eval adaptation:
    #: "linear" or "cosine"
    head_kind = "linear"

    def __init__(self, emb_func, feat_dim: int, num_class: int = 25,
                 inner_param: Optional[Dict] = None, way_num: int = 5, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.num_class = num_class
        self.feat_dim = feat_dim
        self.way_num = way_num
        inner = dict(inner_param or {})
        self.inner_steps = int(inner.get("inner_train_iter", 20))
        self.inner_batch = int(inner.get("inner_batch_size", 4))
        opt = dict(inner.get("inner_optim") or {})
        self.inner_lr = float(opt.get("lr", 0.01))
        self.inner_momentum = float(opt.get("momentum", 0.9) or 0.0)
        # a shipped inner_optim without weight_decay (BaselinePlus) gets 1e-3
        self.inner_wd = float(opt.get("weight_decay", 1e-3) or 0.0)
        self.teacher: Optional[MethodBase] = None
        self.classifier = self._global_head()

    def _global_head(self) -> Optional[nn.Module]:
        """``classifier``: the global head of ``head_kind`` (None where a
        subclass trains another head)."""
        return dense(self.feat_dim, self.num_class, bias=self.head_kind == "linear")

    # -- global classification (training) -------------------------------------------------

    def set_teacher(self, teacher: Optional[MethodBase]) -> None:
        """The frozen teacher of a distillation generation (a method of the
        same class), kept out of this method's modules and state dict."""
        object.__setattr__(self, "teacher", teacher)

    def flat_features(self, x: torch.Tensor) -> torch.Tensor:
        """The backbone's flat features of ``x`` (a flat batch, or copies of
        one: its rows span the ranks)."""
        with sharded_rows():
            feats = self.emb_func(x)
        return _wide(feats.reshape(feats.shape[0], -1))

    def global_logits(self, feats: torch.Tensor) -> torch.Tensor:
        if self.head_kind == "linear":
            return self.classifier(feats)
        scale = 2.0 if self.num_class <= 200 else 10.0
        return cosine_scores(feats, self.classifier.weight, scale)

    def _train_loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return cross_entropy(logits, target)

    @torch.no_grad()
    def teacher_logits(self, x: torch.Tensor) -> torch.Tensor:
        """The teacher's global logits of ``x`` (its backbone in eval mode)."""
        self.teacher.eval()
        return self.teacher.global_logits(self.teacher.flat_features(x))

    def loss(self, batch: FlatBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        flat_only(batch)
        logits = self.global_logits(self.flat_features(batch.data))
        loss = self._train_loss(logits, batch.target)
        return loss, LossOutput(logits, {"acc": _accuracy(logits, batch.target)})

    def backbone_rows(self, batch_size: int) -> int:
        """Segments through the backbones in one train step of ``batch_size``."""
        return batch_size * (2 if self._distills() else 1)

    def _distills(self) -> bool:
        return bool(getattr(self, "is_distill", False)) and self.teacher is not None

    def _distilled(self, loss: torch.Tensor, out: LossOutput,
                   batch: FlatBatch) -> Tuple[torch.Tensor, LossOutput]:
        """The loss plus α·KL to the teacher's logits (born-again
        distillation), when a teacher is set."""
        if self._distills():
            loss = loss + self.alpha * distill_kl_loss(
                out.seg_logits, self.teacher_logits(batch.data), self.kd_T)
        return loss, out

    # -- per-episode adaptation (evaluation) ------------------------------------------------

    def _adapt_steps(self, n_support: int) -> int:
        """``inner_train_iter`` epochs of ⌈n_support / ``inner_batch_size``⌉
        steps, each a full-batch step here."""
        return self.inner_steps * max(1, -(-n_support // self.inner_batch))

    @torch.no_grad()
    def episode_head_logits(self, sup_f: torch.Tensor, sup_y: torch.Tensor,
                            qry_f: torch.Tensor, way: int) -> torch.Tensor:
        """Query logits ``[E, G, way]`` of a head adapted to each episode's
        support features ``[E, N, D]``."""
        sup_f, qry_f = _wide(sup_f), _wide(qry_f)
        e, n, d = sup_f.shape
        onehot = F.one_hot(sup_y.long(), way).to(sup_f.dtype)
        sgd = dict(n_steps=self._adapt_steps(n), lr=self.inner_lr,
                   momentum=self.inner_momentum, weight_decay=self.inner_wd)
        if self.head_kind == "linear":
            w, b = sgd_head_steps((sup_f.new_zeros((e, d, way)), sup_f.new_zeros((e, way))),
                                  linear_head_gradient(sup_f, onehot), **sgd)
            return torch.baddbmm(b[:, None], qry_f, w)
        # the cosine head: linear in its weights over normalised features,
        # started from the class prototypes
        scale = 2.0 if way <= 200 else 10.0
        x = sup_f / (sup_f.norm(dim=-1, keepdim=True) + 1e-5)
        w0 = (sup_f.mT @ onehot) / onehot.sum(dim=1).clamp(min=1.0)[:, None]
        w, = sgd_head_steps((w0,), cosine_head_gradient(x, onehot, scale), **sgd)
        return scale * cosine_scores(qry_f, w.mT, 1.0)

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup_f, qry_f = self.embed(batch)
        return self.episode_head_logits(sup_f, batch.support_target, qry_f, setting.way)


def flat_only(batch) -> None:
    """Raise unless ``batch`` is a ``FlatBatch`` (FINETUNING training)."""
    if not isinstance(batch, FlatBatch):
        raise TypeError("FINETUNING methods train on flat batches (episode.FlatBatch)")


def _accuracy(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == target).float().mean() * 100.0


@CLASSIFIERS.register("Baseline")
class Baseline(FinetuningBase):
    """The linear global head, and a fresh linear head (from zero) adapted
    to each episode."""


@CLASSIFIERS.register("BaselinePlus")
class BaselinePlus(FinetuningBase):
    """The cosine head (Baseline++) in training and in the adaptation."""

    head_kind = "cosine"


@CLASSIFIERS.register("NegNet")
class NegNet(FinetuningBase):
    """Negative-margin cosine softmax: plain cosine (normalised rows) in
    training, scale_factor · (cos − margin · onehot); the adaptation trains
    a NegLayer with ``inner_margin`` / ``inner_scale_factor`` (the global
    ones by default) from the class prototypes, and scores the queries'
    plain cosine × ``inner_scale_factor``."""

    head_kind = "cosine"

    def __init__(self, emb_func, margin: float = -0.01, scale_factor: float = 30.0, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.margin = margin
        self.scale_factor = scale_factor
        inner = dict(kwargs.get("inner_param") or {})
        self.inner_margin = float(inner.get("inner_margin", margin))
        self.inner_scale = float(inner.get("inner_scale_factor", scale_factor))

    def global_logits(self, feats: torch.Tensor) -> torch.Tensor:
        return cosine_scores(feats, self.classifier.weight, 1.0, normalize_weights=True)

    def _train_loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        onehot = F.one_hot(target.long(), logits.shape[-1]).to(logits.dtype)
        return cross_entropy(self.scale_factor * (logits - self.margin * onehot), target)

    @torch.no_grad()
    def episode_head_logits(self, sup_f, sup_y, qry_f, way: int) -> torch.Tensor:
        sup_f, qry_f = _wide(sup_f), _wide(qry_f)
        onehot = F.one_hot(sup_y.long(), way).to(sup_f.dtype)  # [E, N, way]
        s = self.inner_scale

        def unit(v):
            return v / v.norm(dim=-1, keepdim=True).clamp(min=1e-12)

        w0 = (onehot.mT @ sup_f) / onehot.sum(dim=1).clamp(min=1.0)[..., None]  # [E, way, D]
        w, = sgd_head_steps((w0,), negnet_head_gradient(unit(sup_f), onehot, s, self.inner_margin),
                            self._adapt_steps(sup_f.shape[1]), self.inner_lr,
                            self.inner_momentum, self.inner_wd)
        return s * (unit(qry_f) @ unit(w).mT)


class _ProbeEval:
    """Evaluation by the converged logistic-regression probe at
    ``probe_c`` on L2-normalised (+1e-5) features."""

    probe_c = 1.0

    @torch.no_grad()
    def episode_head_logits(self, sup_f, sup_y, qry_f, way: int) -> torch.Tensor:
        return sklearn_probe_logits(_normalize_probe_features(_wide(sup_f)), sup_y,
                                    _normalize_probe_features(_wide(qry_f)), way, self.probe_c)


@CLASSIFIERS.register("RFSModel")
class RFSModel(_ProbeEval, FinetuningBase):
    """Rethinking few-shot: global CE (+ α·KL to a teacher at ``kd_T`` with
    ``is_distill`` and a teacher set); evaluated by the probe at C = 1."""

    def __init__(self, emb_func, is_distill: bool = False, kd_T: float = 4.0,
                 alpha: float = 0.5, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.is_distill = is_distill
        self.kd_T = kd_T
        self.alpha = alpha

    def loss(self, batch: FlatBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        return self._distilled(*super().loss(batch, setting), batch)


@CLASSIFIERS.register("SKDModel")
class SKDModel(_ProbeEval, FinetuningBase):
    """Self-supervised knowledge distillation; evaluated by the probe at
    C = 1.  Generation 0 (no teacher): the four flips, γ·CE + α·BCE of the
    flip head.  Generation 1 (``is_distill`` and a teacher): ``[x, both
    flips]``, γ·KL(class logits of x ‖ the teacher's at ``kd_T``) +
    α·``l2_dist_loss``(flipped, original) / 3."""

    def __init__(self, emb_func, gamma: float = 1.0, alpha: float = 1.0,
                 is_distill: bool = False, kd_T: float = 4.0, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.gamma = gamma
        self.alpha = alpha
        self.is_distill = is_distill
        self.kd_T = kd_T
        # the flip head reads the class logits
        self.rot_classifier = dense(self.num_class, 4)

    def backbone_rows(self, batch_size: int) -> int:
        return batch_size * (3 if self._distills() else 4)

    def loss(self, batch: FlatBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        flat_only(batch)
        x, b = batch.data, batch.data.shape[0]
        if self._distills():
            copies = torch.cat([x, torch.flip(x, (-2, -1))])
            logits = self.global_logits(self.flat_features(copies))
            gamma_loss = distill_kl_loss(logits[:b], self.teacher_logits(x), self.kd_T)
            alpha_loss = l2_dist_loss(logits[b:], logits[:b]) / 3.0
        else:
            copies = torch.cat([x, torch.flip(x, (-1,)), torch.flip(x, (-2,)),
                                torch.flip(x, (-2, -1))])
            logits = self.global_logits(self.flat_features(copies))
            gamma_loss = cross_entropy(logits, batch.target.repeat(4))
            flips = torch.arange(4, device=x.device).repeat_interleave(b)
            alpha_loss = F.binary_cross_entropy_with_logits(
                self.rot_classifier(logits), F.one_hot(flips, 4).to(logits.dtype))
        loss = self.gamma * gamma_loss + self.alpha * alpha_loss
        return loss, LossOutput(logits[:b], {"acc": _accuracy(logits[:b], batch.target)})
