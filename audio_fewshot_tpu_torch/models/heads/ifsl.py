"""DMatchingNet, interventional few-shot learning over a matching network,
and IfslPretrain, the pretrainer of its classifier and class-mean features
(counterpart of ``DMatchingNet`` and ``IfslPretrain`` in
``audio_fewshot_tpu/models/heads/ifsl.py``).

The flat features are cut into ``n_splits`` chunks; each gets a
"d-feature" from a pretrained classifier (``d_feature: pd``, its softmax
probabilities over ``class_num`` classes, under ``no_grad``; ``ed``, their
product with the class-mean features of ``feature_path``, cut the same
way).  Per split a ``MatchingNetLayer`` refines support and queries: a
bidirectional LSTM over the support set, ``g = support + fwd + bwd``, and
the FCE attention LSTM over each query, ``k = n_support`` steps from ``h =
query``, ``c = 0``: ``a = softmax(h gᵀ)``, an LSTM cell over ``[query ‖
a g]``, then ``h = h + query``.  Scores are ``relu(cos(f, g))``:

- dual branch (``single: false``, as shipped): an ``x_block`` over the
  split and a ``d_block`` over the d-feature per split, fused by
  ``logit_fusion`` (``product``: log(σ(x)·σ(d))) times ``temp``, less the
  counterfactual score (x = 1) before the softmax over the support;
- ``single``: one block per split over ``[split ‖ d]``, its counterfactual
  the queries replaced by the support's mean split (or zeros, ``x_zero``).

The per-split attention is averaged, summed per class and logged (+ 1e-6):
log-probabilities, the loss their masked mean NLL.  ``_l2n`` is ``x / (‖x‖
+ 1e-5)``.  Without ``feature_path`` the class-mean features are zeros;
``cls_path`` names IfslPretrain's saved ``classifier`` part, which loads
into ``utils.linear`` at construction (without it the pretrained classifier
starts at random).

IfslPretrain trains the backbone and a linear ``classifier`` with global
cross-entropy on flat batches, validates with euclidean prototypes, and with
``ifsl_pretrain_param.featuring`` runs ``Trainer.run_featuring`` instead of
training: one eval-mode pass over the train split's flat epoch whose
per-class mean features (``class_sums``; ``x / (‖x‖ + 1e-5)`` first with
``norm``) go to ``feature_path`` as float32 ``[num_class, D]``, the
artifact DMatchingNet's ``feature_path`` reads.  Classes the pass does not
see keep zero rows.

Batch statistics belong to each episode's role (``requires_batch_stat_bn``):
the episodes run one after another, support and query through separate
backbone calls, the query call masked to its real rows.  Conv64F's logits
BN1d keeps running statistics (``backbone_kwarg_defaults``): in training
its EMA compounds support → query within an episode, and the JAX package
averages the episodes' results, so the statistics are restored before each
episode and their mean written back after the last (over several ranks, the
mean over every rank's episodes).  The heads run over
all episodes at once, one LSTM batch per block.

Keys (the reference's): ``utils.linear.*``; ``{x_blocks,d_blocks|blocks}.{j}
.G_encoder.{weight,bias}_{ih,hh}_l0[_reverse]`` and ``.FCE.lstmcell.*``
(gate order i|f|g|o; flax's one bias per gate is ``bias_ih``, ``bias_hh``
is 0 and frozen).
"""

from __future__ import annotations

import inspect
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.batchnorm import _BatchNorm

from ...episode import EpisodeBatch, segment_targets
from ...parallel.collectives import all_reduce_mean, sharded_world
from ...registry import CLASSIFIERS
from ...utils.checkpoint import load_part, read_part
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType
from ..init import dense, lecun_normal_
from .pretrains import GlobalPretrain

PREPROCESS_MODES = ("none", "l2n", "cl2n")


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / (x.norm(dim=-1, keepdim=True) + 1e-5)


@torch.no_grad()
def _flax_lstm_init(weight_ih, weight_hh, bias_ih, bias_hh) -> None:
    """flax's ``OptimizedLSTMCell`` draws per gate: lecun_normal input
    kernels, orthogonal recurrent kernels, zero bias.  flax has one bias per
    gate: it is ``bias_ih``; ``bias_hh`` stays 0 and takes no gradient, so
    training moves the gates' bias as flax's one bias moves."""
    for w in weight_ih.chunk(4):
        lecun_normal_(w)
    for w in weight_hh.chunk(4):
        nn.init.orthogonal_(w)
    bias_ih.zero_()
    bias_hh.zero_()
    bias_hh.requires_grad_(False)


class FullyContextualEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.lstmcell = nn.LSTMCell(2 * dim, dim)
        c = self.lstmcell
        _flax_lstm_init(c.weight_ih, c.weight_hh, c.bias_ih, c.bias_hh)

    def forward(self, query: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """``query`` [E, G, d] attending over ``g`` [E, ns, d] → [E, G, d]."""
        e, n, d = query.shape
        flat_query = query.reshape(-1, d)
        h, c = flat_query, torch.zeros_like(flat_query)
        for _ in range(g.shape[1]):
            a = torch.softmax(torch.bmm(h.view(e, n, d), g.mT), dim=-1)
            x = torch.cat([flat_query, torch.bmm(a, g).reshape(-1, d)], dim=-1)
            h, c = self.lstmcell(x, (h, c))
            h = h + flat_query
        return h.view(e, n, d)


class MatchingNetLayer(nn.Module):
    """Bidirectional LSTM over the support set (``G_encoder``) and the FCE
    attention LSTM over the queries."""

    def __init__(self, dim: int):
        super().__init__()
        self.G_encoder = nn.LSTM(dim, dim, batch_first=True, bidirectional=True)
        for sfx in ("", "_reverse"):
            _flax_lstm_init(*(getattr(self.G_encoder, f"{k}_l0{sfx}")
                              for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))
        self.FCE = FullyContextualEmbedding(dim)

    def encode(self, support: torch.Tensor) -> torch.Tensor:
        """``g`` [E, ns, d] = support + forward + backward states."""
        out, _ = self.G_encoder(support)
        fwd, bwd = out.chunk(2, dim=-1)
        return support + fwd + bwd

    def forward(self, support: torch.Tensor, query: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        g = self.encode(support)
        return g, self.FCE(query, g)


class IFSLUtils(nn.Module):
    """The pretrained classifier (``linear``) and the class-mean features."""

    def __init__(self, feat_dim: int, class_num: int, features: np.ndarray):
        super().__init__()
        self.linear = dense(feat_dim, class_num)
        self.register_buffer("features", torch.from_numpy(features), persistent=False)


def _cosine_scores(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return F.relu(torch.bmm(_l2n(f), _l2n(g).mT))


@CLASSIFIERS.register("DMatchingNet")
class DMatchingNet(MethodBase):
    model_type = ModelType.META
    shardable = True
    requires_batch_stat_bn = True
    backbone_kwarg_defaults = {"logits_bn_running_statistics": True}
    #: ``build_method`` passes the backbone's flat feature width as
    #: ``feat_dim`` (the split width is ``feat_dim / n_splits``)
    needs_feat_dim = True

    def __init__(self, emb_func, feat_dim: int, inner_param=None,
                 ifsl_param: Optional[Dict] = None, way_num: int = 5, **kwargs):
        super().__init__(emb_func, **kwargs)
        self._mask_kw = "sample_mask" in inspect.signature(type(emb_func).forward).parameters
        p = dict(ifsl_param or {})
        self.n_splits = int(p.get("n_splits", 4))
        self.temp = float(p.get("temp", 10.0))
        self.class_num = int(p.get("class_num", p.get("num_classes", 25)))
        self.d_feature = str(p.get("d_feature", "pd"))
        self.logit_fusion = str(p.get("logit_fusion", "product"))
        self.use_counterfactual = bool(p.get("use_counterfactual", True))
        self.use_x_only = bool(p.get("use_x_only", False))
        self.single = bool(p.get("single", False)) and not self.use_x_only
        self.fusion = str(p.get("fusion", "concat"))
        self.x_zero = bool(p.get("x_zero", False))
        self.preprocess_before_split = str(p.get("preprocess_before_split", "none"))
        self.preprocess_after_split = str(p.get("preprocess_after_split", "none"))
        self.normalize_before_center = bool(p.get("normalize_before_center", False))
        self.normalize_ed = bool(p.get("normalize_ed", False))
        for mode in (self.preprocess_before_split, self.preprocess_after_split):
            if mode not in PREPROCESS_MODES:
                raise ValueError(f"unsupported preprocess mode {mode!r}; choose from "
                                 f"{PREPROCESS_MODES}")
        if feat_dim % self.n_splits:
            raise ValueError(f"feature width {feat_dim} does not split into {self.n_splits}")
        self.split_dim = feat_dim // self.n_splits
        d_dim = self.class_num if self.d_feature == "pd" else self.split_dim
        if p.get("feature_path"):
            features = np.load(p["feature_path"]).astype(np.float32)
            if features.shape != (self.class_num, feat_dim):
                raise ValueError(f"feature_path holds {features.shape}, expected "
                                 f"{(self.class_num, feat_dim)}")
        else:
            features = np.zeros((self.class_num, feat_dim), np.float32)
        if p.get("normalize_d", False):
            features = features / (np.linalg.norm(features, axis=1, keepdims=True) + 1e-5)
        self.utils = IFSLUtils(feat_dim, self.class_num, features)
        if p.get("cls_path"):
            self.utils.linear.load_state_dict(read_part(p["cls_path"], "classifier"))
        if self.single:
            fused = self.split_dim + (self.class_num if self.d_feature == "pd" else
                                      self.split_dim if self.fusion == "concat" else 0)
            self.blocks = nn.ModuleList(MatchingNetLayer(fused) for _ in range(self.n_splits))
        else:
            self.x_blocks = nn.ModuleList(MatchingNetLayer(self.split_dim)
                                          for _ in range(self.n_splits))
            self.d_blocks = nn.ModuleList(MatchingNetLayer(d_dim) for _ in range(self.n_splits))

    # -- features --------------------------------------------------------------

    def _split(self, x: torch.Tensor) -> List[torch.Tensor]:
        return list(x.split(self.split_dim, dim=-1))

    def _preprocess(self, x: torch.Tensor, center: torch.Tensor, mode: str) -> torch.Tensor:
        if mode == "none":
            return x
        if mode == "l2n":
            return _l2n(x)
        if self.normalize_before_center:
            x = _l2n(x)
        return _l2n(x - center)

    def _get_feature(self, x: torch.Tensor) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """``x`` [E, n, D] → the preprocessed splits and the d-features, one
        ``[E, n, ·]`` of each per split."""
        with torch.no_grad():
            pd = torch.softmax(self.utils.linear(x), dim=-1)
        if self.d_feature == "pd":
            x_d = [pd] * self.n_splits
        else:
            x_d = self._split(pd @ self.utils.features)
        if self.normalize_ed:
            x_d = [_l2n(d) for d in x_d]
        center = self.utils.features.mean(dim=0)
        x = self._preprocess(x, center, self.preprocess_before_split)
        splits = [self._preprocess(s, c, self.preprocess_after_split)
                  for s, c in zip(self._split(x), self._split(center))]
        return splits, x_d

    def _fuse_proba(self, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid
        if self.logit_fusion == "linear_sum":
            return p1 + p2
        if self.logit_fusion == "sum":
            return torch.log(s(p1 + p2))
        if self.logit_fusion == "harmonic":
            p = s(p1) * s(p2)
            return torch.log(p / (1 + p))
        return torch.log((s(p1) * s(p2)).clamp(min=1e-12))  # "product"

    def _fuse_features(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.fusion == "concat":
            return torch.cat([x1, x2], dim=-1)
        return x1 + x2 if self.fusion == "+" else x1 - x2

    def _logprobs(self, sup: torch.Tensor, qry: torch.Tensor, way: int, shot: int
                  ) -> torch.Tensor:
        """``sup`` [E, ns, D], ``qry`` [E, G, D] → ``[E, G, way]`` log-probs."""
        split_s, d_s = self._get_feature(sup)
        split_q, d_q = self._get_feature(qry)
        scores = []
        for j in range(self.n_splits):
            if self.single:
                blk = self.blocks[j]
                fused_s = self._fuse_features(split_s[j], d_s[j])
                c_split_q = (torch.zeros_like(split_q[j]) if self.x_zero else
                             split_s[j].mean(dim=1, keepdim=True).expand_as(split_q[j]))
                g = blk.encode(fused_s)
                f = blk.FCE(self._fuse_features(split_q[j], d_q[j]), g)
                c_f = blk.FCE(self._fuse_features(c_split_q, d_q[j]), g)
                score = _cosine_scores(f, g) * self.temp
                c_score = _cosine_scores(c_f, g) * self.temp
            else:
                g_x, f_x = self.x_blocks[j](split_s[j], split_q[j])
                x_score = _cosine_scores(f_x, g_x)
                if self.use_x_only:
                    score = x_score * self.temp
                    c_score = torch.ones_like(x_score) * self.temp
                else:
                    g_d, f_d = self.d_blocks[j](d_s[j], d_q[j])
                    d_score = _cosine_scores(f_d, g_d)
                    score = self._fuse_proba(x_score, d_score) * self.temp
                    c_score = self._fuse_proba(torch.ones_like(x_score), d_score) * self.temp
            if self.use_counterfactual:
                score = score - c_score
            scores.append(torch.softmax(score, dim=-1))
        proba = torch.stack(scores).mean(dim=0)  # [E, G, ns]
        labels = F.one_hot(torch.arange(way, device=sup.device).repeat_interleave(shot),
                           way).to(proba.dtype)
        return torch.log(proba @ labels + 1e-6)

    # -- the per-episode embedding -----------------------------------------------------

    def _embed_role(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        kw = {"sample_mask": mask} if mask is not None and self._mask_kw else {}
        feats = self.emb_func(x, **kw)
        return feats.reshape(feats.shape[0], -1)

    def _embed(self, batch: EpisodeBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Support and query features ``[E, ns, D]``, ``[E, G, D]``, each role
        of each episode normalised over its own (real) rows; in train mode the
        running statistics end at the mean of the episodes' updates."""
        bns = [m for m in self.emb_func.modules()
               if isinstance(m, _BatchNorm) and m.track_running_stats] if self.training else []
        start = [(m.running_mean.clone(), m.running_var.clone()) for m in bns]
        counts = [m.num_batches_tracked.clone() for m in bns]
        ends = []
        sups, qrys = [], []
        for e in range(batch.num_episodes):
            for m, (mean, var) in zip(bns, start):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
            sups.append(self._embed_role(batch.support[e]))
            qrys.append(self._embed_role(batch.query[e], batch.query_mask[e] > 0))
            ends.append([(m.running_mean.clone(), m.running_var.clone()) for m in bns])
        if bns:
            # the mean of every episode's end: over equal shards, the mean
            # over the ranks of each rank's mean, in one all-reduce; each
            # rank's episodes count on every rank
            means = torch.cat([torch.stack([torch.cat(end[i]) for end in ends]).mean(dim=0)
                               for i in range(len(bns))])
            world = sharded_world()
            if world is not None:
                means = all_reduce_mean(means, world)
                for m, n in zip(bns, counts):
                    m.num_batches_tracked.copy_(n + (m.num_batches_tracked - n) * world.size)
            for m, mean in zip(bns, means.split([2 * m.num_features for m in bns])):
                m.running_mean.copy_(mean[:m.num_features])
                m.running_var.copy_(mean[m.num_features:])
        return torch.stack(sups), torch.stack(qrys)

    # -- method API ------------------------------------------------------------

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self._embed(batch)
        return self._logprobs(sup, qry, setting.way, setting.shot)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        seg_logits = self(batch, setting)
        nll = -seg_logits.gather(-1, segment_targets(batch).long()[..., None])[..., 0]
        mask = batch.query_mask.to(nll.dtype)
        loss = (nll * mask).sum() / mask.sum().clamp(min=1.0)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))


@CLASSIFIERS.register("IfslPretrain")
class IfslPretrain(GlobalPretrain):
    """Global CE through the linear ``classifier`` on flat batches,
    euclidean-prototype validation.  ``ifsl_pretrain_param``: ``norm``,
    ``featuring`` (``Trainer.run_featuring`` in place of training) and
    ``feature_path``.  ``cls_classifier_path`` loads a saved ``classifier``
    part at construction; ``emb_func_path`` / ``emd_func_path`` are ignored
    with a warning (the backbone loads through ``pretrain_path``)."""

    val_metric = "euclidean"

    def __init__(self, emb_func, ifsl_pretrain_param: Optional[Dict] = None,
                 emb_func_path: Optional[str] = None, emd_func_path: Optional[str] = None,
                 cls_classifier_path: Optional[str] = None, **kwargs):
        super().__init__(emb_func, **kwargs)
        p = dict(ifsl_pretrain_param or {})
        self.norm = bool(p.get("norm", False))
        self.featuring = bool(p.get("featuring", False))
        self.feature_path = p.get("feature_path")
        if emb_func_path or emd_func_path:
            warnings.warn("IfslPretrain ignores emb_func_path/emd_func_path — load the backbone "
                          "part through the top-level `pretrain_path` config key instead",
                          stacklevel=2)
        if cls_classifier_path:
            load_part(cls_classifier_path, self, part="classifier")

    def class_sums(self, data: torch.Tensor, targets: torch.Tensor, normalize: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-class sums ``[num_class, D]`` of the flat features of ``data``
        (L2-normalised first with ``normalize``) and the counts
        ``[num_class]``, with the backbone as it is (eval mode for the
        featuring pass)."""
        feats = self.flat_features(data)
        if normalize:
            feats = _l2n(feats)
        onehot = F.one_hot(targets.long(), self.num_class).to(feats.dtype)
        return onehot.T @ feats, onehot.sum(dim=0)

    def compute_class_features(self, data: torch.Tensor, targets: torch.Tensor,
                               normalize: bool = True) -> torch.Tensor:
        """Per-class mean features over a labelled set; unseen classes keep
        zero rows."""
        sums, counts = self.class_sums(data, targets, normalize)
        return sums / counts.clamp(min=1.0)[:, None]
