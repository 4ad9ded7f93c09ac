"""Local-descriptor distribution metrics: ADM, ADM_KL, ConvMNet (counterpart
of ``audio_fewshot_tpu/models/heads/local_metrics.py``).

Each treats a feature map as a cloud of ``h·w`` local descriptors per
segment:

- ADM: class and query Gaussians (mean and covariance + 0.01·I) → an
  asymmetric KL divergence, mixed with a top-k cosine image-to-class term by
  a BatchNorm1d(2·way) and a 2-tap dilated Conv1d (``adm_layer``);
- ADM_KL: the KL term alone;
- ConvMNet: the query-descriptor covariance similarity ``diag(q Σ_w qᵀ)``,
  scored by LeakyReLU → Dropout → a Conv1d with kernel = stride = h·w
  (``convm_layer``).

Everything is a batched product or ``torch.linalg`` call over the episode
axis, in float32.  The heads' parameters carry the reference torch names
(``adm_layer.normLayer``, ``adm_layer.fcLayer``,
``convm_layer.conv1dLayer.2``), which ``utils/convert.py`` fills from the
JAX package's variables.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...episode import EpisodeBatch, segment_targets
from ...parallel.collectives import sharded_rows
from ...registry import CLASSIFIERS
from ..backbones.layers import BatchNorm1d, Dropout
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from ..init import lecun_normal_


def l2_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x / max(‖x‖, 1e-12)`` along ``dim``."""
    return F.normalize(x, dim=dim, eps=1e-12)


def to_descriptors(feat_map: torch.Tensor) -> torch.Tensor:
    """``[E, B, c, h, w]`` → ``[E, B, h·w, c]``."""
    e, b, c, h, w = feat_map.shape
    return feat_map.reshape(e, b, c, h * w).transpose(-1, -2)


def descriptor_moments(feat: torch.Tensor, eps: float = 0.01) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., n, c]`` → (mean ``[..., 1, c]``, covariance ``[..., c, c]``
    with the unbiased 1/(n − 1) and + eps·I)."""
    n = feat.shape[-2]
    mean = feat.mean(dim=-2, keepdim=True)
    centered = feat - mean
    cov = torch.matmul(centered.transpose(-1, -2), centered) / (n - 1)
    return mean, cov + eps * torch.eye(feat.shape[-1], dtype=feat.dtype, device=feat.device)


def kl_gaussian_batch(q_mean, q_cov, s_mean, s_cov) -> torch.Tensor:
    """KL(q ‖ s) of batched Gaussians: q ``[E, G, ...]``, s ``[E, way, ...]``
    → ``[E, G, way]``."""
    c = q_mean.shape[-1]
    s_cov_inv = torch.linalg.inv(s_cov)  # [E, way, c, c]
    mean_diff = s_mean[:, None, :, 0, :] - q_mean[:, :, None, 0, :]  # [E, G, way, c]
    trace = torch.einsum("egcd,ewdc->egw", q_cov, s_cov_inv)
    maha = (torch.einsum("egwc,ewcd->egwd", mean_diff, s_cov_inv) * mean_diff).sum(dim=-1)
    logdet = (torch.linalg.slogdet(s_cov)[1][:, None, :]
              - torch.linalg.slogdet(q_cov)[1][:, :, None])
    return 0.5 * (trace + maha + logdet - c)


def topk_cosine_sim(qd: torch.Tensor, sd_way: torch.Tensor, n_k: int) -> torch.Tensor:
    """Top-k cosine image-to-class similarity: ``qd [E, G, hw, c]`` and
    ``sd_way [E, way, s·hw, c]``, both normalised → ``[E, G, way]``.  The
    top-k values are summed, so the order of ties does not matter."""
    sim = torch.einsum("egxc,ewyc->egwxy", qd, sd_way)
    return sim.topk(n_k, dim=-1).values.sum(dim=(-2, -1))


def _class_descriptors(qry, sup, way: int, shot: int):
    """Query descriptors ``[E, G, hw, c]`` and each class's pooled support
    descriptors ``[E, way, shot·hw, c]``."""
    e, _, c, h, w = qry.shape
    return to_descriptors(qry), to_descriptors(sup).reshape(e, way, shot * h * w, c)


def neg_kl(qd: torch.Tensor, sd: torch.Tensor) -> torch.Tensor:
    """−KL(query ‖ class) ``[E, G, way]`` of the descriptor Gaussians."""
    q_mean, q_cov = descriptor_moments(qd)
    s_mean, s_cov = descriptor_moments(sd)
    return -kl_gaussian_batch(q_mean, q_cov, s_mean, s_cov)


class Blend(nn.Module):
    """The reference's bias-free Conv1d(1 → 1, kernel 2, dilation ``way``) over
    a [a ‖ b] pair of ``way``-wide blocks, ``k0·a + k1·b``: only its weight
    ``[1, 1, 2]``, drawn from N(0, 0.02²) as the JAX package's ``mix``.  Not
    an ``nn.Conv1d``, so ``init_weights`` leaves it as the JAX package
    leaves ``mix`` (a rank-1 parameter, not a kernel)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, 1, 2).normal_(0.0, 0.02))


class ADMLayer(nn.Module):
    """BatchNorm1d(2·way) over the [−KL ‖ cosine] concatenation, then the
    2-tap ``Blend``: ``out[i] = k0·x[i] + k1·x[i + way]`` for i < way, a
    learned blend per class.  Flax's BN semantics (biased running variance,
    torch momentum 0.1), its train-mode moments over every rank's rows;
    running statistics in eval, so a row's logits do not depend on the
    others."""

    def __init__(self, way_num: int):
        super().__init__()
        self.normLayer = BatchNorm1d(2 * way_num)
        self.fcLayer = Blend()

    def forward(self, kl_dis: torch.Tensor, inner_sim: torch.Tensor) -> torch.Tensor:
        e, g, w = kl_dis.shape
        with sharded_rows():  # train-mode moments over every rank's query rows
            flat = self.normLayer(torch.cat([kl_dis, inner_sim], dim=-1).reshape(e * g, 2 * w))
        k = self.fcLayer.weight.reshape(2)
        return (k[0] * flat[:, :w] + k[1] * flat[:, w:]).reshape(e, g, w)


class LocalDescriptorMethod(MethodBase):
    """The shared method plumbing: ``_logits(batch, setting)`` is the head;
    ``loss`` is the masked segment cross-entropy over it."""

    model_type = ModelType.METRIC
    needs_feature_map = True
    shardable = True

    def _logits(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        return self._logits(batch, setting)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        seg_logits = self._logits(batch, setting)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))


@CLASSIFIERS.register("ADM")
class ADM(LocalDescriptorMethod):
    def __init__(self, emb_func, n_k: int = 3, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.n_k = n_k
        self.adm_layer = ADMLayer(int(kwargs.get("way_num", 5)))

    def _logits(self, batch, setting):
        sup, qry = self.embed(batch)
        qd, sd = _class_descriptors(qry, sup, setting.way, setting.shot)
        inner = topk_cosine_sim(l2_normalize(qd, -1), l2_normalize(sd, -1), self.n_k)
        return self.adm_layer(neg_kl(qd, sd), inner)


@CLASSIFIERS.register("ADM_KL")
class ADMKL(LocalDescriptorMethod):
    """The KL-divergence metric alone.  ``n_k`` and ``CMS`` are accepted
    for the configs, as the JAX package does, and change nothing."""

    def __init__(self, emb_func, n_k: int = 3, CMS: bool = False, **kwargs):
        super().__init__(emb_func, **kwargs)
        self.n_k = n_k
        self.cms = CMS

    def _logits(self, batch, setting):
        sup, qry = self.embed(batch)
        return neg_kl(*_class_descriptors(qry, sup, setting.way, setting.shot))


class ConvMLayer(nn.Module):
    """LeakyReLU(0.2) → Dropout(0.5) → Conv1d(1 → 1, kernel = stride =
    ``n_local``) collapsing each class's h·w covariance-similarity diagonal
    to one score.  The kernel is drawn as flax's ``lecun_normal``, the bias
    is 0.  The dropout draws from its own generator (``layers.Dropout``)."""

    def __init__(self, n_local: int):
        super().__init__()
        self.conv1dLayer = nn.Sequential(nn.LeakyReLU(0.2), Dropout(0.5),
                                         nn.Conv1d(1, 1, n_local, stride=n_local))
        lecun_normal_(self.conv1dLayer[2].weight)
        nn.init.zeros_(self.conv1dLayer[2].bias)

    def forward(self, cov_sim: torch.Tensor) -> torch.Tensor:
        # cov_sim [E, G, way, hw] → [E, G, way]
        x = self.conv1dLayer[1](self.conv1dLayer[0](cov_sim))
        conv = self.conv1dLayer[2]
        return torch.matmul(x, conv.weight.reshape(-1, 1))[..., 0] + conv.bias


def cov_similarity(qry: torch.Tensor, sup: torch.Tensor, way: int, shot: int) -> torch.Tensor:
    """``diag(q Σ_w qᵀ)`` ``[E, G, way, hw]``: each centred query descriptor
    against the class covariance of the centred support descriptors.  The
    covariance divides by hw − 1, not shot·hw − 1, as the JAX package does."""
    hw = qry.shape[-2] * qry.shape[-1]
    qd, sd = _class_descriptors(qry, sup, way, shot)
    qd = qd - qd.mean(dim=-2, keepdim=True)
    sd = sd - sd.mean(dim=-2, keepdim=True)
    cov = torch.matmul(sd.transpose(-1, -2), sd) / (hw - 1)  # [E, way, c, c]
    return (torch.einsum("egxc,ewcd->egwxd", qd, cov) * qd[:, :, None]).sum(dim=-1)


@CLASSIFIERS.register("ConvMNet")
class ConvMNet(LocalDescriptorMethod):
    """``map_shape`` (the backbone's ``(c, h, w)``, from ``build_method``)
    sizes the scorer's kernel at h·w; ``n_local`` is accepted for the
    configs and not read, as in the JAX package, which takes h·w from the
    map."""

    needs_map_shape = True

    def __init__(self, emb_func, map_shape: Sequence[int], n_local: Optional[int] = None,
                 **kwargs):
        super().__init__(emb_func, **kwargs)
        self.convm_layer = ConvMLayer(int(map_shape[-2]) * int(map_shape[-1]))

    def _logits(self, batch, setting):
        sup, qry = self.embed(batch)
        return self.convm_layer(cov_similarity(qry, sup, setting.way, setting.shot))
