"""RENet, relational embedding networks (counterpart of
``audio_fewshot_tpu/models/heads/renet.py``).

- **SCR** (``scr_layer``): the 5 × 5 self-correlation of the ReLU'd,
  L2-normalised (eps 1e-12) channel vectors of each map position with its
  zero-padded neighbours, refined by a 1 × 1 conv + BN, two VALID 3 × 3
  convs over the (u, v) neighbour plane + BN and a 1 × 1 conv back to the
  map's width + BN, added to the map and ReLU'd.  Its BNs keep running
  statistics.  The [N, c, h, w, 5, 5] correlation is never formed: the
  first 1 × 1 conv is linear, so it runs offset by offset on (ident ⊙ the
  shifted ident), ``[N, 64, h, w]`` each (at 16 eval episodes of a
  [640, 8, 9] map the correlation alone would be 20.7 GB).
- **CCA** (``cca_layer``): support and query maps are centred over their
  channels, reduced by a shared 1 × 1 conv + BN + ReLU (two calls, support
  then query, each with its own batch statistics) and normalised; their
  4-D correlation ``[nq·ns, h, w, h, w]`` is refined by two separable 4-D
  convs (``SepConv4d``) symmetrised as f(x) + f(xᵀ)ᵀ, gauss-normalised
  (unbiased variance) and softmaxed at ``temperature_attn`` into an
  attention over each side's positions, which pools the centred maps; the
  logit is the cosine of the pooled pair over ``temperature``.  Its BNs use
  batch statistics in train and eval over the rows of real (not
  bucket-padded) queries, one episode at a time: the JAX package ``vmap``s
  it over episodes, so each episode has its own statistics.
- **Training**: λ_epi × the episodic CE of the CCA logits + the global CE of
  ``fc`` over the pooled centred query maps at ``global_target``; with a
  ``DualBatch`` (``dataloader_num: 2``) + the global CE of ``fc(GAP(SCR(
  emb_func(flat))))`` at the flat targets, run after the episodic pass, so
  the BN statistics and DropBlock counters it reads and updates are the ones
  the episodic pass left.

Parameters carry the reference names (``scr_layer.model.1.*``,
``cca_layer.cca_1x1.*``, ``cca_layer.cca_module.conv.{0,2}.*``, ``fc``) and
shapes (its Conv3d kernels), so a reference checkpoint loads.  The CCA BNs
hold running statistics for those keys and never read or update them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...episode import DualBatch, EpisodeBatch, segment_targets
from ...parallel.collectives import sharded_rows
from ...registry import CLASSIFIERS
from ..backbones.layers import _FlaxBatchNorm
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from ..init import dense, lecun_normal_
from ..losses import cross_entropy


class BatchNormNd(_FlaxBatchNorm, nn.modules.batchnorm._BatchNorm):
    """BatchNorm over ``[N, C, ...]`` of any rank (the reference's
    BatchNorm2d / BatchNorm3d), flax's statistics (``_FlaxBatchNorm``).
    ``use_running_statistics=False``: batch statistics in train and eval,
    over the rows of ``mask`` where given, else over the first ``rows`` rows
    (all of them by default; the real rows of a bucket-padded batch lead
    it): their mean and biased variance in one reduction over a view, then
    one normalising pass over every row; the running buffers are kept for
    the reference's keys, never read or updated."""

    def __init__(self, num_features: int, use_running_statistics: bool = True):
        super().__init__(num_features, eps=1e-5, momentum=0.1, track_running_stats=True)
        self.use_running_statistics = use_running_statistics

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"expected an input of rank 2 or more, got {x.dim()}")

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                rows: Optional[int] = None) -> torch.Tensor:
        if self.use_running_statistics:
            return super().forward(x, mask)
        if mask is not None:
            return self._masked(x, mask)[0]
        dims = [0] + list(range(2, x.dim()))
        var, mean = torch.var_mean(x[:rows], dim=dims, correction=0)
        if not mean.requires_grad:  # the library's pass takes no gradient in its statistics
            return F.batch_norm(x, mean, var, self.weight, self.bias, False, 0.0, self.eps)
        # written out under autograd: through the library's training pass
        # the train step's convolutions took 2.2× as long on the card (PERF.md)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = (self.weight * torch.rsqrt(var + self.eps)).reshape(shape)
        return (x - mean.reshape(shape)) * scale + self.bias.reshape(shape)


def _conv_bn(conv: nn.Module, channels: int, use_running_statistics: bool = True
             ) -> nn.Sequential:
    """(bias-free conv drawn as flax's default, BN): the reference's
    ``Sequential`` indices 0 and 1."""
    lecun_normal_(conv.weight)
    return nn.Sequential(conv, BatchNormNd(channels, use_running_statistics))


class SCR(nn.Module):
    """The refinement of the self-correlation (reference ``SCR``):
    ``conv1x1_in`` (c → mid), ``conv1`` and ``conv2`` ((1, 3, 3) Conv3d
    kernels over the (u, v) plane, VALID), ``conv1x1_out`` (mid → c)."""

    def __init__(self, channels: int, mid: int = 64):
        super().__init__()
        self.conv1x1_in = _conv_bn(nn.Conv2d(channels, mid, 1, bias=False), mid)
        self.conv1 = _conv_bn(nn.Conv3d(mid, mid, (1, 3, 3), bias=False), mid)
        self.conv2 = _conv_bn(nn.Conv3d(mid, mid, (1, 3, 3), bias=False), mid)
        self.conv1x1_out = _conv_bn(nn.Conv2d(mid, channels, 1, bias=False), channels)


class SCRLayer(nn.Module):
    """Self-correlation and its refinement, added to the map and ReLU'd:
    ``[N, c, h, w]`` → ``[N, c, h, w]``.  ``model`` holds the reference's
    (parameter-free ``SelfCorrelationComputation``, ``SCR``) pair."""

    def __init__(self, channels: int, mid: int = 64, kernel: int = 5):
        super().__init__()
        self.kernel = kernel
        self.model = nn.ModuleList([nn.Identity(), SCR(channels, mid)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scr = self.model[1]
        n, _, h, w = x.shape
        k = self.kernel
        ident = F.relu(x)
        ident = ident / ident.norm(dim=1, keepdim=True).clamp(min=1e-12)
        padded = F.pad(ident, (k // 2,) * 4)
        w_in = scr.conv1x1_in[0].weight
        # conv1x1_in of the correlation at each neighbour offset (du, dv),
        # stacked as the (u, v) plane: [N, mid, h·w, k, k]
        y = torch.stack([F.conv2d(ident * padded[:, :, du:du + h, dv:dv + w], w_in)
                         for du in range(k) for dv in range(k)], dim=-1)
        y = F.relu(scr.conv1x1_in[1](y.reshape(n, -1, h * w, k, k)))
        for block in (scr.conv1, scr.conv2):
            y = F.relu(block[1](F.conv3d(y, block[0].weight)))
        y = y.reshape(n, -1, h, w)
        y = scr.conv1x1_out[1](F.conv2d(y, scr.conv1x1_out[0].weight))
        return F.relu(x + y)


class SepConv4d(nn.Module):
    """The separable 4-D conv (reference ``SepConv4d``) over ``[B, C, u, v,
    h, w]``: ``conv2``, a (k, k, 1) Conv3d over the (u, v) plane shared
    across (h, w), + BN, ReLU; ``conv1``, a (1, k, k) Conv3d over (h, w)
    shared across (u, v), + BN; with a change of width, ``proj``, a 1 × 1
    conv + BN.  Every BN on batch statistics over the rows of ``sample_mask``
    ``[B]``, or over the first ``rows``."""

    def __init__(self, in_planes: int, out_planes: int, k: int = 3):
        super().__init__()
        self.k = k
        self.conv2 = _conv_bn(nn.Conv3d(in_planes, in_planes, (k, k, 1), bias=False),
                              in_planes, False)
        self.conv1 = _conv_bn(nn.Conv3d(in_planes, in_planes, (1, k, k), bias=False),
                              in_planes, False)
        self.proj = None
        if in_planes != out_planes:
            self.proj = _conv_bn(nn.Conv2d(in_planes, out_planes, 1, bias=False),
                                 out_planes, False)

    def forward(self, x: torch.Tensor, sample_mask: Optional[torch.Tensor] = None,
                rows: Optional[int] = None) -> torch.Tensor:
        b, c, u, v, h, w = x.shape
        p = self.k // 2
        y = F.conv3d(x.reshape(b, c, u, v, h * w), self.conv2[0].weight, padding=(p, p, 0))
        y = F.relu(self.conv2[1](y, sample_mask, rows))
        y = F.conv3d(y.reshape(b, c, u * v, h, w), self.conv1[0].weight, padding=(0, p, p))
        y = self.conv1[1](y, sample_mask, rows)
        if self.proj is not None:
            y = self.proj[1](F.conv3d(y, self.proj[0].weight[:, :, None]), sample_mask, rows)
        return y.reshape(b, -1, u, v, h, w)


class CCAModule(nn.Module):
    """``conv`` = (SepConv4d(1 → 16), ReLU, SepConv4d(16 → 1)) over the 4-D
    correlation ``[B, Hs, Ws, Hq, Wq]``, symmetrised as f(x) + f(xᵀ)ᵀ (ᵀ
    swaps the support and query planes)."""

    def __init__(self, mid: int = 16):
        super().__init__()
        self.conv = nn.ModuleList([SepConv4d(1, mid), nn.ReLU(), SepConv4d(mid, 1)])

    def _f(self, x: torch.Tensor, sample_mask: Optional[torch.Tensor],
           rows: Optional[int]) -> torch.Tensor:
        y = F.relu(self.conv[0](x[:, None], sample_mask, rows))
        return self.conv[2](y, sample_mask, rows)[:, 0]

    def forward(self, corr: torch.Tensor, sample_mask: Optional[torch.Tensor] = None,
                rows: Optional[int] = None) -> torch.Tensor:
        swap = (0, 3, 4, 1, 2)
        return self._f(corr, sample_mask, rows) + self._f(
            corr.permute(swap).contiguous(), sample_mask, rows).permute(swap)


def _gauss_norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """(x − mean) / √(var + 1e-5) over ``dim``, the unbiased variance (the
    reference's ``torch.var``)."""
    mean = x.mean(dim=dim, keepdim=True)
    return (x - mean) / torch.sqrt(x.var(dim=dim, keepdim=True) + 1e-5)


def _unit(x: torch.Tensor, dim: int, eps: float) -> torch.Tensor:
    return x / x.norm(dim=dim, keepdim=True).clamp(min=eps)


class CCALayer(nn.Module):
    """Cross-correlational attention of one episode: ``cca_1x1`` (c → 64
    conv + BN + ReLU) and ``cca_module``."""

    def __init__(self, channels: int, temperature: float = 2.0, temperature_attn: float = 5.0,
                 mid: int = 64):
        super().__init__()
        self.temperature = temperature
        self.temperature_attn = temperature_attn
        self.cca_1x1 = _conv_bn(nn.Conv2d(channels, mid, 1, bias=False), mid, False)
        self.cca_module = CCAModule()

    def _reduce(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                rows: Optional[int]) -> torch.Tensor:
        y = F.relu(self.cca_1x1[1](F.conv2d(x, self.cca_1x1[0].weight), mask, rows))
        return _unit(y, 1, 1e-8)

    def forward(self, spt: torch.Tensor, qry: torch.Tensor, way: int, shot: int,
                qry_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``spt [ns, c, h, w]``, ``qry [nq, c, h, w]`` → (``[nq, way]``
        similarities, ``[nq, c]`` pooled centred queries).  ``qry_mask``
        ``[nq]`` (bool) marks the real query rows."""
        ns, c, h, w = spt.shape
        nq = qry.shape[0]
        if h * w < 2:
            raise ValueError(
                f"RENet CCA needs spatial feature maps, got {h}x{w}: "
                "gaussian-normalizing over a single spatial position is "
                "0/0 (ref renet.py:253-257 unbiased var). Set the backbone's "
                "last_pool: false (see config/kos_fixture/renet_5shot.yaml)"
            )
        spt = spt - spt.mean(dim=1, keepdim=True)
        qry = qry - qry.mean(dim=1, keepdim=True)
        rows = None
        if qry_mask is not None:
            # one host read an episode: the loaders pack the real rows
            # first, so the statistics come from a leading slice (a
            # scattered mask takes the masked path)
            flags = qry_mask.tolist()
            real = sum(flags)
            if all(flags[:real]):
                qry_mask, rows = None, (None if real == nq else real)
        s_r = self._reduce(spt, None, None)
        q_r = self._reduce(qry, qry_mask, rows)
        corr = torch.einsum("scij,qckl->qsijkl", s_r, q_r).reshape(nq * ns, h, w, h, w)
        pair_mask = None if qry_mask is None else qry_mask.repeat_interleave(ns)
        refined = self.cca_module(corr, pair_mask, None if rows is None else rows * ns)
        refined = refined.reshape(nq, ns, h * w, h * w)
        # attention over the support positions (for each query position),
        # summed over the query positions; and the other way round
        attn_s = torch.softmax(_gauss_norm(refined, 2) / self.temperature_attn, dim=2).sum(3)
        attn_q = torch.softmax(_gauss_norm(refined, 3) / self.temperature_attn, dim=3).sum(2)
        # the attended maps pooled over their positions, without forming
        # the [nq, ns, c, h, w] attended maps
        spt_att = torch.einsum("qsp,scp->qsc", attn_s, spt.reshape(ns, c, h * w)) / (h * w)
        qry_att = torch.einsum("qsp,qcp->qsc", attn_q, qry.reshape(nq, c, h * w)) / (h * w)
        if shot > 1:
            spt_att = spt_att.reshape(nq, way, shot, c).mean(dim=2)
            qry_att = qry_att.reshape(nq, way, shot, c).mean(dim=2)
        sims = (_unit(spt_att, -1, 1e-8) * _unit(qry_att, -1, 1e-8)).sum(-1) / self.temperature
        return sims, qry.mean(dim=(-1, -2))


@CLASSIFIERS.register("RENet")
class RENet(MethodBase):
    """SCR and CCA over the backbone's ``[c, h, w]`` map (``map_shape``, from
    ``build_method``); ``fc`` (c → ``num_class``, or the reference's
    ``num_classes``) is the global head.  ``feat_dim`` is accepted for the
    configs: the widths come from the map."""

    model_type = ModelType.METRIC
    shardable = True
    needs_feature_map = True
    needs_map_shape = True

    def __init__(self, emb_func, map_shape: Sequence[int], feat_dim: int = 640,
                 num_class: int = 25, num_classes: Optional[int] = None,
                 lambda_epi: float = 0.25, temperature: float = 0.2,
                 temperature_attn: float = 5.0, **kwargs):
        super().__init__(emb_func, **kwargs)
        c = int(map_shape[0])
        self.lambda_epi = lambda_epi
        self.num_class = num_classes if num_classes is not None else num_class
        self.scr_layer = SCRLayer(c)
        self.cca_layer = CCALayer(c, temperature, temperature_attn)
        self.fc = dense(c, self.num_class)

    def _refined(self, batch: EpisodeBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """SCR over the support and query maps of every episode at once."""
        sup, qry = self.embed(batch)
        e, ws, c, h, w = sup.shape
        with sharded_rows():
            refined = self.scr_layer(torch.cat([sup.reshape(-1, c, h, w),
                                                qry.reshape(-1, c, h, w)]))
        return refined[: e * ws].reshape(sup.shape), refined[e * ws:].reshape(qry.shape)

    def _episode_sims(self, sup: torch.Tensor, qry: torch.Tensor, setting: EpisodeSetting,
                      query_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """CCA episode by episode: ([E, G, way], [E, G, c])."""
        out = [self.cca_layer(s, q, setting.way, setting.shot, m > 0)
               for s, q, m in zip(sup, qry, query_mask)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self._refined(batch)
        return self._episode_sims(sup, qry, setting, batch.query_mask)[0]

    def loss(self, batch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        flat = None
        if isinstance(batch, DualBatch):
            batch, flat = batch.episode, batch.flat
        sup, qry = self._refined(batch)
        sims, qry_pooled = self._episode_sims(sup, qry, setting, batch.query_mask)
        loss = self.lambda_epi * masked_cross_entropy(sims, segment_targets(batch),
                                                      batch.query_mask)
        if batch.global_target is None:
            raise ValueError(
                "RENet training requires global targets for its absolute "
                "global CE (reference renet.py:440-441) — the episodic "
                "loader must populate EpisodeBatch.global_target"
            )
        g_qry = batch.global_target[:, sup.shape[1]:]
        logits_abs = self.fc(qry_pooled)
        if tuple(logits_abs.shape[:2]) != tuple(g_qry.shape):
            raise ValueError(
                f"RENet abs loss layout mismatch: pooled query logits "
                f"{tuple(logits_abs.shape[:2])} vs global query targets "
                f"{tuple(g_qry.shape)} — RENet trains on dense episodic batches "
                f"(one segment per clip; reference renet.py:420-441)"
            )
        loss = loss + cross_entropy(logits_abs.reshape(-1, self.num_class), g_qry.reshape(-1))
        if flat is not None:
            # after the episodic pass: its updated BN statistics and
            # DropBlock counters are the ones this pass starts from
            with sharded_rows():
                g_pooled = self.scr_layer(self.emb_func(flat.data)).mean(dim=(2, 3))
            loss = loss + cross_entropy(self.fc(g_pooled), flat.target.reshape(-1))
        return loss, LossOutput(sims, self.train_metrics(sims, batch))
