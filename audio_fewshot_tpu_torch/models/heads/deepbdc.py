"""DeepBDC: prototypes over BDC features, plus the energy-based OOD
machinery (counterpart of ``audio_fewshot_tpu/models/heads/deepbdc.py``).

- logits: negative squared euclidean to the class prototypes for shot > 1,
  raw dot product for 1-shot (unnormalised on purpose, as the reference);
- per-clip energy uncertainty ``-logsumexp(clip-averaged logits)``;
- a validation calibration pass: threshold = mean over batches of the 95 %
  quantile of correct-prediction uncertainties ('mean' policy), or the
  pooled 95 % quantile ('overall');
- the top 20 % most-uncertain query clips are flagged OOD.

- ``loss``: masked per-segment cross-entropy over the same logits.

The TTA re-vote that consumes the flags comes with a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...episode import EpisodeBatch, materialize_episode_batch, segment_targets
from ...registry import CLASSIFIERS
from ...utils.aggregate import average_logits, majority_vote
from ..base import EpisodeSetting, LossOutput, MethodBase, ModelType, masked_cross_entropy
from .proto_net import neg_sq_euclidean, prototypes


def bdc_proto_logits(query_feat, support_feat, way: int, shot: int) -> torch.Tensor:
    """Euclid for multi-shot, raw dot product for 1-shot ``[E, G, way]``."""
    proto = prototypes(support_feat.float(), way, shot)
    if shot > 1:
        return neg_sq_euclidean(query_feat, proto)
    return torch.matmul(query_feat.float(), proto.transpose(-1, -2))


@CLASSIFIERS.register("DeepBDC")
class DeepBDC(MethodBase):
    model_type = ModelType.METRIC
    supports_energy_ood = True
    #: fraction of most-uncertain query clips flagged OOD
    ood_fraction = 0.2

    def __init__(self, emb_func, use_bpa: bool = False, **kwargs):
        super().__init__(emb_func, **kwargs)
        if use_bpa:
            raise NotImplementedError("use_bpa (ops/bpa.py) is not ported yet")
        self.uncertain_global_threshold: Optional[float] = None
        self.uncertains_mean: Optional[float] = None
        self.uncertains_std: Optional[float] = None

    def forward(self, batch: EpisodeBatch, setting: EpisodeSetting) -> torch.Tensor:
        sup, qry = self.embed(batch)
        return bdc_proto_logits(qry, sup, setting.way, setting.shot)

    def loss(self, batch: EpisodeBatch, setting: EpisodeSetting) -> Tuple[torch.Tensor, LossOutput]:
        sup, qry = self.embed(batch)
        seg_logits = bdc_proto_logits(qry, sup, setting.way, setting.shot)
        loss = masked_cross_entropy(seg_logits, segment_targets(batch), batch.query_mask)
        return loss, LossOutput(seg_logits, self.train_metrics(seg_logits, batch))

    def feature_logits(self, sup_feat, qry_feat, setting: EpisodeSetting) -> torch.Tensor:
        """Head over precomputed features (the TTA re-classification hook)."""
        return bdc_proto_logits(qry_feat, sup_feat, setting.way, setting.shot)

    def embed_segments(self, segments: torch.Tensor) -> torch.Tensor:
        """Backbone features of raw segments ``[N, C, H, W]`` → ``[N, D]``."""
        feats = self.emb_func(segments)
        return feats.reshape(feats.shape[0], -1)

    # -- energy OOD ---------------------------------------------------------

    def clip_uncertainty(self, seg_logits, batch: EpisodeBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-clip energy uncertainty ``[E, Wq]`` and majority-vote
        correctness ``[E, Wq]`` (bool)."""
        nq = batch.num_query_clips
        avg = average_logits(seg_logits, batch.query_clip, batch.query_mask, nq)
        uncertains = -torch.logsumexp(avg, dim=-1)
        preds = majority_vote(seg_logits, batch.query_clip, batch.query_mask, nq)
        return uncertains, preds == batch.query_target

    @torch.no_grad()
    def calibrate_threshold(self, loader, setting: EpisodeSetting,
                            policy: str = "mean",
                            dump_path: Optional[str] = None,
                            bank: Optional[torch.Tensor] = None) -> Optional[float]:
        """Validation calibration pass over ``loader``'s epoch 0.  Sets and
        returns ``uncertain_global_threshold`` (None without a correct
        prediction).  ``dump_path``: also write ``uncertainty_data.npz``."""
        device = next(self.parameters()).device
        # results stay on the device for `depth` steps: one host sync per
        # window instead of one per step
        depth = 32 if bank is not None else 4
        thresholds, means, stds = [], [], []
        all_u, all_ok = [], []
        pending = []

        def drain():
            for u, ok in pending:
                u = u.cpu().numpy().ravel()
                ok = ok.cpu().numpy().ravel()
                all_u.append(u)
                all_ok.append(ok)
                means.append(u.mean())
                stds.append(u.std())
                correct = u[ok]
                if correct.size:
                    thresholds.append(np.quantile(correct, 0.95))
            pending.clear()

        for host_batch in loader.epoch(0):
            batch = materialize_episode_batch(host_batch.to(device), bank)
            seg_logits = self.forward(batch, setting)
            pending.append(self.clip_uncertainty(seg_logits, batch))
            if len(pending) >= depth:
                drain()
        drain()
        if dump_path:
            np.savez(dump_path, uncertains=np.asarray(all_u, dtype=object),
                     is_corrects=np.asarray(all_ok, dtype=object))
        if not thresholds:
            return None
        if policy == "overall":
            pooled_u = np.concatenate(all_u)
            correct_all = pooled_u[np.concatenate(all_ok)]
            self.uncertain_global_threshold = float(np.quantile(correct_all, 0.95))
            self.uncertains_mean = float(correct_all.mean())
            self.uncertains_std = float(correct_all.std())
        else:
            self.uncertain_global_threshold = float(np.mean(thresholds))
            self.uncertains_mean = float(np.mean(means))
            self.uncertains_std = float(np.mean(stds))
        return self.uncertain_global_threshold

    def ood_topk(self, uncertains: torch.Tensor) -> torch.Tensor:
        """Flat indices of the top-20 % most-uncertain query clips."""
        flat = uncertains.reshape(-1)
        k = max(1, int(self.ood_fraction * flat.shape[0]))
        return torch.topk(flat, k).indices

    def ood_mask(self, uncertains: torch.Tensor) -> torch.Tensor:
        """Boolean ``[E, Wq]`` mask form of ``ood_topk``."""
        flat = torch.zeros(uncertains.numel(), dtype=torch.bool, device=uncertains.device)
        flat[self.ood_topk(uncertains)] = True
        return flat.reshape(uncertains.shape)
