"""Test harness: episodic evaluation with confidence intervals (counterpart of
``Test`` in ``audio_fewshot_tpu/eval.py``).

``Test(rank, config, result_path, device).test_loop()`` runs the energy
calibration pass on the val split (for methods that support it), one
warm-up step, then ``test_epoch`` passes over the test loader, and reports
a 95 % CI per epoch and over the epoch means.  With
``enhance_classification_via_energy`` each test step is ``tta_eval_step``,
the energy-OOD TTA re-vote.  With ``dump_features`` (and a result dir) it
first writes ``plots/featdata_*.npz`` for the first test batch
(``utils.features``).  It runs on ``cuda`` unless ``device`` says
otherwise, and raises when no card is there.

Over several ranks (``torchrun``, or ``run_test --nproc``; see
``parallel``) each rank evaluates its contiguous shard of every step's
episodes, copied one step ahead (``parallel.transfer_ahead``).  The
per-episode accuracies are gathered in rank order, so the CI is over the
one-rank run's episodes in its order; the calibration pass gathers each
step's uncertainties before its quantile, and the TTA gathers them before
``ood_topk``, so the whole step's top 20 % is flagged and each rank re-votes
its own flagged clips with the values the whole step's draw gives them.
The host drains the accuracies every ``eval_queue_depth`` steps (0: every
step; by default 32 with a segment bank, 4 without).  A ``test_episode_size``
that the world does not divide runs replicated (``parallel.replicated_rows``):
every rank computes every episode of a step, as the JAX package's ``Test``
and the ``Trainer``'s eval do, and nothing is gathered.
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .config import Config
from .data import get_dataloader, get_mean_std
from .data.bank import resolve_transfer_dtype, setup_segment_banks
from .data.dataset import load_mean_std
from .episode import EpisodeBatch, materialize_episode_batch
from .models import build_method, eval_setting
from .models.base import EpisodeSetting, MethodBase
from .models.heads.proto_net import apply_bpa
from .ops.audio_augmentations import batch_augment_spectrogram, draw_params, select_rows
from .parallel import (World, gather_rows, get_mesh, maybe_init_distributed, replicate,
                       replicated_rows, shard_batch, transfer_ahead)
from .utils import init_logger, init_seed, mean_confidence_interval, resolve_device
from .utils.aggregate import clip_vote_counts
from .utils.checkpoint import BEST, load_model
from .utils.features import dump_episode_features
from .utils.spans import count_rows, span


#: the model part of each shipped config that a chip cell runs (the
#: classifier, the backbone with its include's kwargs, the tag)
SLICE_MODELS = {
    "DeepBDC": {
        "classifier": {"name": "DeepBDC", "kwargs": None},
        "backbone": {"name": "resnet12Bdc", "kwargs": {"num_channels": 1, "reduce_dim": 64}},
        "tag": "deepbdc_5shot_iid_seed0",
    },
    "ProtoNet": {
        "classifier": {"name": "ProtoNet", "kwargs": None},
        "backbone": {"name": "Conv64F", "kwargs": {
            "is_flatten": True, "is_feature": False, "leaky_relu": False,
            "negative_slope": 0.2, "last_pool": True, "maxpool_last2": True,
            "num_channels": 1}},
        "tag": "proto_5shot_iid_seed0",
    },
}
# the Conv64F local-descriptor heads: config/<dir>/<dir>_5shot_iid_seed0.yaml,
# Conv64F with is_flatten and last_pool off (a [64, 4, 5] map of a
# [1, 128, 157] segment)
_MAP_BACKBONE = {"name": "Conv64F", "kwargs": {
    "is_flatten": False, "is_feature": False, "leaky_relu": False, "negative_slope": 0.2,
    "last_pool": False, "maxpool_last2": True, "num_channels": 1}}
SLICE_MODELS.update({
    name: {"classifier": {"name": name, "kwargs": kwargs}, "backbone": _MAP_BACKBONE,
           "tag": f"{tag}_5shot_iid_seed0"}
    for name, tag, kwargs in (
        ("DN4", "dn4", {"n_k": 3}), ("ADM", "adm", {"n_k": 3}), ("ADM_KL", "adm_kl", {"n_k": 3}),
        ("ConvMNet", "convmnet", None), ("ATLNet", "atlnet", {"feat_dim": 64}),
        ("MCL", "mcl", {"katz_factor": 0.5, "gamma": 20.0, "gamma2": 10.0}),
        ("RelationNet", "relationnet", {"feat_dim": 64}))})
# the heads on the plain resnet12 (config/backbones/resnet12.yaml; drop_rate
# 0.1 by default): flat (the [640, 4, 5] avg-pooled map of a [1, 128, 157]
# segment, 12800 features) or, for FRN and CAN, the [640, 8, 9] map
_RESNET12 = {"name": "resnet12", "kwargs": {"num_channels": 1}}
_RESNET12_MAP = {"name": "resnet12", "kwargs": {"num_channels": 1, "is_flatten": False,
                                                "avg_pool": False}}
SLICE_MODELS.update({
    name: {"classifier": {"name": name, "kwargs": kwargs}, "backbone": backbone,
           "tag": f"{tag}_5shot_iid_seed0"}
    for name, tag, kwargs, backbone in (
        ("MetaBaseline", "metabaseline", None, _RESNET12),
        ("MetaBaselineKendall", "kendall", None, _RESNET12),
        ("FEAT", "feat", {"hdim": 640, "temperature": 1.0, "temperature2": 1.0,
                          "balance": 0.5, "mode": "euclidean"}, _RESNET12),
        ("DSN", "dsn", {"discriminative": True}, _RESNET12),
        ("FRN", "frn", None, _RESNET12_MAP),
        ("CAN", "can", {"scale_cls": 7, "num_classes": 25}, _RESNET12_MAP))})
# CPEANet on the class-aware vit_tiny (73 tokens of 192 for a [1, 128, 157]
# segment), and the meta heads on config/backbones/Conv64F.yaml (is_flatten:
# the 1600 features of the logits head); MAML's config trains 2 episodes a step
_CONV64F = SLICE_MODELS["ProtoNet"]["backbone"]
SLICE_MODELS.update({
    "CPEANet": {"classifier": {"name": "CPEANet", "kwargs": {"in_dim": 192}},
                "backbone": {"name": "vit_tiny", "kwargs": {"patch_size": 16, "num_channels": 1}},
                "tag": "cpea_5shot_iid_seed0"},
    "R2D2": {"classifier": {"name": "R2D2", "kwargs": None}, "backbone": _CONV64F,
             "tag": "r2d2_5shot_iid_seed0"},
    "MAML": {"classifier": {"name": "MAML", "kwargs": {
        "inner_param": {"lr": 0.01, "train_iter": 5, "test_iter": 10}}},
        "backbone": _CONV64F, "tag": "maml_5shot_iid_seed0", "episode_size": 2},
    "ANIL": {"classifier": {"name": "ANIL", "kwargs": {
        "inner_param": {"lr": 0.01, "train_iter": 5, "test_iter": 10}}},
        "backbone": _CONV64F, "tag": "anil_5shot_iid_seed0"},
    "BOIL": {"classifier": {"name": "BOIL", "kwargs": {
        "inner_param": {"extractor_lr": 0.01, "classifier_lr": 0.01},
        "testing_method": "NIL"}}, "backbone": _CONV64F, "tag": "boil_5shot_iid_seed0"},
})
# MeTAL, LEO, VERSA and DMatchingNet (config/ifsl) on Conv64F's 1600 flat
# features, MTL on the plain resnet12's 12800
SLICE_MODELS.update({
    "MeTAL": {"classifier": {"name": "MeTAL", "kwargs": {
        "inner_param": {"lr": 0.01, "train_iter": 5, "test_iter": 5}}},
        "backbone": _CONV64F, "tag": "metal_5shot_iid_seed0"},
    "MTL": {"classifier": {"name": "MTL", "kwargs": {"inner_param": {"iter": 100, "lr": 0.01}}},
            "backbone": _RESNET12, "tag": "mtl_5shot_iid_seed0"},
    "LEO": {"classifier": {"name": "LEO", "kwargs": {
        "hid_dim": 64, "kl_weight": 0.001, "encoder_penalty_weight": 1.0e-09,
        "orthogonality_penalty_weight": 0.001,
        "inner_para": {"iter": 5, "lr": 0.01, "finetune_iter": 5, "finetune_lr": 0.01}}},
        "backbone": _CONV64F, "tag": "leo_5shot_iid_seed0"},
    "VERSA": {"classifier": {"name": "VERSA", "kwargs": {
        "sample_num": 10, "d_theta": 256, "drop_rate": 0.5}},
        "backbone": _CONV64F, "tag": "versa_5shot_iid_seed0"},
    "DMatchingNet": {"classifier": {"name": "DMatchingNet", "kwargs": {
        "ifsl_param": {"n_splits": 4, "class_num": 25, "temp": 10.0}}},
        "backbone": _CONV64F, "tag": "ifsl_5shot_iid_seed0"},
})

# the finetuning family and the pretrainers: global heads over Conv64F's 1600
# flat features (Baseline, BaselinePlus), resnet12's 12800 or resnet12Bdc's
# 2080 BDC features; FEAT_Pretrain has no shipped config (its JAX defaults)
_FINETUNE_INNER = {"inner_train_iter": 20, "inner_batch_size": 4,
                   "inner_optim": {"lr": 0.01, "momentum": 0.9, "weight_decay": 0.001}}
SLICE_MODELS.update({
    name: {"classifier": {"name": name, "kwargs": {"num_class": 25, **kwargs}},
           "backbone": backbone, "tag": tag}
    for name, tag, kwargs, backbone in (
        ("Baseline", "baseline_5shot_iid_seed0", {"inner_param": _FINETUNE_INNER}, _CONV64F),
        ("BaselinePlus", "baseline_plus_5shot_iid_seed0", {"inner_param": {
            **_FINETUNE_INNER, "inner_optim": {"lr": 0.01, "momentum": 0.9}}}, _CONV64F),
        ("NegNet", "negnet_5shot_iid_seed0", {"margin": -0.01}, _RESNET12),
        ("RFSModel", "rfs_5shot_iid_seed0", {}, _RESNET12),
        ("SKDModel", "skd_5shot_iid_seed0", {"gamma": 1.0, "alpha": 0.1}, _RESNET12),
        ("MetabaselinePretrain", "metabaseline_pretrain_5shot_iid_seed0", {}, _RESNET12),
        ("FEAT_Pretrain", "feat_pretrain_no_shipped_config", {}, _RESNET12),
        ("DeepBDC_Pretrain", "deepbdc_pretrain_5shot_iid_seed0", {"val_type": "meta"},
         SLICE_MODELS["DeepBDC"]["backbone"]))})
# RENet on resnet12's [640, 8, 9] map, also with the fixture's dual loader
# (``dataloader_num: 2``, flat batches of 12; no shipped config sets it);
# FRN_Pretrain on the map (its shipped config names the plain resnet12,
# whose map FRN_Pretrain asks for), S2M2 on Conv64F's 1600 flat features;
# MTLPretrain and MetabaselineKendallPretrain (no shipped config) on
# resnet12's 12800 at their defaults
_RENET = {"classifier": {"name": "RENet", "kwargs": {"feat_dim": 640, "num_class": 25}},
          "backbone": _RESNET12_MAP, "tag": "renet_5shot_iid_seed0"}
SLICE_MODELS.update({
    "RENet": _RENET,
    "RENet:dual": {**_RENET, "dataloader_num": 2, "batch_size": 12,
                   "tag": "renet_5shot_dual_not_shipped"},
    "FRN_Pretrain": {"classifier": {"name": "FRN_Pretrain", "kwargs": {"num_class": 25}},
                     "backbone": _RESNET12, "tag": "frn_pretrain_5shot_iid_seed0"},
    "S2M2": {"classifier": {"name": "S2M2", "kwargs": {"num_class": 25}},
             "backbone": _CONV64F, "tag": "s2m2_5shot_iid_seed0"},
    "MTLPretrain": {"classifier": {"name": "MTLPretrain", "kwargs": {"num_class": 25}},
                    "backbone": _RESNET12, "tag": "mtl_pretrain_no_shipped_config"},
    "MetabaselineKendallPretrain": {
        "classifier": {"name": "MetabaselineKendallPretrain", "kwargs": {"num_class": 25}},
        "backbone": _RESNET12, "tag": "kendall_pretrain_no_shipped_config"},
})
# the backbones no shipped config names, each swapped into a shipped
# head's config at its JAX defaults ("<head>:<backbone>", NOT shipped
# traffic); WRN-28-10 and resnet12MTLofficial at fewer episodes a step (their
# first stages' bf16 activations at 16 episodes, 4496 segments, would be
# 28.9 GB and 14.5 GB each); ProtoNet on swin_t and swin_mini; ProtoNet on
# CLAPEmbeddingBackbone (a data_root of extracted embeddings) and with
# is_clap on the shipped Conv64F config (the random-init CLAP encoder in its
# place: a data_root of 1-D waveforms); IfslPretrain (no shipped config) on
# config/backbones/Conv64F.yaml's 1600 flat features, the first stage of the
# IFSL cycle that ends in DMatchingNet's config/ifsl/ifsl_5shot_iid_seed42
for key, backbone, extra in (
        ("DeepBDC:resnet18Bdc", {"name": "resnet18Bdc", "kwargs": {
            "num_channels": 1, "reduce_dim": 64}}, {}),
        ("MCL:resnet12_mcl", {"name": "resnet12_mcl", "kwargs": {"num_channels": 1}}, {}),
        ("R2D2:resnet12_r2d2", {"name": "resnet12_r2d2", "kwargs": {"num_channels": 1}}, {}),
        ("MTL:resnet12MTLofficial", {"name": "resnet12MTLofficial", "kwargs": {
            "num_channels": 1}}, {"test_episode_size": 8}),
        ("S2M2:resnet18", {"name": "resnet18", "kwargs": {"num_channels": 1}}, {}),
        ("ProtoNet:WRN", {"name": "WRN", "kwargs": {"num_channels": 1}},
         {"test_episode_size": 4}),
        ("ProtoNet:swin_t", {"name": "swin_t", "kwargs": {"num_channels": 1}}, {}),
        ("ProtoNet:swin_mini", {"name": "swin_mini", "kwargs": {"num_channels": 1}}, {}),
        ("ProtoNet:CLAPEmbeddingBackbone", {"name": "CLAPEmbeddingBackbone", "kwargs": None},
         {}),
        ("ProtoNet:is_clap", {**_CONV64F, "kwargs": {**_CONV64F["kwargs"],
                                                     "allow_random_init": True}},
         {"is_clap": True})):
    head = key.partition(":")[0]
    SLICE_MODELS[key] = {**copy.deepcopy(SLICE_MODELS[head]), "backbone": backbone, **extra,
                         "tag": f"{SLICE_MODELS[head]['tag']}_{backbone['name']}_not_shipped"}
SLICE_MODELS["ProtoNet:is_clap"]["tag"] = "proto_5shot_iid_seed0_is_clap_not_shipped"
SLICE_MODELS["IfslPretrain"] = {
    "classifier": {"name": "IfslPretrain", "kwargs": {"num_class": 25}},
    "backbone": _CONV64F, "save_part": ["emb_func", "classifier"],
    "tag": "ifsl_pretrain_no_shipped_config"}
SLICE_MODELS["DMatchingNet:seed42"] = {**copy.deepcopy(SLICE_MODELS["DMatchingNet"]),
                                       "seed": 42, "tag": "ifsl_5shot_iid_seed42"}


def slice_config(test_episode: int = 64, test_epoch: int = 2, precision: str = "bf16",
                 classifier: str = "DeepBDC",
                 test_episode_size: Optional[int] = None) -> Dict[str, Any]:
    """A full-width eval cell that ``chip_smoke.py`` and ``profile_eval``
    run on the card.

    ``classifier="DeepBDC"``: ``config/deepbdc/deepbdc_5shot_iid_seed0.yaml``
    (resnet12Bdc, ``reduce_dim`` 64); ``"ProtoNet"``:
    ``config/proto/proto_5shot_iid_seed0.yaml`` (Conv64F with the 64 → 1600
    logits head); a Conv64F metric head of ``SLICE_MODELS`` (DN4, ADM,
    ADM_KL, ConvMNet, ATLNet, MCL, RelationNet), a resnet12 head
    (MetaBaseline, MetaBaselineKendall, FEAT, DSN, FRN, CAN), CPEANet on
    vit_tiny, a meta head on Conv64F (R2D2, MAML, ANIL, BOIL, MeTAL, LEO,
    VERSA, DMatchingNet), MTL on resnet12, a finetuning head (Baseline and
    BaselinePlus on Conv64F, NegNet, RFSModel, SKDModel on resnet12) or a
    pretrainer (MetabaselinePretrain on resnet12, DeepBDC_Pretrain on
    resnet12Bdc, FRN_Pretrain on resnet12, S2M2 on Conv64F), RENet on
    resnet12's map (``"RENet:dual"``: with ``dataloader_num: 2`` and
    ``batch_size`` 12, not shipped): its shipped ``*_5shot_iid_seed0.yaml``;
    FEAT_Pretrain, MTLPretrain and MetabaselineKendallPretrain (no shipped
    config) on resnet12 at their defaults; ``"<head>:<backbone>"``: a
    shipped head's config on a backbone no shipped config names (DeepBDC on
    resnet18Bdc, MCL on resnet12_mcl, R2D2 on resnet12_r2d2, MTL on
    resnet12MTLofficial, S2M2 on resnet18, ProtoNet on WRN, swin_t, swin_mini
    and ``CLAPEmbeddingBackbone``; ``"ProtoNet:is_clap"``: the CLAP encoder
    in place of Conv64F; the CLAP cells need a ``data_root`` of embeddings or
    of waveforms), IfslPretrain on
    Conv64F and ``"DMatchingNet:seed42"`` (``ifsl_5shot_iid_seed42``).  Each
    with its headers, as a dict (no YAML needed), cut
    to size: ``test_episode`` 600 → 64 and ``test_epoch`` 5 → 2 by default,
    ``max_segments_per_clip`` 6, ``test_episode_size`` episodes per step (by
    default the entry's own, else 16), and a ``synthetic`` root of ``[1,
    128, 157]`` segments, since no dataset ships with the repository."""
    model = copy.deepcopy(SLICE_MODELS[classifier])
    if test_episode_size is None:
        test_episode_size = model.pop("test_episode_size", 16)
    return Config(None, {
        "seed": 0, **model, "modality": "audio",
        "way_num": 5, "shot_num": 5, "query_num": 10,
        "ood": False,
        "data_root": "synthetic",
        "spec_shape": [1, 128, 157],
        "max_segments_per_clip": 6,
        "test_episode_size": test_episode_size,
        "test_episode": test_episode,
        "test_epoch": test_epoch,
        "precision": precision,
    }).get_config_dict()


def resolve_tta_stats(cfg: Dict[str, Any], logger) -> Tuple[float, float]:
    """De/re-normalisation stats of the energy-OOD TTA pass.

    The reference always loads the Clean stats here, whatever the config's
    ``mean_std_file`` (``tta_mean_std_file``, default
    ``./Auxiliary/Clean_Mean_Std.npy``, which ships).  A missing file fails
    loudly, unless ``tta_allow_config_stats: true`` opts into the config's
    own stats."""
    clean = cfg.get("tta_mean_std_file", "./Auxiliary/Clean_Mean_Std.npy")
    if clean and os.path.isfile(clean):
        return load_mean_std(clean)
    if cfg.get("tta_allow_config_stats", False):
        logger.warning(
            "Clean stats %s not found — TTA falls back to the config's "
            "mean_std_file (tta_allow_config_stats=True)", clean,
        )
        return get_mean_std(cfg, "test")
    raise FileNotFoundError(
        f"energy-OOD TTA requires the Clean normalization stats "
        f"({clean!r} not found). The reference hard-codes "
        f"./Auxiliary/Clean_Mean_Std.npy for the de/re-norm step; falling "
        f"back to the config's own stats would silently change semantics. "
        f"Provide the file (tools/make_assets.py regenerates it), point "
        f"tta_mean_std_file at it, or set tta_allow_config_stats: true to "
        f"opt into the fallback."
    )


def world_for(config: Dict[str, Any], method: MethodBase, device: torch.device,
              divisors: Dict[str, Any]) -> World:
    """The run's ``World`` for ``method``: ``n_devices`` (or ``n_gpu`` > 1)
    must equal the world size, which must divide each value of
    ``divisors``; above one rank the method must be ``shardable``."""
    n_dev = config.get("n_devices") or (
        config["n_gpu"] if int(config.get("n_gpu", 1) or 1) > 1 else None)
    size = dist.get_world_size() if dist.is_initialized() else 1
    if size > 1 and not method.shardable:
        raise ValueError(
            f"{config['classifier']['name']} does not run over {size} ranks: its step has "
            "not been audited for a sharded episode axis (MethodBase.shardable); run it on one")
    return get_mesh(n_dev, divisors, device, config.get("device_ids"))


def flagged_segments(batch: EpisodeBatch, ep_idx: torch.Tensor, clip_idx: torch.Tensor,
                     cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The valid query segments of each flagged clip (episode ``ep_idx[k]``,
    clip ``clip_idx[k]``), in their order, at most ``cap`` of them:
    ``[K, S, C, H, W]`` and their validity ``[K, S]`` (S = min(cap, G))."""
    is_clip = (batch.query_clip[ep_idx] == clip_idx[:, None]) & (batch.query_mask[ep_idx] > 0)
    cap = min(cap, is_clip.shape[1])
    # a stable sort puts each flagged clip's segments first, in their order
    order = torch.argsort((~is_clip).to(torch.uint8), dim=1, stable=True)[:, :cap]
    return batch.query[ep_idx[:, None], order], is_clip.gather(1, order)


def tta_eval_step(method: MethodBase, batch: EpisodeBatch, setting: EpisodeSetting,
                  generator: torch.Generator, *, tta_mean: float, tta_std: float,
                  num_augmentations: int, tta_segments_per_clip: int, bank=None,
                  augment: Optional[Callable] = None,
                  world: Optional[World] = None) -> torch.Tensor:
    """Energy-OOD + TTA re-classification, per-episode accuracy ``[E]``.

    Flag the top-20 % most-uncertain query clips (``method.ood_topk``),
    REPLACE each flagged clip's segments with ``num_augmentations``
    augmented copies of each, and take the majority vote again over the
    augmented pool (the original segments are not re-scored).  The segment
    gather is per clip and exact: all valid segments of a flagged clip, in
    order, capped at ``tta_segments_per_clip``.  The copies are
    noise-suppressed (``batch_augment_spectrogram``), unless ``augment``
    (called as ``augment(segments, mean, std, num_augmentations, generator)``)
    makes them: a test can hand in given ones.

    With the method's ``use_bpa`` the support and query are BPA-transformed
    for the base vote, and each flagged clip's augmented segments are
    transformed jointly with the raw support (the transformed support is not
    reused: its width is that of the episode's own set).

    ``world`` of several ranks: ``batch`` is this rank's shard of the step.
    The uncertainties are gathered first, so the whole step's top 20 % is
    flagged; the rank re-votes the flagged clips of its own episodes, each
    with the noise-suppression values the whole step's draw gives it (the
    clip's rows of a draw for every flagged clip), and returns its
    episodes' accuracies."""
    if bank is not None:
        batch = materialize_episode_batch(batch, bank)
    sup_raw, qry_f = method.embed(batch)
    sup_f = sup_raw
    use_bpa = getattr(method, "use_bpa", False)
    if use_bpa:
        # the base votes score in the space the calibration pass scored in
        sup_f, qry_f = apply_bpa(sup_raw, qry_f, batch.query_mask)
    seg_logits = method.feature_logits(sup_f, qry_f, setting)

    wq = batch.num_query_clips
    uncertains, _ = method.clip_uncertainty(seg_logits, batch)
    top_idx = method.ood_topk(gather_rows(uncertains, world))  # the whole step's flags
    k_all, m = top_idx.shape[0], num_augmentations
    ep_idx, clip_idx = top_idx // wq, top_idx % wq
    positions = None  # of this rank's flagged clips in the whole step's order
    if world is not None and world.size > 1:
        first = world.rank * batch.num_episodes
        positions = torch.nonzero((ep_idx >= first)
                                  & (ep_idx < first + batch.num_episodes)).reshape(-1)
        ep_idx, clip_idx = ep_idx[positions] - first, clip_idx[positions]
    k = ep_idx.shape[0]
    votes = clip_vote_counts(seg_logits, batch.query_clip, batch.query_mask, wq)  # [E, Wq, way]
    if k > 0:
        segments, seg_valid = flagged_segments(batch, ep_idx, clip_idx, tta_segments_per_clip)
        s_cap = seg_valid.shape[1]
        flat = segments.reshape((k * s_cap,) + segments.shape[2:])
        if augment is None:
            params = draw_params("noise_suppression", k_all * s_cap * m, *flat.shape[-2:],
                                 generator)
            if positions is not None:  # each clip's S*M rows of the whole step's draw
                rows = positions.cpu()[:, None] * (s_cap * m) + torch.arange(s_cap * m)
                params = select_rows(params, rows.reshape(-1))
            aug = batch_augment_spectrogram(flat, tta_mean, tta_std, m, "noise_suppression",
                                            params=params)
        else:
            aug = augment(flat, tta_mean, tta_std, m, generator)  # [K*S*M, ...]
        aug_f = method.embed_segments(aug).reshape(k, s_cap * m, -1)
        # each flagged clip scores against its own episode's support set
        if use_bpa:
            # BPA features live in the affinity space of their own joint set:
            # each flagged clip's augmented segments are transformed anew
            # beside the raw support, the empty segment slots kept out of
            # the transport
            aug_mask = seg_valid.float().repeat_interleave(m, dim=1)  # [K, S*M]
            sup_t, aug_t = apply_bpa(sup_raw[ep_idx], aug_f, aug_mask)
            aug_logits = method.feature_logits(sup_t, aug_t, setting)
        else:
            aug_logits = method.feature_logits(sup_f[ep_idx], aug_f, setting)
        way = votes.shape[-1]
        aug_pred = F.one_hot(aug_logits.argmax(dim=-1), way).float().reshape(k, s_cap, m, way)
        aug_votes = (aug_pred * seg_valid[:, :, None, None].float()).sum(dim=(1, 2))  # [K, way]
        votes = votes.index_put((ep_idx, clip_idx), aug_votes)
    preds = votes.argmax(dim=-1)
    return (preds == batch.query_target).float().mean(dim=-1) * 100.0


class Test:
    __test__ = False  # not a pytest case (tests import this module)

    def __init__(self, rank: int, config: Dict[str, Any],
                 result_path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if config.get("precision", "bf16") == "fp32":
            # float32 means float32: cuDNN convolutions default to TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        maybe_init_distributed(config, self.device)
        self.rank = dist.get_rank() if dist.is_initialized() else rank
        self.config = config
        self.result_path = result_path
        self.logger = init_logger(
            os.path.join(result_path, "log_files") if result_path else None,
            level=config.get("log_level", "info"),
            file_name="{}-{}-test.log".format(
                config["classifier"]["name"], config["backbone"]["name"]
            ),
            rank=self.rank,
        )
        # the random init when no checkpoint
        init_seed(int(config.get("seed", 0)), config.get("deterministic"))
        self.method: MethodBase = build_method(config)
        # a step whose episodes do not split over the ranks runs replicated,
        # decided before the world is asked to divide them
        step = int(config.get("test_episode_size") or config.get("episode_size", 1))
        size = dist.get_world_size() if dist.is_initialized() else 1
        self.replicated = step % size != 0
        self.world = world_for(config, self.method, self.device,
                               {} if self.replicated else {"test_episode_size": step})
        self.device = self.world.device
        #: the world a step's episodes split over: one rank's when replicated
        self.step_world = World(0, 1, self.device) if self.replicated else self.world
        self.setting = eval_setting(config)
        modality = config.get("modality", "audio")
        # the val split feeds only the energy calibration pass
        self.val_loader = (
            get_dataloader(config, "val", self.method.model_type, False, modality)
            if getattr(self.method, "supports_energy_ood", False) else None
        )
        self.test_loader = get_dataloader(
            config, "test", self.method.model_type, False, modality
        )
        self._load_model()
        self.transfer_dtype = resolve_transfer_dtype(config.get("transfer_dtype"))
        self.val_bank, self.test_bank = self._setup_segment_banks()
        #: episodes per second of each test epoch (host clock, synchronised)
        self.epoch_eps: List[float] = []
        #: each test epoch's per-episode accuracies, in the one-rank order
        self.episode_accs: List[List[float]] = []
        #: the ``featdata_*.npz`` files ``dump_features`` wrote
        self.feature_dumps: List[str] = []
        requested = bool(config.get("enhance_classification_via_energy", False))
        supported = getattr(self.method, "supports_energy_ood", False)
        if requested and not supported:
            self.logger.warning("enhance_classification_via_energy: %s has no energy-OOD "
                                "pass; the test runs without TTA", config["classifier"]["name"])
        self.enhance_via_energy = requested and supported
        self.num_augmentations = int(config.get("num_augmentations", 10))
        # max_segments_per_clip 0 is the loader's "unlimited" sentinel: the
        # TTA's segment cap stays positive
        self.tta_segments_per_clip = int(config.get("tta_segments_per_clip")
                                         or config.get("max_segments_per_clip") or 8)
        self.tta_mean, self.tta_std = 0.0, 1.0

    def _load_model(self) -> None:
        ckpt = (os.path.join(self.result_path, "checkpoints", BEST)
                if self.result_path else None)
        if ckpt and os.path.isfile(ckpt):
            load_model(ckpt, self.method)
            self.logger.info("loaded checkpoint %s", ckpt)
        else:
            self.logger.warning("no checkpoint found — evaluating at init")
        # evaluation only: no parameter needs grad, so no call builds a graph
        self.method.to(self.device).eval().requires_grad_(False)
        replicate(self.method, self.world)

    def _setup_segment_banks(self):
        loaders = [self.test_loader[0]]
        if self.val_loader is not None:
            loaders.insert(0, self.val_loader[0])
        banks = setup_segment_banks(
            self.config, loaders, self.device, self.transfer_dtype, self.logger
        )
        if self.val_loader is None:
            return None, banks[0]
        return banks[0], banks[1]

    def _dump_features(self) -> None:
        """``dump_features``: the first test batch's ``featdata_*.npz``."""
        if not self.result_path:
            self.logger.warning("dump_features set but no result dir — skipped")
            return
        host_batch = next(iter(self.test_loader[0].epoch(0)))
        if self.test_bank is None:
            batch = host_batch.to(self.device, self.transfer_dtype)
        else:
            batch = materialize_episode_batch(host_batch.to(self.device), self.test_bank)
        self.feature_dumps = dump_episode_features(
            self.method, batch,
            self.result_path, normalize=bool(self.config.get("dump_features_normalize", True)),
            proj_method=str(self.config.get("dump_features_method", "tsne")),
            logger=self.logger)

    def _eval_step(self, host_batch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-episode accuracy (on the device) of this rank's shard of one
        host batch: ``_device_step``."""
        return self._device_step(shard_batch(host_batch, self.step_world, self.transfer_dtype),
                                 generator)

    def _device_step(self, batch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-episode accuracy ``[E / W]`` (on the device) of this rank's
        shard of a step, already on the device; with the energy-OOD TTA on,
        its re-vote with draws from ``generator``.  Counts the step's rows
        (``utils.spans``; the TTA's augmented passes not among them)."""
        with span("afs.step"):
            count_rows(batch)
            if self.enhance_via_energy:
                return tta_eval_step(
                    self.method, batch, self.setting, generator,
                    tta_mean=self.tta_mean, tta_std=self.tta_std,
                    num_augmentations=self.num_augmentations,
                    tta_segments_per_clip=self.tta_segments_per_clip, bank=self.test_bank,
                    world=self.step_world)
            if self.test_bank is not None:
                batch = materialize_episode_batch(batch, self.test_bank)
            with span("afs.head"):
                seg_logits = self.method(batch, self.setting)
            return self.method.eval_episode_accuracy(seg_logits, batch)

    @torch.no_grad()
    def test_loop(self) -> Tuple[float, float]:
        with replicated_rows() if self.replicated else contextlib.nullcontext():
            return self._test_loop()

    def _test_loop(self) -> Tuple[float, float]:
        cfg = self.config
        n_epochs = int(cfg.get("test_epoch", 5))
        if getattr(self.method, "supports_energy_ood", False):
            self.logger.info("============ Calibration pass on the val set ============")
            dump = (os.path.join(self.result_path, "uncertainty_data.npz")
                    if self.result_path and self.world.is_main else None)
            th = self.method.calibrate_threshold(
                self.val_loader[0], self.setting,
                policy=str(cfg.get("uncertainty_policy", "mean")),
                dump_path=dump, bank=self.val_bank, world=self.step_world,
            )
            self.logger.info("uncertainty threshold: %s", th)
        if self.enhance_via_energy:
            self.tta_mean, self.tta_std = resolve_tta_stats(cfg, self.logger)
            self.logger.info("energy-OOD TTA enabled: %d augmentations, top %.0f%% flagged",
                             self.num_augmentations, 100 * self.method.ood_fraction)
        if cfg.get("dump_features", False) and self.world.is_main:
            self._dump_features()
        # the TTA's draws: one generator seeded seed + 7, split into a
        # generator of its own per step
        master = torch.Generator().manual_seed(int(cfg.get("seed", 0)) + 7)

        def step_generator() -> Optional[torch.Generator]:
            if not self.enhance_via_energy:
                return None
            return torch.Generator().manual_seed(int(torch.randint(2 ** 62, (), generator=master)))

        if cfg.get("eval_warmup", True):
            # one discarded step: cuDNN plans and the kernel build stay out
            # of the epoch timer
            t0 = time.time()
            self._eval_step(next(iter(self.test_loader[0].epoch(0))),
                            torch.Generator().manual_seed(0)).cpu()
            self.logger.info("eval step warmed in %.1fs", time.time() - t0)

        # results stay on the device for ``depth`` steps: one host sync a
        # window (0: every step); on the bank-less path each pending step
        # keeps its payload alive, hence the smaller default
        configured = cfg.get("eval_queue_depth")
        depth = max(1, (32 if self.test_bank is not None else 4) if configured is None
                    else int(configured))
        epoch_means: List[float] = []
        for epoch in range(n_epochs):
            t0 = time.time()
            accs: List[float] = []
            pending: List[torch.Tensor] = []

            def drain():
                # each step's episodes in rank order: the one-rank order
                if pending:
                    accs.extend(torch.cat([gather_rows(p, self.step_world) for p in pending])
                                .cpu().tolist())
                pending.clear()

            for batch in transfer_ahead(self.test_loader[0].epoch(epoch), self.step_world,
                                        self.transfer_dtype):
                pending.append(self._device_step(batch, step_generator()))
                if len(pending) >= depth:
                    drain()
            drain()
            dt = time.time() - t0
            self.episode_accs.append(accs)
            mean, ci = mean_confidence_interval(accs)
            n_eps = len(accs)
            self.epoch_eps.append(n_eps / max(dt, 1e-9))
            self.logger.info(
                "Test epoch %d: Acc@1 %.3f ± %.3f (%d episodes, %.1f eps/s)",
                epoch, mean, ci, n_eps, self.epoch_eps[-1],
            )
            epoch_means.append(mean)

        agg_mean, agg_ci = mean_confidence_interval(epoch_means)
        self.logger.info("Aggregated: Acc@1 %.3f ± %.3f over %d epochs", agg_mean, agg_ci, n_epochs)
        return agg_mean, agg_ci
