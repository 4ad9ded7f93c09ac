"""Method builders (counterpart of ``audio_fewshot_tpu/models/__init__.py``)."""

import inspect
from typing import Any, Dict

import torch

from ..registry import BACKBONES, CLASSIFIERS
from . import backbones, heads  # noqa: F401  (populate registries)
from .base import EpisodeSetting, MethodBase, ModelType

_PRECISIONS = {"bf16": torch.bfloat16, "fp32": torch.float32}
# the configured backbone's kwargs that ``is_clap`` hands to ``CLAPBackbone``
_CLAP_KEYS = ("checkpoint_path", "allow_random_init", "enable_fusion")


def _takes(factory, name: str) -> bool:
    """Whether ``factory``'s signature names ``name`` (or takes ``**kwargs``)."""
    params = inspect.signature(factory).parameters
    return name in params or any(p.kind is p.VAR_KEYWORD for p in params.values())


def _build_backbone(config: Dict[str, Any], cls_factory) -> torch.nn.Module:
    """The configured backbone, with the knobs the classifier and the port
    inject.

    - ``requires_batch_stat_bn`` on the classifier forces
      ``use_running_statistics=False`` (the MAML family applies the backbone
      under adapted parameters and keeps every BN on batch statistics);
      ``backbone_kwarg_defaults`` sets finer knobs (e.g. DMatchingNet's
      running-statistics logits BN1d on Conv64F).
    - ``spec_shape`` (the segment's ``[C, F, T]``): torch infers no shapes,
      so Conv64F sizes its logits head from it.

    A config's own backbone kwargs win.  An injected knob reaches only a
    backbone whose factory's signature names it (``layers.backbone_factory``
    gives every registered backbone its class's signature); a user-given
    kwarg the backbone does not take still raises."""
    from ..data.dataset import segment_shape

    backbone = dict(config["backbone"])
    factory = BACKBONES.get(backbone["name"])
    bk_kwargs = dict(backbone.get("kwargs") or {})
    bk_kwargs.setdefault("num_channels", 1 if config.get("modality") == "audio" else 3)
    knobs = {}
    if getattr(cls_factory, "requires_batch_stat_bn", False):
        knobs["use_running_statistics"] = False
    knobs.update(getattr(cls_factory, "backbone_kwarg_defaults", None) or {})
    knobs["spec_shape"] = segment_shape(config)
    bk_kwargs.update({k: v for k, v in knobs.items()
                      if k not in bk_kwargs and _takes(factory, k)})
    bk_kwargs.setdefault("dtype", _PRECISIONS[config.get("precision", "bf16")])
    return factory(**bk_kwargs)


def _map_shape(config: Dict[str, Any], emb_func: torch.nn.Module):
    """``(c, h, w)`` of the backbone's output map for the config's segments.
    torch infers no shapes: heads that declare ``needs_map_shape`` (ConvMNet's
    scorer, ATLNet's transform, RelationNet's ``fc1``, FEAT's attention width,
    CAN's bottleneck, CPEA's ``fc2`` over the ViT's ``(tokens, dim)``) get it
    at construction, where flax sized them at init
    from a traced map."""
    from ..data.dataset import segment_shape

    if not hasattr(emb_func, "map_shape"):
        raise NotImplementedError(
            f"{config['classifier']['name']} on {config['backbone']['name']}: this backbone "
            "states no output map shape (the port has it for Conv64F, the resnet12 family but "
            "resnet12Bdc, resnet18, WRN, the ViTs and Swin)")
    return tuple(emb_func.map_shape(segment_shape(config)))


def _feature_dim(config: Dict[str, Any], emb_func: torch.nn.Module) -> int:
    """The width of the backbone's flat features for the config's segments,
    for heads that declare ``needs_feat_dim`` (the Linear heads of the MAML
    family, MeTAL and MTL, LEO's decoder, VERSA's trunk, DMatchingNet's
    splits and pretrained classifier: flax sized them at init)."""
    from ..data.dataset import segment_shape

    if not hasattr(emb_func, "feature_dim"):
        raise NotImplementedError(
            f"{config['classifier']['name']} on {config['backbone']['name']}: this backbone "
            "states no flat feature width (the port has it for Conv64F, the resnet12 family, "
            "resnet18, resnet18Bdc, WRN, Swin and the CLAP backbones)")
    return int(emb_func.feature_dim(segment_shape(config)))


def build_method(config: Dict[str, Any]) -> MethodBase:
    """Config → method (an ``nn.Module`` on the CPU; the caller moves it).

    ``precision`` (default ``bf16``) is the backbone's compute dtype; the
    heads and the logits always compute in float32.  This function leaves
    the process's TF32 switches alone: ``Test`` and ``Trainer`` turn TF32 off
    for ``fp32`` runs.  ``is_clap`` puts ``CLAPBackbone`` (the waveform
    encoder) in place of a configured backbone whose name does not start
    with ``CLAP``, keeping only its ``checkpoint_path``,
    ``allow_random_init`` and ``enable_fusion`` kwargs (the reference drops
    the configured backbone with its kwargs)."""
    precision = config.get("precision", "bf16")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}, got {precision!r}")
    if config.get("is_clap") and not str(config["backbone"].get("name", "")).startswith("CLAP"):
        kwargs = config["backbone"].get("kwargs") or {}
        config = {**config, "backbone": {"name": "CLAPBackbone", "kwargs": {
            k: v for k, v in kwargs.items() if k in _CLAP_KEYS}}}

    cls_factory = CLASSIFIERS.get(config["classifier"]["name"])
    cls_kwargs = dict(config["classifier"].get("kwargs") or {})
    cls_kwargs["emb_func"] = _build_backbone(config, cls_factory)
    if getattr(cls_factory, "needs_map_shape", False):
        cls_kwargs["map_shape"] = _map_shape(config, cls_kwargs["emb_func"])
    if getattr(cls_factory, "needs_feat_dim", False):
        # the backbone's width, whatever the config says: the JAX package
        # sizes these heads from the traced features and reads no config
        # width (ifsl_dmatching_smoke.yaml's feat_dim: 64)
        cls_kwargs["feat_dim"] = _feature_dim(config, cls_kwargs["emb_func"])
    # episode-geometry kwargs, as the reference passes to every classifier
    for key, val in (
        ("way_num", config.get("way_num")),
        ("shot_num", (config.get("shot_num") or 0) * config.get("augment_times", 1) or None),
        ("query_num", config.get("query_num")),
    ):
        if val is not None:
            cls_kwargs.setdefault(key, val)
    return cls_factory(**cls_kwargs)


def train_setting(config: Dict[str, Any]) -> EpisodeSetting:
    """Train geometry; shot is inflated by augment_times."""
    return EpisodeSetting(
        way=config["way_num"],
        shot=config["shot_num"] * config.get("augment_times", 1),
        query=config["query_num"],
    )


def eval_setting(config: Dict[str, Any]) -> EpisodeSetting:
    """Eval geometry; shot is inflated by augment_times as in training."""
    return EpisodeSetting(
        way=config["test_way"],
        shot=config["test_shot"] * config.get("augment_times", 1),
        query=config["test_query"],
    )


__all__ = ["EpisodeSetting", "MethodBase", "ModelType", "build_method", "eval_setting",
           "train_setting"]
