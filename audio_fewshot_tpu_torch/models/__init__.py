"""Method builders (counterpart of ``audio_fewshot_tpu/models/__init__.py``)."""

from typing import Any, Dict

import torch

from ..registry import BACKBONES, CLASSIFIERS
from . import backbones, heads  # noqa: F401  (populate registries)
from .base import EpisodeSetting, MethodBase, ModelType

_PRECISIONS = {"bf16": torch.bfloat16, "fp32": torch.float32}


def build_method(config: Dict[str, Any]) -> MethodBase:
    """Config → method (an ``nn.Module`` on the CPU; the caller moves it).

    ``precision`` (default ``bf16``) is the backbone's compute dtype; the BDC
    head and the logits always compute in float32.  The builder leaves the
    process's TF32 switches alone: ``Test`` turns TF32 off for ``fp32`` runs."""
    precision = config.get("precision", "bf16")
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(_PRECISIONS)}, got {precision!r}")

    backbone = dict(config["backbone"])
    bk_kwargs = dict(backbone.get("kwargs") or {})
    bk_kwargs.setdefault("num_channels", 1 if config.get("modality") == "audio" else 3)
    bk_kwargs.setdefault("dtype", _PRECISIONS[precision])
    emb_func = BACKBONES.build(backbone["name"], **bk_kwargs)

    cls_kwargs = dict(config["classifier"].get("kwargs") or {})
    cls_kwargs["emb_func"] = emb_func
    # episode-geometry kwargs, as the reference passes to every classifier
    for key, val in (
        ("way_num", config.get("way_num")),
        ("shot_num", (config.get("shot_num") or 0) * config.get("augment_times", 1) or None),
        ("query_num", config.get("query_num")),
    ):
        if val is not None:
            cls_kwargs.setdefault(key, val)
    return CLASSIFIERS.build(config["classifier"]["name"], **cls_kwargs)


def eval_setting(config: Dict[str, Any]) -> EpisodeSetting:
    """Eval geometry; shot is inflated by augment_times as in training."""
    return EpisodeSetting(
        way=config["test_way"],
        shot=config["test_shot"] * config.get("augment_times", 1),
        query=config["test_query"],
    )


__all__ = ["EpisodeSetting", "MethodBase", "ModelType", "build_method", "eval_setting"]
