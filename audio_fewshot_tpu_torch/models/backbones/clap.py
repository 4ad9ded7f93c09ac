"""The CLAP backbones (counterpart of
``audio_fewshot_tpu/models/backbones/clap.py``).

``CLAPEmbeddingBackbone`` passes pre-extracted CLAP embeddings through
(``[N, ...]`` → ``[N, D]`` float32), optionally through a Linear ``proj`` of
width ``project_dim``.  ``CLAPBackbone`` is the waveform encoder
(``clap_encoder.CLAPAudioEncoder``, HTSAT-tiny and CLAP's projection).
No pretrained CLAP weights ship with the repository, so it needs
``checkpoint_path`` (a flat npz the ``Trainer`` loads, or the extraction CLI's
``--checkpoint``) or an explicit ``allow_random_init``.  Both factories
drop ``num_channels`` and ``dtype`` (the encoder's body computes in bf16, the
embeddings pass in float32); ``CLAPBackbone`` also drops ``enable_fusion``
(the fusion variant is not built).
"""

from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn

from ...registry import BACKBONES
from ..init import dense
from .clap_encoder import CLAPAudioEncoder


class CLAPEmbeddingBackbone(nn.Module):
    def __init__(self, embed_dim: int = 512, project_dim: int = 0):
        super().__init__()
        self.embed_dim = embed_dim
        self.proj = dense(embed_dim, project_dim) if project_dim else None

    def feature_dim(self, spec_shape=None) -> int:
        return self.proj.out_features if self.proj is not None else self.embed_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).float()
        return self.proj(x) if self.proj is not None else x


@BACKBONES.register("CLAPEmbeddingBackbone")
def clap_embedding_backbone(embed_dim: Optional[int] = None, project_dim: Optional[int] = None,
                            num_channels=None, dtype=None) -> CLAPEmbeddingBackbone:
    kwargs = {k: v for k, v in (("embed_dim", embed_dim), ("project_dim", project_dim))
              if v is not None}
    return CLAPEmbeddingBackbone(**kwargs)


@BACKBONES.register("CLAPBackbone")
def clap_backbone(checkpoint_path: Optional[str] = None, allow_random_init: bool = False,
                  num_channels=None, dtype=None, enable_fusion=None,
                  **kwargs) -> CLAPAudioEncoder:
    """The encoder; ``kwargs`` are ``CLAPAudioEncoder``'s (None dropped).
    Raises unless ``checkpoint_path`` or ``allow_random_init`` is given."""
    if not checkpoint_path and not allow_random_init:
        raise ValueError(
            "CLAPBackbone has no bundled pretrained weights: pass "
            "backbone.kwargs.checkpoint_path (a flat npz from "
            "tools/convert_clap_checkpoint.py, loaded by the Trainer) or set "
            "allow_random_init: true; for pre-extracted embeddings use "
            "CLAPEmbeddingBackbone")
    return CLAPAudioEncoder(**{k: v for k, v in kwargs.items() if v is not None})


# the encoder's own kwargs beside the factory's, and no **kwargs: build_method
# injects a knob (spec_shape) only where a factory's signature names it
clap_backbone.__signature__ = inspect.Signature(
    [p for name, p in inspect.signature(CLAPAudioEncoder).parameters.items() if name != "dtype"]
    + [p.replace(kind=inspect.Parameter.KEYWORD_ONLY)
       for name, p in inspect.signature(clap_backbone).parameters.items()
       if name != "kwargs"])
