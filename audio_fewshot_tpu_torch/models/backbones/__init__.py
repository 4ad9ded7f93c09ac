"""Backbone registry: embedding networks over [N, C, F, T] spectrograms."""

from . import conv_four, resnet, vit  # noqa: F401  (register the backbones)
