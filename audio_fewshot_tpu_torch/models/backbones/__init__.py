"""Backbone registry: embedding networks over [N, C, F, T] spectrograms."""

from . import clap, conv_four, resnet, resnet18, swin, vit, wrn  # noqa: F401  (register the backbones)
