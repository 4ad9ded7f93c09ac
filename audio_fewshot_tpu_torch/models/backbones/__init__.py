"""Backbone registry: embedding networks over [N, C, F, T] spectrograms."""

from . import resnet  # noqa: F401  (registers resnet12Bdc)
