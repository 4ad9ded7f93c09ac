"""Method (classifier) registry."""

from . import deepbdc  # noqa: F401  (registers DeepBDC)
