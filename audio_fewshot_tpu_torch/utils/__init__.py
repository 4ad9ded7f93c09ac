"""Aggregation, weight conversion, checkpoints, logging, seeding, devices."""

from .aggregate import average_logits, majority_vote, mean_confidence_interval
from .device import resolve_device
from .logger import init_logger
from .seed import init_seed

__all__ = [
    "average_logits",
    "init_logger",
    "init_seed",
    "majority_vote",
    "mean_confidence_interval",
    "resolve_device",
]
