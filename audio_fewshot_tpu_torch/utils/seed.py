"""Seeding: python, numpy and torch, plus an explicit torch generator."""

from __future__ import annotations

import random

import numpy as np
import torch


def init_seed(seed: int = 0) -> torch.Generator:
    """Seed the global RNGs (host-side episode sampling uses its own seeded
    numpy generators) and return a CPU ``torch.Generator`` for code that
    takes one explicitly."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
