"""Seeding: python, numpy and torch, plus an explicit torch generator, and
the configs' ``deterministic`` switch of cuDNN's algorithms."""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch


def set_deterministic(deterministic: bool) -> None:
    """``deterministic`` true: cuDNN's deterministic algorithms and no
    autotuning (``cudnn.deterministic = True``, ``benchmark = False``), as
    the reference's ``init_seed``; false: autotuned algorithms
    (``benchmark = True``), whose sums may take another order each run."""
    torch.backends.cudnn.deterministic = bool(deterministic)
    torch.backends.cudnn.benchmark = not deterministic


def init_seed(seed: int = 0, deterministic: Optional[bool] = None) -> torch.Generator:
    """Seed the global RNGs (host-side episode sampling uses its own seeded
    numpy generators) and return a CPU ``torch.Generator`` for code that
    takes one explicitly.  ``deterministic`` (the config key; None leaves
    cuDNN as it is): ``set_deterministic``."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    if deterministic is not None:
        set_deterministic(deterministic)
    return torch.Generator().manual_seed(seed)
