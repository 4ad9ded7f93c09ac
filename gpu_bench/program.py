"""What the drivers share about the program under test: its configuration
dict, the benchmark's weights loaded into it, and the samples of its
outputs that the comparison reads."""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import manifest, weights
from .manifest import ROOT, Cell

#: the raw normalisation statistics both the program and the reference read
MEAN_STD_FILE = ROOT / "Auxiliary" / "Clean_Mean_Std.npy"


def config(cell: Cell, seed: int, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The program's config dict: the configuration's ``config``, the
    traffic's ``config``, then ``overrides`` (a test's smaller sizes), at
    ``seed``."""
    from audio_fewshot_tpu_torch.config import Config

    merged = copy.deepcopy(cell.config["config"])
    merged.update(copy.deepcopy(cell.traffic.get("config", {})))
    merged.update(copy.deepcopy(overrides or {}))
    merged.update(seed=int(seed), log_level="warning", mean_std_file=str(MEAN_STD_FILE))
    return Config(None, merged).get_config_dict()


def model_config(cell: Cell, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The configuration's ``config`` with ``overrides``: what the reference
    reads."""
    return {**cell.config["config"], **(overrides or {})}


def load_weights(method: torch.nn.Module, cell: Cell, seed: int, device: torch.device,
                 overrides: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
    """Draw the cell's weights from ``seed`` on ``device``, load them into
    ``method`` (every key, no other) and return them for the reference."""
    spec = manifest.reference(cell).weight_spec(model_config(cell, overrides))
    drawn = weights.draw(spec, seed, device)
    method.load_state_dict(drawn, strict=True)
    return drawn


def sample_indices(seed: int, n: int, k: int) -> np.ndarray:
    """``k`` of ``range(n)`` drawn from ``seed``, in order."""
    rng = np.random.default_rng([int(seed), 7])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def bdc_shape(cell: Cell, cfg: Dict[str, Any], rows: int) -> Optional[tuple]:
    """``(B, d, M)`` of the BDC pool's launch over ``rows`` segments, where
    the configuration's backbone has the BDC head: d = ``reduce_dim``, M the
    positions of the map after three 2 × 2 pools."""
    kwargs = cell.config["config"]["backbone"]["kwargs"] or {}
    if "reduce_dim" not in kwargs:
        return None
    _, h, w = cfg["spec_shape"]
    return rows, int(kwargs["reduce_dim"]), (h // 8) * (w // 8)
