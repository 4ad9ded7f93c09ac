"""The port's checkpoints: ``torch.save`` of the method's ``state_dict``.

The JAX package writes flax msgpack under the same file names; those files
are not read here.  Weights cross packages through ``utils/convert.py``.
"""

from __future__ import annotations

import os
import pickle

import torch
from torch import nn

BEST = "model_best.pth"


def save_model_best(result_path: str, method: nn.Module) -> str:
    """Write ``<result_path>/checkpoints/model_best.pth`` atomically."""
    ckpt_dir = os.path.join(result_path, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, BEST)
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in method.state_dict().items()}, tmp)
    os.replace(tmp, path)
    return path


def load_model(path: str, method: nn.Module) -> None:
    """Load a port checkpoint into ``method`` (all keys must match)."""
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as err:
        raise ValueError(
            f"{path} is not a checkpoint of this package (a JAX package "
            "checkpoint is flax msgpack: convert its variables with "
            "utils.convert.state_dict_from_jax)"
        ) from err
    method.load_state_dict(state)
