"""The port's checkpoints (counterpart of
``audio_fewshot_tpu/utils/checkpoint.py``): ``torch.save`` files with the
JAX package's names and best/last/part semantics.

- ``model_best.pth`` and ``model_{epoch:05d}.pth`` hold the method's
  ``state_dict`` alone (``load_model`` reads them, and so does ``Test``);
- ``model_last.pth`` holds the full training state: ``epoch``,
  ``state_dict``, the best accuracies, the scheduler's and the optimizer's
  state (``load_last``);
- ``{part}_best.pth`` / ``{part}_{epoch:05d}.pth`` / ``{part}_last.pth``
  hold one submodule's entries of the state dict, under their full keys
  (``emb_func.…``), for ``pretrain_path`` (``load_part``).

Every file is written to a temporary name and renamed into place.  The JAX
package writes flax msgpack under the same names; those files are not read
here.  Weights cross packages through ``utils/convert.py``.
"""

from __future__ import annotations

import enum
import os
import pickle
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

BEST = "model_best.pth"
LAST = "model_last.pth"


class SaveType(enum.Enum):
    BEST = 0
    NORMAL = 1
    LAST = 2


def _atomic_save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_state(method: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in method.state_dict().items()}


def _load(path: str) -> Any:
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as err:
        raise ValueError(
            f"{path} is not a checkpoint of this package (a JAX package "
            "checkpoint is flax msgpack: convert its variables with "
            "utils.convert.state_dict_from_jax)"
        ) from err


def save_model(ckpt_dir: str, method: nn.Module, epoch: int, save_type: SaveType,
               train_state: Optional[Dict[str, Any]] = None,
               save_part: Sequence[str] = ()) -> str:
    """Write ``model_best.pth`` / ``model_{epoch:05d}.pth`` /
    ``model_last.pth`` (the last with ``train_state`` beside the weights)
    and the matching ``{part}_…`` files.  Returns the model file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    stem = {SaveType.BEST: "model_best", SaveType.NORMAL: f"model_{epoch:05d}",
            SaveType.LAST: "model_last"}[save_type]
    state = _cpu_state(method)
    path = os.path.join(ckpt_dir, stem + ".pth")
    if save_type == SaveType.LAST:
        _atomic_save({"epoch": epoch, "state_dict": state, **(train_state or {})}, path)
    else:
        _atomic_save(state, path)
    for part in save_part:
        sub = {k: v for k, v in state.items() if k.startswith(part + ".")}
        if sub:
            _atomic_save(sub, os.path.join(ckpt_dir, stem.replace("model", part, 1) + ".pth"))
    return path


def save_model_best(result_path: str, method: nn.Module) -> str:
    """Write ``<result_path>/checkpoints/model_best.pth``."""
    return save_model(os.path.join(result_path, "checkpoints"), method, 0, SaveType.BEST)


def load_model(path: str, method: nn.Module) -> None:
    """Load a port checkpoint of the whole method (all keys must match)."""
    method.load_state_dict(_load(path))


_RUNNING = ("running_mean", "running_var", "num_batches_tracked")


def load_part(path: str, method: nn.Module, part: str = "emb_func") -> None:
    """Load a ``{part}_….pth`` file into ``method``'s ``part`` submodule;
    every entry of that submodule must be in the file.  Running statistics
    the submodule does not hold are left out: a method whose BNs run on
    batch statistics (the MAML family, DMatchingNet) loads a backbone saved
    with them, as the JAX package loads them into statistics it never
    reads."""
    state = _load(path)
    own = {k for k in method.state_dict() if k.startswith(part + ".")}
    if not own:
        raise KeyError(f"part {part!r} not present in the method")
    state = {k: v for k, v in state.items() if k in own or not k.endswith(_RUNNING)}
    if set(state) != own:
        raise KeyError(
            f"{path} does not hold the {part!r} part: missing "
            f"{sorted(own - set(state))[:5]}, unexpected {sorted(set(state) - own)[:5]}"
        )
    method.load_state_dict(state, strict=False)


def read_part(path: str, part: str) -> Dict[str, torch.Tensor]:
    """A ``{part}_….pth`` file's entries with the ``{part}.`` prefix taken
    off, for a module that holds the part under another name (DMatchingNet's
    ``cls_path``: IfslPretrain's ``classifier``)."""
    state = _load(path)
    if not state or not all(k.startswith(part + ".") for k in state):
        raise KeyError(f"{path} does not hold the {part!r} part: keys {sorted(state)[:5]}")
    return {k[len(part) + 1:]: v for k, v in state.items()}


def load_last(path: str) -> Dict[str, Any]:
    """The training state of ``model_last.pth`` (``state_dict``, ``epoch``,
    best accuracies, ``scheduler``, ``optimizer``)."""
    return _load(path)
