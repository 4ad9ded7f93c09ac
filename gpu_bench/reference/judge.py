"""The comparison that decides ``correct``: the program's outputs against
the plain reference, worked out again from the seed and the benchmark's
weights.

Eval (the episodes of a sample of the window's steps):

- ``structure``: episodes whose clips the program packed with another
  number of segments, or whose clip labels differ, from the reference's
  (limit 0);
- ``vote``: episodes whose accuracy is not the clip vote of the program's
  own segment logits (limit 0);
- ``logit_gap``: the widest gap between a segment's logits and the
  reference's, each centred over the classes (the vote and the softmax see
  only the differences between classes), over the reference's widest
  centred logit.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from .common import PRECISIONS, float32_exact, in_blocks, vote_accuracy
from .data import build_episodes, episode_plans, synthetic_split

#: rows of segments through a reference backbone at a time
BLOCK_ROWS = 128


def _geometry(model: Dict[str, Any]):
    return model["way_num"], model["shot_num"], model["query_num"]


def backbone_input(x: torch.Tensor, model: Dict[str, Any]) -> torch.Tensor:
    """The segments as the configuration's backbone takes them: rounded to
    bfloat16 where its ``precision`` is bf16, every later operation in
    float32."""
    return x.to(torch.bfloat16).float() if model.get("precision") == "bf16" else x


def reference_logits(ref, weights, eps, model: Dict[str, Any], device,
                     precision: str = "fp32") -> torch.Tensor:
    """The reference's segment logits ``[E, G, way]`` of a step's episodes
    (padded segments left at 0)."""
    q = PRECISIONS[precision]
    way, shot, _ = _geometry(model)
    feat = lambda x: ref.features(weights, backbone_input(x, model), q=q)
    e, ws = eps.support.shape[:2]
    with torch.no_grad(), float32_exact():
        sup = torch.as_tensor(eps.support, device=device).reshape((e * ws,) + eps.support.shape[2:])
        sup_f = in_blocks(feat, sup, BLOCK_ROWS).reshape(e, ws, -1)
        valid = np.nonzero(eps.query_mask.reshape(-1))[0]
        rows = torch.as_tensor(eps.query.reshape((-1,) + eps.query.shape[2:])[valid], device=device)
        q_valid = in_blocks(feat, rows, BLOCK_ROWS)
        qry_f = torch.zeros((e * eps.query.shape[1], q_valid.shape[1]), device=device)
        qry_f[torch.as_tensor(valid, device=device)] = q_valid
        return ref.logits(sup_f, qry_f.reshape(e, eps.query.shape[1], -1), way, shot)


def _by_clip(logits: np.ndarray, clip: np.ndarray, mask: np.ndarray, n_clips: int) -> List:
    """Each clip's valid segment logits, in their order."""
    return [logits[(clip == c) & (mask > 0)] for c in range(n_clips)]


def logit_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    """Widest gap of class-centred logits ``[N, way]``, over the reference's
    widest centred logit."""
    centre = lambda x: x - x.mean(axis=-1, keepdims=True)
    scale = np.abs(centre(ref)).max()
    return float(np.abs(centre(prog) - centre(ref)).max() / max(scale, 1e-30))


def step_episodes(model: Dict[str, Any], seed: int, split, epoch: int, step: int, size: int):
    """The episodes of step ``step`` of test epoch ``epoch`` at ``size`` a step."""
    way, shot, query = _geometry(model)
    plans = episode_plans(seed, "test", epoch, (step + 1) * size, way, shot, query)
    return build_episodes(split, plans[step * size:])


def eval_readings(ref, weights, model: Dict[str, Any], seed: int, samples: Sequence[Dict],
                  device, precisions: Sequence[str] = ("fp32",)) -> Dict[str, float]:
    """The eval numbers of the program's ``samples`` (each a step: ``epoch``,
    ``step``, ``size``, and the program's ``clip``, ``mask`` ``[E, G]``,
    ``logits`` ``[E, G, way]``, ``acc`` ``[E]`` as numpy), against the
    float32 reference; with ``"fp8"`` in ``precisions`` also the control's
    ``control_logit_gap`` (the reference in float8 against the reference)."""
    split = synthetic_split(seed, "test", tuple(model["spec_shape"]),
                            int(model["max_segments_per_clip"]))
    structure = vote = 0
    prog_rows, ref_rows, low_rows = [], [], []
    for s in samples:
        eps = step_episodes(model, seed, split, s["epoch"], s["step"], s["size"])
        ref_logits = reference_logits(ref, weights, eps, model, device).cpu().numpy()
        low = (reference_logits(ref, weights, eps, model, device, "fp8").cpu().numpy()
               if "fp8" in precisions else None)
        n_clips = eps.query_target.shape[1]
        own_vote = vote_accuracy(torch.as_tensor(s["logits"]), torch.as_tensor(s["clip"]),
                                 torch.as_tensor(s["mask"]),
                                 torch.as_tensor(eps.query_target)).numpy()
        vote += int(np.sum(np.abs(own_vote - s["acc"]) > 1e-4))
        for i in range(eps.support.shape[0]):
            p = _by_clip(s["logits"][i], s["clip"][i], s["mask"][i], n_clips)
            r = _by_clip(ref_logits[i], eps.query_clip[i], eps.query_mask[i], n_clips)
            if [len(x) for x in p] != [len(x) for x in r] or not np.array_equal(
                    s["target"][i], eps.query_target[i]):
                structure += 1
                continue
            prog_rows += p
            ref_rows += r
            if low is not None:
                low_rows += _by_clip(low[i], eps.query_clip[i], eps.query_mask[i], n_clips)
    out = {"structure": float(structure), "vote": float(vote),
           "logit_gap": logit_gap(np.concatenate(prog_rows), np.concatenate(ref_rows))
           if prog_rows else float("inf")}
    if low_rows:
        out["control_logit_gap"] = logit_gap(np.concatenate(low_rows), np.concatenate(ref_rows))
    return out
