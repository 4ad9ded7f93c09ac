"""The benchmark's inputs worked out again from the seed: the synthetic
log-mel dataset, the episodic sampler and the ragged packing of query
clips, as plain NumPy.

A frozen copy of the semantics of the program's ``synthetic`` data root
(class-conditional Gaussian segments, clip lengths of 1..``max_segments``
segments), of its episode sampler and of its padding of a step's query
clips to a power-of-two length.  Nothing here imports the program: the
comparison holds the program's batches and outputs against these.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

SPLIT_INDEX = {"train": 0, "val": 1, "test": 2}
SPLIT_CLASSES = {"train": 25, "val": 5, "test": 8}
SPLIT_OFFSET = {"train": 0, "val": 25, "test": 30}
CLIPS_PER_CLASS = 40


@dataclass
class Split:
    """One split's clips: ``clips[class][clip]`` is ``[n_seg, C, F, T]``."""

    clips: List[List[np.ndarray]]
    class_offset: int


@dataclass
class Episodes:
    """A step of ``E`` episodes as plain arrays: ``support`` ``[E, W*S, C, F, T]``,
    ``query`` ``[E, G, C, F, T]`` (zero padded), ``query_clip`` and
    ``query_mask`` ``[E, G]``, ``query_target`` ``[E, W*Q]`` (local labels),
    ``repeats`` ``[E, W*Q]`` (segments of each query clip)."""

    support: np.ndarray
    query: np.ndarray
    query_clip: np.ndarray
    query_mask: np.ndarray
    query_target: np.ndarray
    repeats: np.ndarray


def synthetic_split(seed: int, split: str, segment_shape: Tuple[int, int, int],
                    max_segments: int) -> Split:
    """The split's class-conditional Gaussian clips, drawn in the order the
    ``synthetic`` root draws them: the class means, then each clip's length
    and its noise, class by class."""
    rng = np.random.default_rng(seed + SPLIT_INDEX[split])
    c, f, t = segment_shape
    n_classes = SPLIT_CLASSES[split]
    max_seg = 1 if split == "train" else max_segments
    means = rng.normal(0.0, 1.0, size=(n_classes, c, f, 1)).astype(np.float32)
    clips = []
    for k in range(n_classes):
        row = []
        for _ in range(CLIPS_PER_CLASS):
            n_seg = int(rng.integers(1, max_seg + 1))
            row.append(rng.normal(0.0, 1.0, size=(n_seg, c, f, t)).astype(np.float32) + means[k])
        clips.append(row)
    return Split(clips, SPLIT_OFFSET[split])


def episode_plans(seed: int, split: str, epoch: int, n_episodes: int, way: int, shot: int,
                  query: int) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The first ``n_episodes`` episodes of an epoch: ``(classes [way],
    support [way, shot], query [way, query])`` clip indices, drawn from
    ``default_rng((seed + 1000 · split, epoch))``."""
    rng = np.random.default_rng((seed + 1000 * SPLIT_INDEX[split], epoch))
    counts = np.full(SPLIT_CLASSES[split], CLIPS_PER_CLASS)
    eligible = np.nonzero(counts >= shot + query)[0]
    plans = []
    for _ in range(n_episodes):
        classes = rng.choice(eligible, size=way, replace=False)
        sup = np.empty((way, shot), dtype=np.int64)
        qry = np.empty((way, query), dtype=np.int64)
        for i, c in enumerate(classes):
            pick = rng.choice(counts[c], size=shot + query, replace=False)
            sup[i], qry[i] = pick[:shot], pick[shot:]
        plans.append((classes, sup, qry))
    return plans


def bucket(needed: int) -> int:
    """The padded query length: the least power of two that holds ``needed``."""
    g = 1
    while g < needed:
        g *= 2
    return g


def build_episodes(data: Split, plans) -> Episodes:
    """A step's eval episodes: each support clip's first segment; each query
    clip whole, packed clip after clip and padded with zeros to ``bucket``."""
    way, shot = plans[0][1].shape
    query_n = plans[0][2].shape[1]
    seg_shape = data.clips[0][0].shape[1:]
    e, wq = len(plans), way * query_n
    support = np.stack([np.stack([data.clips[c][k][0] for w, c in enumerate(cls) for k in sup[w]])
                        for cls, sup, _ in plans])
    per_episode = [[data.clips[c][k] for w, c in enumerate(cls) for k in qry[w]]
                   for cls, _, qry in plans]
    repeats = np.asarray([[clip.shape[0] for clip in clips] for clips in per_episode])
    g = bucket(int(repeats.sum(axis=1).max()))
    query = np.zeros((e, g) + seg_shape, dtype=np.float32)
    clip_id = np.zeros((e, g), dtype=np.int64)
    mask = np.zeros((e, g), dtype=np.float32)
    for i, clips in enumerate(per_episode):
        segs = np.concatenate(clips)
        query[i, :len(segs)] = segs
        clip_id[i, :len(segs)] = np.repeat(np.arange(wq), repeats[i])
        mask[i, :len(segs)] = 1.0
    target = np.broadcast_to(np.repeat(np.arange(way), query_n), (e, wq)).copy()
    return Episodes(support, query, clip_id, mask, target, repeats)
