"""Seeded episodic N-way-K-shot sampling (counterpart of
``audio_fewshot_tpu/data/sampler.py``).

Each episode draws ``way`` classes; per class ``shot`` support clips and
``query`` query clips, without overlap; ``episode_size`` episodes per batch.
Sampling is numpy index bookkeeping on the host, in the same draw order as
the JAX package, so the same seed gives the same episodes.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np


@dataclass(frozen=True)
class EpisodeIndices:
    """Index plan for one episode: way-major clip indices."""

    classes: np.ndarray  # [way] class indices into the dataset
    support: np.ndarray  # [way, shot] clip indices within class
    query: np.ndarray  # [way, query] clip indices within class


class EpisodicSampler:
    def __init__(
        self,
        clips_per_class: List[int],
        way: int,
        shot: int,
        query: int,
        episodes_per_epoch: int,
        episode_size: int = 1,
        seed: int = 0,
    ):
        self.counts = np.asarray(clips_per_class)
        self.way = way
        self.shot = shot
        self.query = query
        self.episodes_per_epoch = episodes_per_epoch
        self.episode_size = episode_size
        self.seed = seed
        if episodes_per_epoch % episode_size:
            dropped = episodes_per_epoch % episode_size
            warnings.warn(
                f"episodes_per_epoch={episodes_per_epoch} is not divisible "
                f"by episode_size={episode_size}: the trailing {dropped} "
                f"episode(s) per epoch are dropped",
                stacklevel=2,
            )
        need = shot + query
        eligible = np.nonzero(self.counts >= need)[0]
        if len(eligible) < way:
            raise ValueError(
                f"need {way} classes with ≥ {need} clips; only {len(eligible)} "
                f"of {len(self.counts)} qualify"
            )
        self.eligible = eligible

    def epoch(self, epoch_idx: int) -> Iterator[List[EpisodeIndices]]:
        """Yield ``episodes_per_epoch // episode_size`` batches of episode
        plans, seeded by (seed, epoch)."""
        rng = np.random.default_rng((self.seed, epoch_idx))
        for _ in range(self.episodes_per_epoch // self.episode_size):
            yield [self._sample_episode(rng) for _ in range(self.episode_size)]

    def _sample_episode(self, rng: np.random.Generator) -> EpisodeIndices:
        cls = rng.choice(self.eligible, size=self.way, replace=False)
        support = np.empty((self.way, self.shot), dtype=np.int64)
        query = np.empty((self.way, self.query), dtype=np.int64)
        for i, c in enumerate(cls):
            pick = rng.choice(self.counts[c], size=self.shot + self.query, replace=False)
            support[i] = pick[: self.shot]
            query[i] = pick[self.shot :]
        return EpisodeIndices(classes=cls, support=support, query=query)
