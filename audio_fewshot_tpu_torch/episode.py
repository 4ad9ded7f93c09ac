"""Dense, masked episode batches (counterpart of ``audio_fewshot_tpu/episode.py``).

An episode batch has pre-split support and query; query segments of
variable-length clips are padded to a bucketed length ``G`` and carry an
integer clip id and a validity mask.  Loaders build the batches as numpy
arrays on the host (the same arrays, from the same seed, as the JAX
package); ``.to(device)`` moves them to torch tensors.  Clip-level
aggregation is then a one-hot contraction (``utils/aggregate.py``).
FINETUNING methods train on flat classification batches instead
(``FlatBatch``; ``IndexedFlatBatch`` with rows of a segment bank).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _to_tensor(x: Any, device: torch.device, float_dtype=None) -> Any:
    """numpy / tensor leaf → tensor on ``device``.  Integer leaves become
    int64 (torch's index type); float leaves float32, or ``float_dtype`` when
    given (the wire dtype of a payload batch)."""
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:  # np.broadcast_to views; torch wants writable memory
            x = x.copy()
        x = torch.from_numpy(x)
    if x.dtype.is_floating_point:
        return x.to(device=device, dtype=float_dtype or torch.float32, non_blocking=True)
    return x.to(device=device, dtype=torch.int64, non_blocking=True)


@dataclass
class EpisodeBatch:
    """A batch of ``E`` few-shot episodes with dense masked query segments.

    Shapes (``E`` episodes, ``W`` way, ``S`` shot, ``Q`` query clips/way,
    ``G`` padded query segments, spectrogram ``[C, F, T]``):

    - ``support``:        ``[E, W*S, C, F, T]`` (support clips are single segments)
    - ``query``:          ``[E, G, C, F, T]`` padded segment stack
    - ``query_clip``:     ``[E, G]`` clip id in ``[0, W*Q)`` per segment
      (padding points at clip 0 but is masked out)
    - ``query_mask``:     ``[E, G]`` float, 1 = real segment
    - ``support_target``: ``[E, W*S]`` local labels (way index)
    - ``query_target``:   ``[E, W*Q]`` clip-level local labels
    - ``global_target``:  ``[E, W*(S+Q)]`` dataset-level class ids or None
    """

    support: Any
    query: Any
    query_clip: Any
    query_mask: Any
    support_target: Any
    query_target: Any
    global_target: Optional[Any] = None

    @property
    def num_episodes(self) -> int:
        return self.support.shape[0]

    @property
    def num_query_clips(self) -> int:
        return self.query_target.shape[-1]

    @property
    def segment_shape(self) -> Tuple[int, ...]:
        return tuple(self.support.shape[2:])

    def replace(self, **changes) -> "EpisodeBatch":
        return dataclasses.replace(self, **changes)

    def to(self, device, transfer_dtype: Optional[torch.dtype] = None) -> "EpisodeBatch":
        """Tensors on ``device``.  ``transfer_dtype`` sends the float payload
        in that dtype and upcasts it to float32 on the device."""
        device = torch.device(device)

        def put(x):
            t = _to_tensor(x, device, transfer_dtype)
            return t.float() if t is not None and t.dtype.is_floating_point else t

        return EpisodeBatch(**{f.name: put(getattr(self, f.name))
                               for f in dataclasses.fields(self)})


@dataclass
class IndexedEpisodeBatch:
    """An ``EpisodeBatch`` whose payload lives in a device-resident segment
    bank: ``support_idx`` / ``query_idx`` are rows of ``bank [N, C, F, T]``
    (padding rows point at 0 and are masked out)."""

    support_idx: Any  # [E, W*S]
    query_idx: Any  # [E, G]
    query_clip: Any  # [E, G]
    query_mask: Any  # [E, G]
    support_target: Any  # [E, W*S]
    query_target: Any  # [E, W*Q]
    global_target: Optional[Any] = None

    @property
    def num_episodes(self) -> int:
        return self.support_idx.shape[0]

    def to(self, device) -> "IndexedEpisodeBatch":
        device = torch.device(device)
        return IndexedEpisodeBatch(**{f.name: _to_tensor(getattr(self, f.name), device)
                                      for f in dataclasses.fields(self)})


@dataclass
class FlatBatch:
    """A plain classification batch for FINETUNING training: ``data`` ``[B,
    C, F, T]`` segments and ``target`` ``[B]`` class ids of the train
    split."""

    data: Any
    target: Any

    def to(self, device, transfer_dtype: Optional[torch.dtype] = None) -> "FlatBatch":
        """Tensors on ``device`` (the payload sent in ``transfer_dtype`` when
        given, float32 on the device)."""
        device = torch.device(device)
        return FlatBatch(data=_to_tensor(self.data, device, transfer_dtype).float(),
                         target=_to_tensor(self.target, device))


@dataclass
class IndexedFlatBatch:
    """A ``FlatBatch`` whose payload lives in a segment bank: ``data_idx``
    ``[B]`` rows of ``bank [N, C, F, T]``."""

    data_idx: Any
    target: Any

    def to(self, device) -> "IndexedFlatBatch":
        device = torch.device(device)
        return IndexedFlatBatch(data_idx=_to_tensor(self.data_idx, device),
                                target=_to_tensor(self.target, device))


def materialize_flat_batch(batch, bank: torch.Tensor) -> FlatBatch:
    """Gather an ``IndexedFlatBatch``'s rows out of ``bank`` (upcast to
    float32 after the gather); a ``FlatBatch`` passes through."""
    if isinstance(batch, FlatBatch):
        return batch
    return FlatBatch(data=bank.index_select(0, batch.data_idx).float(), target=batch.target)


def local_targets(way: int, count_per_way: int) -> np.ndarray:
    """Per-way local labels ``[way*count]``."""
    return np.repeat(np.arange(way, dtype=np.int32), count_per_way)


def make_dense_episode_batch(
    support: np.ndarray,
    query: np.ndarray,
    way: int,
    shot: int,
    query_num: int,
    global_target: Optional[np.ndarray] = None,
) -> EpisodeBatch:
    """A fixed-length batch: every query clip is exactly one segment,
    ``G == W*Q``, mask all ones.  ``support``: [E, W*S, C,F,T] way-major;
    ``query``: [E, W*Q, C,F,T]."""
    e = support.shape[0]
    wq = way * query_num
    if query.shape[1] != wq:
        raise ValueError(f"query has {query.shape[1]} clips, expected {wq}")
    return EpisodeBatch(
        support=np.asarray(support),
        query=np.asarray(query),
        query_clip=np.broadcast_to(np.arange(wq, dtype=np.int32), (e, wq)),
        query_mask=np.ones((e, wq), dtype=np.float32),
        support_target=np.broadcast_to(local_targets(way, shot), (e, way * shot)),
        query_target=np.broadcast_to(local_targets(way, query_num), (e, wq)),
        global_target=None if global_target is None else np.asarray(global_target),
    )


def _pack_ragged(repeats: np.ndarray, e: int, wq: int, bucket_sizes):
    """Shared packing plan: ``(G, [(episode, dst, n, clip, src)])``."""
    repeats = np.asarray(repeats, dtype=np.int64).reshape(e, wq)
    g = _pick_bucket(int(repeats.sum(axis=1).max()), bucket_sizes)
    plan = []
    src = 0
    for i in range(e):
        dst = 0
        for c in range(wq):
            n = int(repeats[i, c])
            plan.append((i, dst, n, c, src))
            dst += n
            src += n
    return g, plan, src


def pack_ragged_episode_batch(
    support: np.ndarray,
    query_segments: np.ndarray,
    repeats: np.ndarray,
    way: int,
    shot: int,
    query_num: int,
    bucket_sizes: Optional[Tuple[int, ...]] = None,
) -> EpisodeBatch:
    """Pack variable-length query clips into a padded ``EpisodeBatch``.

    ``query_segments``: ``[N_total, C, F, T]`` in episode → way → clip →
    segment order; ``repeats``: ``[E*W*Q]`` segments per query clip;
    ``bucket_sizes``: allowed padded ``G`` (the smallest one that fits is
    used; default powers of two).
    """
    e = support.shape[0]
    wq = way * query_num
    g, plan, total = _pack_ragged(repeats, e, wq, bucket_sizes)
    if total != query_segments.shape[0]:
        raise ValueError(f"repeats cover {total} segments, got {query_segments.shape[0]}")
    query = np.zeros((e, g) + query_segments.shape[1:], dtype=query_segments.dtype)
    clip_id = np.zeros((e, g), dtype=np.int32)
    mask = np.zeros((e, g), dtype=np.float32)
    for i, dst, n, c, src in plan:
        query[i, dst : dst + n] = query_segments[src : src + n]
        clip_id[i, dst : dst + n] = c
        mask[i, dst : dst + n] = 1.0
    return EpisodeBatch(
        support=np.asarray(support),
        query=query,
        query_clip=clip_id,
        query_mask=mask,
        support_target=np.broadcast_to(local_targets(way, shot), (e, way * shot)),
        query_target=np.broadcast_to(local_targets(way, query_num), (e, wq)),
    )


def _pick_bucket(needed: int, bucket_sizes: Optional[Tuple[int, ...]]) -> int:
    if not bucket_sizes:
        g = 1
        while g < needed:
            g *= 2
        return g
    for b in sorted(bucket_sizes):
        if b >= needed:
            return int(b)
    raise ValueError(f"no bucket ≥ {needed} in {bucket_sizes}")


def segment_targets(batch: EpisodeBatch) -> torch.Tensor:
    """Per-segment query labels ``[E, G]`` (clip labels gathered through the
    clip-id vector)."""
    return torch.gather(batch.query_target, 1, batch.query_clip)


def pack_ragged_episode_indices(
    support_idx: np.ndarray,
    query_seg_ids: np.ndarray,
    repeats: np.ndarray,
    way: int,
    shot: int,
    query_num: int,
    bucket_sizes: Optional[Tuple[int, ...]] = None,
    global_target: Optional[np.ndarray] = None,
) -> IndexedEpisodeBatch:
    """Index twin of ``pack_ragged_episode_batch``: the same packing and
    bucketing, with bank row ids in place of segment arrays."""
    e = support_idx.shape[0]
    wq = way * query_num
    g, plan, total = _pack_ragged(repeats, e, wq, bucket_sizes)
    if total != query_seg_ids.shape[0]:
        raise ValueError(f"repeats cover {total} segments, got {query_seg_ids.shape[0]}")
    query_idx = np.zeros((e, g), dtype=np.int32)
    clip_id = np.zeros((e, g), dtype=np.int32)
    mask = np.zeros((e, g), dtype=np.float32)
    for i, dst, n, c, src in plan:
        query_idx[i, dst : dst + n] = query_seg_ids[src : src + n]
        clip_id[i, dst : dst + n] = c
        mask[i, dst : dst + n] = 1.0
    return IndexedEpisodeBatch(
        support_idx=np.asarray(support_idx, dtype=np.int32),
        query_idx=query_idx,
        query_clip=clip_id,
        query_mask=mask,
        support_target=np.broadcast_to(local_targets(way, shot), (e, way * shot)),
        query_target=np.broadcast_to(local_targets(way, query_num), (e, wq)),
        global_target=None if global_target is None else np.asarray(global_target),
    )


def materialize_episode_batch(batch, bank: torch.Tensor) -> EpisodeBatch:
    """Gather an ``IndexedEpisodeBatch``'s payload out of ``bank`` (on the
    bank's device).  A bank kept in bf16 is gathered first and upcast after,
    so the gather moves half the bytes.  An ``EpisodeBatch`` passes through."""
    if isinstance(batch, EpisodeBatch):
        return batch
    seg = bank.shape[1:]
    support = bank.index_select(0, batch.support_idx.reshape(-1))
    query = bank.index_select(0, batch.query_idx.reshape(-1))
    support = support.float().reshape(tuple(batch.support_idx.shape) + seg)
    query = query.float().reshape(tuple(batch.query_idx.shape) + seg)
    # padded rows gathered bank row 0: zero them, so the batch equals the
    # zero-padded payload batch exactly
    mask = batch.query_mask.to(query.dtype)
    query = query * mask.reshape(mask.shape + (1,) * (query.dim() - 2))
    return EpisodeBatch(
        support=support,
        query=query,
        query_clip=batch.query_clip,
        query_mask=batch.query_mask,
        support_target=batch.support_target,
        query_target=batch.query_target,
        global_target=batch.global_target,
    )
