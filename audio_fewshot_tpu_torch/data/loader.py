"""Episodic and flat loaders and ``get_dataloader`` (counterpart of
``audio_fewshot_tpu/data/loader.py``).

- train: every clip contributes ONE random segment, giving a fully dense
  batch (``G == W*Q``, mask all ones);
- val/test: support clips contribute their first segment; query clips
  contribute ALL their segments, packed into a bucketed, masked query axis.

The per-epoch numpy generator draws in the same order as the JAX package, so
both packages build the same episodes from a seed.  A background thread
builds numpy batches while the device computes.  With a segment bank
(``data/bank.py``) the loader emits bank row ids instead of payloads.
FINETUNING methods train on a ``FlatLoader``'s flat batches; with
``dataloader_num: 2`` an episodic method's train loaders are an episodic
and a flat one over the same dataset (the trainer zips them into one step),
a FINETUNING method's two flat ones (the trainer takes their batches in
turn).
"""

from __future__ import annotations

import os
import queue
import re
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..episode import (
    EpisodeBatch,
    FlatBatch,
    IndexedEpisodeBatch,
    IndexedFlatBatch,
    local_targets,
    make_dense_episode_batch,
    pack_ragged_episode_batch,
    pack_ragged_episode_indices,
)
from ..models.base import ModelType
from ..utils.spans import span
from .dataset import (
    DEFAULT_SEGMENT_FRAMES,
    SpectrogramDataset,
    load_mean_std,
    load_splits,
    parse_synthetic_root,
    segment_shape,
)
from .sampler import EpisodeIndices, EpisodicSampler, FlatSampler

_SPLIT_INDEX = {"train": 0, "val": 1, "test": 2}


def get_mean_std(config: Dict[str, Any], mode: str = "train", modality: str = "audio") -> Tuple[float, float]:
    """Scalar normalization stats for this config ((0, 1) without a file)."""
    path = config.get("mean_std_file")
    if path and os.path.isfile(path):
        return load_mean_std(path)
    return 0.0, 1.0


def resolve_data_sources(config: Dict[str, Any], mode: str) -> Tuple[str, Optional[str]]:
    """``(data_root, mean_std_file)`` for a split, honoring the OOD protocol:
    with ``ood: true`` the TEST split reads ``ood_data_root`` if set, else
    ``data_root`` with its ``KOS_<alpha>_alpha`` component replaced by
    ``KOS_0_alpha``; ``ood_mean_std_file`` overrides the stats."""
    data_root = str(config.get("data_root") or "synthetic")
    mean_std = config.get("mean_std_file")
    if mode == "test" and config.get("ood"):
        if config.get("ood_data_root"):
            data_root = str(config["ood_data_root"])
        else:
            redirected = re.sub(r"KOS_[0-9.]+_alpha", "KOS_0_alpha", data_root)
            if not re.search(r"KOS_[0-9.]+_alpha", data_root) \
                    and parse_synthetic_root(data_root) is None \
                    and os.path.isdir(data_root):
                # a silent no-op would report the IID number as the OOD one
                raise ValueError(
                    f"ood: true but data_root {data_root!r} has no "
                    "KOS_<alpha>_alpha component to redirect and no "
                    "ood_data_root is set — the test split would silently "
                    "be the IID one"
                )
            data_root = redirected
        if config.get("ood_mean_std_file"):
            mean_std = config["ood_mean_std_file"]
    return data_root, mean_std


def build_dataset(config: Dict[str, Any], mode: str) -> SpectrogramDataset:
    data_root, mean_std_file = resolve_data_sources(config, mode)
    cfg_for_stats = dict(config)
    cfg_for_stats["mean_std_file"] = mean_std_file
    mean, std = get_mean_std(cfg_for_stats, mode, config.get("modality", "audio"))
    seg_frames = config.get("segment_frames", DEFAULT_SEGMENT_FRAMES)

    syn = parse_synthetic_root(data_root)
    if syn is None and not os.path.isdir(data_root):
        syn = {"num_classes": 25, "clips_per_class": 40}
    if syn is not None:
        sizes = {"train": syn["num_classes"], "val": 5, "test": 8}
        offsets = {"train": 0, "val": sizes["train"], "test": sizes["train"] + 5}
        # 0 is the on-disk loader's "unlimited" sentinel; the synthetic
        # generator needs a concrete positive cap
        max_seg = 1 if mode == "train" else (
            int(config.get("max_segments_per_clip") or 8)
        )
        # synthetic OOD twin: same classes, shifted generator seed
        ood_shift = 100 if (mode == "test" and config.get("ood")) else 0
        return SpectrogramDataset.synthetic(
            num_classes=sizes[mode],
            clips_per_class=syn["clips_per_class"],
            segment_shape=segment_shape(config),
            max_segments=max_seg,
            seed=int(config.get("seed", 0)) + _SPLIT_INDEX[mode] + ood_shift,
            class_offset=offsets[mode],
        )

    split_file = config.get("class_per_split")
    if split_file and os.path.isfile(split_file):
        splits = load_splits(split_file)
        all_classes = [c for s in splits for c in s]
        classes = splits[_SPLIT_INDEX[mode]]
        class_offset = all_classes.index(classes[0]) if classes else 0
    else:
        classes = None
        class_offset = 0
    return SpectrogramDataset.from_directory(
        data_root,
        classes=classes,
        mean=mean,
        std=std,
        segment_frames=seg_frames,
        class_offset=class_offset,
        max_segments=int(config.get("max_segments_per_clip", 8) or 0),
    )


class EpisodicLoader:
    """Iterable over epochs of ``EpisodeBatch``es, with background
    prefetch."""

    def __init__(
        self,
        dataset: SpectrogramDataset,
        way: int,
        shot: int,
        query: int,
        episodes_per_epoch: int,
        episode_size: int = 1,
        mode: str = "test",
        seed: int = 0,
        segment_bucket_sizes: Optional[Tuple[int, ...]] = None,
        prefetch: int = 2,
        augment_times: int = 1,
    ):
        self.dataset = dataset
        self.way, self.query = way, query
        #: emit ``IndexedEpisodeBatch``es of bank row ids (see ``use_segment_bank``)
        self.emit_indices = False
        self._bank_starts: Optional[List[List[int]]] = None
        #: effective shot: each support clip contributes ``augment_times`` copies
        self.shot = shot * augment_times
        self.augment_times = augment_times
        self.mode = mode
        self.episode_size = episode_size
        self.prefetch = prefetch
        self.segment_bucket_sizes = segment_bucket_sizes
        self.sampler = EpisodicSampler(
            dataset.clips_per_class(),
            way=way,
            shot=shot,
            query=query,
            episodes_per_epoch=episodes_per_epoch,
            episode_size=episode_size,
            seed=seed,
        )

    def __len__(self) -> int:
        return self.sampler.episodes_per_epoch // self.episode_size

    def use_segment_bank(self) -> None:
        """Switch batches to bank-index form; the caller puts
        ``dataset.segment_bank()[0]`` on the device and materializes episodes
        with ``episode.materialize_episode_batch``."""
        self._bank_starts = self.dataset.bank_starts()
        self.emit_indices = True

    def _train_slots(self, plans: List[EpisodeIndices], rng: np.random.Generator):
        """``(class, clip, segment)`` of every support and query slot of a
        dense train batch, ``[E, W*S, 3]`` and ``[E, W*Q, 3]``, and the
        global targets.  One random segment per clip (per copy for support
        clips repeated ``augment_times`` times), drawn in the JAX package's
        order."""
        ds = self.dataset
        e = len(plans)
        sup = np.empty((e, self.way * self.shot, 3), dtype=np.int64)
        qry = np.empty((e, self.way * self.query, 3), dtype=np.int64)

        def draw(cls, k):
            n = ds.clips[cls][k].shape[0]
            return (cls, k, int(rng.integers(n)) if n > 1 else 0)

        for i, plan in enumerate(plans):
            s = q = 0
            for w, cls in enumerate(plan.classes):
                for k in plan.support[w]:
                    for _ in range(self.augment_times):
                        sup[i, s] = draw(cls, k)
                        s += 1
                for k in plan.query[w]:
                    qry[i, q] = draw(cls, k)
                    q += 1
        targets = np.concatenate([sup[..., 0], qry[..., 0]], axis=1) + ds.class_offset
        return sup, qry, targets.astype(np.int32)

    def _build_batch(self, plans: List[EpisodeIndices], rng: np.random.Generator):
        if self.mode == "train":
            return self._build_train_batch(plans, rng)
        if self.emit_indices:
            return self._build_index_batch(plans)
        ds = self.dataset
        e = len(plans)
        ws = self.way * self.shot
        wq = self.way * self.query
        support = np.empty((e, ws) + ds.segment_shape, dtype=np.float32)
        global_sup = np.empty((e, ws), dtype=np.int32)
        global_qry = np.empty((e, wq), dtype=np.int32)
        seg_list: List[np.ndarray] = []
        repeats = np.empty((e, wq), dtype=np.int64)
        for i, plan in enumerate(plans):
            s = q = 0
            for w, cls in enumerate(plan.classes):
                for k in plan.support[w]:
                    for _ in range(self.augment_times):
                        support[i, s] = ds.clips[cls][k][0]
                        global_sup[i, s] = cls + ds.class_offset
                        s += 1
                for k in plan.query[w]:
                    segs = ds.clips[cls][k]
                    seg_list.append(segs)
                    repeats[i, q] = segs.shape[0]
                    global_qry[i, q] = cls + ds.class_offset
                    q += 1
        all_segs = ds.normalize(np.concatenate(seg_list, axis=0))
        support = ds.normalize(support)
        batch = pack_ragged_episode_batch(
            support, all_segs, repeats.reshape(-1), self.way, self.shot,
            self.query, bucket_sizes=self.segment_bucket_sizes,
        )
        return batch.replace(
            global_target=np.concatenate([global_sup, global_qry], axis=1)
        )

    def _build_train_batch(self, plans: List[EpisodeIndices], rng: np.random.Generator):
        """Dense train batch (``G == W*Q``, mask all ones), as segment
        payloads or, with a bank, as bank row ids; the same draws either way."""
        ds = self.dataset
        sup, qry, targets = self._train_slots(plans, rng)
        if self.emit_indices:
            starts = self._bank_starts
            rows = lambda slots: np.asarray(
                [[starts[c][k] + o for c, k, o in ep] for ep in slots], dtype=np.int32)
            e, wq = qry.shape[:2]
            return IndexedEpisodeBatch(
                support_idx=rows(sup),
                query_idx=rows(qry),
                query_clip=np.broadcast_to(np.arange(wq, dtype=np.int32), (e, wq)),
                query_mask=np.ones((e, wq), dtype=np.float32),
                support_target=np.broadcast_to(
                    local_targets(self.way, self.shot), (e, self.way * self.shot)),
                query_target=np.broadcast_to(local_targets(self.way, self.query), (e, wq)),
                global_target=targets,
            )
        payload = lambda slots: ds.normalize(np.stack(
            [np.stack([ds.clips[c][k][o] for c, k, o in ep]) for ep in slots]
        ).astype(np.float32))
        return make_dense_episode_batch(payload(sup), payload(qry), self.way, self.shot,
                                        self.query, global_target=targets)

    def _build_index_batch(self, plans: List[EpisodeIndices]):
        """Index twin of ``_build_batch``: the same episodes, with bank row
        ids as payload."""
        ds = self.dataset
        starts = self._bank_starts
        e = len(plans)
        ws = self.way * self.shot
        wq = self.way * self.query
        support_idx = np.empty((e, ws), dtype=np.int32)
        global_sup = np.empty((e, ws), dtype=np.int32)
        global_qry = np.empty((e, wq), dtype=np.int32)
        seg_ids: List[int] = []
        repeats = np.empty((e, wq), dtype=np.int64)
        for i, plan in enumerate(plans):
            s = q = 0
            for w, cls in enumerate(plan.classes):
                for k in plan.support[w]:
                    for _ in range(self.augment_times):
                        support_idx[i, s] = starts[cls][k]  # segment 0
                        global_sup[i, s] = cls + ds.class_offset
                        s += 1
                for k in plan.query[w]:
                    n = ds.clips[cls][k].shape[0]
                    seg_ids.extend(range(starts[cls][k], starts[cls][k] + n))
                    repeats[i, q] = n
                    global_qry[i, q] = cls + ds.class_offset
                    q += 1
        return pack_ragged_episode_indices(
            support_idx, np.asarray(seg_ids, dtype=np.int32),
            repeats.reshape(-1), self.way, self.shot, self.query,
            bucket_sizes=self.segment_bucket_sizes,
            global_target=np.concatenate([global_sup, global_qry], axis=1),
        )

    def epoch(self, epoch_idx: int = 0) -> Iterator[Any]:
        # segment draws of train batches (eval batches draw nothing)
        rng = np.random.default_rng((self.sampler.seed, epoch_idx, 13))
        plans_iter = self.sampler.epoch(epoch_idx)
        if self.prefetch <= 0:
            for plans in plans_iter:
                with span("afs.data"), span("afs.data.build"):
                    batch = self._build_batch(plans, rng)
                yield batch
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up once the consumer abandoned the
            generator (else the worker blocks on a full queue forever)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for plans in plans_iter:
                    with span("afs.data.build"):
                        batch = self._build_batch(plans, rng)
                    if not put(batch):
                        return
                put(sentinel)
            except BaseException as exc:  # handed to the consumer, which raises it
                put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                with span("afs.data"):
                    item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # the caller waits on the data layer here too: a worker blocked
            # on a full queue sees ``stop`` at its next try
            with span("afs.data"):
                stop.set()
                t.join(timeout=5.0)

    def __iter__(self) -> Iterator[EpisodeBatch]:
        return self.epoch(0)


class FlatLoader:
    """Flat classification batches for FINETUNING training: ``FlatSampler``'s
    (class, clip) pairs, one random segment of each clip, drawn with
    ``default_rng((seed, epoch, 17))`` in the pairs' order (the JAX package's
    draws).  Targets are the class indices of the split."""

    def __init__(self, dataset: SpectrogramDataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        #: emit ``IndexedFlatBatch``es of bank row ids (see ``use_segment_bank``)
        self.emit_indices = False
        self._bank_starts: Optional[List[List[int]]] = None
        self.sampler = FlatSampler(dataset.clips_per_class(), batch_size, seed=seed)

    def use_segment_bank(self) -> None:
        """Switch batches to bank-index form: the same draws, so a batch
        materialised from the bank equals the payload batch."""
        self._bank_starts = self.dataset.bank_starts()
        self.emit_indices = True

    def __len__(self) -> int:
        return len(self.sampler)

    def epoch(self, epoch_idx: int = 0) -> Iterator[Any]:
        ds = self.dataset
        rng = np.random.default_rng((self.sampler.seed, epoch_idx, 17))
        for pairs in self.sampler.epoch(epoch_idx):
            # one draw per pair, in order, on both paths
            picks = [int(rng.integers(ds.clips[c][k].shape[0])) for c, k in pairs]
            target = np.asarray(pairs[:, 0], dtype=np.int32)
            if self.emit_indices:
                starts = self._bank_starts
                yield IndexedFlatBatch(
                    data_idx=np.asarray([starts[c][k] + o for (c, k), o in zip(pairs, picks)],
                                        dtype=np.int32),
                    target=target)
            else:
                data = np.stack([ds.clips[c][k][o] for (c, k), o in zip(pairs, picks)])
                yield FlatBatch(data=ds.normalize(data), target=target)

    def __iter__(self) -> Iterator[Any]:
        return self.epoch(0)


def get_dataloader(
    config: Dict[str, Any],
    mode: str,
    model_type: ModelType = ModelType.METRIC,
    distribute: bool = False,
    modality: str = "audio",
) -> List[Any]:
    """A list of loaders, as the JAX package's surface: one episodic loader,
    or for FINETUNING training ``dataloader_num`` (1 by default)
    ``FlatLoader`` s of ``batch_size`` (128 by default), the i-th seeded
    ``seed + i``.  For another method's training, ``dataloader_num`` n > 1
    adds n − 1 such ``FlatLoader`` s over the episodic loader's dataset (one
    segment bank)."""
    atq = int(config.get("augment_times_query", 1) or 1)
    if atq != 1:
        raise ValueError(
            f"augment_times_query={atq} is not supported: every shipped "
            "config sets 1 (config/headers/data.yaml)"
        )
    dataset = build_dataset(config, mode)
    seed = int(config.get("seed", 0))
    prefetch = int(config.get("prefetch", 2))
    if str(config.get("workers", 1)) in ("0", "0.0"):
        prefetch = 0
    n_loaders = int(config.get("dataloader_num", 1)) if mode == "train" else 1
    if mode == "train" and model_type == ModelType.FINETUNING:
        return [FlatLoader(dataset, int(config.get("batch_size", 128)), seed=seed + i)
                for i in range(n_loaders)]
    if mode == "train":
        way, shot, query_n = config["way_num"], config["shot_num"], config["query_num"]
        episodes = int(config.get("train_episode", 500))
    else:
        way = config.get("test_way") or config["way_num"]
        shot = config.get("test_shot") or config["shot_num"]
        query_n = config.get("test_query") or config["query_num"]
        episodes = int(config.get("test_episode", 600))
    ep_size = int(config.get("episode_size", 1))
    if mode != "train" and config.get("test_episode_size"):
        ep_size = int(config["test_episode_size"])
    buckets = config.get("segment_bucket_sizes")
    return [
        EpisodicLoader(
            dataset,
            way=way,
            shot=shot,
            query=query_n,
            episodes_per_epoch=episodes,
            episode_size=ep_size,
            mode=mode,
            seed=seed + 1000 * _SPLIT_INDEX[mode],
            segment_bucket_sizes=tuple(buckets) if buckets else None,
            prefetch=prefetch,
            augment_times=int(config.get("augment_times", 1)),
        )
    ] + [FlatLoader(dataset, int(config.get("batch_size", 128)), seed=seed + i)
         for i in range(1, n_loaders)]
