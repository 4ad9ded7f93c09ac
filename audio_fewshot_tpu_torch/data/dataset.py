"""Spectrogram datasets (counterpart of ``audio_fewshot_tpu/data/dataset.py``).

On-disk layout: ``data_root`` holds one directory per class of pre-extracted
log-mel spectrograms; class splits are name lists in a ``.npy`` object array
of [train, val, test]; normalisation stats are scalar mean/std ``.npy``
files:

    data_root/
      <class_name>/
        <clip>.npy        # [F, T] or [C, F, T] float spectrogram; T may vary

Variable-length clips are chopped into fixed ``[F, segment_frames]`` windows
at load time.  A synthetic in-memory dataset (``data_root:
synthetic[:n_classes[:clips]]``) gives class-conditional Gaussian
spectrograms, drawn in the same order as the JAX package so the same seed
gives the same data.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# KOS protocol segment geometry: [1, 128, 157] log-mel segments.
DEFAULT_NUM_MEL = 128
DEFAULT_SEGMENT_FRAMES = 157


def segment_shape(config: Dict[str, Any]) -> Tuple[int, int, int]:
    """``[C, F, T]`` of a segment: ``spec_shape``, else one channel of 128
    mel bins × ``segment_frames``."""
    frames = config.get("segment_frames", DEFAULT_SEGMENT_FRAMES)
    return tuple(config.get("spec_shape") or (1, DEFAULT_NUM_MEL, frames))


def load_splits(path: str) -> Tuple[List[str], List[str], List[str]]:
    """Load the class-name split file (reference Auxiliary/KOS_paper_splits.npy
    — object array of [train, val, test] class-name arrays)."""
    arr = np.load(path, allow_pickle=True)
    train, val, test = (sorted(str(c) for c in split) for split in arr)
    return train, val, test


def load_mean_std(path: str) -> Tuple[float, float]:
    """Scalar normalization stats from a ``(2,1,1)`` mean/std file."""
    arr = np.load(path).reshape(-1)
    return float(arr[0]), float(arr[1])


def segment_clip(spec: np.ndarray, segment_frames: int,
                 max_segments: int = 0) -> np.ndarray:
    """Chop a [C, F, T] clip into ``ceil(T / segment_frames)`` fixed windows
    [n, C, F, segment_frames]; the tail window is taken right-aligned so no
    audio is lost and every segment is full-length (MetaAudio protocol).
    ``max_segments`` (0 = unlimited) caps n — very long clips keep their
    first windows so episode buckets stay bounded.

    1-D inputs are pre-extracted embedding vectors (the ``is_clap`` flow,
    reference clap.py:351-386) — wrapped as a single [1, 1, 1, D] segment
    that ``CLAPEmbeddingBackbone`` flattens back to [D]."""
    if spec.ndim == 1:
        return spec[None, None, None, :]
    if spec.ndim == 2:
        spec = spec[None]
    c, f, t = spec.shape
    if t <= segment_frames:
        if t < segment_frames:  # loop-pad short clips to one full window
            reps = int(np.ceil(segment_frames / t))
            spec = np.tile(spec, (1, 1, reps))
        return spec[None, :, :, :segment_frames]
    n = int(np.ceil(t / segment_frames))
    if max_segments:
        n = min(n, max_segments)
    segs = np.empty((n, c, f, segment_frames), dtype=spec.dtype)
    for i in range(n - 1):
        segs[i] = spec[:, :, i * segment_frames : (i + 1) * segment_frames]
    last_end = min(n * segment_frames, t)
    segs[n - 1] = spec[:, :, last_end - segment_frames : last_end]
    return segs


class SpectrogramDataset:
    """All clips of one split, pre-segmented and held in RAM as float32.

    The KOS-scale datasets (a few thousand short clips) fit trivially in host
    memory; keeping segments resident removes file IO from the episode hot
    path entirely (the reference gates this behind ``use_memory``).

    Attributes:
        classes: class names in this split.
        clips: ``clips[class_idx]`` = list of [n_seg, C, F, T] arrays.
    """

    def __init__(
        self,
        classes: Sequence[str],
        clips: Dict[str, List[np.ndarray]],
        mean: float = 0.0,
        std: float = 1.0,
        class_offset: int = 0,
    ):
        self.classes = list(classes)
        self.clips = [clips[c] for c in self.classes]
        self.mean = mean
        self.std = std
        self.class_offset = class_offset  # global label of class 0
        for i, c in enumerate(self.classes):
            if not self.clips[i]:
                raise ValueError(f"class {c!r} has no clips")
        seg = self.clips[0][0]
        self.segment_shape = tuple(seg.shape[1:])

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def clips_per_class(self) -> List[int]:
        return [len(c) for c in self.clips]

    def normalize(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std

    def bank_starts(self) -> List[List[int]]:
        """``starts[class_idx][clip_idx]`` = first bank row of that clip
        (its ``n_seg`` segments are contiguous) — cheap, no payload built."""
        starts: List[List[int]] = []
        pos = 0
        for cl in self.clips:
            row = []
            for clip in cl:
                row.append(pos)
                pos += clip.shape[0]
            starts.append(row)
        return starts

    def segment_bank(self) -> Tuple[np.ndarray, List[List[int]]]:
        """Flatten every segment of the split into one NORMALIZED array
        ``bank [N, C, F, T]`` plus the ``bank_starts`` map.

        This is the host side of the device-resident corpus
        (episode.IndexedEpisodeBatch): the bank is copied to the device once,
        then batches are row gathers in device memory.  Cached;
        ``release_bank_payload`` frees the cache once the device copy
        shipped (rebuilt on demand if asked again).
        """
        if getattr(self, "_bank", None) is None:
            bank = np.concatenate(
                [clip for cl in self.clips for clip in cl], axis=0
            ).astype(np.float32)
            self._bank = (self.normalize(bank), self.bank_starts())
        return self._bank

    def release_bank_payload(self) -> None:
        """Drop the cached host bank array (the device copy has shipped;
        only ``bank_starts`` is needed afterwards)."""
        self._bank = None

    def bank_nbytes(self, bytes_per_elem: int = 4) -> int:
        """Size of the segment bank without building it."""
        n = sum(clip.shape[0] for cl in self.clips for clip in cl)
        return n * int(np.prod(self.segment_shape)) * bytes_per_elem

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_directory(
        cls,
        data_root: str,
        classes: Optional[Sequence[str]] = None,
        mean: float = 0.0,
        std: float = 1.0,
        segment_frames: int = DEFAULT_SEGMENT_FRAMES,
        class_offset: int = 0,
        max_segments: int = 0,
    ) -> "SpectrogramDataset":
        if classes is None:
            classes = sorted(
                d for d in os.listdir(data_root)
                if os.path.isdir(os.path.join(data_root, d))
            )
        clips: Dict[str, List[np.ndarray]] = {}
        for c in classes:
            cdir = os.path.join(data_root, c)
            files = sorted(f for f in os.listdir(cdir) if f.endswith((".npy", ".npz")))
            out = []
            for f in files:
                path = os.path.join(cdir, f)
                if f.endswith(".npz"):
                    with np.load(path) as z:
                        spec = z[z.files[0]]
                else:
                    spec = np.load(path)
                out.append(
                    segment_clip(np.asarray(spec, dtype=np.float32),
                                 segment_frames, max_segments)
                )
            clips[c] = out
        return cls(classes, clips, mean=mean, std=std, class_offset=class_offset)

    @classmethod
    def synthetic(
        cls,
        num_classes: int = 25,
        clips_per_class: int = 40,
        segment_shape: Tuple[int, int, int] = (1, DEFAULT_NUM_MEL, DEFAULT_SEGMENT_FRAMES),
        max_segments: int = 1,
        seed: int = 0,
        class_offset: int = 0,
    ) -> "SpectrogramDataset":
        """Class-conditional Gaussian spectrograms; clip lengths 1..max_segments
        segments.  Learnable (per-class mean shift) so smoke training shows
        accuracy movement."""
        rng = np.random.default_rng(seed)
        c, f, t = segment_shape
        classes = [f"synthetic_{i:03d}" for i in range(num_classes)]
        means = rng.normal(0.0, 1.0, size=(num_classes, c, f, 1)).astype(np.float32)
        clips: Dict[str, List[np.ndarray]] = {}
        for k, name in enumerate(classes):
            out = []
            for _ in range(clips_per_class):
                n_seg = int(rng.integers(1, max_segments + 1))
                noise = rng.normal(0.0, 1.0, size=(n_seg, c, f, t)).astype(np.float32)
                out.append(noise + means[k])
            clips[name] = out
        return cls(classes, clips, class_offset=class_offset)


def parse_synthetic_root(data_root: str) -> Optional[Dict[str, int]]:
    """``synthetic`` / ``synthetic:<classes>`` / ``synthetic:<classes>:<clips>``."""
    if not str(data_root).startswith("synthetic"):
        return None
    parts = str(data_root).split(":")
    out = {"num_classes": 25, "clips_per_class": 40}
    if len(parts) > 1 and parts[1]:
        out["num_classes"] = int(parts[1])
    if len(parts) > 2 and parts[2]:
        out["clips_per_class"] = int(parts[2])
    return out
