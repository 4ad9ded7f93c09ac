"""Data layer: spectrogram datasets, episodic sampling, eval loaders and the
device-resident segment bank."""

from .dataset import SpectrogramDataset, load_mean_std, load_splits, segment_clip
from .loader import EpisodicLoader, get_dataloader, get_mean_std, resolve_data_sources
from .sampler import EpisodicSampler

__all__ = [
    "SpectrogramDataset",
    "load_mean_std",
    "load_splits",
    "segment_clip",
    "EpisodicLoader",
    "EpisodicSampler",
    "get_dataloader",
    "get_mean_std",
    "resolve_data_sources",
]
