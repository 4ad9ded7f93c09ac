"""Data layer: spectrogram datasets, episodic and flat sampling, the loaders
and the device-resident segment bank."""

from .dataset import SpectrogramDataset, load_mean_std, load_splits, segment_clip
from .loader import EpisodicLoader, FlatLoader, get_dataloader, get_mean_std, resolve_data_sources
from .sampler import EpisodicSampler, FlatSampler

__all__ = [
    "SpectrogramDataset",
    "load_mean_std",
    "load_splits",
    "segment_clip",
    "EpisodicLoader",
    "EpisodicSampler",
    "FlatLoader",
    "FlatSampler",
    "get_dataloader",
    "get_mean_std",
    "resolve_data_sources",
]
