"""The CLAP audio encoder, waveform → 512-d embedding (counterpart of
``audio_fewshot_tpu/models/backbones/clap_encoder.py``).

LAION-CLAP's default audio branch, HTSAT-tiny:

1. a waveform at 48 kHz, tiled or centre-cropped to CLAP's 10 s window by
   the caller (``fit_waveform``; ``resample_linear`` on the host);
2. the log-mel front end (``ops.mel``: n_fft 1024, hop 480, 64 mel bins,
   50 Hz to 14 kHz);
3. HTSAT's fold: the [64, 1001] map padded with 0 (in the log domain) to
   ``spec_size · freq_ratio`` = 1024 frames, or cropped, and its four time
   chunks stacked along the frequency axis into a [256, 256] image
   (``fold_spectrogram``);
4. a Swin body (``swin.SwinTransformer``: embed 96, depths 2/2/6/2, heads
   4/8/16/32, window 8, downscaling (4, 2, 2, 2), head_dim 96 / 4 = 24),
   its mean feature (768);
5. CLAP's projection, Linear → ReLU → Linear to 512, L2-normalised.

The body computes in bf16 whatever a config's ``precision`` says, as the JAX
package's (its factory drops the configured dtype): ``dtype`` is there for
float32 checks.  The front end and the projection are float32.

Weights: ``save_params`` / ``load_params`` write and read the JAX package's
flat ``.npz`` of ``/``-joined flax paths (``htsat/stage0_block0/attn/qkv/
kernel``, ``proj0/bias``, …), so one file serves both packages and
``tools/convert_clap_checkpoint.py``'s output loads here;
``utils.convert.state_dict_from_jax(..., "CLAPBackbone")`` maps such a
tree onto the module's keys (``htsat.*`` as ``swin.py`` names them,
``proj0``, ``proj1``).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.mel import log_mel_spectrogram, mel_constants
from ..init import dense
from .swin import SWIN_FACTORS, SwinTransformer

CLAP_SAMPLE_RATE = 48_000
CLAP_CLIP_SAMPLES = 480_000  # 10 s, CLAP's fixed audio window


def fit_waveform(wave: np.ndarray, clip_samples: int = CLAP_CLIP_SAMPLES) -> np.ndarray:
    """Tile short audio (CLAP's ``repeat`` pad), centre-crop long audio, to
    ``clip_samples``."""
    wave = np.asarray(wave, dtype=np.float32).reshape(-1)
    n = wave.shape[0]
    if n == 0:
        raise ValueError("empty waveform")
    if n < clip_samples:
        wave = np.tile(wave, int(np.ceil(clip_samples / n)))[:clip_samples]
    elif n > clip_samples:
        start = (n - clip_samples) // 2
        wave = wave[start: start + clip_samples]
    return wave


def resample_linear(wave: np.ndarray, sr_in: int, sr_out: int = CLAP_SAMPLE_RATE) -> np.ndarray:
    """Linear-interpolation resample on the host."""
    if sr_in == sr_out:
        return np.asarray(wave, dtype=np.float32).reshape(-1)
    wave = np.asarray(wave, dtype=np.float64).reshape(-1)
    n_out = int(round(wave.shape[0] * sr_out / sr_in))
    x_out = np.arange(n_out) * (sr_in / sr_out)
    return np.interp(x_out, np.arange(wave.shape[0]), wave).astype(np.float32)


class CLAPAudioEncoder(nn.Module):
    """Waveform ``[N, samples]`` (or ``[N, ...]``, flattened) → L2-normalised
    embeddings ``[N, embed_dim]``, float32."""

    def __init__(self, embed_dim: int = 512, sample_rate: int = CLAP_SAMPLE_RATE,
                 n_fft: int = 1024, hop: int = 480, num_mels: int = 64, fmin: float = 50.0,
                 fmax: float = 14_000.0, spec_size: int = 256, freq_ratio: int = 4,
                 swin_embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window_size: int = 8,
                 normalize: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.sample_rate, self.n_fft, self.hop, self.num_mels = sample_rate, n_fft, hop, num_mels
        self.spec_size, self.freq_ratio, self.normalize = spec_size, freq_ratio, normalize
        window, filterbank = mel_constants(num_mels, n_fft, sample_rate, fmin, fmax)
        self.register_buffer("mel_window", window, persistent=False)
        self.register_buffer("mel_filterbank", filterbank, persistent=False)
        self.htsat = SwinTransformer(
            embed_dim=swin_embed_dim, depths=depths, num_heads=num_heads,
            downscaling_factors=SWIN_FACTORS["swin_t"][:len(depths)], window_size=window_size,
            head_dim=swin_embed_dim // num_heads[0], is_flatten=True, dtype=dtype,
            spec_shape=(1, spec_size, spec_size))
        latent = swin_embed_dim * 2 ** (len(depths) - 1)
        self.proj0 = dense(latent, embed_dim)
        self.proj1 = dense(embed_dim, embed_dim)

    def feature_dim(self, spec_shape=None) -> int:
        """The embedding's width, whatever the input."""
        return self.proj1.out_features

    def fold_spectrogram(self, mel: torch.Tensor) -> torch.Tensor:
        """``[N, F, T]`` → ``[N, 1, spec_size, spec_size]``: T padded with 0
        (or cropped) to ``spec_size · freq_ratio``, then ``[N, F, R, T/R]`` →
        ``[N, R, F, T/R]`` → ``[N, 1, R·F, T/R]`` (HTSAT's ``reshape_wav2img``)."""
        n, f, t = mel.shape
        target_t = self.spec_size * self.freq_ratio
        target_f = self.spec_size // self.freq_ratio
        if f != target_f:
            raise ValueError(f"expected {target_f} mel bins, got {f}")
        if t > target_t:
            mel = mel[:, :, :target_t]
        elif t < target_t:
            mel = F.pad(mel, (0, target_t - t))
        x = mel.reshape(n, f, self.freq_ratio, self.spec_size).transpose(1, 2)
        return x.reshape(n, 1, self.spec_size, self.spec_size)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        if waveform.ndim == 1:
            waveform = waveform[None]
        waveform = waveform.reshape(waveform.shape[0], -1).float()
        mel = log_mel_spectrogram(waveform, num_mels=self.num_mels, n_fft=self.n_fft,
                                  hop=self.hop, sample_rate=self.sample_rate,
                                  constants=(self.mel_window, self.mel_filterbank))
        x = self.proj1(torch.relu(self.proj0(self.htsat(self.fold_spectrogram(mel)))))
        if self.normalize:
            x = x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        return x


def mini_encoder(**kw) -> CLAPAudioEncoder:
    """A tiny variant for tests (1 s window, a 64 × 64 folded image)."""
    cfg = dict(sample_rate=16_000, n_fft=256, hop=64, num_mels=16, fmin=0.0, fmax=8_000.0,
               spec_size=64, freq_ratio=4, swin_embed_dim=24, depths=(1, 1), num_heads=(2, 4),
               window_size=4)
    cfg.update(kw)
    return CLAPAudioEncoder(**cfg)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_params(path: str, encoder: CLAPAudioEncoder) -> None:
    """The encoder's weights as the JAX package's flat npz of flax paths."""
    from ...utils.convert import clap_jax_params

    np.savez(path, **_flatten(clap_jax_params(encoder.state_dict())))


def load_params(path: str) -> Dict[str, Any]:
    """Flat ``a/b/c`` npz → the nested flax params (numpy)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(z[key])
    return tree


def load_checkpoint(encoder: CLAPAudioEncoder, path: str) -> None:
    """Load a flat npz (``save_params``, ``tools/convert_clap_checkpoint.py``)
    into ``encoder``; a file whose keys or shapes do not match the encoder
    raises, naming it."""
    from ...utils.convert import state_dict_from_jax

    state = state_dict_from_jax({"params": load_params(path)}, "CLAPBackbone")
    own = encoder.state_dict()
    mismatch = sorted(set(own) ^ set(state)) or [
        k for k in own if tuple(own[k].shape) != tuple(state[k].shape)]
    if mismatch:
        raise ValueError(f"CLAP checkpoint {path} does not match the encoder's parameters "
                         f"(e.g. {mismatch[:3]}): was it converted for this variant?")
    encoder.load_state_dict(state)
