"""Waveform → log-mel spectrogram (counterpart of
``audio_fewshot_tpu/ops/mel.py``).

Framing → periodic Hann window → rFFT power → one product with a Slaney mel
filterbank → ``log(mel + eps)``.  Frames are taken with ``unfold`` at hop
``hop`` and no centring (``1 + (t − n_fft) // hop`` of them; a waveform
shorter than ``n_fft`` is zero-padded to one frame), as the JAX package's
strided gather takes them: ``torch.stft(center=True)`` would pad both ends
and add frames.  The window and the filterbank are built on the host in
float64 (numpy) and cast to float32 (``mel_constants``); a caller that runs
many batches keeps them on its device and passes them in (the CLAP encoder
holds them as buffers).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f):
    """Slaney mel scale (librosa's default, ``htk=False``): linear below
    1 kHz, logarithmic above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f < min_log_hz, f / f_sp, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep
    )


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        m < min_log_mel, m * f_sp, min_log_hz * np.exp(logstep * (m - min_log_mel))
    )


def mel_filterbank(num_mels: int, n_fft: int, sample_rate: int,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-style triangular mel filterbank ``[n_fft // 2 + 1, num_mels]``,
    float32, each filter area-normalised."""
    fmax = fmax or sample_rate / 2.0
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), num_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    bins = np.fft.rfftfreq(n_fft, d=1.0 / sample_rate)
    fb = np.zeros((len(bins), num_mels), np.float32)
    for m in range(num_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bins - lo) / max(ctr - lo, 1e-9)
        down = (hi - bins) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    return fb * enorm[None, :].astype(np.float32)


def mel_constants(num_mels: int = 128, n_fft: int = 2048, sample_rate: int = 22050,
                  fmin: float = 0.0, fmax: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The periodic Hann window ``[n_fft]`` (scipy's ``sym=False``, not
    numpy's symmetric one) and the filterbank ``[n_fft // 2 + 1, num_mels]``,
    float32 on the CPU."""
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    return (torch.from_numpy(window),
            torch.from_numpy(mel_filterbank(num_mels, n_fft, sample_rate, fmin=fmin, fmax=fmax)))


def log_mel_spectrogram(
    waveform: torch.Tensor,
    num_mels: int = 128,
    n_fft: int = 2048,
    hop: int = 700,
    sample_rate: int = 22050,
    eps: float = 1e-10,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    constants: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """``[..., T_samples]`` float32 → ``[..., num_mels, T_frames]`` log-mel
    spectrogram, float32.  ``constants``: ``mel_constants`` of these
    arguments on the waveform's device (else built, and copied there, in
    the call)."""
    t = waveform.shape[-1]
    if t < n_fft:
        waveform = F.pad(waveform, (0, n_fft - t))
    if constants is None:
        constants = tuple(c.to(waveform.device)
                          for c in mel_constants(num_mels, n_fft, sample_rate, fmin, fmax))
    window, fb = constants
    frames = waveform.unfold(-1, n_fft, hop)  # [..., n_frames, n_fft]
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = torch.view_as_real(spec).square().sum(-1)
    mel = torch.matmul(power, fb).transpose(-1, -2)
    return torch.log(mel + eps)
