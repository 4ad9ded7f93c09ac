"""Offline CLAP embedding extraction (counterpart of
``tools/extract_clap_embeddings.py``).

    python -m audio_fewshot_tpu_torch.extract_clap_embeddings \\
        --audio_root <dir> --out <dir> (--checkpoint <npz> | --allow-random-init) \\
        [--sample_rate 48000] [--batch 8] [--mini] [--device cuda]

- input: ``<audio_root>/<class>/<clip>.wav`` (PCM int16 / int32, 8-bit or
  float32; channels averaged) or ``<clip>.npy`` (a 1-D waveform at
  ``--sample_rate``);
- each waveform is resampled to the encoder's rate (linear interpolation,
  48 kHz), tiled or centre-cropped to CLAP's 10 s window (the ``--mini``
  encoder's 1 s) and encoded into an L2-normalised 512-d embedding;
- output: ``<out>/<class>/<clip>.npy``, float32 ``[512]``, which the data
  layer reads as one-segment clips (``data_root`` of a
  ``CLAPEmbeddingBackbone`` config).

``--checkpoint`` is a flat npz of the encoder's flax paths
(``tools/convert_clap_checkpoint.py`` makes one from LAION-CLAP's state
dict; ``clap_encoder.save_params`` writes one); ``--allow-random-init``
runs the untrained encoder drawn from seed 0 (pipeline checks only).  It
runs on the card unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os
import time
import wave
from typing import Dict, List, Optional

import numpy as np
import torch

from .models.backbones.clap_encoder import (CLAP_CLIP_SAMPLES, CLAPAudioEncoder, fit_waveform,
                                            load_checkpoint, mini_encoder, resample_linear)
from .utils import init_seed, resolve_device


def read_wav(path: str):
    """``(float32 mono waveform in [-1, 1], sample rate)`` of a PCM wav."""
    with wave.open(path, "rb") as w:
        sr, n, ch, width = w.getframerate(), w.getnframes(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    """Run the CLI; returns ``clips``, ``seconds`` (the extraction, the
    encoder's set-up excluded) and ``peak_gib`` (the card's peak memory, 0
    on the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--audio_root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--checkpoint", default=None, help="flat-npz CLAP weights")
    ap.add_argument("--allow-random-init", action="store_true")
    ap.add_argument("--sample_rate", type=int, default=48000,
                    help="sample rate of .npy waveforms (wav is self-describing)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mini", action="store_true", help="the tiny encoder variant (tests)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.checkpoint and not args.allow_random_init:
        raise SystemExit("no --checkpoint given: pass converted CLAP weights "
                         "(tools/convert_clap_checkpoint.py) or --allow-random-init for the "
                         "untrained encoder")
    device = resolve_device(args.device)
    init_seed(0)  # the random init's draws
    enc = mini_encoder() if args.mini else CLAPAudioEncoder()
    if args.checkpoint:
        load_checkpoint(enc, args.checkpoint)
    enc = enc.to(device).eval().requires_grad_(False)
    clip_samples = enc.sample_rate if args.mini else CLAP_CLIP_SAMPLES
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    classes = sorted(d for d in os.listdir(args.audio_root)
                     if os.path.isdir(os.path.join(args.audio_root, d)))
    total, dim, t0 = 0, 0, time.time()
    for cls in classes:
        cdir, odir = os.path.join(args.audio_root, cls), os.path.join(args.out, cls)
        os.makedirs(odir, exist_ok=True)
        files = sorted(f for f in os.listdir(cdir) if f.endswith((".wav", ".npy")))
        for i in range(0, len(files), args.batch):
            chunk = files[i: i + args.batch]
            waves = []
            for f in chunk:
                path = os.path.join(cdir, f)
                if f.endswith(".wav"):
                    x, sr = read_wav(path)
                else:
                    x, sr = np.load(path).astype(np.float32), args.sample_rate
                waves.append(fit_waveform(resample_linear(x, sr, enc.sample_rate), clip_samples))
            with torch.no_grad():
                emb = enc(torch.from_numpy(np.stack(waves)).to(device)).cpu().numpy()
            for f, e in zip(chunk, emb):
                np.save(os.path.join(odir, os.path.splitext(f)[0] + ".npy"), e.astype(np.float32))
            total, dim = total + len(chunk), emb.shape[-1]
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else 0.0
    print(f"extracted {total} embeddings -> {args.out} (dim {dim}, "
          f"{args.checkpoint or 'random-init'}, {device}): {total / max(seconds, 1e-9):.2f} "
          f"clips/s, peak memory {peak:.2f} GiB")
    return {"clips": total, "seconds": seconds, "peak_gib": peak}


if __name__ == "__main__":
    main()
