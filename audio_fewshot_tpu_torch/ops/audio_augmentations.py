"""Spectrogram augmentations for training, in plain PyTorch (counterpart of
the train part of ``audio_fewshot_tpu/ops/audio_augmentations.py``).

Every augmentation is split in two:

- a pure function of the spectrograms ``[N, ..., H, W]`` and per-sample
  drawn values (``[N]`` or ``[N, k]`` tensors), with every reduction over
  the last two axes; a test can feed it the draws of the JAX package;
- ``draw_params(name, n, h, w, generator)``, which draws those values from an
  explicit ``torch.Generator`` on the host, from the same ranges as the JAX
  package (the two draw different numbers from a seed).

``augment_batch_one_type`` is the train-time entry: de-normalise, ONE
randomly drawn type for the whole batch (sample-level randomness from the
per-sample draws), re-normalise.  Quantiles of the |·| planes run 24 fixed
bisection steps (``bisect_quantile``), as in the JAX package; the temporal
percentile of the background subtraction is an exact linear-interpolation
quantile.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

AUGMENTATION_TYPES = (
    "cutout",
    "linear_filter",
    "noise_suppression",
    "noise_matching",
    "background_subtraction",
    "contrast_enhancement",
    "foreground_norm",
    "wiener_filter",
)
#: the per-call choices of the structurally discrete parameters
CUTOUTS = 3  # at most, drawn from 1..3
LINEAR_FILTER_POINTS = (3, 4, 5, 6)
SMOOTHING_WINDOWS = (3, 5, 7)


def _ps(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-sample ``[N]`` value on ``like``'s device, shaped to broadcast
    against ``like`` ``[N, ...]``."""
    v = torch.as_tensor(v, device=like.device)
    return v.reshape((v.shape[0],) + (1,) * (like.dim() - 1))


def bisect_quantile(flat: torch.Tensor, q: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Per-row quantile of ``flat [..., n]`` by bisection on the value range:
    each step one compare and one mean over the row (``q`` broadcasts
    against ``flat.shape[:-1]``)."""
    lo = flat.amin(dim=-1)
    hi = flat.amax(dim=-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        frac = (flat <= mid[..., None]).float().mean(dim=-1)
        below = frac < q
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _q(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-sample quantile ``q [N]`` over the trailing [H, W] plane, with
    the plane's axes kept."""
    flat = x.reshape(x.shape[:-2] + (-1,))
    return bisect_quantile(flat, _ps(q, flat[..., 0]))[..., None, None]


def linear_quantile(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-sample quantile ``q [N]`` along the last axis, interpolated
    linearly between order statistics (``jnp.quantile``'s default), with
    the axis kept."""
    n = x.shape[-1]
    s = x.sort(dim=-1).values
    pos = _ps(q, x[..., 0]).float() * (n - 1)
    low = pos.floor()
    high_w = pos - low
    low_w = 1.0 - high_w
    lo_i = low.clamp(0, n - 1).long().expand(x.shape[:-1])[..., None]
    hi_i = pos.ceil().clamp(0, n - 1).long().expand(x.shape[:-1])[..., None]
    return (s.gather(-1, lo_i) * low_w[..., None] + s.gather(-1, hi_i) * high_w[..., None])


# -- the augmentations, pure functions of (spectrograms, drawn values) --------

def random_cutout(spec, count, ch, cw, top, left, fill_value: float = 0.0):
    """Mask up to ``ch.shape[1]`` rectangles per sample: rectangle i of
    sample n covers rows ``[top, top + ch)`` and columns
    ``[left, left + cw)`` when ``i < count[n]``; shared across the sample's
    leading axes."""
    h, w = spec.shape[-2:]
    rows = torch.arange(h, device=spec.device)[:, None]
    cols = torch.arange(w, device=spec.device)[None, :]
    count, ch, cw, top, left = (torch.as_tensor(v, device=spec.device)
                                for v in (count, ch, cw, top, left))
    for i in range(ch.shape[1]):
        t, lf = _ps(top[:, i], spec), _ps(left[:, i], spec)
        inside = ((rows >= t) & (rows < t + _ps(ch[:, i], spec))
                  & (cols >= lf) & (cols < lf + _ps(cw[:, i], spec))
                  & _ps(count > i, spec))
        spec = torch.where(inside, torch.full_like(spec, fill_value), spec)
    return spec


def background_noise_suppression(spec, noise_percentile, suppression_strength):
    """Soft-suppress the bins below the noise-floor quantile."""
    a = spec.abs()
    thr = _q(a, noise_percentile / 100.0)
    mask = torch.sigmoid((a - thr) / (thr * 0.1 + 1e-8))
    return spec * (1.0 - _ps(suppression_strength, spec) * (1.0 - mask))


def temporal_median_background_subtraction(spec, percentile):
    """Subtract the per-frequency temporal percentile, clamp at 0."""
    background = linear_quantile(spec, percentile / 100.0)
    return torch.clamp(spec - background, min=0.0)


def spectral_contrast_enhancement(spec, contrast_factor, clip_percentile):
    """Scale around the mean, clip at the |·| percentile."""
    mean = spec.mean(dim=(-2, -1), keepdim=True)
    out = mean + (spec - mean) * _ps(contrast_factor, spec)
    max_val = _q(out.abs(), clip_percentile / 100.0)
    return torch.minimum(torch.maximum(out, -max_val), max_val)


def foreground_energy_normalization(spec, top_k_percent):
    """Normalise by the statistics of the top-k % energy bins."""
    energy = spec.abs()
    thr = _q(energy, 1.0 - top_k_percent / 100.0)
    fg = energy >= thr
    n = fg.sum(dim=(-2, -1), keepdim=True).clamp(min=1).to(spec.dtype)
    zero = torch.zeros((), dtype=spec.dtype, device=spec.device)
    fg_mean = torch.where(fg, spec, zero).sum(dim=(-2, -1), keepdim=True) / n
    fg_var = torch.where(fg, (spec - fg_mean) ** 2, zero).sum(
        dim=(-2, -1), keepdim=True) / (n - 1).clamp(min=1)
    return (spec - fg_mean) / (fg_var.sqrt() + 1e-8)


def wiener_like_filtering(spec, noise_floor_percentile, gain_factor):
    """SNR-gated gain."""
    a = spec.abs()
    noise = _q(a, noise_floor_percentile / 100.0)
    snr = a / (noise + 1e-8)
    return spec * (snr / (snr + 1.0) * _ps(gain_factor, spec))


def _box_smooth(noise: torch.Tensor, window: int) -> torch.Tensor:
    """Same-size box filter of ``window`` along the last axis, reflect
    padded (numpy's ``reflect``: the edge is not repeated), by cumsum."""
    pad = window // 2
    x = torch.cat([noise[..., 1:pad + 1].flip(-1), noise,
                   noise[..., -pad - 1:-1].flip(-1)], dim=-1)
    cs = torch.cat([torch.zeros_like(x[..., :1]), torch.cumsum(x, dim=-1)], dim=-1)
    return (cs[..., window:] - cs[..., :-window]) / window


def adaptive_noise_profile_matching(spec, smoothing_window,
                                    target_noise_level: float = 0.1):
    """Rescale the noise-floor regions toward a target level: per-frame
    minimum over frequency, box-smoothed in time (``smoothing_window [N]``
    per sample, on the host), scale clamped to [0.5, 2], applied through a
    soft signal mask; a floor of ~0 leaves the sample as it is."""
    a = spec.abs()
    noise0 = a.amin(dim=-2, keepdim=True)  # [..., 1, W]
    noise = noise0
    windows = torch.as_tensor(smoothing_window).cpu()
    for win in sorted(set(windows.tolist())):
        if win > 1 and spec.shape[-1] > win:
            noise = torch.where(_ps(windows == win, spec), _box_smooth(noise0, win), noise)
    current = noise.mean(dim=(-2, -1), keepdim=True)
    scale = torch.where(
        current > 1e-8,
        torch.clamp(target_noise_level / (current + 1e-8), 0.5, 2.0),
        torch.ones_like(current),
    )
    thr = _q(a, torch.full((spec.shape[0],), 0.3, dtype=torch.float32))
    signal_mask = torch.sigmoid((a - thr) / (thr * 0.1 + 1e-8))
    return spec * (signal_mask + (1.0 - signal_mask) * scale)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` of ``x [H]`` through each row of ``xp``/``fp [N, P]``
    (``xp`` sorted) → ``[N, H]``: piecewise linear, constant beyond the
    ends."""
    n, p = xp.shape
    xs = x.expand(n, x.shape[0]).contiguous()
    i = torch.searchsorted(xp.contiguous(), xs, right=True).clamp(1, p - 1)
    x0, x1 = xp.gather(1, i - 1), xp.gather(1, i)
    f0, f1 = fp.gather(1, i - 1), fp.gather(1, i)
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(np.float32).eps))
    flat = dx.abs() <= eps
    f = torch.where(flat, f0, f0 + ((xs - x0) / torch.where(flat, torch.ones_like(dx), dx)) * (f1 - f0))
    f = torch.where(xs < xp[:, :1], fp[:, :1], f)
    return torch.where(xs > xp[:, -1:], fp[:, -1:], f)


def apply_linear_filteraugment(spec, num_points, points, values):
    """Linear FilterAugment: per-sample frequency breakpoints
    ``points [N, P]`` (sorted; the first ``num_points[n]`` count) with gains
    ``values``, interpolated linearly to a per-frequency curve."""
    h = spec.shape[-2]
    freq = torch.arange(h, dtype=torch.float32, device=spec.device)
    points = torch.as_tensor(points, device=spec.device)
    values = torch.as_tensor(values, device=spec.device)
    counts = torch.as_tensor(num_points).cpu()
    curve = torch.empty((spec.shape[0], h), dtype=torch.float32, device=spec.device)
    for p in sorted(set(counts.tolist())):
        rows = torch.nonzero(counts == p).reshape(-1).to(spec.device)
        curve[rows] = interp(freq, points[rows, :p], values[rows, :p])
    return spec * curve.reshape((spec.shape[0],) + (1,) * (spec.dim() - 3) + (h, 1))


_APPLY = {
    "cutout": random_cutout,
    "linear_filter": apply_linear_filteraugment,
    "noise_suppression": background_noise_suppression,
    "noise_matching": adaptive_noise_profile_matching,
    "background_subtraction": temporal_median_background_subtraction,
    "contrast_enhancement": spectral_contrast_enhancement,
    "foreground_norm": foreground_energy_normalization,
    "wiener_filter": wiener_like_filtering,
}


# -- the draws ------------------------------------------------------------------

def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float32)


def _choice(gen: torch.Generator, n: int, options) -> torch.Tensor:
    idx = torch.randint(len(options), (n,), generator=gen)
    return torch.as_tensor(options)[idx]


def draw_params(name: str, n: int, h: int, w: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The per-sample values of augmentation ``name`` for ``n`` samples of
    ``[..., h, w]``, drawn on the host from the JAX package's ranges."""
    g = generator
    if name == "cutout":
        rh = _uniform(g, (n, CUTOUTS), 0.1, 0.3)
        rw = _uniform(g, (n, CUTOUTS), 0.1, 0.3)
        ch, cw = (h * rh).long(), (w * rw).long()
        # the top-left corner may sit flush with the bottom/right edge
        top = (torch.rand((n, CUTOUTS), generator=g) * (h - ch + 1).clamp(min=1)).long()
        left = (torch.rand((n, CUTOUTS), generator=g) * (w - cw + 1).clamp(min=1)).long()
        count = torch.randint(1, CUTOUTS + 1, (n,), generator=g)
        return {"count": count, "ch": ch, "cw": cw, "top": top, "left": left}
    if name == "linear_filter":
        strength = _uniform(g, (n, 1), 0.3, 0.7)
        num_points = _choice(g, n, LINEAR_FILTER_POINTS)
        p_max = max(LINEAR_FILTER_POINTS)
        # a sample with p points uses the first p of its sorted draws
        u = torch.rand((n, p_max), generator=g)
        u = torch.where(torch.arange(p_max)[None, :] < num_points[:, None], u, torch.ones_like(u))
        points = torch.sort(u, dim=1).values * (h - 1)
        values = 1.0 + strength * (2.0 * torch.rand((n, p_max), generator=g) - 1.0)
        return {"num_points": num_points, "points": points, "values": values}
    if name == "noise_suppression":
        return {"noise_percentile": _uniform(g, (n,), 15.0, 25.0),
                "suppression_strength": _uniform(g, (n,), 0.4, 0.7)}
    if name == "noise_matching":
        return {"smoothing_window": _choice(g, n, SMOOTHING_WINDOWS)}
    if name == "background_subtraction":
        return {"percentile": _uniform(g, (n,), 5.0, 15.0)}
    if name == "contrast_enhancement":
        return {"contrast_factor": _uniform(g, (n,), 1.3, 2.0),
                "clip_percentile": _uniform(g, (n,), 90.0, 98.0)}
    if name == "foreground_norm":
        return {"top_k_percent": _uniform(g, (n,), 15.0, 25.0)}
    if name == "wiener_filter":
        return {"noise_floor_percentile": _uniform(g, (n,), 10.0, 20.0),
                "gain_factor": _uniform(g, (n,), 1.5, 2.5)}
    raise KeyError(f"unknown augmentation {name!r}; known: {AUGMENTATION_TYPES}")


def augment_batch_with(specs: torch.Tensor, mean: float, std: float, name: str,
                       params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """De-normalise → augmentation ``name`` with the per-sample values
    ``params`` (as ``draw_params`` returns them) → re-normalise."""
    return (_APPLY[name](specs * std + mean, **params) - mean) / std


def augment_batch_one_type(specs: torch.Tensor, mean: float, std: float,
                           generator: torch.Generator) -> torch.Tensor:
    """Augment a batch ``[N, ..., H, W]`` with ONE type drawn for the whole
    batch, and per-sample values."""
    name = AUGMENTATION_TYPES[int(torch.randint(len(AUGMENTATION_TYPES), (), generator=generator))]
    h, w = specs.shape[-2:]
    return augment_batch_with(specs, mean, std, name,
                              draw_params(name, specs.shape[0], h, w, generator))
