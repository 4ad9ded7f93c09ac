"""The train-time spectrogram augmentations of the PyTorch port
(``ops/audio_augmentations.py``) against the JAX package: each of the eight
augmentations given the JAX package's own draws (read off its PRNG keys in
the order its functions split them), ``augment_batch_one_type``'s type
selection, and the quantile and interpolation helpers.  Float32 on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from audio_fewshot_tpu.ops import audio_augmentations as jaug  # noqa: E402
from audio_fewshot_tpu_torch.ops import audio_augmentations as aug  # noqa: E402

# float32 in both; the same quantile bisection and the same arithmetic, with
# means and cumulative sums reduced in another order
TOL = 1e-5
MEAN, STD = -15.114, 26.223  # the shipped Clean_Mean_Std scalars
SHAPE = (6, 1, 24, 31)


def _specs(seed=0):
    return np.random.default_rng(seed).normal(size=SHAPE).astype(np.float32)


def _u(key, lo, hi):
    return float(jax.random.uniform(key, (), minval=lo, maxval=hi))


def jax_draws(name, key, h, w):
    """The values ``audio_fewshot_tpu``'s ``_AUG_FNS[name]`` draws from
    ``key``, split as it splits them."""
    if name == "cutout":
        k_n, rng = jax.random.split(key)
        out = {"count": int(jax.random.randint(k_n, (), 1, 4)),
               "ch": [], "cw": [], "top": [], "left": []}
        for _ in range(aug.CUTOUTS):
            k1, k2, k3, k4, rng = jax.random.split(rng, 5)
            ch = int((h * jax.random.uniform(k1, (), minval=0.1, maxval=0.3)).astype(jnp.int32))
            cw = int((w * jax.random.uniform(k2, (), minval=0.1, maxval=0.3)).astype(jnp.int32))
            out["ch"].append(ch)
            out["cw"].append(cw)
            out["top"].append(int(jax.random.randint(k3, (), 0, max(h - ch + 1, 1))))
            out["left"].append(int(jax.random.randint(k4, (), 0, max(w - cw + 1, 1))))
        return out
    if name == "linear_filter":
        k_n, k_s, k = jax.random.split(key, 3)
        strength = _u(k_s, 0.3, 0.7)
        p = aug.LINEAR_FILTER_POINTS[int(jax.random.randint(k_n, (), 0, 4))]
        k1, k2 = jax.random.split(k)
        pts = np.asarray(jnp.sort(jax.random.uniform(k1, (p,)) * (h - 1)))
        vals = np.asarray(1.0 + jax.random.uniform(k2, (p,), minval=-strength, maxval=strength))
        pad = max(aug.LINEAR_FILTER_POINTS) - p
        return {"num_points": p, "points": np.pad(pts, (0, pad), mode="edge"),
                "values": np.pad(vals, (0, pad), mode="edge")}
    if name == "noise_matching":
        k_w, _ = jax.random.split(key)
        return {"smoothing_window": aug.SMOOTHING_WINDOWS[int(jax.random.randint(k_w, (), 0, 3))]}
    ranges = {
        "noise_suppression": (("noise_percentile", 15.0, 25.0), ("suppression_strength", 0.4, 0.7)),
        "background_subtraction": (("percentile", 5.0, 15.0),),
        "contrast_enhancement": (("contrast_factor", 1.3, 2.0), ("clip_percentile", 90.0, 98.0)),
        "foreground_norm": (("top_k_percent", 15.0, 25.0),),
        "wiener_filter": (("noise_floor_percentile", 10.0, 20.0), ("gain_factor", 1.5, 2.5)),
    }[name]
    keys = jax.random.split(key, len(ranges) + 1)
    return {k: _u(kk, lo, hi) for (k, lo, hi), kk in zip(ranges, keys)}


def stack_draws(draws):
    """Per-sample draws → the batched tensors ``draw_params`` returns."""
    out = {}
    for k in draws[0]:
        vals = np.asarray([d[k] for d in draws])
        out[k] = torch.from_numpy(vals.astype(np.float32 if vals.dtype.kind == "f" else np.int64))
    return out


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=TOL, atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("name", jaug.AUGMENTATION_TYPES)
def test_augmentation_matches_jax_given_its_draws(name):
    specs = _specs()
    keys = jax.random.split(jax.random.PRNGKey(7), SHAPE[0])
    h, w = SHAPE[-2:]
    ref = jax.vmap(lambda k, s: jaug._AUG_FNS[name](k, s))(keys, jnp.asarray(specs * STD + MEAN))
    ref = (ref - MEAN) / STD
    params = stack_draws([jax_draws(name, k, h, w) for k in keys])
    ours = aug.augment_batch_with(torch.from_numpy(specs), MEAN, STD, name, params)
    assert ours.shape == SHAPE and ours.dtype == torch.float32
    _close(ours, ref)


@pytest.mark.parametrize("seed", range(6))
def test_augment_batch_one_type_selection_matches_jax(seed):
    """One type for the whole batch (drawn first), per-sample values from
    the keys split off the rest: given the JAX package's type and values
    the port gives its output."""
    specs = _specs(seed)
    rng = jax.random.PRNGKey(100 + seed)
    ref = jaug.augment_batch_one_type(rng, jnp.asarray(specs), MEAN, STD)
    k_pick, k_aug = jax.random.split(rng)
    name = jaug.AUGMENTATION_TYPES[int(jax.random.randint(k_pick, (), 0, 8))]
    keys = jax.random.split(k_aug, SHAPE[0])
    params = stack_draws([jax_draws(name, k, *SHAPE[-2:]) for k in keys])
    _close(aug.augment_batch_with(torch.from_numpy(specs), MEAN, STD, name, params), ref)


def test_port_draws_one_type_per_batch_within_the_ranges():
    specs = torch.from_numpy(_specs())
    seen = set()
    gen = torch.Generator().manual_seed(0)
    for _ in range(64):
        state = gen.get_state()
        name = aug.AUGMENTATION_TYPES[int(torch.randint(8, (), generator=gen))]
        seen.add(name)
        params = aug.draw_params(name, 6, 24, 31, gen)
        gen.set_state(state)
        out = aug.augment_batch_one_type(specs, MEAN, STD, gen)  # same draws again
        torch.testing.assert_close(out, aug.augment_batch_with(specs, MEAN, STD, name, params),
                                   rtol=0, atol=0)
        assert torch.isfinite(out).all()
        if name == "cutout":
            assert ((params["count"] >= 1) & (params["count"] <= 3)).all()
            assert (params["top"] + params["ch"] <= 24).all() and (params["left"] + params["cw"] <= 31).all()
            assert (params["ch"] >= 2).all() and (params["ch"] <= 7).all()
        elif name == "linear_filter":
            p = params["num_points"]
            assert set(p.tolist()) <= set(aug.LINEAR_FILTER_POINTS)
            for i in range(6):
                pts = params["points"][i, : p[i]]
                assert (pts[1:] >= pts[:-1]).all() and (pts >= 0).all() and (pts <= 23).all()
            assert ((params["values"] >= 0.3) & (params["values"] <= 1.7)).all()
        elif name == "noise_matching":
            assert set(params["smoothing_window"].tolist()) <= set(aug.SMOOTHING_WINDOWS)
    assert seen == set(aug.AUGMENTATION_TYPES)


def test_bisect_quantile_is_the_jax_bisection():
    flat = np.abs(np.random.default_rng(3).normal(size=(5, 2, 700))).astype(np.float32)
    q = np.asarray([0.1, 0.2, 0.5, 0.8, 0.95], np.float32)
    ref = np.asarray(jax.vmap(jaug._bisect_quantile)(jnp.asarray(flat), jnp.asarray(q)))
    ours = aug.bisect_quantile(torch.from_numpy(flat), torch.from_numpy(q)[:, None]).numpy()
    np.testing.assert_array_equal(ours, ref)  # the same float32 steps
    exact = np.stack([np.quantile(flat[i], q[i], axis=-1, method="inverted_cdf")
                      for i in range(len(q))])
    span = flat.max(-1) - flat.min(-1)
    assert (np.abs(ours - exact) <= span / 2 ** 23).all()


def test_linear_quantile_matches_jnp_quantile():
    x = np.random.default_rng(4).normal(size=(4, 1, 8, 37)).astype(np.float32)
    q = np.asarray([0.05, 0.1, 0.137, 0.15], np.float32)
    ref = jax.vmap(lambda a, qq: jnp.quantile(a, qq, axis=-1, keepdims=True))(jnp.asarray(x), jnp.asarray(q))
    np.testing.assert_allclose(aug.linear_quantile(torch.from_numpy(x), torch.from_numpy(q)).numpy(),
                               np.asarray(ref), rtol=TOL, atol=TOL)


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(5)
    xp = np.sort(rng.uniform(0, 30, size=(3, 5)).astype(np.float32), axis=1)
    fp = rng.uniform(0.5, 1.5, size=(3, 5)).astype(np.float32)
    x = np.arange(31, dtype=np.float32)
    ref = np.stack([np.asarray(jnp.interp(x, xp[i], fp[i])) for i in range(3)])
    ours = aug.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)
