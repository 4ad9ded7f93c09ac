"""The energy-OOD TTA re-vote of the PyTorch port against the JAX package on
the CPU: the flagged clip sets, the per-clip segment gather, the TTA
augmentation dispatchers given the JAX package's draws, ``resolve_tta_stats``
and ``tta_eval_step``'s re-vote on the same augmented segments, at the
DeepBDC weights of ``test_torch_port_slice.py`` (spec [1, 32, 40],
``reduce_dim`` 8), in float32.

The two packages draw different numbers from a seed, so the re-vote is held
on the JAX package's own augmented segments (handed to the port's step
through its ``augment`` argument), and the dispatchers on the JAX package's
draws read off its keys.  Tolerances: augmented spectrograms 1e-5 of their
max abs (the same bisection quantiles and arithmetic); accuracies 1e-6
relative (float32 means of the same votes).  Uncertainties are drawn without
ties (``ood_topk`` may order exact ties differently in the two packages)."""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import audio_fewshot_tpu.eval as jax_eval  # noqa: E402
from audio_fewshot_tpu.data import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.models import build_method as jax_build_method  # noqa: E402
from audio_fewshot_tpu.models.heads.deepbdc import DeepBDC as JaxDeepBDC  # noqa: E402
from audio_fewshot_tpu.ops import audio_augmentations as jaug  # noqa: E402
from audio_fewshot_tpu_torch import eval as port_eval  # noqa: E402
from audio_fewshot_tpu_torch.data import get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.episode import EpisodeBatch  # noqa: E402
from audio_fewshot_tpu_torch.models import build_method, eval_setting  # noqa: E402
from audio_fewshot_tpu_torch.models.heads.deepbdc import DeepBDC  # noqa: E402
from audio_fewshot_tpu_torch.ops import audio_augmentations as aug  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

from test_torch_port_augment import MEAN, STD, jax_draws, stack_draws  # noqa: E402
from test_torch_port_backbone import randomize_batchnorm  # noqa: E402
from test_torch_port_slice import slice_config  # noqa: E402

AUG_TOL = 1e-5
ACC_RTOL = 1e-6
LOG = logging.getLogger("test_torch_port_tta")


@pytest.fixture(scope="module")
def models():
    """The JAX DeepBDC with random non-trivial weights, and the port's at the
    same weights (``test_torch_port_slice.py``'s cell; the JAX side built
    under ``jit``)."""
    cfg = slice_config()
    jax_method = jax_build_method(cfg)
    setting = eval_setting(cfg)
    example = next(iter(jax_get_dataloader(cfg, "test")[0].epoch(0)))
    variables = jax.jit(lambda k, b: jax_method.init_variables(k, b, setting))(
        jax.random.PRNGKey(0), example)
    variables = randomize_batchnorm(jax.tree_util.tree_map(np.asarray, variables),
                                    np.random.default_rng(1))
    method = build_method(cfg)
    method.load_state_dict(state_dict_from_jax(variables, "resnet12Bdc", prefix="emb_func."))
    return cfg, setting, jax_method, variables, method.eval()


def _specs(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=AUG_TOL, atol=AUG_TOL * np.abs(ref).max())


# -- the flagged clips and their segments ------------------------------------------

@pytest.mark.parametrize("e, wq", [(2, 15), (8, 50), (3, 7)])
def test_flagged_sets_match_jax(e, wq):
    jax_method, method = JaxDeepBDC(emb_func=None), DeepBDC(torch.nn.Identity())
    u = np.random.default_rng(e * wq).permutation(e * wq).astype(np.float32).reshape(e, wq)
    u = u * 0.37 - 4.0  # distinct values: no ties
    ours = method.ood_topk(torch.from_numpy(u)).numpy()
    ref = np.asarray(jax_method.ood_topk(jnp.asarray(u)))
    assert len(ours) == len(ref) == max(1, int(0.2 * e * wq))
    assert set(ours.tolist()) == set(ref.tolist())
    np.testing.assert_array_equal(method.ood_mask(torch.from_numpy(u)).numpy(),
                                  np.asarray(jax_method.ood_mask(jnp.asarray(u))))


def _ragged_batch(seed=0, e=2, g=12, wq=5):
    """Query clips of 0..4 segments each, in shuffled slots, padding after."""
    rng = np.random.default_rng(seed)
    clip = np.zeros((e, g), np.int64)
    mask = np.zeros((e, g), np.float32)
    for i in range(e):
        lengths = rng.integers(0, 5, wq)
        ids = np.repeat(np.arange(wq), lengths)[:g]
        slots = rng.permutation(g)[: len(ids)]
        clip[i, slots] = ids
        mask[i, slots] = 1.0
    query = rng.normal(size=(e, g, 1, 2, 3)).astype(np.float32)
    return EpisodeBatch(support=np.zeros((e, 5, 1, 2, 3), np.float32), query=query,
                        query_clip=clip, query_mask=mask,
                        support_target=np.zeros((e, 5), np.int64),
                        query_target=np.zeros((e, wq), np.int64)).to("cpu")


@pytest.mark.parametrize("cap", [2, 4, 20])
def test_segment_gather_takes_each_flagged_clips_segments_in_order(cap):
    """All valid segments of a flagged clip, in slot order, at most ``cap``
    of them (the cap is never above the padded width), as the JAX package's
    stable argsort gather and as a plain loop."""
    batch = _ragged_batch()
    ep_idx = torch.tensor([0, 1, 1, 0, 1])
    clip_idx = torch.tensor([3, 0, 4, 1, 2])
    segments, valid = port_eval.flagged_segments(batch, ep_idx, clip_idx, cap)
    s = min(cap, batch.query.shape[1])
    assert segments.shape == (5, s, 1, 2, 3) and valid.shape == (5, s)
    # the JAX package's expressions (audio_fewshot_tpu/eval.py, tta_eval_step)
    clip, mask, query = (jnp.asarray(t.numpy()) for t in
                         (batch.query_clip, batch.query_mask, batch.query))
    je, jc = jnp.asarray(ep_idx.numpy()), jnp.asarray(clip_idx.numpy())
    is_clip = (clip[je] == jc[:, None]) & (mask[je] > 0)
    order = jnp.argsort(~is_clip, axis=1, stable=True)[:, :s]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jnp.take_along_axis(is_clip, order, 1)))
    np.testing.assert_array_equal(segments.numpy(), np.asarray(query[je[:, None], order]))
    for k in range(5):
        e, c = int(ep_idx[k]), int(clip_idx[k])
        slots = [j for j in range(batch.query.shape[1])
                 if batch.query_clip[e, j] == c and batch.query_mask[e, j] > 0][:s]
        assert valid[k].sum().item() == len(slots)
        for i, j in enumerate(slots):
            assert torch.equal(segments[k, i], batch.query[e, j])


# -- the dispatchers -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["noise_suppression", "wiener_filter", "cutout"])
def test_batch_augment_matches_jax_given_its_draws(name):
    """``num_augmentations`` versions per sample, sample-major, one key (here:
    one set of drawn values) per version, as the JAX package vmaps them."""
    specs = _specs((3, 1, 24, 31))
    rng = jax.random.PRNGKey(3)
    m = 4
    ref = jax.jit(lambda r, x: jaug.batch_augment_spectrogram(r, x, MEAN, STD, m, name))(
        rng, jnp.asarray(specs))
    keys = jax.random.split(rng, 3 * m)
    params = stack_draws([jax_draws(name, k, 24, 31) for k in keys])
    ours = aug.batch_augment_spectrogram(torch.from_numpy(specs), MEAN, STD, m, name, params=params)
    assert ours.shape == (12, 1, 24, 31)
    _close(ours, ref)


def test_random_type_per_sample_matches_jax_given_its_draws(monkeypatch):
    """``"random"``: each sample draws its type, and each drawn type runs
    once, on its group of samples only."""
    specs = _specs((4, 1, 24, 31), 1)
    rng = jax.random.PRNGKey(11)
    m = 5
    ref = jax.jit(lambda r, x: jaug.batch_augment_spectrogram(r, x, MEAN, STD, m, "random"))(
        rng, jnp.asarray(specs))
    types, groups = [], {}
    for key in jax.random.split(rng, 4 * m):
        k_pick, k_aug = jax.random.split(key)
        idx = int(jax.random.randint(k_pick, (), 0, len(jaug.AUGMENTATION_TYPES)))
        types.append(idx)
        name = aug.AUGMENTATION_TYPES[idx]
        groups.setdefault(name, []).append(jax_draws(name, k_aug, 24, 31))
    params = {"types": torch.tensor(types), **{n: stack_draws(d) for n, d in groups.items()}}
    calls = []
    inner = aug.augment_batch_with

    def spy(specs, mean, std, name, values):
        calls.append((name, specs.shape[0]))
        return inner(specs, mean, std, name, values)

    monkeypatch.setattr(aug, "augment_batch_with", spy)
    ours = aug.batch_augment_spectrogram(torch.from_numpy(specs), MEAN, STD, m, "random",
                                         params=params)
    _close(ours, ref)
    assert sorted(calls) == sorted((n, len(d)) for n, d in groups.items())
    assert len(groups) > 2  # several types drawn
    calls.clear()  # drawn by the port itself: still one call per drawn type
    out = aug.augment_spectrogram(torch.from_numpy(specs).repeat(10, 1, 1, 1), MEAN, STD,
                                  generator=torch.Generator().manual_seed(0))
    assert len(calls) == len({n for n, _ in calls}) <= 8 and sum(c for _, c in calls) == 40
    assert torch.isfinite(out).all()


def test_tta_copies_draw_from_the_generator_in_range():
    segments = torch.from_numpy(_specs((3, 1, 24, 31), 2))
    a, b = (aug.batch_augment_spectrogram(segments, MEAN, STD, 4, "noise_suppression",
                                          torch.Generator().manual_seed(5)) for _ in range(2))
    assert a.shape == (12, 1, 24, 31) and torch.equal(a, b)
    params = aug.draw_params("noise_suppression", 12, 24, 31, torch.Generator().manual_seed(5))
    torch.testing.assert_close(
        a, aug.augment_batch_with(segments.repeat_interleave(4, 0), MEAN, STD,
                                  "noise_suppression", params), rtol=0, atol=0)
    assert ((params["noise_percentile"] >= 15) & (params["noise_percentile"] <= 25)).all()
    assert ((params["suppression_strength"] >= 0.4) & (params["suppression_strength"] <= 0.7)).all()


# -- resolve_tta_stats ----------------------------------------------------------------

def test_resolve_tta_stats_matches_jax(tmp_path, caplog):
    cfg = slice_config()
    assert port_eval.resolve_tta_stats(cfg, LOG) == pytest.approx(
        jax_eval.resolve_tta_stats(cfg, LOG), rel=1e-7)
    missing = slice_config(tta_mean_std_file=str(tmp_path / "absent.npy"))
    for resolve in (port_eval.resolve_tta_stats, jax_eval.resolve_tta_stats):
        with pytest.raises(FileNotFoundError, match="tta_allow_config_stats"):
            resolve(missing, LOG)
    stats = np.asarray([2.5, 4.0], np.float32)
    np.save(tmp_path / "own.npy", stats)
    fallback = slice_config(tta_mean_std_file=str(tmp_path / "absent.npy"),
                            tta_allow_config_stats=True, mean_std_file=str(tmp_path / "own.npy"))
    with caplog.at_level(logging.WARNING):
        ours = port_eval.resolve_tta_stats(fallback, LOG)
    assert ours == pytest.approx(jax_eval.resolve_tta_stats(fallback, LOG), rel=1e-7)
    assert "falls back" in caplog.text


# -- the re-vote ----------------------------------------------------------------------

def test_tta_re_vote_matches_jax_on_the_same_augmented_segments(models, monkeypatch):
    """The JAX package's ``tta_eval_step`` with its own draws, and the
    port's given the JAX package's augmented segments: the port gathers
    the same segments (so it flagged the same clips) and re-votes to the same
    per-episode accuracies."""
    cfg, setting, jax_method, variables, method = models
    jax_batch = next(iter(jax_get_dataloader(cfg, "test")[0].epoch(0)))
    batch = next(iter(get_dataloader(cfg, "test")[0].epoch(0))).to("cpu")
    seen = {}
    inner = jaug.batch_augment_spectrogram

    def recording(rng, specs, *args, **kwargs):
        out = inner(rng, specs, *args, **kwargs)
        jax.debug.callback(lambda a, b: seen.update({"in": np.array(a), "out": np.array(b)}),
                           specs, out)
        return out

    monkeypatch.setattr(jaug, "batch_augment_spectrogram", recording)
    kwargs = dict(tta_mean=MEAN, tta_std=STD, num_augmentations=4, tta_segments_per_clip=3)
    step = jax.jit(lambda v, b, r: jax_eval.tta_eval_step(jax_method, v, b, r, setting, **kwargs))
    ref = np.asarray(step(variables, jax_batch, jax.random.PRNGKey(7)))

    def given(segments, mean, std, m, generator):
        assert (mean, std, m, generator) == (MEAN, STD, 4, None)
        np.testing.assert_array_equal(segments.numpy(), seen["in"])
        return torch.from_numpy(seen["out"].copy())

    with torch.no_grad():
        ours = port_eval.tta_eval_step(method, batch, setting, None, augment=given, **kwargs)
    k = max(1, int(DeepBDC.ood_fraction * batch.query_target.numel()))
    assert seen["out"].shape == (k * 3 * 4, 1, 32, 40)
    assert ours.shape == ref.shape == (2,)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=ACC_RTOL)
    with torch.no_grad():  # the re-vote changed some clip's vote
        plain = method.eval_episode_accuracy(method(batch, setting), batch)
        flipped = port_eval.tta_eval_step(method, batch, setting, None, augment=lambda s, *a:
                                          torch.zeros((s.shape[0] * 4,) + s.shape[1:]), **kwargs)
    assert not torch.equal(flipped, plain)
