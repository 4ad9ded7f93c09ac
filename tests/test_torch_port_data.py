"""Data path of the PyTorch port against the JAX package: the same seed gives
bit-identical episodes (sampler plans, dense and ragged batches, bank-
materialised batches), the same merged configs, and the same clip-level
aggregation and confidence intervals."""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import audio_fewshot_tpu.config as jax_config  # noqa: E402
import audio_fewshot_tpu.data.dataset as jax_dataset  # noqa: E402
import audio_fewshot_tpu.data.loader as jax_loader  # noqa: E402
import audio_fewshot_tpu.data.sampler as jax_sampler  # noqa: E402
import audio_fewshot_tpu.episode as jax_episode  # noqa: E402
import audio_fewshot_tpu.utils.aggregate as jax_aggregate  # noqa: E402
import audio_fewshot_tpu_torch.config as port_config  # noqa: E402
import audio_fewshot_tpu_torch.data.dataset as port_dataset  # noqa: E402
import audio_fewshot_tpu_torch.data.loader as port_loader  # noqa: E402
import audio_fewshot_tpu_torch.data.sampler as port_sampler  # noqa: E402
import audio_fewshot_tpu_torch.episode as port_episode  # noqa: E402
import audio_fewshot_tpu_torch.utils.aggregate as port_aggregate  # noqa: E402
from audio_fewshot_tpu_torch.data.bank import setup_segment_banks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("support", "query", "query_clip", "query_mask", "support_target",
          "query_target", "global_target")
INDEX_FIELDS = ("support_idx", "query_idx", "query_clip", "query_mask",
                "support_target", "query_target", "global_target")


def _config(**over):
    cfg = {
        "data_root": "synthetic:8:12", "spec_shape": [1, 8, 10], "seed": 3,
        "way_num": 5, "shot_num": 2, "query_num": 3,
        "test_way": 5, "test_shot": 2, "test_query": 3,
        "test_episode": 6, "test_episode_size": 2,
        "max_segments_per_clip": 4, "prefetch": 0,
    }
    cfg.update(over)
    return cfg


def _assert_batches_equal(ours, ref, fields):
    assert type(ours).__name__ == type(ref).__name__
    for name in fields:
        a, b = getattr(ours, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_plans_identical(seed):
    counts = [12, 9, 15, 7, 20, 11]
    args = dict(way=4, shot=2, query=3, episodes_per_epoch=6, episode_size=2, seed=seed)
    ours = port_sampler.EpisodicSampler(counts, **args)
    ref = jax_sampler.EpisodicSampler(counts, **args)
    for epoch in (0, 1):
        for po, pr in zip(ours.epoch(epoch), ref.epoch(epoch), strict=True):
            for eo, er in zip(po, pr, strict=True):
                np.testing.assert_array_equal(eo.classes, er.classes)
                np.testing.assert_array_equal(eo.support, er.support)
                np.testing.assert_array_equal(eo.query, er.query)


def test_dense_batch_identical():
    rng = np.random.default_rng(0)
    sup = rng.normal(size=(2, 6, 1, 4, 5)).astype(np.float32)
    qry = rng.normal(size=(2, 9, 1, 4, 5)).astype(np.float32)
    _assert_batches_equal(
        port_episode.make_dense_episode_batch(sup, qry, 3, 2, 3),
        jax_episode.make_dense_episode_batch(sup, qry, 3, 2, 3), FIELDS,
    )


@pytest.mark.parametrize("needed,buckets", [(1, None), (5, None), (64, None), (65, None),
                                            (3, (4, 8)), (8, (8, 4)), (9, (4, 8, 16))])
def test_pick_bucket_identical(needed, buckets):
    assert port_episode._pick_bucket(needed, buckets) == jax_episode._pick_bucket(needed, buckets)


@pytest.mark.parametrize("buckets", [None, [16, 32, 64]])
@pytest.mark.parametrize("mode", ["val", "test"])
def test_ragged_loader_batches_identical(buckets, mode):
    cfg = _config(segment_bucket_sizes=buckets)
    ours = port_loader.get_dataloader(cfg, mode)[0]
    ref = jax_loader.get_dataloader(cfg, mode)[0]
    assert len(ours) == len(ref) == 3
    for epoch in (0, 1):
        for bo, br in zip(ours.epoch(epoch), ref.epoch(epoch), strict=True):
            _assert_batches_equal(bo, br, FIELDS)


@pytest.mark.parametrize("transfer_dtype", [None, torch.bfloat16])
def test_bank_materialised_batches_identical(transfer_dtype):
    cfg = _config()
    ours = port_loader.get_dataloader(cfg, "test")[0]
    ref = jax_loader.get_dataloader(cfg, "test")[0]
    payload = list(port_loader.get_dataloader(cfg, "test")[0].epoch(0))
    (bank,) = setup_segment_banks(cfg, [ours], torch.device("cpu"), transfer_dtype)
    assert bank.dtype == (transfer_dtype or torch.float32)
    host, _ = ref.dataset.segment_bank()
    if transfer_dtype is not None:
        host = host.astype(ml_dtypes.bfloat16)
    ref_bank = jnp.asarray(host)
    ref.use_segment_bank()
    for bo, br, bp in zip(ours.epoch(0), ref.epoch(0), payload, strict=True):
        _assert_batches_equal(bo, br, INDEX_FIELDS)
        mo = port_episode.materialize_episode_batch(bo.to("cpu"), bank)
        mr = jax_episode.materialize_episode_batch(br, ref_bank)
        assert mo.support.dtype == mo.query.dtype == torch.float32
        _assert_batches_equal(mo, mr, FIELDS)
        if transfer_dtype is None:  # the bank path equals the payload path
            _assert_batches_equal(mo, bp.to("cpu"), FIELDS)


def test_segment_targets_identical():
    batch = next(iter(port_loader.get_dataloader(_config(), "test")[0].epoch(0)))
    ref = next(iter(jax_loader.get_dataloader(_config(), "test")[0].epoch(0)))
    np.testing.assert_array_equal(
        port_episode.segment_targets(batch.to("cpu")).numpy(),
        np.asarray(jax_episode.segment_targets(ref)),
    )


def test_payload_batch_to_device_with_wire_dtype():
    batch = next(iter(port_loader.get_dataloader(_config(), "test")[0].epoch(0)))
    moved = batch.to("cpu", torch.bfloat16)
    assert moved.query.dtype == torch.float32 and moved.query_clip.dtype == torch.int64
    ref = torch.from_numpy(batch.query).to(torch.bfloat16).float()
    torch.testing.assert_close(moved.query, ref, rtol=0, atol=0)


@pytest.mark.parametrize("t,seg,cap", [(10, 4, 0), (3, 4, 0), (17, 5, 2), (20, 5, 0)])
def test_segment_clip_identical(t, seg, cap):
    spec = np.random.default_rng(t).normal(size=(1, 3, t)).astype(np.float32)
    np.testing.assert_array_equal(
        port_dataset.segment_clip(spec, seg, cap), jax_dataset.segment_clip(spec, seg, cap)
    )


def _aggregation_inputs():
    """Logits with a 1–1 vote tie (clip 1), a 2–1 majority (clip 0) and an
    empty clip (3) over 4 clips."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 8, 4)).astype(np.float32)
    clip = np.array([[0, 0, 0, 1, 1, 2, 0, 0],
                     [1, 1, 2, 2, 0, 0, 0, 0]], dtype=np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 1, 0, 0],
                     [1, 1, 1, 1, 1, 0, 0, 0]], dtype=np.float32)
    logits[0, 0, 2] = logits[0, 1, 2] = 9.0  # clip 0: class 2 twice
    logits[0, 2, 1] = 9.0                    # ... and class 1 once
    logits[0, 3, 3] = 9.0                    # clip 1: class 3 vs class 0 → tie
    logits[0, 4, 0] = 9.0
    return logits, clip, mask


@pytest.mark.parametrize("fn", ["majority_vote", "average_logits", "clip_vote_counts"])
def test_aggregation_identical(fn):
    logits, clip, mask = _aggregation_inputs()
    ours = getattr(port_aggregate, fn)(
        torch.from_numpy(logits), torch.from_numpy(clip), torch.from_numpy(mask), 4
    ).numpy()
    ref = np.asarray(getattr(jax_aggregate, fn)(
        jnp.asarray(logits), jnp.asarray(clip), jnp.asarray(mask), 4
    ))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_vote_ties_go_to_the_smallest_class_and_empty_clips_average_to_zero():
    logits, clip, mask = _aggregation_inputs()
    t = [torch.from_numpy(a) for a in (logits, clip, mask)]
    preds = port_aggregate.majority_vote(*t, 4)
    assert preds[0, 0].item() == 2
    assert preds[0, 1].item() == 0  # tie between classes 0 and 3
    assert preds[0, 3].item() == 0  # no votes at all
    avg = port_aggregate.average_logits(*t, 4)
    assert torch.all(avg[:, 3] == 0)


@pytest.mark.parametrize("values", [[], [5.0], [1.0, 2.0, 3.0, 4.0],
                                    list(np.random.default_rng(0).uniform(40, 100, 100))])
def test_mean_confidence_interval_identical(values):
    assert port_aggregate.mean_confidence_interval(values) == pytest.approx(
        jax_aggregate.mean_confidence_interval(values), rel=1e-12, abs=1e-12
    )


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(REPO, "config", "deepbdc", "**", "*.yaml"), recursive=True)),
    ids=os.path.basename,
)
def test_deepbdc_configs_merge_identically(path, monkeypatch):
    monkeypatch.chdir(REPO)
    overrides = ["--test_episode", "40", "--backbone.kwargs.reduce_dim", "32"]
    ours = port_config.Config(path, {"test_epoch": 1}, cli_args=overrides).get_config_dict()
    ref = jax_config.Config(path, {"test_epoch": 1}, cli_args=overrides).get_config_dict()
    assert ours == ref
    assert ours["backbone"]["name"] == "resnet12Bdc" and ours["test_episode"] == 40
