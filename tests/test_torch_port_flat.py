"""The PyTorch port's flat (FINETUNING) training path against the JAX
package on the CPU: ``FlatSampler``, ``FlatLoader`` (payload and bank-index
batches), ``get_dataloader``'s FINETUNING branch, the segment bank behind a
flat loader, the two losses the finetuning family adds, and ``Trainer``
taking flat steps.

Geometry: synthetic datasets of ``[1, 8, 10]`` segments (clips of 1-4
segments, so the segment draws show); the trainer on Baseline over
Conv64F (``is_flatten``, ``[1, 81, 90]`` segments, 1600 features) on a
``synthetic:10:12`` root, flat batches of 60 (2 steps an epoch).

Tolerances:
- batches: identical (``np.testing.assert_array_equal``), on both paths;
- the losses against the JAX functions, float32: rtol 1e-6 (``LOSS_RTOL``);
- the trainer: per-step losses against the JAX ``Trainer``'s at the same
  initial weights and batches, SGD at lr 5e-5 and Dropout the identity in
  both: rtol 1e-4 (``STEP_RTOL``, as ``test_torch_port_trainer.py``; the
  JAX package's train-mode BN takes a one-pass float32 variance), val and
  test accuracies rtol 1e-5 (float32 means of the same votes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

from audio_fewshot_tpu.data.dataset import SpectrogramDataset as JaxDataset  # noqa: E402
from audio_fewshot_tpu.data.loader import FlatLoader as JaxFlatLoader  # noqa: E402
from audio_fewshot_tpu.data.loader import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.data.sampler import FlatSampler as JaxFlatSampler  # noqa: E402
from audio_fewshot_tpu.episode import materialize_flat_batch as jax_materialize  # noqa: E402
from audio_fewshot_tpu.models import losses as jax_losses  # noqa: E402
from audio_fewshot_tpu.models.base import ModelType as JaxModelType  # noqa: E402
import audio_fewshot_tpu.train as jax_train_module  # noqa: E402
from audio_fewshot_tpu.train import Trainer as JaxTrainer  # noqa: E402
from audio_fewshot_tpu.utils.meters import TensorboardWriter as JaxTensorboardWriter  # noqa: E402
import audio_fewshot_tpu_torch.train as port_train_module  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.data import (  # noqa: E402
    EpisodicLoader, FlatLoader, FlatSampler, SpectrogramDataset, get_dataloader)
from audio_fewshot_tpu_torch.data.bank import setup_segment_banks  # noqa: E402
from audio_fewshot_tpu_torch.episode import (  # noqa: E402
    FlatBatch, IndexedFlatBatch, materialize_flat_batch)
from audio_fewshot_tpu_torch.models import losses  # noqa: E402
from audio_fewshot_tpu_torch.models.backbones.layers import Dropout  # noqa: E402
from audio_fewshot_tpu_torch.models.base import ModelType  # noqa: E402
from audio_fewshot_tpu_torch.train import Trainer  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402
from audio_fewshot_tpu_torch.utils.meters import TensorboardWriter  # noqa: E402

LOSS_RTOL = 1e-6
STEP_RTOL = 1e-4
ACC_RTOL = 1e-5
SEG = (1, 8, 10)


def datasets(seed=3):
    """The same synthetic dataset in both packages (6 classes × 9 clips of 1
    to 4 segments)."""
    kw = dict(num_classes=6, clips_per_class=9, segment_shape=SEG, max_segments=4, seed=seed)
    ours, ref = SpectrogramDataset.synthetic(**kw), JaxDataset.synthetic(**kw)
    for a, b in zip(ours.clips, ref.clips):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    return ours, ref


# -- the sampler and the loader ----------------------------------------------------------------

@pytest.mark.parametrize("seed, epoch, batch", [(0, 0, 7), (0, 3, 7), (5, 1, 16), (2, 0, 10)])
def test_flat_sampler_matches_jax(seed, epoch, batch):
    counts = [9, 4, 12, 7, 1]
    ours = FlatSampler(counts, batch, seed=seed)
    ref = JaxFlatSampler(counts, batch, seed=seed)
    assert len(ours) == len(ref) == 33 // batch
    got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
    assert len(got) == len(want) == len(ours)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # each epoch is a fresh permutation of the (class, clip) pairs
    if batch == 7:
        assert not np.array_equal(np.concatenate(got), np.concatenate(list(ours.epoch(epoch + 1))))


@pytest.mark.parametrize("epoch", [0, 2])
def test_flat_loader_payload_batches_match_jax(epoch):
    ours_ds, ref_ds = datasets()
    ours, ref = FlatLoader(ours_ds, 8, seed=4), JaxFlatLoader(ref_ds, 8, seed=4)
    assert len(ours) == len(ref) == 54 // 8
    n = 0
    for a, b in zip(ours.epoch(epoch), ref.epoch(epoch)):
        assert isinstance(a, FlatBatch)
        assert a.data.shape == (8,) + SEG
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.target, b.target)
        n += 1
    assert n == len(ours)


@pytest.mark.parametrize("epoch", [0, 1])
def test_flat_loader_bank_batches_match_jax_and_the_payload(epoch):
    """Bank rows equal the JAX package's; gathered from the bank, each batch
    is the payload batch of the same epoch, bit for bit."""
    ours_ds, ref_ds = datasets()
    payload = list(FlatLoader(ours_ds, 8, seed=4).epoch(epoch))
    ours, ref = FlatLoader(ours_ds, 8, seed=4), JaxFlatLoader(ref_ds, 8, seed=4)
    ours.use_segment_bank()
    ref.use_segment_bank()
    bank_np, _ = ours_ds.segment_bank()
    bank = torch.from_numpy(bank_np)
    ref_bank = jnp.asarray(ref_ds.segment_bank()[0])
    for a, b, p in zip(ours.epoch(epoch), ref.epoch(epoch), payload):
        assert isinstance(a, IndexedFlatBatch)
        np.testing.assert_array_equal(a.data_idx, b.data_idx)
        np.testing.assert_array_equal(a.target, b.target)
        got = materialize_flat_batch(a.to("cpu"), bank)
        np.testing.assert_array_equal(got.data.numpy(), p.data)
        np.testing.assert_array_equal(got.target.numpy(), p.target)
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(jax_materialize(b, ref_bank).data))


def loader_config(**over):
    cfg = {"classifier": {"name": "Baseline", "kwargs": None},
           "backbone": {"name": "Conv64F", "kwargs": None}, "data_root": "synthetic:6:9",
           "spec_shape": list(SEG), "way_num": 5, "shot_num": 1, "query_num": 2,
           "seed": 3, "modality": "audio"}
    cfg.update(over)
    return cfg


def test_get_dataloader_gives_finetuning_training_a_flat_loader():
    """FINETUNING training gets one ``FlatLoader`` of ``batch_size`` (128 by
    default) seeded ``seed``, whose batches are the JAX package's; its val
    and test loaders stay episodic."""
    cfg = loader_config(batch_size=16)
    ours = get_dataloader(cfg, "train", ModelType.FINETUNING)
    ref = jax_get_dataloader(cfg, "train", JaxModelType.FINETUNING)
    assert len(ours) == len(ref) == 1 and isinstance(ours[0], FlatLoader)
    assert ours[0].sampler.batch_size == 16 and ours[0].sampler.seed == 3
    for a, b in zip(ours[0].epoch(1), ref[0].epoch(1)):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.target, b.target)
    assert get_dataloader(loader_config(), "train", ModelType.FINETUNING)[0].sampler.batch_size \
        == 128
    assert isinstance(get_dataloader(cfg, "val", ModelType.FINETUNING)[0], EpisodicLoader)
    assert isinstance(get_dataloader(cfg, "train", ModelType.METRIC)[0], EpisodicLoader)


def test_dual_loader_still_raises():
    """``dataloader_num: 2`` pairs a flat loader with an episodic method's
    (``test_torch_port_dual.py``); a FINETUNING method gets two flat
    loaders, seeded ``seed`` and ``seed + 1``, as in the JAX package, whose
    batches the trainer takes in turn."""
    cfg = loader_config(dataloader_num=2, batch_size=16)
    ours = get_dataloader(cfg, "train", ModelType.FINETUNING)
    ref = jax_get_dataloader(cfg, "train", JaxModelType.FINETUNING)
    assert len(ours) == len(ref) == 2 and all(isinstance(ld, FlatLoader) for ld in ours)
    assert [ld.sampler.seed for ld in ours] == [ld.sampler.seed for ld in ref] == [3, 4]
    for a, b in zip(ours, ref):
        first, want = next(iter(a.epoch(0))), next(iter(b.epoch(0)))
        np.testing.assert_array_equal(first.data, want.data)
        np.testing.assert_array_equal(first.target, want.target)


def test_segment_banks_take_a_flat_loader():
    """``setup_segment_banks`` switches a ``FlatLoader`` to bank rows beside
    episodic loaders; its gathered batches are the payload batches."""
    cfg = loader_config(batch_size=16)
    flat = get_dataloader(cfg, "train", ModelType.FINETUNING)[0]
    payload = list(get_dataloader(cfg, "train", ModelType.FINETUNING)[0].epoch(0))
    val = get_dataloader(cfg, "val", ModelType.FINETUNING)[0]
    banks = setup_segment_banks({"device_data_bank": True}, [flat, val], torch.device("cpu"))
    assert flat.emit_indices and val.emit_indices and all(b is not None for b in banks)
    for batch, want in zip(flat.epoch(0), payload):
        got = materialize_flat_batch(batch.to("cpu"), banks[0])
        np.testing.assert_array_equal(got.data.numpy(), want.data)


def test_flat_batch_moves_in_its_transfer_dtype():
    data = np.random.default_rng(0).normal(size=(3,) + SEG).astype(np.float32)
    batch = FlatBatch(data=data, target=np.arange(3, dtype=np.int32)).to(
        "cpu", transfer_dtype=torch.bfloat16)
    assert batch.data.dtype == torch.float32 and batch.target.dtype == torch.int64
    np.testing.assert_array_equal(batch.data.numpy(),
                                  torch.from_numpy(data).bfloat16().float().numpy())
    assert materialize_flat_batch(batch, None) is batch


# -- the losses ---------------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "nan"])
def test_l2_dist_loss_matches_jax(case):
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(2, 6, 9)).astype(np.float32)
    if case == "nan":
        a[2, 4] = np.nan
    got = losses.l2_dist_loss(torch.from_numpy(a), torch.from_numpy(b)).item()
    want = float(jax_losses.l2_dist_loss(jnp.asarray(a), jnp.asarray(b)))
    if case == "nan":
        assert got == want == 0.0
    else:
        assert got == pytest.approx(want, rel=LOSS_RTOL)


@pytest.mark.parametrize("temperature, teacher_scale", [(4.0, 1.0), (1.0, 3.0), (1.0, 200.0)])
def test_distill_kl_loss_matches_jax(temperature, teacher_scale):
    """KL(teacher ∥ student) · T²; at a teacher scale of 200 its softmax
    underflows to 0 and the 1e-12 clamp is what keeps the log finite."""
    rng = np.random.default_rng(3)
    student = rng.normal(size=(5, 8)).astype(np.float32)
    teacher = (teacher_scale * rng.normal(size=(5, 8))).astype(np.float32)
    got = losses.distill_kl_loss(torch.from_numpy(student), torch.from_numpy(teacher),
                                 temperature).item()
    want = float(jax_losses.distill_kl_loss(jnp.asarray(student), jnp.asarray(teacher),
                                            temperature))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-5)
    same = losses.distill_kl_loss(torch.from_numpy(teacher), torch.from_numpy(teacher),
                                  temperature).item()
    assert abs(same) < 1e-5 * temperature ** 2


# -- the trainer --------------------------------------------------------------------------------

@pytest.fixture
def no_tensorboard(monkeypatch):
    """Both packages' TensorBoard writers as no-ops (as without tensorboard
    installed): importing tensorboard pulls in TensorFlow, seconds a
    process, and no test here reads the event files."""
    for module, writer in ((port_train_module, TensorboardWriter),
                           (jax_train_module, JaxTensorboardWriter)):
        class NoWriter(writer):
            def __init__(self, log_dir):
                self.step, self._writer = 0, None

        monkeypatch.setattr(module, "TensorboardWriter", NoWriter)


def trainer_config(root, **over):
    cfg = {
        "classifier": {"name": "Baseline", "kwargs": {"num_class": 10, "inner_param": {
            "inner_train_iter": 3, "inner_batch_size": 4}}},
        "backbone": {"name": "Conv64F", "kwargs": {"is_flatten": True, "num_channels": 1}},
        "data_root": "synthetic:10:12", "spec_shape": [1, 81, 90], "batch_size": 60,
        "way_num": 5, "shot_num": 2, "query_num": 2,
        "epoch": 1, "test_episode": 4, "test_episode_size": 2,
        "max_segments_per_clip": 3, "segment_bucket_sizes": [48],
        "precision": "fp32", "seed": 0, "prefetch": 0, "augment": True,
        "result_root": str(root), "save_interval": 1, "log_interval": 1, "n_devices": 1,
        "optimizer": {"name": "SGD", "kwargs": {"lr": 5e-5, "momentum": 0.9}, "other": None},
        "lr_scheduler": {"name": "CosineAnnealingLR", "kwargs": {"T_max": 100, "eta_min": 0}},
        "compilation_cache": False,
    }
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


def test_trainer_takes_flat_steps_as_jax(tmp_path, monkeypatch, no_tensorboard):
    """Two flat steps (an epoch of 120 clips in batches of 60) of Baseline on
    Conv64F: the losses of both steps and the val/test accuracies against
    the JAX ``Trainer`` at the same initial weights (augmentation asked for
    and off for FINETUNING in both; Dropout the identity in both); the
    history keeps ms a step and the segments a second."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)
    ref = JaxTrainer(0, trainer_config(tmp_path / "jax"))
    ref_losses, ref_accs = [], []
    step, validate = ref._jit_train_step, ref._validate

    def recording_step(*args, **kwargs):
        out = step(*args, **kwargs)
        ref_losses.append(float(out[2]["loss"]))
        return out

    def recording_validate(*args, **kwargs):
        out = validate(*args, **kwargs)
        ref_accs.append(out[0])
        return out

    ref._jit_train_step, ref._validate = recording_step, recording_validate
    init = jax.tree_util.tree_map(np.asarray, ref.variables)
    assert not ref.augment
    ref.train_loop()

    ours = Trainer(0, trainer_config(tmp_path / "port"), device="cpu")
    assert not ours.augment and isinstance(ours.train_loader[0], FlatLoader)
    ours.method.load_state_dict(state_dict_from_jax(init, "Conv64F", prefix="emb_func.",
                                                    classifier="Baseline"))
    ours.train_loop()
    record = ours.history[0]
    assert len(record["train_losses"]) == len(ref_losses) == 2
    np.testing.assert_allclose(record["train_losses"], ref_losses, rtol=STEP_RTOL)
    np.testing.assert_allclose([record["val_acc"], record["test_acc"]], ref_accs, rtol=ACC_RTOL)
    assert record["step_ms"] > 0 and record["train_segments_per_s"] > 0
    assert "train_eps" not in record
