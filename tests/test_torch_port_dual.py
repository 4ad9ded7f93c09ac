"""The dual (episodic + flat) loader of ``dataloader_num: 2`` and RENet's
dual train step in the PyTorch port, against the JAX package on the CPU.

RENet on a narrow resnet12's [20, 6, 7] map (planes 8/12/16/20 on
``[1, 96, 112]``), ``drop_rate`` 0.1 so the DropBlock counters exist, with
no block dropped on either side (the packages cannot draw the same blocks:
the seeds are all zero in both, and the stage 1-2 Dropout is the identity),
3-way 3-shot 2-query episodes and flat
batches of 6.

Tolerances: the dual step against the JAX package's with a float64
resnet12 and a float64 head (``test_torch_port_renet.py``'s
``STEP_TOLS``): loss and logits 1e-5 of the logits' scale, gradients 1e-4 of
their max abs, running statistics 1e-5 (the port with float64 blocks);
the DropBlock counters equal.  The loaders' batches equal the JAX
package's exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as flax_nn  # noqa: E402

from audio_fewshot_tpu.data import get_dataloader as jax_get_dataloader  # noqa: E402
from audio_fewshot_tpu.episode import DualBatch as JaxDualBatch  # noqa: E402
from audio_fewshot_tpu.episode import FlatBatch as JaxFlatBatch  # noqa: E402
from audio_fewshot_tpu.models.base import ModelType as JaxModelType  # noqa: E402
from audio_fewshot_tpu_torch import run_trainer  # noqa: E402
from audio_fewshot_tpu_torch.config import Config  # noqa: E402
from audio_fewshot_tpu_torch.data import EpisodicLoader, FlatLoader, get_dataloader  # noqa: E402
from audio_fewshot_tpu_torch.data.bank import setup_segment_banks  # noqa: E402
from audio_fewshot_tpu_torch.episode import (  # noqa: E402
    DualBatch, FlatBatch, materialize_dual_batch)
from audio_fewshot_tpu_torch.models.backbones.layers import DropBlock, Dropout  # noqa: E402
from audio_fewshot_tpu_torch.models.base import ModelType  # noqa: E402
from audio_fewshot_tpu_torch.train import Trainer  # noqa: E402

import test_torch_port_renet as rn  # noqa: E402
from test_torch_port_flat import no_tensorboard  # noqa: E402,F401
from test_torch_port_metric import _running  # noqa: E402
from test_torch_port_resnet12_heads import _check_step  # noqa: E402

FLAT_ROWS = 6


def dual_config(root=None, **over):
    """A dual-loader RENet config on a small synthetic root (6 classes × 16
    clips), one epoch of 4 train episodes, flat batches of ``batch_size``."""
    cfg = rn.renet_config("resnet12", drop_rate=0.1)
    cfg["backbone"]["kwargs"]["planes"] = [8, 12, 16, 20]
    cfg.update(spec_shape=[1, 32, 40], data_root="synthetic:6:16", dataloader_num=2,
               batch_size=16, epoch=1, train_episode=4, test_episode=2, test_episode_size=2,
               max_segments_per_clip=2, seed=3, prefetch=0, augment=True,
               mean_std_file="./Auxiliary/Clean_Mean_Std.npy",
               result_root=str(root or "/nonexistent"))
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


# -- the loaders ------------------------------------------------------------------------------

def test_get_dataloader_pairs_an_episodic_and_a_flat_loader_as_jax():
    """``dataloader_num: 2`` in training: an episodic loader and a flat one
    of ``batch_size`` seeded ``seed + 1``, over one dataset; their first
    batches are the JAX package's, array for array.  Eval splits keep one
    loader; a FINETUNING method's training gets two flat ones."""
    cfg = dual_config()
    ours = get_dataloader(cfg, "train", ModelType.METRIC)
    ref = jax_get_dataloader(cfg, "train", JaxModelType.METRIC)
    assert [type(ld) for ld in ours] == [EpisodicLoader, FlatLoader]
    assert ours[0].dataset is ours[1].dataset
    assert ours[1].sampler.seed == ref[1].sampler.seed == 4
    assert len(ours[1]) == len(ref[1]) == 96 // 16
    ep, ep_ref = next(iter(ours[0].epoch(0))), next(iter(ref[0].epoch(0)))
    fl, fl_ref = next(iter(ours[1].epoch(0))), next(iter(ref[1].epoch(0)))
    for got, want in ((ep.support, ep_ref.support), (ep.query, ep_ref.query),
                      (ep.global_target, ep_ref.global_target), (fl.data, fl_ref.data),
                      (fl.target, fl_ref.target)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert len(get_dataloader(cfg, "test", ModelType.METRIC)) == 1
    flat_only = get_dataloader(cfg, "train", ModelType.FINETUNING)
    assert [type(ld) for ld in flat_only] == [FlatLoader, FlatLoader]


def test_bank_gathers_both_halves_as_the_payload_batch():
    """With a segment bank both loaders emit bank rows (one bank: they share
    the dataset); the gathered ``DualBatch`` equals the payload one."""
    cfg = dual_config()
    payload = get_dataloader(cfg, "train", ModelType.METRIC)
    indexed = get_dataloader(cfg, "train", ModelType.METRIC)
    banks = setup_segment_banks(cfg, indexed, torch.device("cpu"))
    assert banks[0] is banks[1] and banks[0] is not None
    host = DualBatch(episode=next(iter(indexed[0].epoch(0))), flat=next(iter(indexed[1].epoch(0))))
    got = materialize_dual_batch(host.to("cpu"), banks[0])
    want = DualBatch(episode=next(iter(payload[0].epoch(0))),
                     flat=next(iter(payload[1].epoch(0)))).to("cpu")
    for a, b in ((got.episode.support, want.episode.support),
                 (got.episode.query, want.episode.query), (got.flat.data, want.flat.data),
                 (got.flat.target, want.flat.target)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("batch_size, steps", [(48, 2), (16, 4)])
def test_dual_epoch_is_the_shorter_loader(batch_size, steps, tmp_path, no_tensorboard):
    """The trainer zips the loaders into one ``DualBatch`` a step: an epoch
    of min(4 episodes, 96 // ``batch_size`` flat batches) steps, the
    truncation said in the log, as the JAX package says it; both halves go
    through the device bank and the augmentation."""
    cfg = dual_config(tmp_path, batch_size=batch_size)
    trainer = Trainer(0, cfg, device="cpu")
    assert trainer.train_bank is not None
    seen = []
    step = trainer._train_step
    trainer._train_step = lambda batch: seen.append(batch) or step(batch)
    trainer.train_loop()
    losses = trainer.history[0]["train_losses"]
    assert len(losses) == len(seen) == steps and all(np.isfinite(losses))
    assert all(isinstance(b, DualBatch) and b.flat.data.shape[0] == batch_size for b in seen)
    with open(os.path.join(trainer.log_dir, "RENet-resnet12-train.log")) as f:
        truncated = [line.split(" INFO ")[-1].strip() for line in f if "truncated" in line]
    if steps < 4:
        assert truncated == [
            f"dual-loader epoch truncated to {steps} steps: the global-flat companion "
            f"({steps} batches of batch_size {batch_size}) is shorter than the episodic "
            "loader (4) — reference zip semantics (trainer.py:159)"]
    else:
        assert not truncated


def test_finetuning_takes_two_flat_loaders_in_turn(tmp_path, no_tensorboard):
    """A FINETUNING method with ``dataloader_num: 2`` trains on both flat
    loaders' batches in turn, as the JAX package's trainer: an epoch of 2 ×
    96 // 48 steps."""
    cfg = dual_config(tmp_path, batch_size=48, augment=False, spec_shape=[1, 81, 90],
                      classifier={"name": "Baseline", "kwargs": {"num_class": 6}},
                      backbone={"name": "Conv64F", "kwargs": {"is_flatten": True,
                                                               "num_channels": 1}})
    trainer = Trainer(0, cfg, device="cpu")
    assert [ld.sampler.seed for ld in trainer.train_loader] == [3, 4]
    seen = []
    step = trainer._train_step
    trainer._train_step = lambda batch: seen.append(batch) or step(batch)
    trainer.train_loop()
    assert len(trainer.history[0]["train_losses"]) == len(seen) == 4
    first = [next(iter(ld.epoch(0))) for ld in trainer.train_loader]
    for got, want in zip(seen[:2], first):  # the first step from each loader
        np.testing.assert_array_equal(got.target.numpy(), want.target)


def test_fixture_config_trains_through_run_trainer(tmp_path, no_tensorboard):
    """``config/kos_fixture/renet_5shot.yaml`` (Conv64F's map, the dual
    loader, flat batches of 12, bf16 on the wire) through ``run_trainer`` on
    the CPU, on a synthetic root in place of the fixture's generated data."""
    argv = ["--yaml_path", os.path.join(rn.REPO, "config", "kos_fixture", "renet_5shot.yaml"),
            "--device", "cpu",
            "--data_root", "synthetic:6:24", "--mean_std_file", "./Auxiliary/Clean_Mean_Std.npy",
            "--class_per_split", "none", "--spec_shape", "[1, 81, 90]", "--epoch", "1",
            "--train_episode", "4", "--episode_size", "2", "--test_episode", "2",
            "--test_episode_size", "2", "--max_segments_per_clip", "2", "--precision", "fp32",
            "--result_root", str(tmp_path), "--prefetch", "0"]
    trainer = run_trainer.main(argv)
    assert [type(ld) for ld in trainer.train_loader] == [EpisodicLoader, FlatLoader]
    assert trainer.train_loader[1].sampler.batch_size == 12
    record = trainer.history[0]
    assert len(record["train_losses"]) == 2
    assert all(np.isfinite(record["train_losses"])) and np.isfinite(record["test_acc"])


# -- the dual step ---------------------------------------------------------------------------

@pytest.fixture
def no_blocks(monkeypatch):
    """Every DropBlock seed zero in both packages: no block dropped, the
    counters still ramp; the Dropout of stages 1 and 2 the identity."""
    monkeypatch.setattr(flax_nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.zeros(shape, bool))
    draw = DropBlock.draw_seeds
    monkeypatch.setattr(DropBlock, "draw_seeds",
                        lambda self, x, gamma: torch.zeros_like(draw(self, x, gamma)))


def _dual_batches(seed=2):
    jb, pb = rn.batches("resnet12", 1, seed=seed)
    rng = np.random.default_rng(seed + 10)
    data = rng.normal(size=(FLAT_ROWS,) + rn.SPECS["resnet12"]).astype(np.float32)
    target = rng.integers(0, 25, size=FLAT_ROWS).astype(np.int32)
    return (JaxDualBatch(episode=jb, flat=JaxFlatBatch(data=jnp.asarray(data),
                                                       target=jnp.asarray(target))),
            DualBatch(episode=pb, flat=FlatBatch(data=data, target=target).to("cpu")))


def test_dual_step_compounds_as_the_jax_dual_step(no_blocks):
    """RENet's loss on a ``DualBatch``: the episodic terms + the global CE of
    ``fc(GAP(SCR(emb_func(flat))))``.  The flat pass runs after the episodic
    one, from its updated BN statistics and DropBlock counters: after the
    step every running statistic and counter is the JAX dual step's (two
    momentum updates, counters + 2), the loss and every gradient too."""
    variables = rn.jax_variables("resnet12")
    jdual, pdual = _dual_batches()
    ref = rn.jax_step_reference("resnet12", variables, jdual, drop_rate=0.1)
    method = rn.port_method("resnet12", variables, torch.float64, drop_rate=0.1).train()
    loss, out = method.loss(pdual, rn.SETTING)
    loss.backward()
    _check_step(dict(method.named_parameters()), _running(method), loss, out, ref,
                rn.STEP_TOLS)
    state = method.state_dict()
    for block, start in (("layer3", 7), ("layer4", 11)):
        key = f"emb_func.{block}.0.num_batches_tracked"
        assert int(state[key]) == int(ref[3][key]) == start + 2
    # the episodic pass alone leaves other statistics: the flat pass counted
    alone = rn.port_method("resnet12", variables, torch.float64, drop_rate=0.1).train()
    alone.loss(pdual.episode, rn.SETTING)
    ep_only = _running(alone)
    assert any(not torch.allclose(ep_only[k], v) for k, v in _running(method).items())
