"""The port's ``Trainer`` and its CLIs on the CPU: a 2-epoch × 4-step
synthetic DeepBDC run against the JAX package's ``Trainer`` at the same
initial weights (per-step losses, val/test accuracies, best/last
bookkeeping), resume (1 epoch + resume = 2 epochs), ``pretrain_path``,
the result directory, and the guards (no silent CPU, no skipped feature).

The JAX-vs-port run trains with SGD (momentum 0.9, lr 5e-5), not the
configs' Adam: Adam's updates are about ±lr whatever a gradient's size, so
the float32 noise of near-zero gradients flips whole steps and two float32
runs part after a few steps (``test_torch_port_train.py`` holds Adam's
first steps and its update on given gradients).  With SGD the two
trajectories stay within float32 noise: the losses agree to 3e-6 (measured)
and are held at 1e-4."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from test_torch_port_backbone import xdist_torch_threads  # noqa: E402,F401

import jax  # noqa: E402

from audio_fewshot_tpu.train import Trainer as JaxTrainer  # noqa: E402
from audio_fewshot_tpu_torch import run_trainer, run_trainer_resume  # noqa: E402
from audio_fewshot_tpu_torch.config import Config, save_config  # noqa: E402
from audio_fewshot_tpu_torch.eval import Test  # noqa: E402
from audio_fewshot_tpu_torch.train import Trainer, slice_config  # noqa: E402
from audio_fewshot_tpu_torch.utils.checkpoint import BEST, LAST, load_last  # noqa: E402
from audio_fewshot_tpu_torch.utils.convert import state_dict_from_jax  # noqa: E402

LOSS_RTOL = 1e-4
# accuracies are float32 means of the same votes
ACC_RTOL = 1e-5


def trainer_config(root, **over):
    cfg = {
        "classifier": {"name": "DeepBDC", "kwargs": None},
        "backbone": {"name": "resnet12Bdc",
                     "kwargs": {"num_channels": 1, "reduce_dim": 8, "fused_bdc": False}},
        "data_root": "synthetic:10:12", "spec_shape": [1, 16, 20],
        "way_num": 5, "shot_num": 2, "query_num": 2,
        "epoch": 2, "train_episode": 4, "test_episode": 4, "test_episode_size": 2,
        "max_segments_per_clip": 3, "segment_bucket_sizes": [48],
        "precision": "fp32", "seed": 0, "prefetch": 0, "augment": False,
        "result_root": str(root), "save_interval": 1, "log_interval": 1,
        "optimizer": {"name": "Adam", "kwargs": {"lr": 0.005}, "other": None},
        "lr_scheduler": {"name": "CosineAnnealingLR", "kwargs": {"T_max": 100, "eta_min": 0}},
        "compilation_cache": False,
    }
    cfg.update(over)
    return Config(None, cfg).get_config_dict()


def _losses(trainer):
    return [loss for record in trainer.history for loss in record["train_losses"]]


def test_two_epochs_match_jax(tmp_path):
    sgd = {"name": "SGD", "kwargs": {"lr": 5e-5, "momentum": 0.9}, "other": None}
    ref = JaxTrainer(0, trainer_config(tmp_path / "jax", optimizer=sgd))
    ref_losses = []
    step = ref._jit_train_step

    def recording_step(*args, **kwargs):
        out = step(*args, **kwargs)
        ref_losses.append(float(out[2]["loss"]))
        return out

    ref._jit_train_step = recording_step
    ref_accs = []
    validate = ref._validate

    def recording_validate(*args, **kwargs):
        out = validate(*args, **kwargs)
        ref_accs.append(out[0])
        return out

    ref._validate = recording_validate
    init = jax.tree_util.tree_map(np.asarray, ref.variables)
    ref_best = ref.train_loop()

    ours = Trainer(0, trainer_config(tmp_path / "port", optimizer=sgd), device="cpu")
    ours.method.load_state_dict(state_dict_from_jax(init, "resnet12Bdc", prefix="emb_func."))
    best = ours.train_loop()

    assert len(_losses(ours)) == len(ref_losses) == 8
    np.testing.assert_allclose(_losses(ours), ref_losses, rtol=LOSS_RTOL)
    accs = [a for r in ours.history for a in (r["val_acc"], r["test_acc"])]
    np.testing.assert_allclose(accs, ref_accs, rtol=ACC_RTOL)
    assert best == pytest.approx(ref_best, rel=ACC_RTOL)
    # the best test accuracy is the one at the best-val epoch
    best_epoch = int(np.argmax([r["val_acc"] for r in ours.history]))
    assert ours.best_test_acc == ours.history[best_epoch]["test_acc"]
    files = sorted(os.listdir(ours.ckpt_dir))
    assert files == sorted(os.listdir(ref.ckpt_dir))
    assert {BEST, LAST, "model_00000.pth", "model_00001.pth", "emb_func_best.pth",
            "emb_func_last.pth", "emb_func_00001.pth"} <= set(files)
    last = load_last(os.path.join(ours.ckpt_dir, LAST))
    assert last["epoch"] == 1 and last["best_val_acc"] == ours.best_val_acc
    assert last["best_test_acc"] == ours.best_test_acc
    assert set(last) >= {"state_dict", "optimizer", "scheduler"}
    # model_best.pth is what the port's Test reads
    test = Test(0, trainer_config(tmp_path / "port", test_epoch=1), ours.result_dir, device="cpu")
    assert np.isfinite(test.test_loop()[0])


def test_resume_continues_as_an_uninterrupted_run(tmp_path):
    """Adam, cosine LR and augmentation on: 1 epoch through the train CLI,
    then the resume CLI for epoch 2, gives the losses of 2 epochs in one
    run (the same arithmetic in the same process: exact)."""
    whole = Trainer(0, trainer_config(tmp_path / "whole", augment=True), device="cpu")
    whole.train_loop()

    yaml_path = tmp_path / "one_epoch.yaml"
    save_config(trainer_config(tmp_path / "parts", augment=True, epoch=1), str(yaml_path))
    first = run_trainer.main(["--yaml_path", str(yaml_path), "--device", "cpu"])
    assert [r["epoch"] for r in first.history] == [0]
    resumed = run_trainer_resume.build_trainer(
        [first.result_dir, "--device", "cpu", "--epoch", "2"])
    assert resumed.start_epoch == 1
    saved = load_last(os.path.join(first.ckpt_dir, LAST))
    assert resumed.scheduler.state_dict() == saved["scheduler"]
    state = resumed.optimizer.state_dict()["state"]
    assert len(state) == len(list(resumed.method.parameters()))
    for key, val in saved["optimizer"]["state"].items():
        torch.testing.assert_close(state[key]["exp_avg"], val["exp_avg"], rtol=0, atol=0)
    assert resumed.best_val_acc == first.best_val_acc
    resumed.train_loop()
    assert [r["epoch"] for r in resumed.history] == [1]
    np.testing.assert_allclose(_losses(first) + _losses(resumed), _losses(whole), rtol=1e-6)
    assert resumed.best_val_acc == whole.best_val_acc
    assert resumed.best_test_acc == whole.best_test_acc
    for key, val in whole.method.state_dict().items():
        torch.testing.assert_close(resumed.method.state_dict()[key], val, rtol=1e-5, atol=1e-6)


def test_pretrain_path_loads_the_emb_func_part(tmp_path):
    src = Trainer(0, trainer_config(tmp_path / "src", epoch=1, train_episode=1), device="cpu")
    src.train_loop()
    part = os.path.join(src.ckpt_dir, "emb_func_last.pth")
    dst = Trainer(0, trainer_config(tmp_path / "dst", seed=5, pretrain_path=part), device="cpu")
    for key, val in src.method.state_dict().items():
        torch.testing.assert_close(dst.method.state_dict()[key], val, rtol=0, atol=0)
    with pytest.raises(KeyError, match="emb_func"):
        Trainer(0, trainer_config(tmp_path / "bad", pretrain_path=os.path.join(
            src.ckpt_dir, LAST)), device="cpu")


def test_entry_points_never_drift_to_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(0, trainer_config(tmp_path))
    yaml_path = tmp_path / "c.yaml"
    save_config(trainer_config(tmp_path), str(yaml_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_trainer.main(["--yaml_path", str(yaml_path)])
    save_config(trainer_config(tmp_path), str(tmp_path / "config.yaml"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_trainer_resume.main([str(tmp_path)])


@pytest.mark.parametrize("over, error, match", [
    ({"profile_steps": 2}, NotImplementedError, "profile_steps"),
    ({"classifier": {"name": "IfslPretrain", "kwargs": {
        "num_class": 10, "ifsl_pretrain_param": {"featuring": True}}}},
     ValueError, "feature_path"),
], ids=["profile_steps", "featuring"])
def test_unported_training_features_raise(tmp_path, over, error, match):
    """``profile_steps`` is not ported; IFSL's featuring pass is
    (``test_torch_port_ifsl_cycle.py``), and refuses to run without its
    ``feature_path``."""
    with pytest.raises(error, match=match):
        Trainer(0, trainer_config(tmp_path, train_episode=1, **over), device="cpu").train_loop()


def test_resnet12bdc_trains_with_dropblock(tmp_path):
    """resnet12Bdc at drop_rate 0.1 (the JAX default): finite losses, and the
    DropBlock counter counts one per train step."""
    over = {"backbone": {"name": "resnet12Bdc",
                         "kwargs": {"num_channels": 1, "reduce_dim": 8, "drop_rate": 0.1}}}
    trainer = Trainer(0, trainer_config(tmp_path, train_episode=1, **over), device="cpu")
    trainer.train_loop()
    assert _losses(trainer) and np.isfinite(_losses(trainer)).all()
    assert int(trainer.method.emb_func.layer4[0].num_batches_tracked) == 2  # 2 epochs x 1


def test_chip_training_cell_is_the_shipped_config_cut_to_size(tmp_path):
    """``train.slice_config`` (the cell ``chip_smoke.py`` trains) is the
    flagship YAML with its headers, but for the cuts it names."""
    cell = slice_config(str(tmp_path))
    shipped = Config(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                  "config", "deepbdc", "deepbdc_5shot_iid_seed0.yaml")).get_config_dict()
    cuts = {"epoch": (30, 2), "train_episode": (1000, 40), "test_episode": (600, 32),
            "result_root": ("./results", str(tmp_path)),
            "tb_scale": (1000 / 600, 40 / 32)}  # train/test episodes, derived
    for key, (full, cut) in cuts.items():
        assert (shipped[key], cell[key]) == (full, cut), key
    for key, val in shipped.items():
        if key not in cuts and key != "includes":
            assert cell[key] == val, key
    assert cell["spec_shape"] == [1, 128, 157] and cell["precision"] == "bf16"
