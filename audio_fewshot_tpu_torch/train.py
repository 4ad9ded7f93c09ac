"""Trainer: the train loop with validation, testing and checkpoints
(counterpart of ``Trainer`` in ``audio_fewshot_tpu/train.py``).

``Trainer(rank, config, device).train_loop()`` runs, per epoch: the train
steps of one episodic loader (random segment per clip, optional random
spectrogram augmentation, loss, backward, optimizer step; the LR scale is
set once per epoch) or, for a FINETUNING method, of one ``FlatLoader``
(flat batches of ``batch_size`` segments, no augmentation, an epoch of
``len(FlatSampler)`` steps) or, with ``dataloader_num: 2``, of both at
once (each step one ``DualBatch``: the two loaders zipped, the epoch as long
as the shorter, both halves augmented), then a validation and a test pass (per-episode
majority-vote clip accuracy and a 95 % CI), then the checkpoints: best (by
val accuracy; the best test accuracy is the one AT that epoch), every
``save_interval`` epochs, and last (with the optimizer and scheduler
state, which ``resume`` reads back).  It runs on ``cuda`` unless ``device``
says otherwise, and raises when no card is there.  IfslPretrain with
``ifsl_pretrain_param.featuring`` runs ``run_featuring`` in place of the
epochs.

Not ported yet (``NotImplementedError`` naming the ROADMAP item):
``profile_steps``.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .config import Config, save_config
from .data import FlatLoader, get_dataloader, get_mean_std
from .data.bank import resolve_transfer_dtype, setup_segment_banks
from .episode import (DualBatch, EpisodeBatch, FlatBatch, IndexedFlatBatch,
                      materialize_dual_batch, materialize_episode_batch, materialize_flat_batch)
from .eval import SLICE_MODELS
from .models import build_method, eval_setting, train_setting
from .models.backbones.layers import seed_dropout
from .models.base import MethodBase, ModelType
from .models.init import init_weights
from .ops.audio_augmentations import augment_batch_one_type
from .optim import LRScheduler, Optimizer, build_optimizer, build_scheduler
from .utils import init_logger, init_seed, mean_confidence_interval, resolve_device
from .utils.checkpoint import LAST, SaveType, load_last, load_part, save_model
from .utils.meters import AverageMeter, TensorboardWriter


def slice_config(result_root: str, classifier: str = "DeepBDC", epoch: int = 2,
                 train_episode: int = 40, test_episode: int = 32) -> Dict[str, Any]:
    """A full-width training cell that ``chip_smoke.py`` runs on the card.

    ``classifier="DeepBDC"``: ``config/deepbdc/deepbdc_5shot_iid_seed0.yaml``
    (resnet12Bdc, planes 64/160/320/640, ``reduce_dim`` 64);
    ``"ProtoNet"``: ``config/proto/proto_5shot_iid_seed0.yaml`` (Conv64F
    with ``is_flatten``: the 64 → 1600 logits head); any other head of
    ``eval.SLICE_MODELS``: its shipped ``*_5shot_iid_seed0.yaml``.  Each with
    its headers, as a dict (no YAML needed): 5-way 5-shot 10-query on
    ``[1, 128, 157]`` segments, one episode a step (75 segments; MAML's
    config: two; a FINETUNING head trains on flat batches of ``batch_size``
    128, 7 steps an epoch over the 25 × 40 train clips), bf16
    backbone and fp32 head, Adam at lr 0.005 with CosineAnnealingLR(T_max
    100), ``augment: true`` with the Clean mean/std.  Cut to size: ``epoch``
    30 → 2, ``train_episode`` 1000 → 40, ``test_episode`` (val and test) 600
    → 32 by default, and a ``synthetic`` root, since no dataset ships with
    the repository."""
    return Config(None, {
        "seed": 0, **copy.deepcopy(SLICE_MODELS[classifier]),
        "modality": "audio", "way_num": 5, "shot_num": 5, "query_num": 10,
        "ood": False, "data_root": "synthetic", "spec_shape": [1, 128, 157],
        "mean_std_file": "./Auxiliary/Clean_Mean_Std.npy",
        "class_per_split": "./Auxiliary/KOS_paper_splits.npy",
        "augment": True, "epoch": epoch, "train_episode": train_episode,
        "test_episode": test_episode,
        "precision": "bf16", "result_root": result_root,
        "optimizer": {"name": "Adam", "kwargs": {"lr": 0.005}, "other": None},
        "lr_scheduler": {"name": "CosineAnnealingLR", "kwargs": {"T_max": 100, "eta_min": 0}},
    }).get_config_dict()


class Trainer:
    def __init__(self, rank: int, config: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if config.get("profile_steps"):
            raise NotImplementedError("profile_steps: a torch.profiler window is not ported yet "
                                      "(ROADMAP Queue A, remaining pieces)")
        if config.get("precision", "bf16") == "fp32":
            # float32 means float32: cuDNN convolutions default to TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.rank = rank
        self.config = config
        self.result_dir, self.ckpt_dir, self.log_dir = self._init_files(config)
        self.logger = init_logger(
            self.log_dir, level=config.get("log_level", "info"),
            file_name="{}-{}-train.log".format(
                config["classifier"]["name"], config["backbone"]["name"]),
        )
        self.writer = TensorboardWriter(os.path.join(self.log_dir, "tfboard_files"))
        self.seed = int(config.get("seed", 0))
        init_seed(self.seed)  # the initial weights
        self.method: MethodBase = build_method(config)
        if config.get("init_type"):
            init_weights(self.method, config["init_type"],
                         torch.Generator().manual_seed(self.seed))
        self.train_setting = train_setting(config)
        self.eval_setting = eval_setting(config)
        modality = config.get("modality", "audio")
        model_type = self.method.model_type
        self.train_loader = get_dataloader(config, "train", model_type, False, modality)
        self.val_loader = get_dataloader(config, "val", model_type, False, modality)
        self.test_loader = get_dataloader(config, "test", model_type, False, modality)
        n_params = sum(p.numel() for p in self.method.parameters())
        self.logger.info("model: %s / %s — %.2fM params", config["classifier"]["name"],
                         config["backbone"]["name"], n_params / 1e6)
        self.method.to(self.device)
        self.optimizer: Optimizer = build_optimizer(config, self.method)
        self.scheduler: LRScheduler = build_scheduler(config)

        self.start_epoch = 0
        self.best_val_acc = -1.0
        self.best_test_acc = -1.0
        self._maybe_load_pretrain_or_resume()

        self.augment = bool(config.get("augment", False)) and model_type != ModelType.FINETUNING
        self.aug_mean, self.aug_std = get_mean_std(config, "train")
        self.transfer_dtype = resolve_transfer_dtype(config.get("transfer_dtype"))
        # the dual loader's flat half shares the episodic loader's dataset
        banks = setup_segment_banks(
            config, [*self.train_loader, self.val_loader[0], self.test_loader[0]],
            self.device, self.transfer_dtype, self.logger,
        )
        self.train_bank, self.val_bank, self.test_bank = banks[0], banks[-2], banks[-1]

        self.train_meter = AverageMeter(
            "train", ["batch_time", "data_time", "calc_time", "loss", "acc"], self.writer)
        self.eval_meter = AverageMeter("eval", ["acc"], self.writer)
        #: per epoch run by ``train_loop``: epoch, train losses per step,
        #: train episodes/s (flat training: segments through the backbones
        #: per second) and ms per step (host clock, each step ends in a
        #: sync), val/test accuracy and CI
        self.history: List[Dict[str, Any]] = []

    # -- setup --------------------------------------------------------------

    def _init_files(self, config) -> Tuple[str, str, str]:
        """``<result_root>/<Classifier-data-backbone-way-shot[-tag]>/
        {checkpoints, log_files}`` and the merged ``config.yaml``; a resumed
        run reuses ``resume_path``."""
        if config.get("resume") and config.get("resume_path"):
            result_dir = config["resume_path"]
        else:
            data_name = os.path.basename(str(config.get("data_root", "data")).rstrip("/"))
            tag = config.get("tag")
            name = "{}-{}-{}-{}-{}{}".format(
                config["classifier"]["name"], data_name, config["backbone"]["name"],
                config["way_num"], config["shot_num"], f"-{tag}" if tag else "",
            )
            result_dir = os.path.join(config.get("result_root", "./results"), name)
        ckpt_dir = os.path.join(result_dir, "checkpoints")
        log_dir = os.path.join(result_dir, "log_files")
        for d in (result_dir, ckpt_dir, log_dir):
            os.makedirs(d, exist_ok=True)
        save_config(config, os.path.join(result_dir, "config.yaml"))
        return result_dir, ckpt_dir, log_dir

    def _maybe_load_pretrain_or_resume(self) -> None:
        cfg = self.config
        if cfg.get("pretrain_path"):
            load_part(cfg["pretrain_path"], self.method, part="emb_func")
            self.logger.info("loaded pretrained emb_func from %s", cfg["pretrain_path"])
        if cfg.get("resume"):
            path = os.path.join(self.ckpt_dir, LAST)
            if os.path.isfile(path):
                state = load_last(path)
                self.method.load_state_dict(state["state_dict"])
                if state.get("optimizer") is not None:
                    self.optimizer.load_state_dict(state["optimizer"])
                self.start_epoch = int(state.get("epoch", 0)) + 1
                self.best_val_acc = float(state.get("best_val_acc", -1.0))
                self.best_test_acc = float(state.get("best_test_acc", -1.0))
                if state.get("scheduler"):
                    self.scheduler.load_state_dict(state["scheduler"])
                self.logger.info("resumed from %s at epoch %d", path, self.start_epoch)

    # -- steps --------------------------------------------------------------

    def _device_batch(self, host_batch, bank):
        """An ``EpisodeBatch``, ``FlatBatch`` or ``DualBatch`` on the device
        (gathered from ``bank`` when the loaders emit bank rows)."""
        if bank is not None:
            if isinstance(host_batch, DualBatch):
                materialize = materialize_dual_batch
            elif isinstance(host_batch, (FlatBatch, IndexedFlatBatch)):
                materialize = materialize_flat_batch
            else:
                materialize = materialize_episode_batch
            return materialize(host_batch.to(self.device), bank)
        return host_batch.to(self.device, self.transfer_dtype)

    def _augment_batch(self, batch, gen: torch.Generator):
        """One random augmentation type for the support, one for the query
        and, in a ``DualBatch``, one for the flat half of a step, with
        per-segment values."""
        def aug(x):
            flat = x.reshape((-1,) + x.shape[2:])
            return augment_batch_one_type(flat, self.aug_mean, self.aug_std, gen).reshape(x.shape)

        if isinstance(batch, DualBatch):
            return DualBatch(episode=self._augment_batch(batch.episode, gen),
                             flat=FlatBatch(data=augment_batch_one_type(
                                 batch.flat.data, self.aug_mean, self.aug_std, gen),
                                 target=batch.flat.target))
        return batch.replace(support=aug(batch.support), query=aug(batch.query))

    def _dual(self) -> bool:
        """An episodic loader paired with a flat one (``dataloader_num: 2``
        for an episodic method)."""
        return len(self.train_loader) > 1 and not isinstance(self.train_loader[0], FlatLoader)

    def _steps_per_epoch(self) -> int:
        """Train steps an epoch: the loaders are zipped, as long as the
        shortest; without a pair each zipped batch is a step of its own."""
        shortest = min(len(ld) for ld in self.train_loader)
        return shortest if self._dual() else shortest * len(self.train_loader)

    def _host_batches(self, epoch: int):
        """The epoch's host batches: the loaders zipped, as long as the
        shortest, each zipped batch a step (FINETUNING with ``dataloader_num``
        > 1: the flat loaders' batches in turn); an episodic and a flat
        loader (``dataloader_num: 2``) zipped into one ``DualBatch`` a step
        (the truncation said in the log at epoch 0 when the flat one is the
        shorter)."""
        loaders = self.train_loader
        if not self._dual():
            return (b for batches in zip(*(ld.epoch(epoch) for ld in loaders)) for b in batches)
        n_ep, n_flat = len(loaders[0]), len(loaders[1])
        if epoch == 0 and n_flat < n_ep:
            self.logger.info(
                "dual-loader epoch truncated to %d steps: the global-flat companion "
                "(%d batches of batch_size %s) is shorter than the episodic loader "
                "(%d) — reference zip semantics (trainer.py:159)",
                n_flat, n_flat, self.config.get("batch_size", 128), n_ep)
        return (DualBatch(episode=e, flat=f)
                for e, f in zip(loaders[0].epoch(epoch), loaders[1].epoch(epoch)))

    def _train_step(self, batch: EpisodeBatch) -> Dict[str, torch.Tensor]:
        loss, out = self.method.loss(batch, self.train_setting)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(), **out.metrics}

    # -- loops --------------------------------------------------------------

    @torch.no_grad()
    def run_featuring(self) -> Tuple[float, float]:
        """IFSL's featuring pass (IfslPretrain with
        ``ifsl_pretrain_param.featuring``): one eval-mode pass over the flat
        train loader's epoch 0, the per-class sums and counts of the
        backbone's flat features (``IfslPretrain.class_sums``, with its
        ``norm``), their means written to ``feature_path`` with ``np.save`` as
        float32 ``[num_class, D]`` (unseen classes: zero rows, warned), and
        a LAST checkpoint of the unchanged weights with its ``save_part``
        files.  The parameters never move, so no epoch loop."""
        feature_path = getattr(self.method, "feature_path", None)
        if not feature_path:
            raise ValueError("featuring: true requires ifsl_pretrain_param.feature_path")
        self.method.eval()
        num_class = self.method.num_class
        sums = torch.zeros((num_class, self.method.feat_dim), device=self.device)
        counts = torch.zeros((num_class,), device=self.device)
        t0, steps = time.time(), 0
        for host_batch in self.train_loader[0].epoch(0):
            batch = self._device_batch(host_batch, self.train_bank)
            step_sums, step_counts = self.method.class_sums(batch.data, batch.target,
                                                            self.method.norm)
            sums += step_sums
            counts += step_counts
            steps += 1
        means = (sums / counts.clamp(min=1.0)[:, None]).cpu().numpy().astype(np.float32)
        os.makedirs(os.path.dirname(os.path.abspath(feature_path)), exist_ok=True)
        np.save(feature_path, means)
        covered = int((counts > 0).sum())
        self.logger.info("featuring: %d steps, %d/%d classes covered -> %s (%.1f s)", steps,
                         covered, num_class, feature_path, time.time() - t0)
        if covered < num_class:
            self.logger.warning("featuring: %d classes unseen in the train split keep all-zero "
                                "feature rows", num_class - covered)
        save_model(self.ckpt_dir, self.method, 0, SaveType.LAST,
                   train_state={"best_val_acc": -1.0, "best_test_acc": -1.0},
                   save_part=self.config.get("save_part") or [])
        self.writer.close()
        return self.best_val_acc, self.best_test_acc

    def train_loop(self, rank: int = 0) -> Tuple[float, float]:
        cfg = self.config
        if getattr(self.method, "featuring", False):
            return self.run_featuring()
        epochs = int(cfg.get("epoch", 1))
        t_start = time.time()
        for epoch in range(self.start_epoch, epochs):
            self.logger.info("============ Train on the train set ============")
            self.logger.info("learning rate: %.6g", self.optimizer.base_lr * self.scheduler.scale(epoch))
            record = {"epoch": epoch}
            train_loss = self._train(epoch, record)

            val_acc = test_acc = None
            if (epoch + 1) % int(cfg.get("val_per_epoch", 1)) == 0:
                self.logger.info("============ Validation on the val set ============")
                val_acc, val_ci = self._validate(epoch, self.val_loader[0], self.val_bank)
                self.logger.info(" * Acc@1 %.3f ± %.3f Best acc %.3f", val_acc, val_ci,
                                 max(self.best_val_acc, val_acc))
                self.logger.info("============ Testing on the test set ============")
                test_acc, test_ci = self._validate(epoch, self.test_loader[0], self.test_bank)
                self.logger.info(" * Acc@1 %.3f ± %.3f Best acc %.3f", test_acc, test_ci,
                                 max(self.best_test_acc, test_acc))
                record.update(val_acc=val_acc, val_ci=val_ci, test_acc=test_acc, test_ci=test_ci)

            self.scheduler.step(train_loss)
            self._checkpoint(epoch, val_acc, test_acc)
            self.history.append(record)
            done = epoch - self.start_epoch + 1
            per_epoch = (time.time() - t_start) / done
            self.logger.info("epoch %d done (%.1fs/epoch, ETA %.0fs)", epoch, per_epoch,
                             per_epoch * (epochs - epoch - 1))
        self.logger.info("End of experiment — best val %.3f / best test %.3f (results: %s)",
                         self.best_val_acc, self.best_test_acc, self.result_dir)
        self.writer.close()
        return self.best_val_acc, self.best_test_acc

    def _train(self, epoch: int, record: Dict[str, Any]) -> float:
        cfg = self.config
        meter = self.train_meter
        meter.reset()
        self.optimizer.set_lr_scale(self.scheduler.scale(epoch))
        log_interval = int(cfg.get("log_interval", 100))
        flat = self.method.model_type == ModelType.FINETUNING
        episode_size = 1 if flat else int(cfg.get("episode_size", 1))
        n_steps = self._steps_per_epoch()
        # augmentation and dropout draws per epoch: a resumed run draws what
        # an uninterrupted one would.  The dropout seed is the first draw of
        # the epoch's stream, so no two streams share a seed
        gen = torch.Generator().manual_seed(self.seed * 100003 + epoch)
        seed_dropout(self.method, int(torch.randint(2 ** 62, (), generator=gen)))
        self.method.train()
        losses: List[float] = []
        t_epoch = t_end = time.time()
        for step, host_batch in enumerate(self._host_batches(epoch)):
            self.writer.set_step(epoch * n_steps + step)
            meter.update("data_time", time.time() - t_end)
            t0 = time.time()
            batch = self._device_batch(host_batch, self.train_bank)
            if self.augment:
                batch = self._augment_batch(batch, gen)
            metrics = self._train_step(batch)
            loss = float(metrics["loss"])  # waits for the step
            losses.append(loss)
            meter.update("calc_time", time.time() - t0)
            meter.update("loss", loss)
            meter.update("acc", float(metrics.get("acc", 0.0)))
            meter.update("batch_time", time.time() - t_end)
            t_end = time.time()
            if step % log_interval == 0:
                self.logger.info(
                    "Epoch-({}): [{}/{}]\tTime {:.3f} ({:.3f})\tCalc {:.3f} ({:.3f})\t"
                    "Data {:.3f} ({:.3f})\tLoss {:.3f} ({:.3f})\tAcc@1 {:.3f} ({:.3f})".format(
                        epoch, step * episode_size, n_steps * episode_size,
                        meter.last("batch_time"), meter.avg("batch_time"),
                        meter.last("calc_time"), meter.avg("calc_time"),
                        meter.last("data_time"), meter.avg("data_time"),
                        meter.last("loss"), meter.avg("loss"),
                        meter.last("acc"), meter.avg("acc"),
                    )
                )
        wall = time.time() - t_epoch
        record.update(train_losses=losses, step_ms=1e3 * meter.avg("calc_time"))
        if flat:
            # segments through the backbones (SKD's flips, a teacher's pass)
            rows = self.method.backbone_rows(self.train_loader[0].sampler.batch_size)
            record["train_segments_per_s"] = len(losses) * rows / max(wall, 1e-9)
        else:
            record["train_eps"] = len(losses) * episode_size / max(wall, 1e-9)
        return meter.avg("loss")

    @torch.no_grad()
    def _validate(self, epoch: int, loader, bank=None) -> Tuple[float, float]:
        self.writer.set_step(epoch)
        self.method.eval()
        pending = []
        for host_batch in loader.epoch(epoch):
            batch = self._device_batch(host_batch, bank)
            seg_logits = self.method(batch, self.eval_setting)
            pending.append(self.method.eval_episode_accuracy(seg_logits, batch))
        # one host sync per pass
        accs = torch.cat(pending).cpu().tolist() if pending else []
        mean, ci = mean_confidence_interval(accs)
        self.eval_meter.update("acc", mean)
        return mean, ci

    # -- checkpoints --------------------------------------------------------

    def _checkpoint(self, epoch: int, val_acc: Optional[float], test_acc: Optional[float]) -> None:
        cfg = self.config
        save_part = cfg.get("save_part") or []
        if val_acc is not None and val_acc > self.best_val_acc:
            self.best_val_acc = val_acc
            # the test accuracy AT the best-val epoch, not a running max
            if test_acc is not None:
                self.best_test_acc = test_acc
            save_model(self.ckpt_dir, self.method, epoch, SaveType.BEST, save_part=save_part)
        if (epoch + 1) % int(cfg.get("save_interval", 10)) == 0:
            save_model(self.ckpt_dir, self.method, epoch, SaveType.NORMAL, save_part=save_part)
        save_model(
            self.ckpt_dir, self.method, epoch, SaveType.LAST,
            train_state={
                "best_val_acc": self.best_val_acc,
                "best_test_acc": self.best_test_acc,
                "scheduler": self.scheduler.state_dict(),
                "optimizer": self.optimizer.state_dict(),
            },
            save_part=save_part,
        )
