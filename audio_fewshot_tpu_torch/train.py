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
epochs.  On a CLAP encoder (``CLAPBackbone``, or ``is_clap``) the backbone's
``checkpoint_path`` (a flat npz) is loaded into ``emb_func`` before
``pretrain_path`` and resume.  ``profile_steps`` traces train steps
[``profile_start``, ``profile_start + profile_steps``) of epoch 0 with
``torch.profiler`` (CPU, and CUDA on the card) into a Chrome trace under
``<log_dir>/profile/``, with the program's ``afs.*`` spans of every thread
(``utils/spans.py``: the loader's, the copy's, the backbone's).

Over several ranks (``torchrun``, or ``run_trainer --nproc``; see
``parallel``) each rank trains on its contiguous shard of every step's
episodes (and of a ``DualBatch``'s flat rows): the backbone's BatchNorm
moments span the ranks, the augmentation values are drawn for the whole
step and sliced, the gradients are averaged over the ranks in one
all-reduce before the optimizer step, and the validation accuracies are
gathered in rank order, so the run computes what one rank computes (but for
Dropout and DropBlock masks, drawn per rank).  The world size must divide
the training batch's axis (a FINETUNING method's ``batch_size``, else
``episode_size``); an eval step whose episodes do not split over the ranks
runs replicated, every rank computing all of them.  IfslPretrain's featuring
sums are added over the ranks.  Rank 0 alone writes the checkpoints,
TensorBoard (with ``log_paramerter``, a histogram of each parameter every
``log_interval`` steps), the profiler trace, the log file and the
featuring means.  A method not audited for it (``MethodBase.shardable``)
raises at a world above one.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.modules.batchnorm import _BatchNorm

from .config import Config, save_config
from .data import FlatLoader, get_dataloader, get_mean_std
from .data.bank import resolve_transfer_dtype, setup_segment_banks
from .episode import (DualBatch, EpisodeBatch, FlatBatch, IndexedFlatBatch,
                      materialize_dual_batch, materialize_episode_batch, materialize_flat_batch)
from .eval import SLICE_MODELS, world_for
from .models import build_method, eval_setting, train_setting
from .models.backbones.clap_encoder import CLAPAudioEncoder, load_checkpoint
from .models.backbones.layers import seed_dropout
from .models.base import MethodBase, ModelType
from .models.init import init_weights
from .ops.audio_augmentations import augment_batch_one_type
from .optim import LRScheduler, Optimizer, build_optimizer, build_scheduler
from .parallel import (World, all_reduce_gradients, all_reduce_mean, gather_rows,
                       maybe_init_distributed, replicate, replicated_rows, shard_batch)
from .utils import init_logger, init_seed, mean_confidence_interval, resolve_device
from .utils.checkpoint import LAST, SaveType, load_last, load_part, save_model
from .utils.meters import AverageMeter, TensorboardWriter
from .utils.spans import every_thread


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


def train_divisors(config: Dict[str, Any], method: MethodBase) -> Dict[str, Any]:
    """The knobs the world size must divide: the training batch's axis, a
    FINETUNING method's flat ``batch_size`` (its ``episode_size`` sizes
    nothing), else ``episode_size`` (and a dual loader's ``batch_size``).
    Eval steps that do not split run replicated (``Trainer._validate``), as
    the JAX ``Trainer`` sizes its mesh."""
    if method.model_type == ModelType.FINETUNING:
        return {"batch_size": config.get("batch_size", 128)}
    divisors = {"episode_size": config.get("episode_size", 1)}
    if int(config.get("dataloader_num", 1)) > 1:
        divisors["batch_size"] = config.get("batch_size", 128)
    return divisors


def sharded_train_step(method: MethodBase, optimizer: Optimizer, batch, setting,
                       world: World) -> Dict[str, torch.Tensor]:
    """One optimizer step on this rank's shard: the loss, its backward, the
    gradients averaged over the ranks, the step.  Returns the loss and the
    method's metrics, averaged over the ranks (each a mean over equal
    shards, so the whole batch's)."""
    loss, out = method.loss(batch, setting)
    optimizer.zero_grad()
    loss.backward()
    all_reduce_gradients(method.parameters(), world)
    optimizer.step()
    metrics = {"loss": loss.detach(), **out.metrics}
    if world.size > 1:
        keys = list(metrics)
        means = all_reduce_mean(torch.stack([torch.as_tensor(metrics[k], device=loss.device)
                                             .float().reshape(()) for k in keys]), world)
        metrics = dict(zip(keys, means))
    return metrics


class Trainer:
    def __init__(self, rank: int, config: Dict[str, Any],
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if config.get("precision", "bf16") == "fp32":
            # float32 means float32: cuDNN convolutions default to TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        maybe_init_distributed(config, self.device)
        self.rank = dist.get_rank() if dist.is_initialized() else rank
        self.config = config
        self.result_dir, self.ckpt_dir, self.log_dir = self._init_files(config)
        self.logger = init_logger(
            self.log_dir, level=config.get("log_level", "info"),
            file_name="{}-{}-train.log".format(
                config["classifier"]["name"], config["backbone"]["name"]),
            rank=self.rank,
        )
        tb_dir = os.path.join(self.log_dir, "tfboard_files")
        self.writer = (TensorboardWriter(tb_dir) if self.rank == 0
                       else TensorboardWriter(tb_dir, enabled=False))
        self.seed = int(config.get("seed", 0))
        init_seed(self.seed, config.get("deterministic"))  # the initial weights
        self.method: MethodBase = build_method(config)
        self.world = world_for(config, self.method, self.device,
                               train_divisors(config, self.method))
        self.device = self.world.device
        if self.world.size > 1:
            self.logger.info("world: %d ranks (%s), this rank %d on %s", self.world.size,
                             dist.get_backend(), self.rank, self.device)
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
        replicate(self.method, self.world)  # every rank starts from rank 0's state

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
        {checkpoints, log_files}`` and the merged ``config.yaml`` (made by
        rank 0); a resumed run reuses ``resume_path``."""
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
        if self.rank == 0:
            for d in (result_dir, ckpt_dir, log_dir):
                os.makedirs(d, exist_ok=True)
            save_config(config, os.path.join(result_dir, "config.yaml"))
        return result_dir, ckpt_dir, log_dir

    def _maybe_load_pretrain_or_resume(self) -> None:
        cfg = self.config
        clap_ckpt = (cfg["backbone"].get("kwargs") or {}).get("checkpoint_path")
        if clap_ckpt and isinstance(self.method.emb_func, CLAPAudioEncoder):
            load_checkpoint(self.method.emb_func, clap_ckpt)
            self.logger.info("loaded CLAP encoder weights from %s", clap_ckpt)
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

    def _splits(self, host_batch) -> bool:
        """Whether a host batch's leading (episode) axis splits over the
        ranks."""
        lead = getattr(host_batch, dataclasses.fields(host_batch)[0].name)
        return lead.shape[0] % self.world.size == 0

    def _device_batch(self, host_batch, bank, replicated: bool = False):
        """This rank's shard of an ``EpisodeBatch``, ``FlatBatch`` or
        ``DualBatch`` on the device, or with ``replicated`` the whole batch
        (gathered from ``bank`` when the loaders emit bank rows)."""
        batch = shard_batch(host_batch, None if replicated else self.world,
                            self.transfer_dtype, self.device)
        if bank is not None:
            if isinstance(host_batch, DualBatch):
                materialize = materialize_dual_batch
            elif isinstance(host_batch, (FlatBatch, IndexedFlatBatch)):
                materialize = materialize_flat_batch
            else:
                materialize = materialize_episode_batch
            return materialize(batch, bank)
        return batch

    def _augment_batch(self, batch, gen: torch.Generator):
        """One random augmentation type for the support, one for the query
        and, in a ``DualBatch``, one for the flat half of a step, with
        per-segment values (over several ranks, drawn for the whole step's
        segments and sliced to this rank's)."""
        world = self.world

        def aug_rows(flat):
            part = (world.rank * flat.shape[0], world.size * flat.shape[0])
            return augment_batch_one_type(flat, self.aug_mean, self.aug_std, gen,
                                          part if world.size > 1 else None)

        def aug(x):
            return aug_rows(x.reshape((-1,) + x.shape[2:])).reshape(x.shape)

        if isinstance(batch, DualBatch):
            return DualBatch(episode=self._augment_batch(batch.episode, gen),
                             flat=FlatBatch(data=aug_rows(batch.flat.data),
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
        return sharded_train_step(self.method, self.optimizer, batch, self.train_setting,
                                  self.world)

    # -- loops --------------------------------------------------------------

    @torch.no_grad()
    def featuring_sums(self) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """The featuring pass's per-class sums ``[num_class, D]`` and counts
        ``[num_class]`` of the backbone's flat features (eval mode;
        ``IfslPretrain.class_sums`` with its ``norm``) over the flat train
        loader's epoch 0, and its steps.  Over several ranks each rank sums
        its shard of every batch and the sums are then added over the
        ranks, so every rank holds the whole epoch's."""
        self.method.eval()
        num_class = self.method.num_class
        sums = torch.zeros((num_class, self.method.feat_dim), device=self.device)
        counts = torch.zeros((num_class,), device=self.device)
        steps = 0
        for host_batch in self.train_loader[0].epoch(0):
            batch = self._device_batch(host_batch, self.train_bank)
            step_sums, step_counts = self.method.class_sums(batch.data, batch.target,
                                                            self.method.norm)
            sums += step_sums
            counts += step_counts
            steps += 1
        if self.world.size > 1:
            dist.all_reduce(sums)
            dist.all_reduce(counts)
        return sums, counts, steps

    @torch.no_grad()
    def run_featuring(self) -> Tuple[float, float]:
        """IFSL's featuring pass (IfslPretrain with
        ``ifsl_pretrain_param.featuring``): ``featuring_sums``, their means
        written to ``feature_path`` with ``np.save`` as float32
        ``[num_class, D]`` (unseen classes: zero rows, warned), and a LAST
        checkpoint of the unchanged weights with its ``save_part`` files,
        both by rank 0.  The parameters never move, so no epoch loop."""
        feature_path = getattr(self.method, "feature_path", None)
        if not feature_path:
            raise ValueError("featuring: true requires ifsl_pretrain_param.feature_path")
        num_class = self.method.num_class
        t0 = time.time()
        sums, counts, steps = self.featuring_sums()
        means = (sums / counts.clamp(min=1.0)[:, None]).cpu().numpy().astype(np.float32)
        if self.rank == 0:
            os.makedirs(os.path.dirname(os.path.abspath(feature_path)), exist_ok=True)
            np.save(feature_path, means)
        covered = int((counts > 0).sum())
        self.logger.info("featuring: %d steps, %d/%d classes covered -> %s (%.1f s)", steps,
                         covered, num_class, feature_path, time.time() - t0)
        if covered < num_class:
            self.logger.warning("featuring: %d classes unseen in the train split keep all-zero "
                                "feature rows", num_class - covered)
        if self.rank == 0:
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
        seed_dropout(self.method, int(torch.randint(2 ** 62, (), generator=gen)), self.rank)
        self.method.train()
        losses: List[float] = []
        window = self._profile_window() if epoch == 0 else None
        profiler = None
        t_epoch = t_end = time.time()
        for step, host_batch in enumerate(self._host_batches(epoch)):
            if window and step == window[0]:
                profiler = self._start_profiler()
            if profiler is not None and step == window[1]:
                self._stop_profiler(profiler)
                profiler = None
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
                if cfg.get("log_paramerter") and self.rank == 0:
                    self._log_param_histograms()
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
        if profiler is not None:  # the epoch ended inside the window
            self._stop_profiler(profiler)
        wall = time.time() - t_epoch
        record.update(train_losses=losses, step_ms=1e3 * meter.avg("calc_time"))
        if flat:
            # segments through the backbones (SKD's flips, a teacher's pass)
            rows = self.method.backbone_rows(self.train_loader[0].sampler.batch_size)
            record["train_segments_per_s"] = len(losses) * rows / max(wall, 1e-9)
        else:
            record["train_eps"] = len(losses) * episode_size / max(wall, 1e-9)
        return meter.avg("loss")

    def _log_param_histograms(self) -> None:
        """``log_paramerter: true``: a TensorBoard histogram of every
        parameter at every ``log_interval`` step, tagged with its name's
        dots as slashes, as float32, but for BatchNorm's (the parameters of
        a BatchNorm module, and any name with a part holding "bn" or
        "batchnorm", as the JAX ``Trainer`` filters its flax names)."""
        skip = {f"{module_name}.{name}" if module_name else name
                for module_name, module in self.method.named_modules()
                if isinstance(module, _BatchNorm)
                for name, _ in module.named_parameters(recurse=False)}
        for name, param in self.method.named_parameters():
            parts = [part.lower() for part in name.split(".")]
            if name in skip or any("bn" in part or "batchnorm" in part for part in parts):
                continue
            self.writer.add_histogram(name.replace(".", "/"),
                                      param.detach().float().cpu().numpy())

    def _profile_window(self) -> Optional[Tuple[int, int]]:
        """The traced steps [start, stop) of epoch 0, or None."""
        steps = int(self.config.get("profile_steps", 0) or 0)
        start = int(self.config.get("profile_start", 2))
        return (start, start + steps) if steps > 0 else None

    def _start_profiler(self) -> torch.profiler.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        # every thread: the loader's prefetch worker records afs.data.build
        profiler = torch.profiler.profile(activities=activities, **every_thread())
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler: torch.profiler.profile) -> None:
        """Stop ``profiler`` after the device's work and export its Chrome
        trace under ``<log_dir>/profile/``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        if self.rank != 0:
            return
        out_dir = os.path.join(self.log_dir, "profile")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "train_steps_{}-{}.json".format(*self._profile_window()))
        profiler.export_chrome_trace(path)
        self.logger.info("profiler trace written to %s", path)

    @torch.no_grad()
    def _validate(self, epoch: int, loader, bank=None) -> Tuple[float, float]:
        """A val or test pass: the mean per-episode accuracy and its 95 % CI.
        Over several ranks a step whose episodes split over them is
        sharded, its accuracies gathered in rank order; one whose episodes
        do not (a FINETUNING run's ranks divide its ``batch_size``, not its
        ``test_episode_size``) runs replicated: every rank computes every
        episode, as the JAX ``Trainer`` does, and nothing is gathered."""
        self.writer.set_step(epoch)
        self.method.eval()
        pending = []  # (a step's accuracies, whether they are this rank's shard)
        for host_batch in loader.epoch(epoch):
            sharded = self._splits(host_batch)
            batch = self._device_batch(host_batch, bank, replicated=not sharded)
            with contextlib.nullcontext() if sharded else replicated_rows():
                seg_logits = self.method(batch, self.eval_setting)
            pending.append((self.method.eval_episode_accuracy(seg_logits, batch), sharded))
        # one host sync per pass; a sharded step's accuracies in rank order,
        # the order one rank gives them in
        pending = [gather_rows(acc, self.world) if sharded else acc
                   for acc, sharded in pending]
        accs = torch.cat(pending).cpu().tolist() if pending else []
        mean, ci = mean_confidence_interval(accs)
        self.eval_meter.update("acc", mean)
        return mean, ci

    # -- checkpoints --------------------------------------------------------

    def _checkpoint(self, epoch: int, val_acc: Optional[float], test_acc: Optional[float]) -> None:
        cfg = self.config
        save_part = cfg.get("save_part") or []
        best = val_acc is not None and val_acc > self.best_val_acc
        if best:
            self.best_val_acc = val_acc
            # the test accuracy AT the best-val epoch, not a running max
            if test_acc is not None:
                self.best_test_acc = test_acc
        if self.rank != 0:  # every rank holds the same state; rank 0 writes it
            return
        if best:
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
