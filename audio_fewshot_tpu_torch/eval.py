"""Test harness: episodic evaluation with confidence intervals (counterpart of
``Test`` in ``audio_fewshot_tpu/eval.py``).

``Test(rank, config, result_path, device).test_loop()`` runs the energy
calibration pass on the val split (for methods that support it), one
warm-up step, then ``test_epoch`` passes over the test loader, and reports
a 95 % CI per epoch and over the epoch means.  It runs on ``cuda`` unless
``device`` says otherwise, and raises when no card is there.

The energy-OOD TTA re-vote (``enhance_classification_via_energy``) and
``dump_features`` are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from .config import Config
from .data import get_dataloader
from .data.bank import resolve_transfer_dtype, setup_segment_banks
from .episode import materialize_episode_batch
from .models import build_method, eval_setting
from .models.base import MethodBase
from .utils import init_logger, init_seed, mean_confidence_interval, resolve_device
from .utils.checkpoint import BEST, load_model


def slice_config(test_episode: int = 64, test_epoch: int = 2,
                 precision: str = "bf16") -> Dict[str, Any]:
    """The full-width DeepBDC + resnet12Bdc eval cell that ``chip_smoke.py``
    and ``profile_eval`` run on the card.

    ``config/deepbdc/deepbdc_5shot_iid_seed0.yaml`` with its headers, as a
    dict (no YAML needed), cut to size: ``test_episode`` 600 → 64 and
    ``test_epoch`` 5 → 2 by default, ``max_segments_per_clip`` 6, 16 episodes
    per step, and a ``synthetic`` root of ``[1, 128, 157]`` segments, since no
    dataset ships with the repository."""
    return Config(None, {
        "classifier": {"name": "DeepBDC", "kwargs": None},
        "backbone": {"name": "resnet12Bdc",
                     "kwargs": {"num_channels": 1, "reduce_dim": 64}},
        "modality": "audio",
        "way_num": 5, "shot_num": 5, "query_num": 10,
        "seed": 0, "ood": False, "tag": "deepbdc_5shot_iid_seed0",
        "data_root": "synthetic",
        "spec_shape": [1, 128, 157],
        "max_segments_per_clip": 6,
        "test_episode_size": 16,
        "test_episode": test_episode,
        "test_epoch": test_epoch,
        "precision": precision,
    }).get_config_dict()


class Test:
    __test__ = False  # not a pytest case (tests import this module)

    def __init__(self, rank: int, config: Dict[str, Any],
                 result_path: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if config.get("enhance_classification_via_energy"):
            raise NotImplementedError(
                "enhance_classification_via_energy: the energy-OOD TTA re-vote "
                "(eval.tta_eval_step, ops/audio_augmentations.py) is the TTA "
                "slice of the port and is not ported yet"
            )
        if config.get("dump_features"):
            raise NotImplementedError("dump_features is not ported yet")
        if config.get("precision", "bf16") == "fp32":
            # float32 means float32: cuDNN convolutions default to TF32
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.rank = rank
        self.config = config
        self.result_path = result_path
        self.logger = init_logger(
            os.path.join(result_path, "log_files") if result_path else None,
            level=config.get("log_level", "info"),
            file_name="{}-{}-test.log".format(
                config["classifier"]["name"], config["backbone"]["name"]
            ),
        )
        init_seed(int(config.get("seed", 0)))  # the random init when no checkpoint
        self.method: MethodBase = build_method(config)
        self.setting = eval_setting(config)
        modality = config.get("modality", "audio")
        # the val split feeds only the energy calibration pass
        self.val_loader = (
            get_dataloader(config, "val", self.method.model_type, False, modality)
            if getattr(self.method, "supports_energy_ood", False) else None
        )
        self.test_loader = get_dataloader(
            config, "test", self.method.model_type, False, modality
        )
        self._load_model()
        self.transfer_dtype = resolve_transfer_dtype(config.get("transfer_dtype"))
        self.val_bank, self.test_bank = self._setup_segment_banks()
        #: episodes per second of each test epoch (host clock, synchronised)
        self.epoch_eps: List[float] = []

    def _load_model(self) -> None:
        ckpt = (os.path.join(self.result_path, "checkpoints", BEST)
                if self.result_path else None)
        if ckpt and os.path.isfile(ckpt):
            load_model(ckpt, self.method)
            self.logger.info("loaded checkpoint %s", ckpt)
        else:
            self.logger.warning("no checkpoint found — evaluating at init")
        # evaluation only: no parameter needs grad, so no call builds a graph
        self.method.to(self.device).eval().requires_grad_(False)

    def _setup_segment_banks(self):
        loaders = [self.test_loader[0]]
        if self.val_loader is not None:
            loaders.insert(0, self.val_loader[0])
        banks = setup_segment_banks(
            self.config, loaders, self.device, self.transfer_dtype, self.logger
        )
        if self.val_loader is None:
            return None, banks[0]
        return banks[0], banks[1]

    def _eval_step(self, host_batch) -> torch.Tensor:
        """Per-episode accuracy ``[E]`` (on the device) of one host batch."""
        if self.test_bank is not None:
            batch = materialize_episode_batch(host_batch.to(self.device), self.test_bank)
        else:
            batch = host_batch.to(self.device, self.transfer_dtype)
        seg_logits = self.method(batch, self.setting)
        return self.method.eval_episode_accuracy(seg_logits, batch)

    @torch.no_grad()
    def test_loop(self) -> Tuple[float, float]:
        cfg = self.config
        n_epochs = int(cfg.get("test_epoch", 5))
        if getattr(self.method, "supports_energy_ood", False):
            self.logger.info("============ Calibration pass on the val set ============")
            dump = (os.path.join(self.result_path, "uncertainty_data.npz")
                    if self.result_path else None)
            th = self.method.calibrate_threshold(
                self.val_loader[0], self.setting,
                policy=str(cfg.get("uncertainty_policy", "mean")),
                dump_path=dump, bank=self.val_bank,
            )
            self.logger.info("uncertainty threshold: %s", th)

        if cfg.get("eval_warmup", True):
            # one discarded step: cuDNN plans and the kernel build stay out
            # of the epoch timer
            t0 = time.time()
            self._eval_step(next(iter(self.test_loader[0].epoch(0)))).cpu()
            self.logger.info("eval step warmed in %.1fs", time.time() - t0)

        epoch_means: List[float] = []
        for epoch in range(n_epochs):
            t0 = time.time()
            # results stay on the device until the epoch ends: one host sync
            pending = [self._eval_step(b) for b in self.test_loader[0].epoch(epoch)]
            accs = torch.cat(pending).cpu().tolist() if pending else []
            dt = time.time() - t0
            mean, ci = mean_confidence_interval(accs)
            n_eps = len(accs)
            self.epoch_eps.append(n_eps / max(dt, 1e-9))
            self.logger.info(
                "Test epoch %d: Acc@1 %.3f ± %.3f (%d episodes, %.1f eps/s)",
                epoch, mean, ci, n_eps, self.epoch_eps[-1],
            )
            epoch_means.append(mean)

        agg_mean, agg_ci = mean_confidence_interval(epoch_means)
        self.logger.info("Aggregated: Acc@1 %.3f ± %.3f over %d epochs", agg_mean, agg_ci, n_epochs)
        return agg_mean, agg_ci
