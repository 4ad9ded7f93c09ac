"""Layered YAML configuration (counterpart of ``audio_fewshot_tpu/config.py``).

Merge order (later wins):

    built-in defaults  <-  ``includes:`` headers (in list order)
                       <-  the named YAML file
                       <-  ``variable_dict`` overrides
                       <-  CLI overrides (``--key value`` pairs)

All merging is recursive on nested dicts, so ``config/**`` leaves merge to
the same dict in both packages.  PyYAML is imported only where a file or a
CLI value is parsed: a config built from a dict (``Config(None, var_dict)``)
needs no YAML.
"""

from __future__ import annotations

import copy
import os
import warnings
from typing import Any, Dict, Optional

# Built-in defaults mirroring the reference's header YAMLs
# (reference config/headers/{data,device,misc,model,optimizer}.yaml) so that a
# leaf config with no ``includes:`` still resolves to a complete config dict.
DEFAULTS: Dict[str, Any] = {
    # data
    "data_root": "",
    "image_size": 84,
    "audio_size": None,   # no consumer anywhere (loud warning if set)
    "use_memory": False,  # → forces device_data_bank on (_finalize)
    "augment": True,
    "augment_times": 1,
    "augment_times_query": 1,
    "workers": 8,         # 0 → synchronous batch build (data/loader.py)
    "dataloader_num": 1,
    "is_clap": False,     # → CLAPBackbone override (models.build_method)
    "modality": "audio",
    "mean_std_file": None,
    "class_per_split": None,
    "ood": False,
    # device-resident segment banks (data/bank.py, episode.Indexed*Batch):
    # true / false / "auto" = on when the split banks fit the GB cap.
    # device_eval_bank is the accepted alias (the knob's original name).
    "device_data_bank": "auto",
    "device_data_bank_max_gb": 4.0,
    # device
    # the ranks of a run (parallel/mesh.py): one process a card, started by
    # torchrun or an entry point's --nproc; n_devices (or n_gpu > 1) must
    # equal the world size, and device_ids (a comma list) picks the cards
    "device_ids": 0,
    "n_gpu": 1,
    "n_devices": None,
    "seed": 0,
    "deterministic": True,
    "port": None,
    # misc / logging
    "log_name": None,
    "log_level": "info",
    "log_interval": 100,
    "log_paramerter": False,
    "result_root": "./results",
    "save_interval": 10,
    "save_part": ["emb_func"],
    "parallel_part": ["emb_func"],
    "tag": None,
    "epoch": 25,
    "test_epoch": 5,
    "pretrain_path": None,
    "resume": False,
    "warmup": 0,
    "val_per_epoch": 1,
    # few-shot settings
    "way_num": 5,
    "shot_num": 1,
    "query_num": 10,
    "test_way": None,
    "test_shot": None,
    "test_query": None,
    "episode_size": 1,
    "train_episode": 500,
    "test_episode": 600,
    "batch_size": 128,
    # model / optim
    "classifier": {"name": "ProtoNet", "kwargs": None},
    "backbone": {"name": "Conv64F", "kwargs": None},
    "optimizer": {"name": "Adam", "kwargs": {"lr": 0.01}, "other": None},
    "lr_scheduler": {"name": "StepLR", "kwargs": {"gamma": 1.0, "step_size": 20}},
    # framework knobs (no reference equivalent)
    "precision": "bf16",  # compute dtype for backbones: bf16|fp32
    "max_segments_per_clip": 8,  # bucket cap for variable-length eval clips
    "segment_bucket_sizes": None,  # explicit list of Qseg buckets, else auto
    "prefetch": 2,
    "rank": 0,
}


def _recursive_update(base: Dict[str, Any], new: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """In-place recursive dict merge; ``new`` wins, nested dicts merge."""
    if not new:
        return base
    for k, v in new.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _recursive_update(base[k], v)
        else:
            base[k] = v
    return base


def _parse_scalar(text: str) -> Any:
    """Parse a CLI override value with YAML scalar semantics."""
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


class Config:
    """Load and merge a layered YAML config.

    Args:
        config_path: path to the leaf YAML (or a saved ``config.yaml`` when
            resuming).  ``None`` loads defaults only.
        variable_dict: programmatic overrides (reference run_test.py:137-149
            ``VAR_DICT``).
        is_resume: when True, the file is a fully-merged saved config; its
            ``includes`` are ignored and ``resume`` is forced on
            (reference run_trainer_resume.py:20).
        cli_args: optional explicit argv list for overrides; ``None`` means
            "don't read sys.argv" (safer for library use; the run_* entry
            points pass the remainder of their argv).
    """

    def __init__(
        self,
        config_path: Optional[str] = None,
        variable_dict: Optional[Dict[str, Any]] = None,
        is_resume: bool = False,
        cli_args: Optional[list] = None,
    ):
        self.config_path = config_path
        self.is_resume = is_resume

        # deep copy: _recursive_update mutates nested dicts in place, and a
        # shallow copy would leak one Config's overrides into the module
        # DEFAULTS (and thus into every later Config in the process)
        config = copy.deepcopy(DEFAULTS)

        file_dict = self._load_yaml(config_path) if config_path else {}

        if not is_resume:
            for include in file_dict.get("includes", []) or []:
                _recursive_update(config, self._load_include(config_path, include))
        _recursive_update(config, file_dict)
        _recursive_update(config, variable_dict)
        _recursive_update(config, self._parse_cli(cli_args))

        if is_resume:
            config["resume"] = True

        self._finalize(config)
        self.config_dict = config

    # -- loading ------------------------------------------------------------

    @staticmethod
    def _load_yaml(path: str) -> Dict[str, Any]:
        import yaml

        with open(path, "r", encoding="utf-8") as f:
            loaded = yaml.safe_load(f)
        return loaded or {}

    @staticmethod
    def _load_include(leaf_path: str, include: str) -> Dict[str, Any]:
        """Resolve an ``includes:`` entry.

        Reference leaf configs live in ``config/<method>/`` and reference
        headers as ``headers/data.yaml`` — i.e. relative to the config ROOT,
        not the leaf directory (upstream resolves against ``./config`` from
        the repo root; the snapshot's own ``libfewshot_core.config`` import
        is broken — module absent — so upstream LibFewShot semantics govern).
        Search order: leaf dir, each ancestor up to 3 levels, each ancestor's
        ``config/`` subdir (covers ``reproduce/<M>/`` leaves including their
        sibling ``config/`` tree), then ``./config``.
        """
        leaf_dir = os.path.dirname(os.path.abspath(leaf_path))
        candidates = [os.path.join(leaf_dir, include)]
        parent = leaf_dir
        for _ in range(3):
            parent = os.path.dirname(parent)
            candidates.append(os.path.join(parent, include))
            candidates.append(os.path.join(parent, "config", include))
        candidates.append(os.path.join(os.getcwd(), "config", include))
        for cand in candidates:
            if os.path.isfile(cand):
                return Config._load_yaml(cand)
        raise FileNotFoundError(f"cannot resolve include {include!r} from {leaf_path!r}")

    @staticmethod
    def _parse_cli(cli_args: Optional[list]) -> Dict[str, Any]:
        """Parse ``--key value`` / ``--nested.key value`` overrides."""
        if not cli_args:
            return {}
        out: Dict[str, Any] = {}
        i = 0
        while i < len(cli_args):
            tok = cli_args[i]
            if not tok.startswith("--"):
                i += 1
                continue
            key = tok[2:]
            if "=" in key:
                key, val = key.split("=", 1)
                i += 1
            elif i + 1 < len(cli_args) and not cli_args[i + 1].startswith("--"):
                val = cli_args[i + 1]
                i += 2
            else:
                val = "true"
                i += 1
            target = out
            parts = key.split(".")
            for part in parts[:-1]:
                target = target.setdefault(part, {})
            target[parts[-1]] = _parse_scalar(val)
        return out

    # -- post-processing ----------------------------------------------------

    @staticmethod
    def _finalize(config: Dict[str, Any]) -> None:
        """Derived keys, matching reference upstream semantics."""
        for test_key, train_key in (
            ("test_way", "way_num"),
            ("test_shot", "shot_num"),
            ("test_query", "query_num"),
        ):
            if config.get(test_key) is None:
                config[test_key] = config[train_key]
        if config.get("test_episode") and config.get("train_episode"):
            config.setdefault(
                "tb_scale", float(config["train_episode"]) / float(config["test_episode"])
            )
        # episode divisibility sanity checks (reference trainer.py:724-754)
        # at the world size the config asks for; the launched world's size
        # is checked against the knob its loop reads (episode_size in
        # training: train.train_divisors; an eval step that does not split
        # runs replicated)
        n_dev = int(config.get("n_devices") or config.get("n_gpu") or 1)
        if n_dev > 1 and config["episode_size"] % n_dev != 0:
            raise ValueError(
                f"episode_size ({config['episode_size']}) must be divisible by "
                f"the world size ({n_dev} ranks: n_devices, --nproc or torchrun "
                f"--nproc_per_node)"
            )
        # -- knob audit: every accepted key is consumed or rejected loudly --
        # use_memory (upstream LibFewShot: hold the dataset in RAM) → the
        # dataset cache here is the device-resident segment bank
        # (data/bank.py); force it on rather than silently ignoring the key
        if config.get("use_memory") and config.get("device_data_bank") == "auto":
            config["device_data_bank"] = True
        # parallel_part (upstream: which submodules get nn.DataParallel) has
        # no analogue: every rank holds the whole model and takes a shard of
        # the episode axis (parallel/mesh.py)
        if list(config.get("parallel_part") or []) not in ([], ["emb_func"]):
            warnings.warn(
                "parallel_part is accepted for config parity only: each rank "
                "runs the whole model on its shard of the episode axis, there "
                "is no per-submodule DataParallel split",
                stacklevel=2,
            )
        # audio_size is consumed by nothing in the reference snapshot either
        # (its data package is absent); spec_shape governs input geometry here
        if config.get("audio_size"):
            warnings.warn(
                "audio_size has no consumer (reference snapshot included); "
                "input geometry is set by spec_shape",
                stacklevel=2,
            )

    def get_config_dict(self) -> Dict[str, Any]:
        return self.config_dict


def save_config(config: Dict[str, Any], path: str) -> None:
    """Dump a fully-merged config as ``config.yaml`` for run_test."""
    import yaml

    clean = {k: v for k, v in config.items() if k != "includes"}
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(clean, f, default_flow_style=False, sort_keys=True)
