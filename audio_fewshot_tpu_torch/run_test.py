"""Test CLI: ``python -m audio_fewshot_tpu_torch.run_test <result_dir>`` or
``--yaml_path <config.yaml>``, with ``--key value`` config overrides.

Loads ``<result_dir>/config.yaml`` (or the given YAML) with the overrides
``test_epoch: 1, test_episode: 400`` and runs ``Test.test_loop`` on the
card; ``--device cpu`` runs on the CPU instead.  Several cards: ``torchrun
--nproc_per_node N -m audio_fewshot_tpu_torch.run_test ...``, or ``--nproc
N``, which starts the N ranks itself.
"""

import argparse
import os

import torch.distributed as dist

from .config import Config
from .eval import Test
from .parallel.launch import spawn

VAR_DICT = {
    "test_epoch": 1,
    "test_episode": 400,
}


def _config(args, rest):
    var_dict = dict(VAR_DICT)
    if args.test_epoch is not None:
        var_dict["test_epoch"] = args.test_epoch
    if args.test_episode is not None:
        var_dict["test_episode"] = args.test_episode
    yaml_path = args.yaml_path
    if yaml_path is None and args.result_path:
        yaml_path = os.path.join(args.result_path, "config.yaml")
    return Config(yaml_path, var_dict, cli_args=list(rest)).get_config_dict()


def _rank(rank: int, init_method: str, args, rest) -> None:
    config = _config(args, rest)
    config["dist_init_method"] = init_method
    try:
        Test(rank, config, args.result_path, device=args.device).test_loop()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "result_path", nargs="?", default=None,
        help="result dir containing config.yaml + checkpoints/model_best.pth",
    )
    parser.add_argument("--yaml_path", "-y", type=str, default=None,
                        help="explicit config yaml (overrides result_path/config.yaml)")
    parser.add_argument("--test_epoch", type=int, default=None)
    parser.add_argument("--test_episode", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; raises without a GPU)")
    parser.add_argument("--nproc", type=int, default=1,
                        help="ranks to start on this host, one a card (default 1)")
    args, rest = parser.parse_known_args(argv)
    if args.nproc > 1:
        spawn(_rank, args.nproc, (args, rest))
        return
    Test(0, _config(args, rest), args.result_path, device=args.device).test_loop()


if __name__ == "__main__":
    main()
