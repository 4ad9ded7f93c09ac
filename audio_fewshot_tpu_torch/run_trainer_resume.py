"""Resume CLI: ``python -m audio_fewshot_tpu_torch.run_trainer_resume
<result_dir>``, with ``--key value`` config overrides (e.g. ``--epoch 40``
to train further).

Reads the run's merged ``config.yaml`` and its
``checkpoints/model_last.pth`` (weights, optimizer and scheduler state, best
accuracies) and continues at the epoch after the saved one, on the card;
``--device cpu`` runs on the CPU instead.  Several cards: ``torchrun
--nproc_per_node N -m audio_fewshot_tpu_torch.run_trainer_resume ...``, or
``--nproc N``, which starts the N ranks itself (every rank reads the
checkpoint; rank 0's state is broadcast).
"""

import argparse
import os

import torch.distributed as dist

from .config import Config
from .parallel.launch import spawn
from .train import Trainer


def _parse(argv):
    parser = argparse.ArgumentParser()
    parser.add_argument("result_path", help="result dir of the run to resume")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; raises without a GPU)")
    parser.add_argument("--nproc", type=int, default=1,
                        help="ranks to start on this host, one a card (default 1)")
    return parser.parse_known_args(argv)


def _trainer(args, rest, rank: int = 0, init_method=None) -> Trainer:
    config = Config(os.path.join(args.result_path, "config.yaml"), is_resume=True,
                    cli_args=list(rest)).get_config_dict()
    config["resume_path"] = args.result_path
    if init_method:
        config["dist_init_method"] = init_method
    return Trainer(rank, config, device=args.device)


def build_trainer(argv=None) -> Trainer:
    """The resumed ``Trainer``, before its loop runs (one rank)."""
    args, rest = _parse(argv)
    return _trainer(args, rest)


def _rank(rank: int, init_method: str, args, rest) -> None:
    try:
        _trainer(args, rest, rank, init_method).train_loop()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    """The resumed and trained ``Trainer`` (None when ``--nproc`` started
    the ranks)."""
    args, rest = _parse(argv)
    if args.nproc > 1:
        spawn(_rank, args.nproc, (args, rest))
        return None
    trainer = _trainer(args, rest)
    trainer.train_loop()
    return trainer


if __name__ == "__main__":
    main()
