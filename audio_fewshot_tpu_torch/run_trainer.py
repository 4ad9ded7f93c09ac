"""Train CLI: ``python -m audio_fewshot_tpu_torch.run_trainer --yaml_path
<leaf config.yaml>``, with ``--key value`` config overrides (dotted keys
such as ``--optimizer.kwargs.lr 0.01``).

Runs ``Trainer.train_loop`` on the card; ``--device cpu`` runs on the CPU
instead.  Results go to ``<result_root>/<Classifier-data-backbone-way-shot>``.
Several cards: ``torchrun --nproc_per_node N -m
audio_fewshot_tpu_torch.run_trainer ...``, or ``--nproc N``, which starts
the N ranks itself (NCCL on the cards, gloo with ``--device cpu``).
"""

import argparse

import torch.distributed as dist

from .config import Config
from .parallel.launch import spawn
from .train import Trainer


def _rank(rank: int, init_method: str, yaml_path, device: str, rest) -> None:
    config = Config(yaml_path, cli_args=list(rest)).get_config_dict()
    config["dist_init_method"] = init_method
    try:
        Trainer(rank, config, device=device).train_loop()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(argv=None):
    """The trained ``Trainer`` (None when ``--nproc`` started the ranks)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--yaml_path", "-y", type=str, default=None,
                        help="path to the leaf config yaml")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; raises without a GPU)")
    parser.add_argument("--nproc", type=int, default=1,
                        help="ranks to start on this host, one a card (default 1)")
    args, rest = parser.parse_known_args(argv)
    if args.nproc > 1:
        spawn(_rank, args.nproc, (args.yaml_path, args.device, rest))
        return None
    config = Config(args.yaml_path, cli_args=rest).get_config_dict()
    trainer = Trainer(0, config, device=args.device)
    trainer.train_loop()
    return trainer


if __name__ == "__main__":
    main()
